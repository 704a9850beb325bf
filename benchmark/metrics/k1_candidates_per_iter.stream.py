"""Candidates that K1's global cull loaded a live slot-iteration: the
program's "k1_candidates" counter of the traced window over its
"k1_slot_iterations" (propagate_fused adds the launches' CNT_CAND and
CNT_WORK on the global plans at its "totals" wait).  None where the
program counts neither."""

from benchmark import spans as S


def read(data):
    rec = S.recorded()
    if data.get("driver") != "stream" or rec is None:
        return None
    _, counters = rec
    work = S.counted(counters, "k1_slot_iterations")
    if not work:
        return None
    return S.counted(counters, "k1_candidates") / work
