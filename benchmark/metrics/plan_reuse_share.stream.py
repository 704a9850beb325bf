"""The share of the call loop's calls that reused a kept plan, in %: the
program's "plan_reuse" counter of the traced window over "plan_reuse" and
"plan_build" together (propagate_fused counts one of them a call).  None
where the program counts neither."""

from benchmark import spans as S


def read(data):
    rec = S.recorded()
    if data.get("driver") != "stream" or rec is None:
        return None
    _, counters = rec
    reused = S.counted(counters, "plan_reuse")
    calls = reused + S.counted(counters, "plan_build")
    if not calls:
        return None
    return 100.0 * reused / calls
