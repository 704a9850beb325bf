"""The harvester's host work on a batch outside its waits on the card, in
milliseconds a batch: the program's "batch" spans of the traced window less
the "wait" spans inside them, over the batches."""

from benchmark import spans as S


def read(data):
    rec = S.recorded()
    if data.get("driver") != "stream" or rec is None:
        return None
    spans, _ = rec
    n = S.batches(spans)
    if not n:
        return None
    return (S.total_s(spans, "batch") - S.outer_waits_s(spans)) / n * 1e3
