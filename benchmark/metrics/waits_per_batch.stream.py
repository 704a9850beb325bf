"""Host reads of device values (syncs on the card) on the event path, on
either thread, a batch: the program's "waits" counter of the traced window
over its "batch" spans."""

from benchmark import spans as S


def read(data):
    rec = S.recorded()
    if data.get("driver") != "stream" or rec is None:
        return None
    spans, counters = rec
    n = S.batches(spans)
    if not n:
        return None
    return S.counted(counters, "waits") / n
