"""The call loop's repacks between launches (repack_slots), in
milliseconds a batch: the program's "repack" spans of the traced window
over its "batch" spans; 0 where the call loop ran ("plan" spans) and never
repacked, None where it did not run."""

from benchmark import spans as S


def read(data):
    rec = S.recorded()
    if data.get("driver") != "stream" or rec is None:
        return None
    spans, _ = rec
    n = S.batches(spans)
    if not n or not S.has(spans, "plan"):
        return None
    return S.total_s(spans, "repack") / n * 1e3
