"""The harvester waiting for the feeder's next batch, in milliseconds a
batch: the program's "queue_wait" spans of the traced window over its
"batch" spans."""

from benchmark import spans as S


def read(data):
    if data.get("driver") != "stream":
        return None
    return S.per_batch_ms(S.recorded(), "queue_wait")
