"""The call loop's host planning of a batch (propagate_fused from its first
check through fused_spec and build_tables), in milliseconds a batch: the
program's "plan" spans of the traced window over its "batch" spans."""

from benchmark import spans as S


def read(data):
    if data.get("driver") != "stream":
        return None
    return S.per_batch_ms(S.recorded(), "plan")
