"""K1's share of its roofline, in percent: the least time its work needs
on the card (roofline.k1_work: the larger of its operations over the
float32 peak and its bytes over the HBM bandwidth) over its device time in
the trace."""

from benchmark.roofline import least_seconds


def read(data):
    if not data.get("k1_s") or "k1_ops" not in data:
        return None
    return 100.0 * least_seconds(data["k1_ops"], data["k1_bytes"]) \
        / data["k1_s"]
