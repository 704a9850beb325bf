"""K1's share of its roofline in the fit, in percent: the least time of
the fit forwards' work (roofline_fit.k1_work: the larger of its operations
over the float32 peak and its bytes over the HBM bandwidth) over the
device time of their propagate_kernel launches in the trace."""

from benchmark.roofline import least_seconds


def read(data):
    if data.get("driver") != "fit" or not data.get("k1_s"):
        return None
    return 100.0 * least_seconds(data["k1_ops"], data["k1_bytes"]) \
        / data["k1_s"]
