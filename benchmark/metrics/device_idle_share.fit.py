"""The device's idle share over the traced window of the fit cell, in
percent: 1 - (the union of the CUDA kernel and copy intervals in the
profiler's trace) / (the window)."""

from benchmark.trace import idle_share


def read(data):
    if data.get("driver") != "fit" or not data.get("busy_s"):
        return None
    return idle_share(data["busy_s"], data["window_s"])
