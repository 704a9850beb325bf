"""Device time of the propagation kernel's launches (propagate_kernel in
the trace) in nanoseconds a generated photon."""


def read(data):
    if data.get("driver") != "stream" or not data.get("k1_s"):
        return None
    return data["k1_s"] / data["photons"] * 1e9
