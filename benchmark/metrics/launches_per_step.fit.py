"""CUDA kernel launches a fit step: the kernels (not copies or sets) in the
profiler's trace of the traced window over the steps taken in it; nearly
all of them are the engine's operators in the autograd backward."""


def read(data):
    if data.get("driver") != "fit" or not data.get("steps"):
        return None
    return data["launches"] / data["steps"]
