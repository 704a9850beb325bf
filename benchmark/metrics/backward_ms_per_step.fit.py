"""The fit's backward (_ExpectedHist.backward: the engine's replay under
autograd and its vector-Jacobian product), in milliseconds a step: the
program's "fit_backward" spans of the traced window over its "fit_step"
spans."""

from benchmark.fit_spans import per_step_ms


def read(data):
    if data.get("driver") != "fit":
        return None
    return per_step_ms("fit_backward")
