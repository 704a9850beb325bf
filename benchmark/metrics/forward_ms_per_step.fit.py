"""The fit's kernel forward (_ExpectedHist.forward: the call loop's plan
and K1's launch), in milliseconds a step: the program's "fit_forward" spans
of the traced window over its "fit_step" spans."""

from benchmark.fit_spans import per_step_ms


def read(data):
    if data.get("driver") != "fit":
        return None
    return per_step_ms("fit_forward")
