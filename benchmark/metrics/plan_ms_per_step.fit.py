"""The call loop's planning of the fit's forward (propagate_fused's "plan"
span: the kept geometry part looked up, the medium part rebuilt, since the
fit changes the ice every step), in milliseconds a step: the "plan" spans
of the traced window over its "fit_step" spans."""

from benchmark.fit_spans import per_step_ms


def read(data):
    if data.get("driver") != "fit":
        return None
    return per_step_ms("plan")
