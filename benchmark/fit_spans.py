"""The fit's own spans of a traced window, for the fit cell's readers under
metrics/ (spans.py reads the stream's).

IceFit.step records while a torch.profiler runs on its calling thread:
"fit_step" (root, one a step), with "fit_forward" (the kernel forward,
with the call loop's "plan" inside it) and "fit_optimizer" inside it, and
the backward's "fit_backward" (a root on autograd's device thread on
CUDA tensors) with "fit_replay" and "fit_vjp" inside it.  A program
older than these spans leaves none, and every reader returns None.
"""

from __future__ import annotations

from typing import Optional

from benchmark import spans as S


def per_step_ms(name: str) -> Optional[float]:
    """The summed seconds of the `name` spans over the "fit_step" spans, in
    milliseconds a step; None without steps or such spans."""
    rec = S.recorded()
    if rec is None:
        return None
    spans, _ = rec
    steps = sum(1 for s in spans if s["name"] == "fit_step")
    if not steps or not S.has(spans, name):
        return None
    return S.total_s(spans, name) / steps * 1e3
