"""The control's precision: every float32 tensor that a torch operation
returns is rounded to bfloat16 (and kept in a float32 container), so the
reference computes as it would in bfloat16 with float32 accumulation
inside single operations.  Elements that hold a whole number stay as they
are: the engine keeps DOM, layer and bin indices in float32, and an index
is not arithmetic a lower precision would round (rounded, an index above
256 lands on another DOM, or outside the table).  float64 tensors (the
engine's counters) are left as they are."""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return torch.where(x == torch.round(x), x,
                           x.to(torch.bfloat16).to(torch.float32))
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_round(v) for v in x)
    if isinstance(x, list):
        return [_round(v) for v in x]
    return x


class Bfloat16(TorchFunctionMode):
    """Within `with Bfloat16():` every float32 result is bfloat16's, but
    for its whole numbers."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "").endswith("_"):
            return out      # an in-place result keeps its storage (and its
                            # autograd version); the next operation rounds
        return _round(out)
