from .engine import PropagationResult, propagate  # noqa: F401
