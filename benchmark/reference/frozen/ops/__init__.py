from . import rotations, samplers, spectrum  # noqa: F401
