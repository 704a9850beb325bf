from . import anisotropy, functions, properties, tilt  # noqa: F401
