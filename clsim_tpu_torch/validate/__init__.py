from .oracle import oracle_propagate, oracle_sample_wavelength  # noqa: F401
