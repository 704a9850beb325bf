from .muon_slicer import slice_muon, unslice_hits  # noqa: F401
from .sanitize import filter_light_sources, sanitize_taus  # noqa: F401
