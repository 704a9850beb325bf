from .muon_slicer import slice_muon, unslice_hits  # noqa: F401
