"""clsim_tpu_torch: the PyTorch + CUDA port of clsim_tpu (photon propagation
for IceCube-style detectors), for NVIDIA Hopper GPUs.

The JAX package clsim_tpu is the reference; each module here has its
counterpart there under the same name.  This package imports torch and
numpy only.  The propagation kernel is hand-written CUDA (csrc/), built with
nvcc at first use (see _build.py).
"""

__version__ = "0.1.0"

from .types import PhotonBatch, PropagationConfig, StepBatch  # noqa: F401
from .geometry import (DetectorGeometry, build_geometry,  # noqa: F401
                       hexagonal_geometry, single_string_geometry)
from .medium.properties import MediumProperties, make_homogeneous_ice  # noqa: F401
