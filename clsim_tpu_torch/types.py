"""Core data batches (struct-of-arrays) and the static simulation config.

PyTorch counterparts of clsim_tpu.types:
  * StepBatch   <-> I3CLSimStep   (public/clsim/I3CLSimStep.h:68-155)
  * PhotonBatch <-> I3CLSimPhoton (public/clsim/I3CLSimPhoton.h:194-210)

A StepBatch holds numpy arrays on the host (the step generators in
sources/ are numpy) and torch tensors once it has been moved to a device
with convert.steps_from_numpy.  PropagationConfig is copied field for field
from the JAX package: options that only the JAX package implements stay
here so that a config built for one package means the same in the other,
and the port raises NotImplementedError where it meets one.
tensor_leaves lists the floating-point tensors of a NamedTuple of tensors
such as MediumProperties (the fit's leaves, the plan cache's versions).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


class StepBatch(NamedTuple):
    """A bunch of light-emitting Cherenkov steps, padded to a fixed size with
    dummy steps (num_photons == 0), exactly like the reference's bunching
    contract (I3CLSimStepStore.h:163-220)."""
    x: np.ndarray           # (S,) start position [m]
    y: np.ndarray
    z: np.ndarray
    t: np.ndarray           # (S,) start time [ns]
    dir_x: np.ndarray       # (S,) unit direction
    dir_y: np.ndarray
    dir_z: np.ndarray
    length: np.ndarray      # (S,) step length [m]
    beta: np.ndarray        # (S,) particle speed / c
    num_photons: np.ndarray   # (S,) photons to spawn
    weight: np.ndarray      # (S,) statistical weight
    identifier: np.ndarray    # (S,) external id (frame/particle ref)
    source_type: np.ndarray   # (S,) 0=Cherenkov, >=1 flasher spectrum

    @property
    def n_steps(self):
        return self.x.shape[0]

    @staticmethod
    def concatenate(batches):
        """Concatenate host (numpy) batches."""
        return StepBatch(*[np.concatenate([np.asarray(getattr(b, f))
                                           for b in batches])
                           for f in StepBatch._fields])

    @staticmethod
    def empty(n: int):
        zf = np.zeros(n, np.float32)
        zi = np.zeros(n, np.int32)
        return StepBatch(x=zf, y=zf, z=zf, t=zf, dir_x=zf, dir_y=zf,
                         dir_z=np.ones(n, np.float32), length=zf,
                         beta=np.ones(n, np.float32), num_photons=zi,
                         weight=np.ones(n, np.float32), identifier=zi,
                         source_type=zi)

    def pad_to(self, n: int):
        """Pad (host arrays) with dummy (num_photons=0) steps to exactly n."""
        cur = self.n_steps
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"batch of {cur} does not fit into {n}")
        pad = n - cur

        def _pad(a, fill=0):
            return np.concatenate([np.asarray(a),
                                   np.full((pad,), fill, np.asarray(a).dtype)])

        return StepBatch(
            x=_pad(self.x), y=_pad(self.y), z=_pad(self.z), t=_pad(self.t),
            dir_x=_pad(self.dir_x), dir_y=_pad(self.dir_y), dir_z=_pad(self.dir_z, 1),
            length=_pad(self.length), beta=_pad(self.beta, 1),
            num_photons=_pad(self.num_photons), weight=_pad(self.weight, 1),
            identifier=_pad(self.identifier), source_type=_pad(self.source_type))


class PhotonBatch(NamedTuple):
    """Recorded photons at DOMs (validity-masked), as host numpy arrays:
    hits/photons.records_to_photon_batch builds it from a propagation
    result's records and load_photons_npz from a file.

    Field-for-field the information content of I3CLSimPhoton: hit position is
    stored relative to the hit DOM center with pancaking undone
    (propagation_kernel.c.cl:337-363), direction as (theta, phi)."""
    valid: np.ndarray        # (P,) bool
    pos_x: np.ndarray        # (P,) position relative to DOM center [m]
    pos_y: np.ndarray
    pos_z: np.ndarray
    time: np.ndarray         # (P,) arrival time [ns]
    dir_theta: np.ndarray
    dir_phi: np.ndarray
    wavelength: np.ndarray   # (P,) [nm]
    cherenkov_dist: np.ndarray  # (P,) total path length [m]
    num_scatters: np.ndarray
    weight: np.ndarray
    identifier: np.ndarray
    string_id: np.ndarray
    om_id: np.ndarray
    start_x: np.ndarray      # photon emission point / time / direction
    start_y: np.ndarray
    start_z: np.ndarray
    start_time: np.ndarray
    start_theta: np.ndarray
    start_phi: np.ndarray
    group_velocity: np.ndarray  # [m/ns]
    dist_in_abs_lens: np.ndarray


@dataclasses.dataclass(frozen=True)
class PropagationConfig:
    """Static propagation options, field for field as clsim_tpu.types.

    Mirrors the reference's kernel #define flags and converter options
    (public/clsim/I3CLSimStepToPhotonConverterOpenCL.h:78-255)."""
    n_slots: int = 8192            # parallel photon slots (work items)
    stop_on_detection: bool = True  # STOP_PHOTONS_ON_DETECTION
    save_photons: bool = False      # keep full photon records (parity mode)
    save_all_photons: bool = False  # SAVE_ALL_PHOTONS: record every photon at
                                    # its absorption point (no detector test)
    save_all_prescale: float = 1.0  # SAVE_ALL_PHOTONS_PRESCALE
    photon_capacity_per_slot: int = 8  # record ring size when save_photons
    photon_history_entries: int = 0 # SAVE_PHOTON_HISTORY: keep the last N
                                    # scatter positions per recorded photon
    pancake_factor: float = 1.0     # PANCAKE_FACTOR (DOM oversize flattening)
    dom_oversize: float = 1.0       # collision radius = R * oversize
    max_segment_m: float = 90.0     # segment cap; bounds the per-iteration
                                    # layer/DOM windows
    max_layer_steps: int = 16       # medium layers crossable per segment
    max_dom_layers: int = 8         # DOM z-layers checked per (segment,string)
    strings_per_photon: int = 2     # top-K candidate strings per segment
    collision_mode: str = "culled"  # "culled" | "bruteforce" (oracle/testing)
    estimator: str = "detect"       # "detect": faithful clsim accept/reject;
                                    # "expected": continuous-absorption
                                    # pass-through weights (differentiable)
    hit_compact_capacity: int = 0   # JAX-package scatter tuning; the port
                                    # deposits with index_add_ / atomicAdd
                                    # and ignores it
    fixed_abs_lens: float = 0.0     # >0: PROPAGATE_FOR_FIXED_NUMBER_OF_
                                    # ABSORPTION_LENGTHS (tabulator mode)
    # time histogram
    hist_t_min: float = 0.0         # [ns]
    hist_t_max: float = 6400.0
    hist_n_bins: int = 512
    soft_binning: bool = False      # linear-interp deposition (differentiable)
    # expected-estimator DOM angular acceptance polynomial (static tuple of
    # coefficients in cos(eta)); None disables
    expected_angular_poly: Optional[tuple] = None
    pmt_axis: tuple = (0.0, 0.0, -1.0)
    # detached-sampling gradients of the expected estimator
    detach_trajectories: bool = True
    # score-function correction for detached sampling (expected estimator)
    score_function: bool = False

    @property
    def hist_dt(self) -> float:
        return (self.hist_t_max - self.hist_t_min) / self.hist_n_bins


def tensor_leaves(obj, prefix=()):
    """[(path, tensor)] of every floating-point tensor in a (nested)
    NamedTuple such as MediumProperties, in field order."""
    out = []
    for name, v in obj._asdict().items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            out.append((prefix + (name,), v))
        elif hasattr(v, "_asdict"):
            out.extend(tensor_leaves(v, prefix + (name,)))
    return out
