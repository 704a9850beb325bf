"""Parser for PPC-format ice-model directories (PyTorch counterpart of
clsim_tpu.medium.ice_parser).

File contract (reference python/MakeIceCubeMediumProperties.py:69-163):
  * icemodel.dat -- per-layer rows: depth[m], b_e400 (effective scattering
    coefficient), a_dust400, delta_tau.  Rows are top-to-bottom in depth
    (i.e. ascending depth) and get flipped to ascending z.
  * icemodel.par -- 6 rows (alpha, kappa, A, B, D, E) or 4 rows
    (alpha, kappa, A, B; then D = 400^kappa, E = 0).
  * cfg.txt     -- oversize scaling, efficiency correction, Liu scattering
    fraction, <cos theta>; optionally anisotropy azimuth [deg], magnitude
    along tilt, magnitude along flow.
  * tilt.par / tilt.dat -- optional layer-tilt maps.

Conventions reproduced exactly:
  * b_400 = b_e400 / (1 - <cos theta>)  (effective -> geometric)
  * the specified depths are the *middle* of each layer (PPC convention); the
    layer grid is shifted by height/2 accordingly
  * z = detector_center_depth - depth

The files are read on the host (numpy, float64); the parameters are
carried across to float32 tensors on `device` by convert.medium_from_numpy.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..constants import DETECTOR_CENTER_DEPTH
from . import functions as F
from .tilt import disabled_tilt, load_tilt


class IceModelExtras(NamedTuple):
    oversize_scaling: float
    efficiency: float
    has_anisotropy: bool


def parse_ppc_ice_model(ice_dir: str,
                        detector_center_depth: float = DETECTOR_CENTER_DEPTH,
                        use_tilt_if_available: bool = True,
                        device="cuda"):
    """Parse a PPC ice-model directory into (MediumProperties, IceModelExtras)."""
    from ..convert import medium_from_numpy, numpy_tree
    dat = np.loadtxt(os.path.join(ice_dir, "icemodel.dat"), unpack=True)
    par = np.loadtxt(os.path.join(ice_dir, "icemodel.par"))
    cfg = np.loadtxt(os.path.join(ice_dir, "cfg.txt"))

    if len(par) == 6:
        alpha, kappa, A, B, D, E = (par[i][0] for i in range(6))
    elif len(par) == 4:
        alpha, kappa, A, B = (par[i][0] for i in range(4))
        D = 400.0 ** kappa
        E = 0.0
    else:
        raise ValueError(f"{ice_dir}/icemodel.par needs 4 or 6 rows, has {len(par)}")

    if len(cfg) < 4:
        raise ValueError(f"{ice_dir}/cfg.txt needs at least 4 values")
    oversize_scaling = float(cfg[0])
    efficiency = float(cfg[1])
    liu_fraction = float(cfg[2])
    mean_cos = float(cfg[3])
    if not (0.0 <= liu_fraction <= 1.0):
        raise ValueError(f"invalid Liu scattering fraction {liu_fraction}")
    if not (-1.0 <= mean_cos <= 1.0):
        raise ValueError(f"invalid <cos theta> {mean_cos}")

    has_anisotropy = len(cfg) > 4
    if has_anisotropy and len(cfg) < 7:
        raise ValueError(f"{ice_dir}/cfg.txt has anisotropy but needs >= 7 values")
    if has_anisotropy:
        aniso = dict(azimuth=np.deg2rad(float(cfg[4])),
                     mag_along=float(cfg[5]), mag_perp=float(cfg[6]),
                     enabled=True)
    else:
        aniso = dict(azimuth=0.0, mag_along=0.0, mag_perp=0.0, enabled=False)

    depth, b_e400, a_dust400, delta_tau = dat[0], dat[1], dat[2], dat[3]
    if len(depth) < 2:
        raise ValueError("need at least two ice layers")
    layer_height = depth[1] - depth[0]
    if layer_height <= 0:
        raise ValueError("ice layer depths must be ascending")
    if not np.allclose(np.diff(depth), layer_height, atol=1e-5):
        raise ValueError("ice layers are not evenly spaced")

    # top-to-bottom (ascending depth) -> bottom-to-top (ascending z)
    depth = depth[::-1].copy()
    b_e400 = b_e400[::-1].copy()
    a_dust400 = a_dust400[::-1].copy()
    delta_tau = delta_tau[::-1].copy()

    b_400 = b_e400 / (1.0 - mean_cos)

    # PPC mid-layer depth convention -> depth of the top of each layer
    depth_top = depth - layer_height / 2.0
    depth_bottom = depth_top + layer_height
    layer_z_start = detector_center_depth - depth_bottom  # ascending

    tilt = disabled_tilt("cpu")
    if use_tilt_if_available:
        tp = os.path.join(ice_dir, "tilt.par")
        td = os.path.join(ice_dir, "tilt.dat")
        has_par, has_dat = os.path.isfile(tp), os.path.isfile(td)
        if has_par != has_dat:
            raise ValueError("ice model dir has only one of tilt.par/tilt.dat")
        if has_par:
            tilt = load_tilt(tp, td, detector_center_depth, device="cpu")

    medium = medium_from_numpy(dict(
        layers_z_start=layer_z_start[0],
        layer_height=layer_height,
        n_layers=len(depth),
        alpha=alpha, kappa=kappa,
        abs_A=A, abs_B=B, abs_D=D, abs_E=E,
        b400=b_400, a_dust400=a_dust400, delta_tau=delta_tau,
        ref_index=F.DEFAULT_ICE_REF_INDEX,
        scattering=dict(mean_cos=mean_cos, liu_fraction=liu_fraction),
        anisotropy=aniso,
        tilt=numpy_tree(tilt),
        density=0.9216,
        efficiency=efficiency,
    ), device=device)
    return medium, IceModelExtras(oversize_scaling, efficiency, has_anisotropy)
