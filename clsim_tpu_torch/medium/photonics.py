"""Photonics-format ice table parser (PyTorch counterpart of
clsim_tpu.medium.photonics, the reference's
MakeIceCubeMediumPropertiesPhotonics, python/
MakeIceCubeMediumPropertiesPhotonics.py:46-227).  The file format:

  NLAYER <n>
  NWVL <n> <start_nm> <step_nm>
  per layer: LAYER <z0> <z1>, ABS <nwvl coefficients 1/m>,
             SCAT <nwvl effective coefficients 1/m>, COS <nwvl mean cosines>,
             N_GROUP / N_PHASE <nwvl indices>
  (# comments allowed; wavelength grid is bin-centered: start += step/2)

Contract details preserved from the reference:
  * upside-down layers are flipped, layers are sorted by bottom z, uniform
    height and gap-free coverage are enforced
  * the mean scattering cosine must be constant (single HG model)
  * N_GROUP/N_PHASE must be layer-independent
  * geometric scattering length = (1/SCAT) * (1 - <cos>)  (the photonics SCAT
    is the *effective* coefficient b_e)

The (layer, wavelength) coefficient tables are decomposed into the
propagation's separable rank structure

    1/l_sca(l, w) ~ gs(w) * b400[l]                      (rank 1)
    1/l_abs(l, w) ~ pa(w)*a[l] + qa(w) + ra(w)*dt[l]     (mean + rank 2)

by SVD, with the achieved max relative error checked against
`max_rel_error`.  Parsing and decomposition are numpy, as in the JAX
package; the tensors are made at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import functions as F
from .anisotropy import AnisotropyParams
from .properties import MediumProperties, ScatteringAngleDist
from .tilt import disabled_tilt


def _parse_lines(text: str):
    rows = [ln.split() for ln in text.splitlines()
            if ln.strip() and ln.lstrip()[0] != "#"]
    nlayer = [r for r in rows if r[0].upper() == "NLAYER"]
    nwvl = [r for r in rows if r[0].upper() == "NWVL"]
    if len(nlayer) != 1:
        raise ValueError("need exactly one NLAYER entry")
    if len(nwvl) != 1:
        raise ValueError("need exactly one NWVL entry")
    n_layers = int(nlayer[0][1])
    n_wvl = int(nwvl[0][1])
    start_wlen = float(nwvl[0][2]) + float(nwvl[0][3]) / 2.0  # bin centers
    step_wlen = float(nwvl[0][3])
    rows = [r for r in rows if r[0].upper() not in ("NLAYER", "NWVL")]
    if len(rows) != n_layers * 6:
        raise ValueError(f"expected {n_layers * 6} layer lines, "
                         f"got {len(rows)}")
    if rows[0][0].upper() != "LAYER":
        raise ValueError("layer definitions must start with LAYER")

    layers = []
    cur = None
    for r in rows:
        kw = r[0].upper()
        if kw == "LAYER":
            if cur:
                layers.append(cur)
            cur = {}
        elif kw in cur:
            raise ValueError(f"keyword {kw} duplicated within a layer")
        cur[kw] = np.array([float(v) for v in r[1:]], np.float64)
    if cur:
        layers.append(cur)

    # flip upside-down layers, sort by bottom z, enforce uniform gap-free grid
    for lay in layers:
        z0, z1 = lay["LAYER"][:2]
        if z0 > z1:
            lay["LAYER"] = np.array([z1, z0])
    layers.sort(key=lambda l: l["LAYER"][0])
    height = layers[0]["LAYER"][1] - layers[0]["LAYER"][0]
    end_z = None
    for lay in layers:
        z0, z1 = lay["LAYER"][:2]
        if abs((z1 - z0) - height) > 1e-4:
            raise ValueError("differing layer heights")
        if end_z is not None and abs(end_z - z0) > 1e-4:
            raise ValueError(f"layer hole between z={end_z} and z={z0}")
        end_z = z1

    mean_cos = layers[0]["COS"][0]
    for lay in layers:
        for kw in ("COS", "ABS", "SCAT", "N_GROUP", "N_PHASE"):
            if len(lay[kw]) != n_wvl:
                raise ValueError(f"expected {n_wvl} {kw} values")
        if np.abs(lay["COS"] - mean_cos).max() > 1e-4:
            raise ValueError("only a constant mean cosine is supported")
        if np.abs(lay["N_GROUP"] - layers[0]["N_GROUP"]).max() > 1e-4:
            raise ValueError("N_GROUP may not differ between layers")
        if np.abs(lay["N_PHASE"] - layers[0]["N_PHASE"]).max() > 1e-4:
            raise ValueError("N_PHASE may not differ between layers")

    if len(layers) != n_layers:
        raise ValueError("NLAYER does not match the number of LAYER blocks")
    return layers, mean_cos, start_wlen, step_wlen


def _rank_decompose(abs_inv: np.ndarray, scat_inv: np.ndarray
                    ) -> Tuple[dict, float]:
    """Fit the separable rank structure to (L, nw) tables."""
    # scattering: rank 1 (positive by construction)
    u, s, vt = np.linalg.svd(scat_inv, full_matrices=False)
    sign = np.sign(u[:, 0].mean()) or 1.0
    b400 = u[:, 0] * s[0] * sign
    gs = vt[0] * sign
    scat_fit = np.outer(b400, gs)

    # absorption: layer-mean + rank 2
    qa = abs_inv.mean(axis=0)
    res = abs_inv - qa[None, :]
    u, s, vt = np.linalg.svd(res, full_matrices=False)
    a_dust = u[:, 0] * s[0]
    pa = vt[0]
    if len(s) > 1:
        delta_tau = u[:, 1] * s[1]
        ra = vt[1]
    else:
        delta_tau = np.zeros(abs_inv.shape[0])
        ra = np.zeros(abs_inv.shape[1])
    abs_fit = qa[None, :] + np.outer(a_dust, pa) + np.outer(delta_tau, ra)

    rel = max(
        float(np.abs(scat_fit - scat_inv).max() / np.abs(scat_inv).max()),
        float(np.abs(abs_fit - abs_inv).max() / np.abs(abs_inv).max()))
    return dict(b400=b400, gs=gs, qa=qa, a_dust=a_dust, pa=pa,
                delta_tau=delta_tau, ra=ra), rel


def parse_photonics_ice_table(path_or_text: str,
                              density: float = 0.9216,
                              max_rel_error: float = 1e-3,
                              device="cuda") -> MediumProperties:
    """Build a MediumProperties from a photonics-format ice table file (path)
    or its text content."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    layers, mean_cos, w0, dw = _parse_lines(text)
    L = len(layers)
    nw = len(layers[0]["ABS"])

    abs_inv = np.stack([lay["ABS"] for lay in layers])          # (L, nw)
    # photonics SCAT is the effective coefficient; geometric length is
    # (1/b_e)*(1-<cos>)  ->  inverse geometric length = b_e/(1-<cos>)
    scat_inv = np.stack([lay["SCAT"] for lay in layers]) / (1.0 - mean_cos)

    fit, rel = _rank_decompose(abs_inv, scat_inv)
    if rel > max_rel_error:
        raise ValueError(
            f"separable decomposition error {rel:.2e} exceeds "
            f"{max_rel_error:.0e}; this table is not representable by the "
            "rank-separable walk (raise max_rel_error to accept)")

    t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return MediumProperties(
        layers_z_start=t(layers[0]["LAYER"][0]),
        layer_height=t(layers[0]["LAYER"][1] - layers[0]["LAYER"][0]),
        n_layers=L,
        alpha=t(0.0), kappa=t(0.0), abs_A=t(0.0), abs_B=t(0.0),
        abs_D=t(0.0), abs_E=t(0.0),
        b400=t(fit["b400"]),
        a_dust400=t(fit["a_dust"]),
        delta_tau=t(fit["delta_tau"]),
        ref_index=F.RefIndexParams(n=t(F.DEFAULT_ICE_REF_INDEX.n),
                                   g=t(F.DEFAULT_ICE_REF_INDEX.g)),
        # the reference builds a pure HenyeyGreenstein model for photonics
        # tables (MakeIceCubeMediumPropertiesPhotonics.py:197): liu_fraction=0
        scattering=ScatteringAngleDist(mean_cos=t(mean_cos),
                                       liu_fraction=t(0.0)),
        anisotropy=AnisotropyParams(azimuth=t(0.0), mag_along=t(0.0),
                                    mag_perp=t(0.0), enabled=False),
        tilt=disabled_tilt(device),
        density=t(density),
        efficiency=t(1.0),
        min_wlen=float(w0),
        max_wlen=float(w0 + (nw - 1) * dw),
        medium_kind="separable_table",
        water_wlen_first=float(w0),
        water_wlen_step=float(dw),
        fac_gs=t(fit["gs"]), fac_pa=t(fit["pa"]),
        fac_qa=t(fit["qa"]), fac_ra=t(fit["ra"]),
        ref_n_table=t(layers[0]["N_PHASE"]),
        ref_g_table=t(layers[0]["N_GROUP"]),
    )
