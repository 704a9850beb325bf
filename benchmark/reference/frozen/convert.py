"""Carry parameters across from host arrays: mappings of field name -> numpy
array (plus the static fields) become the port's NamedTuples of tensors on
a given device.

A mapping may come from any source; `{k: np.asarray(v) for k, v in
obj._asdict().items()}` of a JAX-package object works, with nested
NamedTuples (the medium's ref_index, scattering, anisotropy and tilt) given
as mappings or NamedTuples of arrays.  The per-layer ice parameters (b400,
a_dust400, delta_tau) are the system's "weights": after conversion both
packages compute the same histograms from them.  Nothing here imports the
JAX package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .geometry import DetectorGeometry
from .medium.anisotropy import AnisotropyParams
from .medium.functions import RefIndexParams
from .medium.properties import MediumProperties, ScatteringAngleDist
from .medium.tilt import TiltParams
from .ops.spectrum import SpectrumTable
from .types import StepBatch

_STATIC_GEO = ("om_radius", "oversize", "max_string_r", "min_layer_height")
_INT_GEO = ("dom_string_id", "dom_om_id", "n_layers", "layer_to_dom")
_INT_STEPS = ("num_photons", "identifier", "source_type")


def numpy_tree(obj):
    """Nested mapping of numpy arrays from a NamedTuple (possibly nested) of
    array-likes; strings, bools, numbers and None pass through."""
    if hasattr(obj, "_asdict"):
        return {k: numpy_tree(v) for k, v in obj._asdict().items()}
    if obj is None or isinstance(obj, (str, bool, int, float)):
        return obj
    return np.asarray(obj)


def _fields(m):
    return m._asdict() if hasattr(m, "_asdict") else dict(m)


def _tensor(v, device, dtype=torch.float32):
    return torch.as_tensor(np.array(v, copy=True), device=device).to(dtype)


def geometry_from_numpy(m: Mapping, device="cuda") -> DetectorGeometry:
    m = _fields(m)
    out = {}
    for f in DetectorGeometry._fields:
        if f in _STATIC_GEO:
            out[f] = float(np.asarray(m[f]))
        else:
            out[f] = _tensor(m[f], device,
                             torch.int32 if f in _INT_GEO else torch.float32)
    return DetectorGeometry(**out)


def spectra_from_numpy(m: Mapping, device="cuda") -> SpectrumTable:
    m = _fields(m)
    return SpectrumTable(**{f: _tensor(m[f], device)
                            for f in SpectrumTable._fields})


def steps_from_numpy(m: Mapping, device="cuda") -> StepBatch:
    """Host step arrays -> tensors (float32; int32 counts, ids and types)."""
    m = _fields(m)
    return StepBatch(**{f: _tensor(m[f], device,
                                   torch.int32 if f in _INT_STEPS
                                   else torch.float32)
                        for f in StepBatch._fields})


# the tabulated media's optional fields (None for the icecube kind)
_MEDIUM_TABLES = ("water_scat_inv", "water_abs_inv", "fac_gs", "fac_pa",
                  "fac_qa", "fac_ra", "ref_n_table", "ref_g_table")


def medium_from_numpy(m: Mapping, device="cuda") -> MediumProperties:
    """Every medium kind ("icecube", "water", "separable_table") and both
    scattering kinds, field for field; a tabulated kind must carry its
    tables."""
    m = _fields(m)
    scat = _fields(m["scattering"])
    t = lambda v: _tensor(v, device)
    opt = lambda v: None if v is None else t(v)
    ref = _fields(m["ref_index"])
    an = _fields(m["anisotropy"])
    tl = _fields(m["tilt"])
    out = MediumProperties(
        layers_z_start=t(m["layers_z_start"]),
        layer_height=t(m["layer_height"]),
        n_layers=int(np.asarray(m["n_layers"])),
        alpha=t(m["alpha"]), kappa=t(m["kappa"]),
        abs_A=t(m["abs_A"]), abs_B=t(m["abs_B"]),
        abs_D=t(m["abs_D"]), abs_E=t(m["abs_E"]),
        b400=t(m["b400"]), a_dust400=t(m["a_dust400"]),
        delta_tau=t(m["delta_tau"]),
        ref_index=RefIndexParams(n=t(ref["n"]), g=t(ref["g"])),
        scattering=ScatteringAngleDist(
            mean_cos=t(scat["mean_cos"]),
            liu_fraction=t(scat["liu_fraction"]),
            kind=str(scat.get("kind", "icecube")),
            table_cos=opt(scat.get("table_cos")),
            table_cdf=opt(scat.get("table_cdf"))),
        anisotropy=AnisotropyParams(
            azimuth=t(an["azimuth"]), mag_along=t(an["mag_along"]),
            mag_perp=t(an["mag_perp"]), enabled=bool(an["enabled"])),
        tilt=TiltParams(
            distances=t(tl["distances"]), first_z=t(tl["first_z"]),
            z_spacing=t(tl["z_spacing"]),
            z_corrections=t(tl["z_corrections"]),
            azimuth_cos=t(tl["azimuth_cos"]),
            azimuth_sin=t(tl["azimuth_sin"]), enabled=bool(tl["enabled"])),
        density=t(m["density"]), efficiency=t(m["efficiency"]),
        min_wlen=float(m.get("min_wlen", 265.0)),
        max_wlen=float(m.get("max_wlen", 675.0)),
        medium_kind=str(m.get("medium_kind", "icecube")),
        water_wlen_first=float(m.get("water_wlen_first", 290.0)),
        water_wlen_step=float(m.get("water_wlen_step", 10.0)),
        **{f: opt(m.get(f)) for f in _MEDIUM_TABLES})
    reason = out.missing_tables()
    if reason:
        raise ValueError(f"medium cannot be carried across: {reason}")
    return out
