"""Photon -> MCPE (photoelectron hit) conversion.

PyTorch counterpart of clsim_tpu.hits.mcpe, the equivalent of
I3PhotonToMCPEConverter (private/clsim/dom/I3PhotonToMCPEConverter.cxx:
330-510):

  hitProbability = photon.weight
                 * wavelengthAcceptance(lambda)
                 * angularAcceptance(cos eta)          (eta vs the PMT axis,
                                                        IceCube: straight down)
                 * relative DOM efficiency (calibration)

then accept if hitProbability > U (Bernoulli), MCPE time = photon arrival.
Because the wavelength bias pre-applied the lambda-dependent QE during
sampling, weights stay O(1) (the importance-sampling contract of
SURVEY.md section 2.5).

The Bernoulli draw comes from an explicit torch.Generator, or from
`uniforms` of the probabilities' shape (so a test can hand in the draw the
JAX package makes).  expected_mcpe_factor is the differentiable path's
factor: the spectrum-averaged wavelength acceptance that scales an
expected-estimator histogram to photoelectrons.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..medium.functions import TableParams, eval_table
from .acceptance import angular_factor
from .photons import _ring_mask


class MCPEBatch(NamedTuple):
    """Accepted photoelectrons (validity-masked fixed capacity)."""
    valid: torch.Tensor       # (P,) bool
    dom: torch.Tensor         # (P,) int64 flat DOM index
    time: torch.Tensor        # (P,) [ns]
    identifier: torch.Tensor  # (P,) int32 source identifier (particle ref)


def hit_probability(weight, wavelength, cos_impact,
                    wlen_acceptance: TableParams, angular_coeffs,
                    efficiency=1.0):
    """The product formula of I3PhotonToMCPEConverter.cxx:466-475.
    `angular_coeffs` is a polynomial coefficient array (IceCube hole ice)
    or an acceptance.AngularSensitivity with its cutoff (Antares,
    GetAntaresOMAngularSensitivity.py)."""
    p = weight * eval_table(wlen_acceptance, wavelength)
    p = p * angular_factor(angular_coeffs, cos_impact)
    return p * efficiency


def expected_mcpe_factor(wlen_acceptance: TableParams, spectrum_x,
                         spectrum_pdf):
    """Spectrum-averaged wavelength acceptance, for scaling per-DOM time
    histograms of the differentiable path (the per-photon wavelengths are
    already marginalized into the histogram).  The angular factor is folded
    in at propagation time through cfg.expected_angular_poly, not here."""
    x = torch.as_tensor(spectrum_x, dtype=torch.float32)
    pdf = torch.as_tensor(spectrum_pdf, dtype=torch.float32, device=x.device)
    acc = eval_table(wlen_acceptance, x.to(wlen_acceptance.values.device))
    w = pdf.to(acc.device) / pdf.sum()
    return (acc * w).sum()


def _accept(p, dom, valid, dom_efficiency, generator, uniforms):
    if dom_efficiency is not None:
        p = p * torch.as_tensor(dom_efficiency, dtype=torch.float32,
                                device=p.device)[dom]
    if uniforms is None:
        u = torch.rand(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32)
    else:
        if not isinstance(uniforms, torch.Tensor):
            uniforms = torch.from_numpy(np.array(uniforms, np.float32))
        u = uniforms.to(device=p.device, dtype=torch.float32)
        if tuple(u.shape) != tuple(p.shape):
            raise ValueError(f"uniforms must have shape {tuple(p.shape)}")
    return valid & (p > u)


def cos_impact(theta, phi, pmt_axis=(0.0, 0.0, -1.0)):
    """cos(eta) of photon directions (theta, phi) against the PMT axis."""
    ax, ay, az = pmt_axis
    dx = torch.sin(theta) * torch.cos(phi)
    dy = torch.sin(theta) * torch.sin(phi)
    dz = torch.cos(theta)
    return -(dx * ax + dy * ay + dz * az)


def sample_mcpes(rec: dict, rec_count,
                 generator: Optional[torch.Generator],
                 wlen_acceptance: TableParams, angular_coeffs,
                 efficiency=1.0, pmt_axis=(0.0, 0.0, -1.0),
                 dom_efficiency=None, uniforms=None) -> MCPEBatch:
    """Accept/reject photon records into MCPEs.

    `rec`/`rec_count` are either record contract (rings or flat; see
    hits/photons.py); the result is flattened over slots x capacity.
    cos(impact) is computed from the photon direction against the PMT axis
    only, matching the reference's standard path (position unused when
    pancaked, …cxx:410-445).  `efficiency` is the global scale;
    `dom_efficiency` an optional per-DOM calibration vector (n_doms,) (the
    RDE x SPE-compensation factor, I3PhotonToMCPEConverter.cxx:340-387).
    The draw comes from `generator` unless `uniforms` (of the flattened
    records' shape) is given."""
    cap = rec["time"].shape[1]
    flat = {k: v.reshape(-1) for k, v in rec.items()}
    valid = _ring_mask(rec_count, cap, flat["time"].device).reshape(-1)
    cos_eta = cos_impact(flat["dir_theta"], flat["dir_phi"], pmt_axis)
    dom = flat["dom"].to(torch.int64)
    p = hit_probability(flat["weight"], flat["wavelength"], cos_eta,
                        wlen_acceptance, angular_coeffs, efficiency)
    accept = _accept(p, dom, valid, dom_efficiency, generator, uniforms)
    return MCPEBatch(valid=accept, dom=dom, time=flat["time"],
                     identifier=flat["identifier"].to(torch.int32))


def sample_mcpes_from_batch(batch, dom_index,
                            generator: Optional[torch.Generator],
                            wlen_acceptance: TableParams, angular_coeffs,
                            efficiency=1.0, pmt_axis=(0.0, 0.0, -1.0),
                            dom_efficiency=None, uniforms=None) -> MCPEBatch:
    """Accept/reject a (possibly file-loaded) PhotonBatch into MCPEs: the
    I3CLSimMakeHitsFromPhotons half of the two-phase flow.  `dom_index` is
    the flat DOM index per photon (hits/photons.photon_batch_dom_index).
    The photons go to the acceptance table's device."""
    dev = wlen_acceptance.values.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cos_eta = cos_impact(t(batch.dir_theta), t(batch.dir_phi), pmt_axis)
    p = hit_probability(t(batch.weight), t(batch.wavelength), cos_eta,
                        wlen_acceptance, angular_coeffs, efficiency)
    dom = torch.as_tensor(np.asarray(dom_index, np.int64), device=dev)
    valid = torch.as_tensor(np.asarray(batch.valid, bool), device=dev)
    accept = _accept(p, dom, valid, dom_efficiency, generator, uniforms)
    return MCPEBatch(valid=accept, dom=dom, time=t(batch.time),
                     identifier=torch.as_tensor(
                         np.asarray(batch.identifier, np.int32), device=dev))


def merge_mcpes(dom, time, ident, window_ns: float):
    """Merge MCPEs on the same DOM closer than `window_ns` into one entry
    with summed npe, keeping the earliest time (the reference's optional
    hit time-merging, I3PhotonToMCPEConverter.cxx:520+).

    Inputs are host numpy arrays sorted however; returns
    (dom, time, npe, ident) sorted by (dom, time).  The merged entry keeps
    the first contributing photon's identifier."""
    dom = np.asarray(dom)
    time = np.asarray(time)
    ident = np.asarray(ident)
    order = np.lexsort((time, dom))
    dom, time, ident = dom[order], time[order], ident[order]
    if len(dom) == 0:
        return dom, time, np.zeros(0, np.int32), ident
    # a new group starts when the DOM changes or the gap exceeds the window
    # (gap measured to the previous hit, matching the reference's sequential
    # coalescing of time-sorted hits)
    new_group = np.ones(len(dom), bool)
    new_group[1:] = (dom[1:] != dom[:-1]) | \
        ((time[1:] - time[:-1]) > window_ns)
    gid = np.cumsum(new_group) - 1
    n_groups = gid[-1] + 1
    npe = np.bincount(gid, minlength=n_groups).astype(np.int32)
    first = np.nonzero(new_group)[0]
    return dom[first], time[first], npe, ident[first]


def mcpes_to_numpy(m: MCPEBatch):
    """Compact the accepted hits to host numpy arrays sorted by time (the
    reference sorts MCPE series by time, I3PhotonToMCPEConverter.cxx:520):
    (dom int32, time float32, identifier int32)."""
    valid = m.valid.detach().cpu().numpy()
    dom = m.dom.detach().cpu().numpy()[valid].astype(np.int32)
    time = m.time.detach().cpu().numpy()[valid]
    ident = m.identifier.detach().cpu().numpy()[valid]
    order = np.argsort(time, kind="stable")
    return dom[order], time[order], ident[order]


def check_photon_positions(rec, rec_count, collision_radius: float,
                           pancake_factor: float, tolerance_m: float = 0.03,
                           only_warn: bool = True):
    """Spherical-DOM sanity check (I3PhotonToMCPEConverter.cxx:415-455):
    with pancake_factor == 1 every recorded photon must sit ON the
    (oversized) DOM sphere within 3 cm; flattened pancake DOMs skip the
    check.  Record positions are DOM-relative, so the distance is simply
    |pos|.  Returns the number of off-sphere photons; warns (or raises,
    matching the reference's log_fatal default) when nonzero."""
    if pancake_factor != 1.0:
        return 0
    cap = rec["time"].shape[1]
    valid = _ring_mask(rec_count, cap, rec["time"].device)
    px, py, pz = (rec[k][valid].double() for k in ("pos_x", "pos_y",
                                                    "pos_z"))
    dev = torch.abs(torch.sqrt(px * px + py * py + pz * pz)
                    - collision_radius)
    bad = int((dev > tolerance_m).sum())
    if bad:
        msg = (f"{bad} recorded photons are not on the DOM sphere "
               f"(radius {collision_radius:.4f} m +- {tolerance_m} m); "
               f"worst |dist-R| = {float(dev.max()):.4f} m")
        if only_warn:
            import warnings
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        else:
            raise RuntimeError(msg)
    return bad
