"""The peaks of the card and the least work kernel K1 (the propagation
kernel) has to do for a cell's inputs.

Counted only from the inputs, never from the kernel's own counters, so a
kernel that does less of its own bookkeeping cannot shrink its bound:

  bytes       each input byte read once per launched slot batch (the
              batch's steps, the medium's layer tables, the DOM positions,
              the stacked spectra) and each output byte written once (the
              batch's histogram and its counters);
  operations  photons x (1 + expected scatters) x OPS_SEGMENT, with the
              expected scatters a lower bound worked out from the ice.

Both are lower bounds, so the share of the roofline cannot pass 100%.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet (700 W): float32 outside the tensor cores,
# and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# float32 operations a propagated segment needs at the least (a
# transcendental counted as one):
#   scattering budget -log(u)                                2
#   budgets to metres in the current layer                   2
#   advance x, y, z, t (four FMAs)                           8
#   absorption budget left                                   2
#   sphere test against one DOM (offset, dot, discriminant) 10
#   scattering angle (the Liu / HG mixture)                  4
#   rotate the direction by the angle and an azimuth,
#   and renormalise                                         18
OPS_SEGMENT = 46

STEP_FIELDS = 13          # StepBatch: 13 four-byte fields a slot
N_COUNTERS = 22           # the kernel's counter vector (float64)
STOPPED_SHARE = 0.9       # photons that a detection stops early are at most
                          # a few per thousand; count 90% of the rest


def _inv_lengths(conf: dict, wl):
    """(1/l_sca, 1/l_abs) per layer (rows) and wavelength (columns) from
    the configuration's ice with the frozen medium's default coefficients
    (medium/properties.make_homogeneous_ice)."""
    from benchmark.world import REFERENCE, make_medium
    med = make_medium(REFERENCE, conf["ice"], "cpu")
    f = lambda t: float(t)
    b400 = med.b400.numpy()[:, None].astype(np.float64)
    adust = med.a_dust400.numpy()[:, None].astype(np.float64)
    dtau = med.delta_tau.numpy()[:, None].astype(np.float64)
    inv_s = b400 * (wl / 400.0) ** (-f(med.alpha))
    inv_a = ((f(med.abs_D) * adust + f(med.abs_E)) * wl ** (-f(med.kappa))
             + f(med.abs_A) * np.exp(-f(med.abs_B) / wl)
             * (1.0 + 0.01 * dtau))
    return inv_s, inv_a, med


def _min_abs_scaling(med) -> float:
    """The smallest directional absorption-length scale of the ice's
    anisotropy over a grid of directions (1 without anisotropy)."""
    an = med.anisotropy
    if not an.enabled:
        return 1.0
    k1, k2 = np.exp(float(an.mag_along)), np.exp(float(an.mag_perp))
    kz = 1.0 / (k1 * k2)
    l1, l2, l3 = k1 * k1, k2 * k2, kz * kz
    c = np.linspace(-1.0, 1.0, 101)[:, None]
    p = np.linspace(0.0, 2.0 * np.pi, 181)[None, :]
    s = np.sqrt(1.0 - c * c)
    n1, n2, n3 = s * np.cos(p), s * np.sin(p), c * np.ones_like(p)
    B2 = 1.0 / l1 + 1.0 / l2 + 1.0 / l3
    nB = n1 * n1 / l1 + n2 * n2 / l2 + n3 * n3 / l3
    An = n1 * n1 * l1 + n2 * n2 * l2 + n3 * n3 * l3
    return float((2.0 / ((B2 - nB) * An)).min())


def scatters_lower_bound(conf: dict, spectra) -> float:
    """A lower bound on the scatters a photon undergoes before absorption:
    its absorption budget is Exp(1) absorption lengths (mean 1), and each
    absorption length holds at least l_abs / l_sca scatters of the layer
    that minimises it.  Averaged over each spectrum's density, the least
    over the spectra, times the smallest anisotropy scale, times
    STOPPED_SHARE."""
    best = np.inf
    for x, beta in spectra:
        wl = np.asarray(x, np.float64)
        dens = np.asarray(beta, np.float64)
        inv_s, inv_a, med = _inv_lengths(conf, wl)
        ratio = (inv_s / inv_a).min(axis=0)
        mean = np.trapezoid(dens * ratio, wl) / np.trapezoid(dens, wl)
        best = min(best, float(mean))
    return best * _min_abs_scaling(med) * STOPPED_SHARE


def k1_work(conf: dict, world, photons: float, batches: int):
    """(operations, bytes, which bound) of K1 over `photons` photons in
    `batches` launched slot batches of the world's configuration."""
    cfg = world.config
    geo = world.geometry
    sp = world.spectra
    scat = scatters_lower_bound(conf, [
        (sp.x[i].cpu().numpy(), sp.beta[i].cpu().numpy())
        for i in range(sp.x.shape[0])])
    ops = photons * (1.0 + scat) * OPS_SEGMENT
    n_layers = conf["ice"]["n_layers"]
    per_batch = (cfg.n_slots * STEP_FIELDS * 4          # the step batch
                 + n_layers * 3 * 4                     # b400, a_dust, dtau
                 + int(geo.n_doms) * 3 * 4              # DOM positions
                 + int(sp.x.numel()) * 3 * 4            # x, acu, beta
                 + int(geo.n_doms) * cfg.hist_n_bins * 4  # histogram out
                 + N_COUNTERS * 8)
    nbytes = float(batches) * per_batch
    by = ("operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_HBM_BYTES
          else "bytes")
    return ops, nbytes, by


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)
