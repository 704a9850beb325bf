"""Independent float64 numpy oracle of the clsim propagation contract.

This is a deliberately direct, slow, float64 re-statement of the reference
device kernel's semantics (resources/kernels/propagation_kernel.c.cl:406-913
and sparse_collision_kernel.c.cl), written WITHOUT reference to the JAX
engine's vectorization tricks:

  * the layer walk is an unbounded data-dependent loop (no max_segment cap,
    no fixed trip count) exactly like the reference's while-loop
    (propagation_kernel.c.cl:646-676),
  * collision is an exact brute-force sphere test against every DOM with the
    pancake factor and entry-distance semantics of
    sparse_collision_kernel.c.cl:109-158,
  * every photon is an independent row; there is no slot machinery.

This is the PyTorch port's copy of clsim_tpu.validate.oracle.  It reads the
port's containers (tensors on any device, or numpy arrays) and copies every
field to float64 numpy on the host first.  Because it shares no code with
clsim_tpu_torch.propagate (it imports numpy and torch only), statistical
agreement between this oracle and the engine/CUDA kernel is evidence about
the *physics contract*, not about shared bugs --
the role the reference fills with its compareToPPC golden tests
(SURVEY.md section 4.3).  The engine's max_segment_m truncation claims to be
statistically exact (memoryless exponentials); the oracle, having no cap,
tests precisely that claim.

Everything here is pure numpy float64; uniforms come from a caller-provided
numpy Generator.  Scale: ~1e6 photons in tens of seconds (vectorized over
photons, python loops only over scatter generations and layer crossings).
"""

from __future__ import annotations

import numpy as np
import torch

C_LIGHT = 0.299792458  # m/ns, constants.py / I3Constants::c


def _f64(a):
    """float64 host copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


# ---------------------------------------------------------------------------
# spectrum sampling (I3CLSimRandomValueInterpolatedDistribution.cxx:84-177)
# ---------------------------------------------------------------------------

def oracle_build_cdf(x, y):
    """Trapezoid CDF of a piecewise-linear pdf (float64)."""
    x = _f64(x)
    y = _f64(y)
    seg = (x[1:] - x[:-1]) * (y[1:] + y[:-1]) / 2.0
    acu = np.concatenate([[0.0], np.cumsum(seg)])
    return x, acu / acu[-1], y / acu[-1]


def oracle_sample_wavelength(x, acu, beta, u):
    """Inverse-CDF with the in-segment quadratic solve."""
    k = np.clip(np.searchsorted(acu, u, side="right") - 1, 0, len(x) - 2)
    x0, x1 = x[k], x[k + 1]
    b0, b1 = beta[k], beta[k + 1]
    dy = u - acu[k]
    slope = (b1 - b0) / (x1 - x0)
    out = np.empty_like(u, np.float64)
    s0 = np.abs(slope) < 1e-20
    b_0 = np.abs(b0) < 1e-20
    both = s0 & b_0
    lin = b_0 & ~s0
    const = s0 & ~b_0
    full = ~s0 & ~b_0
    out[both] = x0[both]
    out[lin] = x0[lin] + np.sqrt(np.maximum(2.0 * dy[lin] / slope[lin], 0.0))
    out[const] = x0[const] + dy[const] / b0[const]
    f = full
    out[f] = x0[f] + (np.sqrt(np.maximum(
        dy[f] * 2.0 * slope[f] / (b0[f] * b0[f]) + 1.0, 0.0)) - 1.0) \
        * b0[f] / slope[f]
    return out


# ---------------------------------------------------------------------------
# medium property formulas (float64 restatements of SURVEY section 2.5)
# ---------------------------------------------------------------------------

def _poly4(c, x):
    c = [float(v) for v in _f64(c)]
    return c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))


class OracleMedium:
    """Float64 snapshot of a MediumProperties (icecube kind)."""

    def __init__(self, medium):
        g = _f64
        self.z_start = float(medium.layers_z_start)
        self.h = float(medium.layer_height)
        self.L = int(medium.n_layers)
        self.alpha = float(medium.alpha)
        self.kappa = float(medium.kappa)
        self.A = float(medium.abs_A)
        self.B = float(medium.abs_B)
        self.D = float(medium.abs_D)
        self.E = float(medium.abs_E)
        self.b400 = g(medium.b400)
        self.adust = g(medium.a_dust400)
        self.dtau = g(medium.delta_tau)
        self.n_coeffs = g(medium.ref_index.n)
        self.g_coeffs = g(medium.ref_index.g)
        self.mean_cos = float(medium.scattering.mean_cos)
        self.liu_frac = float(medium.scattering.liu_fraction)
        an = medium.anisotropy
        self.aniso = bool(an.enabled)
        if self.aniso:
            self.an_ca = float(np.cos(g(an.azimuth)))
            self.an_sa = float(np.sin(g(an.azimuth)))
            self.k1 = float(np.exp(g(an.mag_along)))
            self.k2 = float(np.exp(g(an.mag_perp)))
            self.kz = 1.0 / (self.k1 * self.k2)
        tl = medium.tilt
        self.tilt = bool(tl.enabled)
        if self.tilt:
            self.tilt_dist = g(tl.distances)
            self.tilt_z0 = float(tl.first_z)
            self.tilt_dz = float(tl.z_spacing)
            self.tilt_zc = g(tl.z_corrections)
            self.tilt_ca = float(tl.azimuth_cos)
            self.tilt_sa = float(tl.azimuth_sin)

    def phase_index(self, wlen):
        return _poly4(self.n_coeffs, wlen * 1e-3)

    def group_index(self, wlen):
        x = wlen * 1e-3
        return _poly4(self.n_coeffs, x) * _poly4(self.g_coeffs, x)

    def inv_scat(self, layer, wlen):
        """1/l_sca = b400[layer] * (wlen/400)^-alpha (ScatLenIceCube.cxx:53)."""
        return self.b400[layer] * (wlen / 400.0) ** (-self.alpha)

    def inv_abs(self, layer, wlen):
        """(D*aDust400+E)*wlen^-kappa + A e^(-B/wlen) (1 + 0.01 dtau)
        (AbsLenIceCube.cxx:63-67)."""
        xk = wlen ** (-self.kappa)
        ebx = self.A * np.exp(-self.B / wlen)
        return (self.D * self.adust[layer] + self.E) * xk \
            + ebx * (1.0 + 0.01 * self.dtau[layer])

    def tilt_shift(self, x, y, z):
        """Bilinear tilt interpolation (IceTiltZShift.cxx:145-285)."""
        if not self.tilt:
            return np.zeros_like(z)
        nz = self.tilt_zc.shape[1]
        zr = (z - self.tilt_z0) / self.tilt_dz
        k = np.clip(np.floor(zr).astype(np.int64), 0, nz - 2)
        fz_above = zr - k
        fz_below = 1.0 - fz_above
        nr = self.tilt_ca * x + self.tilt_sa * y
        nd = len(self.tilt_dist)
        j = np.clip(np.searchsorted(self.tilt_dist, nr, side="right"),
                    1, nd - 1)
        d_lo = self.tilt_dist[j - 1]
        d_hi = self.tilt_dist[j]
        frac_lo = (d_hi - nr) / (d_hi - d_lo)
        val_lo = self.tilt_zc[j - 1, k + 1] * fz_above \
            + self.tilt_zc[j - 1, k] * fz_below
        val_hi = self.tilt_zc[j, k + 1] * fz_above \
            + self.tilt_zc[j, k] * fz_below
        return val_hi * (1.0 - frac_lo) + val_lo * frac_lo

    def abs_corr(self, dx, dy, dz):
        """Directional absorption scaling (AnisotropyAbsLenScaling.cxx:63-90)."""
        if not self.aniso:
            return np.ones_like(dx)
        l1, l2, l3 = self.k1 ** 2, self.k2 ** 2, self.kz ** 2
        n1 = self.an_ca * dx + self.an_sa * dy
        n2 = -self.an_sa * dx + self.an_ca * dy
        s1, s2, s3 = n1 * n1, n2 * n2, dz * dz
        B2 = 1.0 / l1 + 1.0 / l2 + 1.0 / l3
        nB = s1 / l1 + s2 / l2 + s3 / l3
        An = s1 * l1 + s2 * l2 + s3 * l3
        return 2.0 / ((B2 - nB) * An)

    def pre_scatter(self, dx, dy, dz):
        """dir' ~ T' A T dir, A = diag(k1, k2, kz), renormalized
        (VectorTransformMatrix.cxx via GetSpiceLeaAnisotropyTransforms.py)."""
        if not self.aniso:
            return dx, dy, dz
        return self._diag(dx, dy, dz, self.k1, self.k2, self.kz)

    def post_scatter(self, dx, dy, dz):
        if not self.aniso:
            return dx, dy, dz
        return self._diag(dx, dy, dz, 1.0 / self.k1, 1.0 / self.k2,
                          1.0 / self.kz)

    def _diag(self, dx, dy, dz, d1, d2, d3):
        n1 = (self.an_ca * dx + self.an_sa * dy) * d1
        n2 = (-self.an_sa * dx + self.an_ca * dy) * d2
        n3 = dz * d3
        ox = self.an_ca * n1 - self.an_sa * n2
        oy = self.an_sa * n1 + self.an_ca * n2
        inv = 1.0 / np.sqrt(ox * ox + oy * oy + n3 * n3)
        return ox * inv, oy * inv, n3 * inv


# ---------------------------------------------------------------------------
# direction rotation (scatterDirectionByAngle, propagation_kernel.c.cl:83-129)
# ---------------------------------------------------------------------------

def rotate_by_angle(cosa, sina, dx, dy, dz, u_azimuth):
    b = 2.0 * np.pi * u_azimuth
    cosb, sinb = np.cos(b), np.sin(b)
    sinth = np.sqrt(np.maximum(1.0 - dz * dz, 0.0))
    safe = np.maximum(sinth, 1e-20)
    gx = dx * cosa - (dy * cosb + dz * dx * sinb) * sina / safe
    gy = dy * cosa + (dx * cosb - dz * dy * sinb) * sina / safe
    gz = dz * cosa + sina * sinb * sinth
    vx = sina * cosb
    vy = sina * sinb
    vz = cosa * np.sign(dz)
    vertical = sinth <= 0.0
    nx = np.where(vertical, vx, gx)
    ny = np.where(vertical, vy, gy)
    nz = np.where(vertical, vz, gz)
    inv = 1.0 / np.sqrt(nx * nx + ny * ny + nz * nz)
    return nx * inv, ny * inv, nz * inv


def _scatter_cos(m: OracleMedium, u_sel, u_samp):
    """Mixed simplified-Liu / HG (MakeIceCubeMediumProperties.py:183-187)."""
    g = m.mean_cos
    beta = (1.0 - g) / (1.0 + g)
    liu = np.clip(2.0 * u_samp ** beta - 1.0, -1.0, 1.0)
    if abs(g) < 1e-6:
        hg = 2.0 * u_samp - 1.0
    else:
        s = 2.0 * u_samp - 1.0
        frac = (1.0 - g * g) / (1.0 + g * s)
        hg = np.clip((1.0 + g * g - frac * frac) / (2.0 * g), -1.0, 1.0)
    return np.where(u_sel < m.liu_frac, liu, hg)


# ---------------------------------------------------------------------------
# unbounded layer walk (propagation_kernel.c.cl:646-676 semantics)
# ---------------------------------------------------------------------------

def oracle_walk(m: OracleMedium, x, y, z, dz_dir, wlen, sca_budget,
                abs_budget):
    """Convert (scattering, absorption) budgets to meters through the layered
    medium along a ray with vertical component dz_dir, starting at (x, y, z).

    Returns (d_scat, d_abs, abs_left_fn) where abs_left_fn(d) gives the
    remaining (corrected) absorption budget after travelling d <= d_abs.
    The loop is unbounded: it walks layer boundaries until both budgets
    convert, with the outermost layers extended to infinity."""
    z_eff = z - m.tilt_shift(x, y, z)
    j = np.clip(np.floor((z_eff - m.z_start) / m.h).astype(np.int64),
                0, m.L - 1)
    going_up = dz_dir >= 0.0
    vertical = np.abs(dz_dir) < 1e-5

    n = len(np.atleast_1d(z))
    d_scat = np.zeros(n)
    d_abs = np.zeros(n)
    t_done = np.zeros(n)
    tau_s = sca_budget.copy()
    tau_a = abs_budget.copy()
    done_s = np.zeros(n, bool)
    done_a = np.zeros(n, bool)

    boundary = m.z_start + j * m.h + np.where(going_up, m.h, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_bound = np.where(vertical, np.inf, (boundary - z_eff) / dz_dir)
    t_bound = np.where(t_bound < 0.0, np.inf, t_bound)
    t_step = np.where(vertical, np.inf, m.h / np.maximum(np.abs(dz_dir),
                                                         1e-300))

    while True:
        inv_s = m.inv_scat(j, wlen)
        inv_a = m.inv_abs(j, wlen)
        cand_s = t_done + tau_s / inv_s
        cand_a = t_done + tau_a / inv_a
        at_edge = np.where(going_up, j >= m.L - 1, j <= 0)
        fin_s = ~done_s & (at_edge | (cand_s <= t_bound))
        fin_a = ~done_a & (at_edge | (cand_a <= t_bound))
        d_scat = np.where(fin_s, cand_s, d_scat)
        d_abs = np.where(fin_a, cand_a, d_abs)
        done_s |= fin_s
        done_a |= fin_a
        if (done_s & done_a).all():
            break
        cross = ~(done_s & done_a)
        dt = t_bound - t_done
        tau_s = np.where(cross & ~done_s, tau_s - dt * inv_s, tau_s)
        tau_a = np.where(cross & ~done_a, tau_a - dt * inv_a, tau_a)
        t_done = np.where(cross, t_bound, t_done)
        t_bound = np.where(cross, t_bound + t_step, t_bound)
        j = np.where(cross, j + np.where(going_up, 1, -1), j)
        j = np.clip(j, 0, m.L - 1)
    return d_scat, d_abs


# ---------------------------------------------------------------------------
# the oracle propagation loop
# ---------------------------------------------------------------------------

def oracle_propagate(steps, medium, geo, spectrum_xy, bias_xy, cfg, rng,
                     photons_per_step=1, collect_weights=False):
    """Propagate `photons_per_step` photons per step row; returns
    (hist[n_doms, n_bins], n_hits, weight_sum).

    steps: StepBatch (tensors or numpy); medium: MediumProperties (icecube);
    geo: DetectorGeometry; spectrum_xy = (wlen_nm, density) of the biased
    emission spectrum; bias_xy = (bias_x, bias_y) for the weight unfolding;
    cfg: PropagationConfig (hist binning, pancake, stop_on_detection).
    """
    m = OracleMedium(medium)
    # one spectrum (x, density) or a list indexed by step.source_type (the
    # generateWavelength(sourceType) dispatch of
    # propagation_kernel.c.cl:153-183; flasher sources keep the step
    # direction instead of the Cherenkov cone, createPhotonFromTrack
    # :132-184)
    if isinstance(spectrum_xy[0], (list, tuple)):
        cdfs = [oracle_build_cdf(*sxy) for sxy in spectrum_xy]
    else:
        cdfs = [oracle_build_cdf(*spectrum_xy)]
    bias_x = _f64(bias_xy[0])
    bias_y = _f64(bias_xy[1])

    g = _f64
    rep = lambda a: np.repeat(g(a), photons_per_step)
    st_x, st_y, st_z = rep(steps.x), rep(steps.y), rep(steps.z)
    st_t = rep(steps.t)
    st_dx, st_dy, st_dz = rep(steps.dir_x), rep(steps.dir_y), rep(steps.dir_z)
    st_len, st_beta = rep(steps.length), rep(steps.beta)
    st_w = rep(steps.weight)
    n = len(st_x)

    dom_x = g(geo.dom_x)
    dom_y = g(geo.dom_y)
    dom_z = g(geo.dom_z)
    R = float(geo.collision_radius)
    pancake = float(cfg.pancake_factor)

    # --- spawn (createPhotonFromTrack, kernel:132-184) ---
    shift = st_len * rng.random(n)
    x = st_x + st_dx * shift
    y = st_y + st_dy * shift
    z = st_z + st_dz * shift
    t = st_t + shift / (C_LIGHT * st_beta)
    st_type = np.repeat(g(steps.source_type).astype(np.int64),
                        photons_per_step)
    u_wl = rng.random(n)
    wlen = np.empty(n, np.float64)
    for s_i, (cx_, cacu, cbeta) in enumerate(cdfs):
        msk = st_type == s_i
        if msk.any():
            wlen[msk] = oracle_sample_wavelength(cx_, cacu, cbeta, u_wl[msk])
    n_phase = m.phase_index(wlen)
    cos_c = np.minimum(1.0, 1.0 / (st_beta * n_phase))
    sin_c = np.sqrt(np.maximum(1.0 - cos_c ** 2, 0.0))
    cdx, cdy, cdz = rotate_by_angle(cos_c, sin_c, st_dx, st_dy, st_dz,
                                    rng.random(n))
    is_cher = st_type == 0
    dx = np.where(is_cher, cdx, st_dx)
    dy = np.where(is_cher, cdy, st_dy)
    dz = np.where(is_cher, cdz, st_dz)
    inv_gv = m.group_index(wlen) / C_LIGHT
    abs_left = -np.log(1.0 - rng.random(n))
    w0 = st_w / np.maximum(np.interp(wlen, bias_x, bias_y), 1e-20)

    n_bins = cfg.hist_n_bins
    hist = np.zeros(len(dom_x) * n_bins)
    alive = np.ones(n, bool)
    n_hits = 0
    w_sum = 0.0
    hit_weights = []
    hit_bins = []

    max_gen = 100000
    for _gen in range(max_gen):
        if not alive.any():
            break
        idx = np.nonzero(alive)[0]
        xa, ya, za = x[idx], y[idx], z[idx]
        dxa, dya, dza = dx[idx], dy[idx], dz[idx]
        wl = wlen[idx]

        sca_budget = -np.log(1.0 - rng.random(n)[idx])
        corr = m.abs_corr(dxa, dya, dza)
        abs_budget = abs_left[idx] * corr

        d_scat, d_abs = oracle_walk(m, xa, ya, za, dza, wl, sca_budget,
                                    abs_budget)
        absorbed = d_abs < d_scat
        d_prop = np.where(absorbed, d_abs, d_scat)

        # --- exact brute-force collision (sphere entry at smin1) ---
        ox = dom_x[None, :] - xa[:, None]
        oy = dom_y[None, :] - ya[:, None]
        oz = dom_z[None, :] - za[:, None]
        urdot = ox * dxa[:, None] + oy * dya[:, None] + oz * dza[:, None]
        dr2 = ox * ox + oy * oy + oz * oz
        discr = urdot ** 2 - dr2 + R * R
        sq = np.sqrt(np.maximum(discr, 0.0)) / pancake
        smin1 = urdot - sq
        has_xy = (dxa ** 2 + dya ** 2) > 0.0
        good = (discr >= 0.0) & (urdot + sq >= 0.0) & (smin1 >= 0.0) \
            & (smin1 < d_prop[:, None]) & has_xy[:, None]
        smin1 = np.where(good, smin1, np.inf)
        hit_dom = np.argmin(smin1, axis=1)
        hit_dist = smin1[np.arange(len(idx)), hit_dom]
        hit = np.isfinite(hit_dist)

        # --- record (stop-on-detection) ---
        t_hit = t[idx] + inv_gv[idx] * hit_dist
        tbin = np.clip(((t_hit - cfg.hist_t_min) / cfg.hist_dt), 0,
                       n_bins - 1)
        flat = hit_dom * n_bins + np.floor(tbin).astype(np.int64)
        np.add.at(hist, flat[hit], w0[idx][hit])
        n_hits += int(hit.sum())
        w_sum += float(w0[idx][hit].sum())
        if collect_weights:
            hit_weights.append(w0[idx][hit])
            hit_bins.append(flat[hit])

        d_adv = np.where(hit, hit_dist, d_prop)
        x[idx] += dxa * d_adv
        y[idx] += dya * d_adv
        z[idx] += dza * d_adv
        t[idx] += inv_gv[idx] * d_adv

        # remaining corrected budget after the segment, back to raw units
        walked = np.minimum(d_adv, d_abs)
        # recompute consumed tau by re-walking is expensive; instead use the
        # identity that scattering (not absorption) ends the segment, so the
        # consumed absorption budget is proportional along the LAST layer
        # only when no boundary was crossed.  For exactness, re-walk:
        tau_used = _tau_abs_used(m, xa, ya, za, dza, wl, walked)
        new_abs = np.maximum(abs_budget - tau_used, 0.0) / corr
        new_abs[absorbed | hit] = 0.0
        abs_left[idx] = new_abs

        # --- scatter survivors ---
        surv = ~absorbed & ~hit & (new_abs > 1e-5)
        pdx, pdy, pdz = m.pre_scatter(dxa, dya, dza)
        cos_s = _scatter_cos(m, rng.random(n)[idx], rng.random(n)[idx])
        sin_s = np.sqrt(np.maximum(1.0 - cos_s ** 2, 0.0))
        ndx, ndy, ndz = rotate_by_angle(cos_s, sin_s, pdx, pdy, pdz,
                                        rng.random(n)[idx])
        ndx, ndy, ndz = m.post_scatter(ndx, ndy, ndz)
        dx[idx] = np.where(surv, ndx, dxa)
        dy[idx] = np.where(surv, ndy, dya)
        dz[idx] = np.where(surv, ndz, dza)
        alive[idx] = surv
    if collect_weights:
        w = (np.concatenate(hit_weights) if hit_weights
             else np.zeros(0))
        fb = (np.concatenate(hit_bins) if hit_bins
              else np.zeros(0, np.int64))
        return hist.reshape(len(dom_x), n_bins), n_hits, w_sum, w, fb
    return hist.reshape(len(dom_x), n_bins), n_hits, w_sum


def _tau_abs_used(m: OracleMedium, x, y, z, dz_dir, wlen, dist):
    """Corrected absorption optical depth accumulated over `dist` meters
    from (x, y, z) along vertical component dz_dir (piecewise-constant
    layer integral, same walk semantics as oracle_walk)."""
    z_eff = z - m.tilt_shift(x, y, z)
    j = np.clip(np.floor((z_eff - m.z_start) / m.h).astype(np.int64),
                0, m.L - 1)
    going_up = dz_dir >= 0.0
    vertical = np.abs(dz_dir) < 1e-5
    boundary = m.z_start + j * m.h + np.where(going_up, m.h, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_bound = np.where(vertical, np.inf, (boundary - z_eff) / dz_dir)
    t_bound = np.where(t_bound < 0.0, np.inf, t_bound)
    t_step = np.where(vertical, np.inf,
                      m.h / np.maximum(np.abs(dz_dir), 1e-300))
    tau = np.zeros_like(dist)
    t_done = np.zeros_like(dist)
    finished = np.zeros(dist.shape, bool)
    while True:
        inv_a = m.inv_abs(j, wlen)
        at_edge = np.where(going_up, j >= m.L - 1, j <= 0)
        seg_end = np.minimum(np.where(at_edge, np.inf, t_bound), dist)
        tau += np.where(finished, 0.0,
                        np.maximum(seg_end - t_done, 0.0) * inv_a)
        finished |= at_edge | (t_bound >= dist)
        if finished.all():
            break
        t_done = np.where(finished, t_done, t_bound)
        t_bound = np.where(finished, t_bound, t_bound + t_step)
        j = np.where(finished, j, j + np.where(going_up, 1, -1))
        j = np.clip(j, 0, m.L - 1)
    return tau
