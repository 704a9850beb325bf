"""Photon-table generation (the reference's TABULATE mode).

PyTorch counterpart of clsim_tpu.tabulator.table, the equivalent of
I3CLSimStepToTableConverter + the #ifdef TABULATE branch of the propagation
kernel (propagation_kernel.c.cl:226-304, 540-785): photons are propagated
for a fixed number of absorption lengths (no detector collision); every
`step_length` (1 m) along each scattering segment a table entry is deposited
at the source-relative spherical coordinates with weight

    w * angular_acceptance(dir_z) * exp(-(depth + frac * stepDepth))

(survival probability in absorption lengths, linearly interpolated within
the segment).  The first sub-step of each photon is randomized to decorrelate
the comb from the emission point (kernel:562).

The iteration is the port's engine pieces (engine._create_photons,
_segment_distances, the anisotropy transforms, mixed_cos and the scatter
rotation), run on the tensors' device, with the comb of sub-steps as
(max_substeps, N) tensors.  The table is one float64 tensor of axes.n_bins
on the same device; each chunk of CHUNK_ITERS iterations adds its nonzero
comb entries into it with index_add_ (on a GPU an atomic add into global
memory, as the reference's GPU kernel does, propagation_kernel.c.cl:296-304).
A chunk makes one host sync, which reads the alive count and the number of
nonzero entries together.

Random numbers are the JAX package's, bit for bit: key = base_key(seed),
batch i's key fold_in(key, i), iteration i's (9, N) block
uniforms(iter_key(bkey, i), (N,), 9) (u8 sets the first sub-step offset) and
sub-step m's impact-angle draws
uniforms(iter_key(iter_key(iter_key(bkey, i), 0x1A7B), m), (N,), 2), so the
same seed gives the JAX table up to float rounding.

Normalization divides each spatial cell by bin_volume/(step_length*dom_area)
(I3CLSimStepToTableConverter.cxx:513-540), in float64 numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import C_LIGHT, PI
from ..convert import steps_from_numpy
from ..hits.acceptance import dom_angular_sensitivity
from ..medium.anisotropy import (abs_len_scaling, post_scatter_transform,
                                 pre_scatter_transform)
from ..medium.functions import eval_polynomial
from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.rotations import safe_sqrt, scatter_direction_by_angle
from ..ops.samplers import mixed_cos
from ..ops.spectrum import SpectrumTable
from ..propagate import engine as E
from ..types import PropagationConfig, StepBatch
from .axes import SphericalAxes, default_spherical_axes

CHUNK_ITERS = 16          # iterations between host syncs
MAX_ITERATIONS = 65536    # a batch's iteration cap (the JAX package's)
IMPACT_SALT = 0x1A7B      # folded into the iteration key for impact draws


class ReferenceSource(NamedTuple):
    """Source frame for the table coordinates (I3CLSimReferenceParticle):
    position, direction, and a perpendicular reference direction, float32
    tensors on the propagation device."""
    pos: torch.Tensor     # (3,)
    time: torch.Tensor    # ()
    dir: torch.Tensor     # (3,) unit
    perp: torch.Tensor    # (3,) unit, perpendicular to dir


def make_reference_source(x, y, z, t, zenith, azimuth,
                          device="cuda") -> ReferenceSource:
    """Build the source frame like the tabulator does from a particle."""
    d = np.array([-np.sin(zenith) * np.cos(azimuth),
                  -np.sin(zenith) * np.sin(azimuth),
                  -np.cos(zenith)])
    # a perpendicular direction (the reference uses the cross with z unless
    # degenerate)
    up = np.array([0.0, 0.0, 1.0])
    perp = np.cross(d, up)
    if np.linalg.norm(perp) < 1e-9:
        perp = np.array([1.0, 0.0, 0.0])
    perp = perp / np.linalg.norm(perp)
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return ReferenceSource(pos=f32([x, y, z]), time=f32(t), dir=f32(d),
                           perp=f32(perp))


def _cylindrical_coords(px, py, pz, pt, source: ReferenceSource,
                        min_inv_groupvel, tan_theta_c, dirp=None):
    """Source-relative (rho, azimuth_rad, z_closest, residual_t) for infinite
    muon tracks (cylindrical_coordinates.c.cl:42-63); the time residual is
    relative to the geometric Cherenkov cone (l + rho*tan(theta_c))/c.

    `dirp` (optional randomized photon direction) appends the impact-angle
    cosine against the vector from the nominal Cherenkov emission point to
    the impact point (cylindrical_coordinates.c.cl:61-75)."""
    rx = px - source.pos[0]
    ry = py - source.pos[1]
    rz = pz - source.pos[2]
    l = rx * source.dir[0] + ry * source.dir[1] + rz * source.dir[2]
    hx = rx - l * source.dir[0]
    hy = ry - l * source.dir[1]
    hz = rz - l * source.dir[2]
    rho = torch.sqrt(hx * hx + hy * hy + hz * hz)
    cos_az = (hx * source.perp[0] + hy * source.perp[1]
              + hz * source.perp[2]) / torch.clamp(rho, min=1e-20)
    azimuth = torch.where(rho > 0, torch.acos(torch.clamp(cos_az, -1.0, 1.0)),
                          0.0)
    z_closest = source.pos[2] + l * source.dir[2]
    dt = (pt - source.time) - (l + rho * tan_theta_c) / C_LIGHT
    if dirp is None:
        return rho, azimuth, z_closest, dt
    lc = l - rho / tan_theta_c
    cx = rx - lc * source.dir[0]
    cy = ry - lc * source.dir[1]
    cz = rz - lc * source.dir[2]
    cdist = torch.sqrt(cx * cx + cy * cy + cz * cz)
    cimp = (dirp[0] * cx + dirp[1] * cy + dirp[2] * cz) \
        / torch.clamp(cdist, min=1e-20)
    cimp = torch.where(cdist > 0, torch.clamp(cimp, -1.0, 1.0), 1.0)
    return rho, azimuth, z_closest, dt, cimp


def _spherical_coords(px, py, pz, pt, source: ReferenceSource,
                      min_inv_groupvel, dirp=None):
    """Source-relative (r, azimuth_deg, cos_polar, residual_t); the azimuth
    is folded to [0, 180] (spherical_coordinates.c.cl:28-66).

    `dirp` (optional randomized photon direction) appends the impact-angle
    cosine against the emitter-to-impact-point vector
    (spherical_coordinates.c.cl:67-75)."""
    rx = px - source.pos[0]
    ry = py - source.pos[1]
    rz = pz - source.pos[2]
    r = torch.sqrt(rx * rx + ry * ry + rz * rz)
    l = rx * source.dir[0] + ry * source.dir[1] + rz * source.dir[2]
    hx = rx - l * source.dir[0]
    hy = ry - l * source.dir[1]
    hz = rz - l * source.dir[2]
    n_rho = torch.sqrt(hx * hx + hy * hy + hz * hz)
    cos_az = (hx * source.perp[0] + hy * source.perp[1]
              + hz * source.perp[2]) / torch.clamp(n_rho, min=1e-20)
    azimuth = torch.where(
        n_rho > 0, torch.acos(torch.clamp(cos_az, -1.0, 1.0)) / (PI / 180.0),
        0.0)
    cos_polar = torch.where(r > 0, l / torch.clamp(r, min=1e-20), 0.0)
    dt = (pt - source.time) - r * min_inv_groupvel
    if dirp is None:
        return r, azimuth, cos_polar, dt
    cimp = (dirp[0] * rx + dirp[1] * ry + dirp[2] * rz) \
        / torch.clamp(r, min=1e-20)
    cimp = torch.where(r > 0, torch.clamp(cimp, -1.0, 1.0), 1.0)
    return r, azimuth, cos_polar, dt, cimp


def _impact_direction(dx, dy, dz, u_sin, u_az):
    """Photon direction randomized over the receiver's cross-section:
    rotate by asin(sqrt(u)) about a uniform azimuth (the 'average over
    possible DOM positions', spherical_coordinates.c.cl:68-74)."""
    sina = torch.sqrt(u_sin)
    cosa = safe_sqrt(1.0 - u_sin)
    return scatter_direction_by_angle(cosa, sina, dx, dy, dz, u_az)


def _make_tabulate_chunk(medium: MediumProperties, spectra: SpectrumTable,
                         source: ReferenceSource, angular_coeffs,
                         cfg: PropagationConfig, axes: SphericalAxes,
                         step_length: float, min_inv_groupvel: float,
                         tan_theta_c: float,
                         chunk_iters: int = CHUNK_ITERS):
    """The propagation chunk of one tabulate() run:
    chunk(steps, key, state, remainder, i0) runs iterations i0 ..
    i0 + chunk_iters - 1 and returns (state, remainder, idx_buf, w_buf,
    alive), with idx_buf / w_buf the (chunk_iters, max_substeps * N) comb
    entries (bin clipped to the table, weight 0 where nothing deposits) and
    alive the device count of slots with a photon left (no host sync)."""
    max_substeps = int(cfg.max_segment_m / step_length) + 2
    horizon = E.horizon(cfg)
    with_impact = bool(getattr(axes, "impact_angle", False))
    cylindrical = getattr(axes, "kind", "spherical") == "cylindrical"

    def coords_of(px, py, pz, pt, dirp):
        if cylindrical:
            return _cylindrical_coords(px, py, pz, pt, source,
                                       min_inv_groupvel, tan_theta_c, dirp)
        return _spherical_coords(px, py, pz, pt, source, min_inv_groupvel,
                                 dirp)

    def body(u, sub_key, state, remainder, steps, offs):
        n = steps.x.shape[0]
        fresh = (state.in_flight < 0.5) & (state.photons_left > 0.5)
        state, _ = E._create_photons(state, steps, medium, spectra, cfg, u,
                                     fresh)
        freshf = fresh.to(torch.float32)
        state = state._replace(
            in_flight=torch.maximum(state.in_flight, freshf),
            photons_left=state.photons_left - freshf)
        # randomize the first sub-step offset per new photon (kernel:562)
        remainder = torch.where(fresh, step_length * (1.0 - u[8]), remainder)

        active = state.in_flight > 0.5
        abs_corr = abs_len_scaling(medium.anisotropy, state.dx, state.dy,
                                   state.dz)
        sca_budget = -torch.log(rng.uniform_oc(u[4]))
        abs_budget = state.abs_left * abs_corr
        d_prop, absorbed, scattered, abs_left = E._segment_distances(
            state, medium, cfg, sca_budget, abs_budget)
        abs_left = abs_left / abs_corr

        # under the fixed horizon every photon starts with `horizon`
        # absorption lengths, so the depth so far is horizon - abs_left
        depth_start = horizon - state.abs_left
        step_depth = state.abs_left - abs_left

        # with an impact-angle axis the acceptance weight is REPLACED by the
        # explicit dimension (propagation_kernel.c.cl:245-250)
        if with_impact:
            impact = steps.weight
        else:
            impact = steps.weight * eval_polynomial(
                angular_coeffs, torch.clamp(state.dz, -1.0, 1.0))

        # the comb: sub-steps remainder, remainder + dl, ... < d_prop, all m
        # at once as (M, N) tensors
        d = remainder[None, :] + offs
        in_seg = (d < d_prop) & active
        px = state.x + d * state.dx
        py = state.y + d * state.dy
        pz = state.z + d * state.dz
        pt = state.t + d * state.inv_gv
        dirp = None
        if with_impact:
            ms = torch.arange(max_substeps, dtype=torch.int64,
                              device=sub_key.device)
            ui = rng.uniforms(rng.fold_in(sub_key, ms), (n,), 2)
            dirp = _impact_direction(state.dx, state.dy, state.dz,
                                     ui[:, 0], ui[:, 1])
        coords = coords_of(px, py, pz, pt, dirp)
        oob = axes.out_of_bounds(coords)
        frac = d / torch.clamp(d_prop, min=1e-20)
        w = torch.where(in_seg & ~oob,
                        impact * torch.exp(-(depth_start + frac * step_depth)),
                        0.0)
        idx = torch.clamp(axes.flat_index(coords), 0, axes.n_bins - 1)
        # photons that leave the table bounds stop propagating
        stop = (in_seg & oob).any(0)
        state = state._replace(in_flight=torch.where(stop, 0.0,
                                                      state.in_flight))
        # in_seg is a prefix of m (d grows with m): the next segment's first
        # sub-step continues the comb from the last one in this segment
        n_in = in_seg.sum(0)
        d_last = d.gather(0, torch.clamp(n_in - 1, min=0)[None, :])[0]
        remainder = torch.where(active & (n_in > 0),
                                d_last + step_length - d_prop, remainder)

        # advance / absorb / scatter (same flow as the main engine)
        state = state._replace(
            x=state.x + torch.where(active, state.dx * d_prop, 0.0),
            y=state.y + torch.where(active, state.dy * d_prop, 0.0),
            z=state.z + torch.where(active, state.dz * d_prop, 0.0),
            t=state.t + torch.where(active, state.inv_gv * d_prop, 0.0),
            abs_left=torch.where(active, abs_left, state.abs_left))

        do_scatter = scattered & active
        pdx, pdy, pdz = pre_scatter_transform(medium.anisotropy, state.dx,
                                              state.dy, state.dz)
        cos_s = mixed_cos(medium.scattering.mean_cos,
                          medium.scattering.liu_fraction, u[5], u[6])
        sin_s = safe_sqrt(1.0 - cos_s * cos_s)
        sdx, sdy, sdz = scatter_direction_by_angle(cos_s, sin_s, pdx, pdy,
                                                   pdz, u[7])
        sdx, sdy, sdz = post_scatter_transform(medium.anisotropy, sdx, sdy,
                                               sdz)
        state = state._replace(
            dx=torch.where(do_scatter, sdx, state.dx),
            dy=torch.where(do_scatter, sdy, state.dy),
            dz=torch.where(do_scatter, sdz, state.dz))

        died = active & (absorbed | (state.abs_left < E.EPSILON))
        state = state._replace(in_flight=torch.where(died, 0.0,
                                                     state.in_flight))
        return state, remainder, idx.reshape(-1), w.reshape(-1)

    def chunk(steps: StepBatch, key, state: E.SlotState, remainder, i0: int):
        n = steps.x.shape[0]
        dev = steps.x.device
        K = chunk_iters
        offs = (torch.arange(max_substeps, dtype=torch.float64) * step_length
                ).to(torch.float32).to(dev)[:, None]
        # the chunk's iteration keys and (9, N) uniform blocks, drawn at once
        keys = rng.fold_in(key, torch.arange(i0, i0 + K, dtype=torch.int64,
                                             device=dev))
        u_all = rng.uniforms(keys, (n,), 9)
        sub_keys = rng.fold_in(keys, IMPACT_SALT) if with_impact \
            else [None] * K
        idx_buf = torch.empty((K, max_substeps * n), dtype=torch.int64,
                              device=dev)
        w_buf = torch.empty((K, max_substeps * n), dtype=torch.float32,
                            device=dev)
        for k in range(K):
            state, remainder, idx_buf[k], w_buf[k] = body(
                u_all[k], sub_keys[k], state, remainder, steps, offs)
        alive = ((state.in_flight > 0.5) | (state.photons_left > 0.5)).sum()
        return state, remainder, idx_buf, w_buf, alive

    return chunk


def _deposit(table: torch.Tensor, idx_buf, w_buf, alive,
             tally: Optional[dict]) -> int:
    """Add a chunk's nonzero comb entries to the table (index_add_, an
    atomic add on a GPU) and return its alive count.  The chunk's one host
    sync reads the alive count and the nonzero count together; the entries
    are then packed in order (cumsum positions) without another sync."""
    w = w_buf.reshape(-1)
    nz = w != 0.0
    n_alive, n_nz = torch.stack([alive.to(torch.int64), nz.sum()]).tolist()
    if n_nz:
        # zero entries land in the spare slot n_nz, which is dropped
        dest = torch.where(nz, torch.cumsum(nz, 0) - 1, n_nz)
        sel_idx = torch.zeros(n_nz + 1, dtype=torch.int64,
                              device=w.device).scatter_(
                                  0, dest, idx_buf.reshape(-1))
        sel_w = torch.zeros(n_nz + 1, dtype=torch.float64,
                            device=w.device).scatter_(0, dest, w.double())
        table.index_add_(0, sel_idx[:n_nz], sel_w[:n_nz])
    if tally is not None:
        tally["entries"] = tally.get("entries", 0) + n_nz
        tally["weight"] = tally.get("weight", 0.0) + w.sum(
            dtype=torch.float64)
        tally["syncs"] = tally.get("syncs", 0) + 1
    return n_alive


def _tabulate_batch(chunk, steps: StepBatch, key, table: torch.Tensor,
                    tally: Optional[dict] = None,
                    chunk_iters: int = CHUNK_ITERS,
                    max_iterations: int = MAX_ITERATIONS) -> int:
    """Propagate one slot-assigned batch in table mode, adding its
    unnormalized contents to `table`; returns the iterations run (at most
    `max_iterations`)."""
    n = steps.x.shape[0]
    state = E._init_state(steps)
    remainder = torch.zeros(n, dtype=torch.float32, device=steps.x.device)
    i0 = 0
    for _ in range(max_iterations // chunk_iters):
        state, remainder, idx_buf, w_buf, alive = chunk(
            steps, key, state, remainder, i0)
        i0 += chunk_iters
        if _deposit(table, idx_buf, w_buf, alive, tally) == 0:
            break
    return i0


def _steps_on(batch: StepBatch, device) -> StepBatch:
    """A step batch as tensors on `device` (numpy batches through
    convert.steps_from_numpy)."""
    if isinstance(batch.x, torch.Tensor):
        return StepBatch(*[f.to(device) for f in batch])
    return steps_from_numpy(batch._asdict(), device)


class PhotonTable(NamedTuple):
    values: np.ndarray        # normalized contents, shape axes.shape
    weights_sq: Optional[np.ndarray]
    axes: object
    n_photons: float
    header: dict


def _table_chunk(medium: MediumProperties, spectra: SpectrumTable,
                 source: ReferenceSource, axes: SphericalAxes, angular_coeffs,
                 cfg: PropagationConfig, step_length: float,
                 abs_lens_horizon: float):
    """tabulate()'s propagation chunk on the medium's device (the fixed
    absorption horizon, non-stopping), with the minimum group index and
    the phase index at its wavelength (the table header's)."""
    device = medium.device
    if angular_coeffs is None:
        angular_coeffs = dom_angular_sensitivity(device=device)
    angular_coeffs = torch.as_tensor(angular_coeffs, dtype=torch.float32,
                                     device=device)
    cfg = dataclasses.replace(cfg, fixed_abs_lens=abs_lens_horizon,
                              stop_on_detection=False)

    # GetMinimumRefractiveIndex (I3CLSimStepToTableConverter.cxx:191-196):
    # minimum group index sets min_invGroupVel; the phase index at that
    # wavelength sets tan(theta_c) for the cylindrical time residual.  In
    # float32, as the JAX package evaluates it: a bin edge can depend on
    # the last bit
    wl = torch.as_tensor(np.linspace(medium.min_wlen, medium.max_wlen, 128),
                         dtype=torch.float32, device=device)
    n_group = medium.group_ref_index(wl).cpu().numpy()
    n_phase = medium.phase_ref_index(wl).cpu().numpy()
    i_min = int(np.argmin(n_group))
    min_inv_gv = float(np.float32(n_group[i_min] / C_LIGHT))
    tan_theta_c = float(np.float32(np.sqrt(n_phase[i_min] ** 2 - 1.0)))

    chunk = _make_tabulate_chunk(medium, spectra, source, angular_coeffs,
                                 cfg, axes, float(step_length), min_inv_gv,
                                 tan_theta_c)
    return chunk, n_group[i_min], n_phase[i_min]


def tabulate(step_batches, medium: MediumProperties, spectra: SpectrumTable,
             source: ReferenceSource, seed: int,
             axes: Optional[SphericalAxes] = None,
             angular_coeffs=None,
             cfg: Optional[PropagationConfig] = None,
             step_length: float = 1.0,
             abs_lens_horizon: float = 46.0,
             dom_radius: float = 0.16510,
             tally: Optional[dict] = None) -> PhotonTable:
    """Generate a photon table from slot-assigned step batches (the
    TabulatePhotonsFromSource equivalent, python/tablemaker/tabulator.py:441)
    on the medium's device; numpy batches are copied there.

    `tally` (a dict) gains the run's counts: "iterations", "entries" (the
    nonzero comb entries added), "weight" (the float64 device sum of every
    comb weight, which the table's sum must equal), "syncs" (host syncs)
    and "raw" (the unnormalized flat table, float64 on the device)."""
    axes = axes or default_spherical_axes()
    device = medium.device
    cfg = cfg or PropagationConfig(n_slots=int(step_batches[0].x.shape[0]))
    chunk, n_group, n_phase = _table_chunk(medium, spectra, source, axes,
                                           angular_coeffs, cfg, step_length,
                                           abs_lens_horizon)
    key = rng.base_key(seed, device)
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)
    n_photons = 0.0
    iterations = 0
    for i, batch in enumerate(step_batches):
        steps = _steps_on(batch, device)
        iterations += _tabulate_batch(chunk, steps, rng.fold_in(key, i),
                                      table, tally)
        n_photons += float(steps.num_photons.sum())
    if tally is not None:
        tally["iterations"] = tally.get("iterations", 0) + iterations
        tally["raw"] = table

    # normalize spatial cells: content /= bin_volume/(step_length*dom_area)
    values = table.cpu().numpy().reshape(axes.shape)
    vol = axes.bin_volumes()  # (nr, naz, nct) for the inner data bins
    dom_area = PI * dom_radius ** 2
    # only the first 3 dims are spatial; the time (and optional impact-angle)
    # dims share each spatial cell's norm (I3CLSimStepToTableConverter
    # .cxx:513-540 Normalize)
    norm = np.ones(axes.shape[:3])
    norm[1:-1, 1:-1, 1:-1] = vol / (step_length * dom_area)
    values = values / norm.reshape(norm.shape + (1,) * (values.ndim - 3))

    header = dict(n_photons=n_photons, step_length=step_length,
                  abs_lens_horizon=abs_lens_horizon, dom_radius=dom_radius,
                  seed=seed, n_group=n_group, n_phase=n_phase)
    return PhotonTable(values=values, weights_sq=None, axes=axes,
                       n_photons=n_photons, header=header)


def save_table_npz(table: PhotonTable, path: str):
    """Persist a photon table (.npz with values, bin edges and header --
    the FITS writer analog, I3CLSimStepToTableConverter.cxx:593-686)."""
    np.savez_compressed(
        path, values=table.values,
        **{f"edges_{i}": a.bin_edges() for i, a in enumerate(table.axes.axes)},
        **{f"header_{k}": v for k, v in table.header.items()})
