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

The table is one float64 tensor of axes.n_bins on the medium's device.  On
a card the iterations run in the kernel of csrc/tabulate.cu (tabulator/
kernel.py packs its inputs): one thread a slot, each sub-step added into the
table with atomicAdd, as the reference's GPU kernel does
(propagation_kernel.c.cl:296-304), TAB_LAUNCH_ITERS iterations a launch
while more than half the slots live and TAB_TAIL_ITERS after that.
On the CPU they run in its plain version, tabulate_iterations_plain: the
iteration of _make_tabulate_body (the port's engine pieces, with the comb
of sub-steps as (max_substeps, N) tensors) and one index_add_ an iteration.
Each launch makes one host sync, which reads its counters, the alive count
among them; every launch after the first serves only the slots still live
(live_slots, built on the device from that count).

Random numbers are the JAX package's, bit for bit: key = base_key(seed),
batch i's key fold_in(key, i), iteration i's (9, N) block
uniforms(iter_key(bkey, i), (N,), 9) (u8 sets the first sub-step offset) and
sub-step m's impact-angle draws
uniforms(iter_key(iter_key(iter_key(bkey, i), 0x1A7B), m), (N,), 2), so the
same seed gives the JAX table up to float rounding.

Normalization divides each spatial cell by bin_volume/(step_length*dom_area)
(I3CLSimStepToTableConverter.cxx:513-540) in float64, on the table's device,
into a host array.
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
from ..propagate import kernel as K
from ..types import PropagationConfig, StepBatch
from . import kernel as TK
from .axes import SphericalAxes, default_spherical_axes
from .kernel import IMPACT_SALT  # noqa: F401  (the impact draws' salt)

CHUNK_ITERS = 16          # the JAX chunk's iterations; a CPU launch's
MAX_ITERATIONS = 65536    # a batch's iteration cap (the JAX package's)


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


def _make_tabulate_body(medium: MediumProperties, spectra: SpectrumTable,
                        source: ReferenceSource, angular_coeffs,
                        cfg: PropagationConfig, axes: SphericalAxes,
                        step_length: float, min_inv_groupvel: float,
                        tan_theta_c: float):
    """One tabulator iteration in plain PyTorch, on every slot at once:
    body(u, ui, state, remainder, steps, offs, counts=None) returns (state,
    remainder, idx, w), with u the (9, N) uniforms, ui the (M, 2, N) impact
    draws (None without the impact axis), offs the (M, 1) sub-step offsets
    and idx / w the (M * N,) comb entries (bin clipped to the table, weight 0
    where nothing deposits).  `counts` (a dict) gains the iteration's
    "substeps" (tested, inside their segment), "work" (live slots), "walk"
    and "generated" as device tensors."""
    horizon = E.horizon(cfg)
    with_impact = bool(getattr(axes, "impact_angle", False))
    cylindrical = getattr(axes, "kind", "spherical") == "cylindrical"

    def coords_of(px, py, pz, pt, dirp):
        if cylindrical:
            return _cylindrical_coords(px, py, pz, pt, source,
                                       min_inv_groupvel, tan_theta_c, dirp)
        return _spherical_coords(px, py, pz, pt, source, min_inv_groupvel,
                                 dirp)

    def body(u, ui, state, remainder, steps, offs, counts=None):
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
            state, medium, cfg, sca_budget, abs_budget, tally=counts,
            active=active)
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
        if counts is not None:
            for k, v in (("substeps", n_in.sum()), ("work", active.sum()),
                         ("generated", fresh.sum())):
                counts[k] = counts.get(k, 0) + v

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

    return body


def _offsets(n_sub: int, step_length: float, device) -> torch.Tensor:
    """The (M, 1) sub-step offsets m * step_length, rounded once to
    float32."""
    return (torch.arange(n_sub, dtype=torch.float64) * step_length).to(
        torch.float32).to(device)[:, None]


def _n_sub(cfg: PropagationConfig, step_length: float) -> int:
    """Comb sub-steps a segment, at most."""
    return int(cfg.max_segment_m / step_length) + 2


def _make_tabulate_chunk(medium: MediumProperties, spectra: SpectrumTable,
                         source: ReferenceSource, angular_coeffs,
                         cfg: PropagationConfig, axes: SphericalAxes,
                         step_length: float, min_inv_groupvel: float,
                         tan_theta_c: float,
                         chunk_iters: int = CHUNK_ITERS):
    """The JAX package's raw chunk (clsim_tpu/tabulator/table.py
    _make_tabulate_chunk) on _make_tabulate_body:
    chunk(steps, key, state, remainder, i0) runs iterations i0 ..
    i0 + chunk_iters - 1 and returns (state, remainder, idx_buf, w_buf,
    alive), with idx_buf / w_buf the (chunk_iters, max_substeps * N) comb
    entries and alive the device count of slots with a photon left."""
    body = _make_tabulate_body(medium, spectra, source, angular_coeffs, cfg,
                               axes, step_length, min_inv_groupvel,
                               tan_theta_c)
    n_sub = _n_sub(cfg, step_length)

    def chunk(steps: StepBatch, key, state: E.SlotState, remainder, i0: int):
        n = steps.x.shape[0]
        dev = steps.x.device
        keys = TK.launch_keys(key, i0, chunk_iters, n_sub,
                              axes.impact_angle, dev)
        offs = _offsets(n_sub, step_length, dev)
        idx_buf = torch.empty((chunk_iters, n_sub * n), dtype=torch.int64,
                              device=dev)
        w_buf = torch.empty((chunk_iters, n_sub * n), dtype=torch.float32,
                            device=dev)
        for k in range(chunk_iters):
            state, remainder, idx_buf[k], w_buf[k] = body(
                *_draws(keys, k, n), state, remainder, steps, offs)
        alive = ((state.in_flight > 0.5) | (state.photons_left > 0.5)).sum()
        return state, remainder, idx_buf, w_buf, alive

    return chunk


def _draws(keys: TK.TabKeys, k: int, n: int):
    """Iteration k's (9, N) uniforms and (M, 2, N) impact draws (or None)
    from the launch's key tables."""
    ui = None if keys.impact is None else rng.uniforms(keys.impact[k], (n,), 2)
    return rng.uniforms(keys.iter[k], (n,), 9), ui


class TabPlan(NamedTuple):
    """A tabulate() run's iteration: the kernel's packed blocks and tables,
    and the plain version's body on the same inputs."""
    block: TK.TabBlock
    body: object           # _make_tabulate_body's function
    step_length: float


def init_state(steps: StepBatch) -> torch.Tensor:
    """(NSF + 1, N) float32: the propagation kernel's slot state
    (kernel.init_state) and the comb's remainder, 0."""
    st = K.init_state(steps)
    return torch.cat([st, st.new_zeros((1, st.shape[1]))]).contiguous()


def tabulate_iterations_plain(plan: TabPlan, state, steps, keys: TK.TabKeys,
                              table: torch.Tensor,
                              slots: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, with its interface: the
    iterations of `keys` (TabKeys) on the slots of `slots` (int32; None
    for every slot) of the (NSF + 1, N) state, updated in place, and the
    (NST, N) step rows; each slot draws with its own index, and each
    iteration's comb entries are added to `table` with index_add_.
    Returns the float64 TAB_COUNTERS vector (KERNEL_ONLY 0) on the state's
    device."""
    n = state.shape[1]
    dev = state.device
    cols = slice(None) if slots is None else slots.long()
    sub = state[:, cols]
    st = E.SlotState(*sub[:K.NSF].unbind(0))
    sb = StepBatch(**{f: steps[k, cols] for k, f in enumerate(K.STEP_FIELDS)},
                   num_photons=st.photons_left)
    rem = sub[K.NSF]
    offs = _offsets(plan.block.n_sub, plan.step_length, dev)
    counts = {}
    entries = weight = torch.zeros((), dtype=torch.float64, device=dev)
    for k in range(keys.iter.shape[0]):
        u, ui = _draws(keys, k, n)
        ui = None if ui is None else ui[..., cols]
        st, rem, idx, w = plan.body(u[:, cols], ui, st, rem, sb, offs,
                                    counts)
        # zero weights add nothing: the whole comb goes in, with no sync
        table.index_add_(0, idx, w.double())
        entries = entries + (w != 0.0).sum()
        weight = weight + w.sum(dtype=torch.float64)
    state[:, cols] = torch.cat([torch.stack(list(st)), rem[None]])
    alive = ((st.in_flight > 0.5) | (st.photons_left > 0.5)).sum()
    zero = torch.zeros((), device=dev)
    c = [entries, weight] + [counts.get(k, zero) for k in (
        "substeps", "work", "walk")] + [alive, counts.get("generated", zero)]
    c += [zero] * len(TK.KERNEL_ONLY)
    return torch.stack([torch.as_tensor(v, device=dev).to(torch.float64)
                        for v in c])


def tabulate_iterations(plan: TabPlan, state, steps, keys: TK.TabKeys,
                        table: torch.Tensor,
                        slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the iterations of `keys` on the slots of `slots` (None: every
    slot): CUDA tensors launch the kernel (csrc/tabulate.cu; it raises
    when the kernel cannot serve the inputs or the launch fails), CPU
    tensors run tabulate_iterations_plain.  Returns the TAB_COUNTERS
    vector."""
    if state.device.type == "cuda":
        return TK.launch(plan.block, state, steps, keys, table, slots)
    if state.device.type == "cpu":
        return tabulate_iterations_plain(plan, state, steps, keys, table,
                                         slots)
    raise ValueError(f"no tabulator kernel for device {state.device}")


def live_slots(state: torch.Tensor, alive: int) -> torch.Tensor:
    """The int32 indices, ascending, of the slots of the (NSF + 1, N) state
    with a photon in flight or left, `alive` of them (the count the last
    launch's counters brought to the host, so that nothing here waits on
    the device)."""
    n = state.shape[1]
    live = (state[K.STATE_FIELDS.index("in_flight")] > 0.5) | \
        (state[K.STATE_FIELDS.index("photons_left")] > 0.5)
    pos = torch.where(live, torch.cumsum(live, 0) - 1, alive)
    out = torch.empty(alive + 1, dtype=torch.int32, device=state.device)
    out.scatter_(0, pos, torch.arange(n, dtype=torch.int32,
                                      device=state.device))
    return out[:alive]


def _tabulate_batch(plan: TabPlan, steps: StepBatch, key, table: torch.Tensor,
                    tally: Optional[dict] = None,
                    launch_iters: Optional[int] = None,
                    tail_iters: Optional[int] = None,
                    max_iterations: int = MAX_ITERATIONS) -> int:
    """Propagate one slot-assigned batch in table mode, adding its
    unnormalized contents to `table`, in launches of `launch_iters`
    iterations while more than half the slots live and of `tail_iters`
    after that (defaults TAB_LAUNCH_ITERS and TAB_TAIL_ITERS on a card,
    CHUNK_ITERS for both on the CPU, the JAX chunk), the last one cut at
    `max_iterations`; returns the iterations run.  The first launch serves
    every slot, each later one the list of the slots still live.  A
    launch's one host sync reads its counters, the alive count among them:
    the batch ends after the launch that leaves none."""
    dev = steps.x.device
    cuda = dev.type == "cuda"
    if launch_iters is None:
        launch_iters = TK.TAB_LAUNCH_ITERS if cuda else CHUNK_ITERS
    if tail_iters is None:
        tail_iters = TK.TAB_TAIL_ITERS if cuda else CHUNK_ITERS
    state = init_state(steps)
    n = state.shape[1]
    sp = K.pack_steps(steps)
    hkey = rng.as_key(key, "cpu")
    slots = None
    i0 = 0
    while i0 < max_iterations:
        full = slots is None or 2 * slots.shape[0] > n
        n_it = min(launch_iters if full else tail_iters, max_iterations - i0)
        keys = TK.launch_keys(hkey, i0, n_it, plan.block.n_sub,
                              plan.block.impact, dev)
        c = dict(zip(TK.TAB_COUNTERS, tabulate_iterations(
            plan, state, sp, keys, table, slots).tolist()))
        i0 += n_it
        if tally is not None:
            for k in ("entries", "substeps", "work", "walk", "generated") \
                    + TK.KERNEL_ONLY:
                tally[k] = tally.get(k, 0) + int(c[k])
            tally["weight"] = tally.get("weight", 0.0) + c["weight"]
            tally["syncs"] = tally.get("syncs", 0) + 1
        if c["alive"] == 0:
            break
        slots = live_slots(state, int(c["alive"]))
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


def _table_plan(medium: MediumProperties, spectra: SpectrumTable,
                source: ReferenceSource, axes: SphericalAxes, angular_coeffs,
                cfg: PropagationConfig, step_length: float,
                abs_lens_horizon: float):
    """tabulate()'s iteration on the medium's device (the fixed absorption
    horizon, non-stopping), with the minimum group index and the phase
    index at its wavelength (the table header's)."""
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

    step_length = float(step_length)
    body = _make_tabulate_body(medium, spectra, source, angular_coeffs, cfg,
                               axes, step_length, min_inv_gv, tan_theta_c)
    block = TK.pack(medium, spectra, source, axes, angular_coeffs, cfg,
                    step_length, min_inv_gv, tan_theta_c, E.horizon(cfg),
                    _n_sub(cfg, step_length))
    return (TabPlan(block=block, body=body, step_length=step_length),
            n_group[i_min], n_phase[i_min])


NORM_CHUNK_BYTES = 1 << 26   # device memory of one normalized slab


def _normalized(table: torch.Tensor, shape, norm: np.ndarray) -> np.ndarray:
    """table / norm (broadcast over the dimensions after the first three)
    as a float64 numpy array: divided on the table's device, a slab of
    the first axis at a time (at most NORM_CHUNK_BYTES), each slab copied
    into the host array.  IEEE division rounds alike on the host and the
    card, so the values equal numpy's table / norm bit for bit."""
    values = np.empty(shape)
    out = torch.from_numpy(values)
    raw = table.view(shape)
    norm_t = torch.as_tensor(norm, device=table.device).reshape(
        norm.shape + (1,) * (len(shape) - 3))
    step = max(1, NORM_CHUNK_BYTES // (8 * raw[0].numel()))
    for i in range(0, shape[0], step):
        out[i:i + step].copy_(raw[i:i + step] / norm_t[i:i + step])
    return values


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
    on the medium's device; numpy batches are copied there.  On a card
    every iteration runs in the kernel of csrc/tabulate.cu (a failed build
    or launch raises, and inputs it does not serve raise
    NotImplementedError); on the CPU in its plain version.

    `tally` (a dict) gains the run's counts: "iterations", "entries" (the
    nonzero comb entries added), "weight" (the float64 sum of every comb
    weight, which the table's sum must equal), "syncs" (host syncs, one a
    launch), "substeps", "work", "walk", "generated" and the kernel-only
    counts (TAB_COUNTERS; KERNEL_ONLY are 0 on the CPU) and "raw" (the
    unnormalized flat table, float64 on the device)."""
    axes = axes or default_spherical_axes()
    device = medium.device
    cfg = cfg or PropagationConfig(n_slots=int(step_batches[0].x.shape[0]))
    plan, n_group, n_phase = _table_plan(medium, spectra, source, axes,
                                         angular_coeffs, cfg, step_length,
                                         abs_lens_horizon)
    key = rng.base_key(seed)
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=device)
    n_photons = 0.0
    iterations = 0
    for i, batch in enumerate(step_batches):
        steps = _steps_on(batch, device)
        iterations += _tabulate_batch(plan, steps, rng.fold_in(key, i),
                                      table, tally)
        n_photons += float(steps.num_photons.sum())
    if tally is not None:
        tally["iterations"] = tally.get("iterations", 0) + iterations
        tally["raw"] = table

    # normalize spatial cells: content /= bin_volume/(step_length*dom_area)
    vol = axes.bin_volumes()  # (nr, naz, nct) for the inner data bins
    dom_area = PI * dom_radius ** 2
    # only the first 3 dims are spatial; the time (and optional impact-angle)
    # dims share each spatial cell's norm (I3CLSimStepToTableConverter
    # .cxx:513-540 Normalize)
    norm = np.ones(axes.shape[:3])
    norm[1:-1, 1:-1, 1:-1] = vol / (step_length * dom_area)
    values = _normalized(table, axes.shape, norm)

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
