"""The photon propagation engine in plain PyTorch.

PyTorch counterpart of clsim_tpu.propagate.engine, and the CPU twin of the
CUDA propagation kernel (csrc/propagate.cu): the kernel's plain version
(propagate/kernel.py::run_fused_iterations_plain) is this module's
`_iteration` run on the kernel's state layout.  The execution model is the
JAX package's:

  * one photon slot per lane; a slot spawns a fresh photon from its assigned
    step the moment the previous one dies,
  * segments are capped at `max_segment_m` (exponential scatter distances
    are memoryless, so truncating a segment and re-sampling is
    statistically identical to the reference's unbounded segments),
  * the layered-ice optical-depth -> meters conversion walks at most
    max_layer_steps + 1 layers (propagation_kernel.c.cl:646-676),
  * DOM collision: a dense 2-D cull over all strings, then the sphere test
    against every DOM of the top-K nearest strings,
  * hits are deposited into per-DOM time histograms with index_add.

Per-photon wavelength-derived constants (bias weight w0, scattering factor
gs, absorption factors pa/qa/ra, group slowness) are computed once at spawn
and carried in SlotState, as the kernel does; the values are the same
functions of the wavelength that the JAX engine recomputes each iteration.

Randomness: each iteration consumes an (8, N) block of uniforms, from a
torch.Generator, from an external (T, 8, N) stream shared with the JAX
engine and the kernel (the parity contract), or, with `key=`, from the
port's threefry (ops/rng.py): iteration i draws
rng.uniforms(rng.iter_key(key, i), (N,), 8), bit-exact to the JAX engine's
stream for the same key.  Row meanings: u0 emission point along the step,
u1 wavelength, u2 Cherenkov azimuth, u3 absorption budget, u4 scattering
budget, u5 phase-function branch, u6 scattering-angle sample, u7
scattering azimuth.

Estimators (cfg.estimator): "detect" is the reference's accept/reject
(a photon that hits a DOM deposits its weight and, with
stop_on_detection, dies; fixed_abs_lens > 0 replaces the sampled absorption
budget by a fixed horizon).  "expected" is the differentiable estimator:
photons fly to a fixed horizon (fixed_abs_lens, or 46 absorption lengths),
pass through DOMs, and every DOM entry deposits the survival weight
exp(-optical depth to the entry point), optionally times the angular
acceptance polynomial (expected_angular_poly about pmt_axis) and soft
binned in time.  Under autograd the expected estimator is a smooth function
of the medium tensors: with detach_trajectories the sampled geometry is a
fixed sample, and with score_function the likelihood-ratio term of the
scattering law rides in a per-slot log-likelihood (ScoreState, engine only:
the kernel's primal factor is exp(0) = 1).  Deposits use the functional
index_add, and divisions are where-guarded, so gradients stay finite.

Photon records (cfg.save_photons): a RecState carries the emission point,
wavelength and scatter count of each slot's photon beside the SlotState, and
a photon is recorded at its hit (or, with save_all_photons, at its
absorption point).  propagate() writes the records into fixed-capacity rings
per slot, as the JAX engine does; the kernel's plain version takes the same
per-iteration record values through `emit` instead.

Scatter-history rings (cfg.photon_history_entries = H > 0, with
save_photons; SAVE_PHOTON_HISTORY, propagation_kernel.c.cl:452-455,
833-837): each slot's photon keeps its last H scatter points and their
depths in absorption lengths in (N, H) rings (RecState.rings, cleared at
spawn), and a record copies them into the (N, capacity, H) record fields
hist_x, hist_y, hist_z and hist_abs, as the JAX engine does
(clsim_tpu/propagate/engine.py:89, 496-500, 684-695, 763-773).  They ride
on the engine only: the CUDA kernel refuses them, as the JAX kernel does,
and dispatch.propagate_auto sends a ring run to the engine on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import C_LIGHT
from ..geometry import DetectorGeometry
from ..medium.anisotropy import (abs_len_scaling, post_scatter_transform,
                                 pre_scatter_transform)
from ..medium.properties import MediumProperties
from ..medium.tilt import tilt_z_shift
from ..ops import rng
from ..ops.rotations import (cart_to_sph, safe_sqrt,
                             scatter_direction_by_angle)
from ..ops.samplers import (mixed_cos, rayleigh_cos,
                            sample_interpolated_fast)
from ..ops.spectrum import (SpectrumTable, check_source_types,
                            sample_wavelength_dispatch, source_type_range,
                            wavelength_bias)
from ..types import PropagationConfig, StepBatch
from ..util import profiling as P

EPSILON = 1e-5  # matches the reference kernel's single-precision EPSILON
BIG = 1e30

# raw record columns (the JAX kernel's REC_QUEUE_FIELDS): what the CUDA
# kernel writes per record, and what the kernel's plain version takes from
# the record block; records_from_rows derives the public fields from them
REC_QUEUE_FIELDS = ["pos_x", "pos_y", "pos_z", "time", "dir_x", "dir_y",
                    "dir_z", "wavelength", "identifier", "start_x",
                    "start_y", "start_z", "start_time", "start_dx",
                    "start_dy", "start_dz", "inv_gv", "num_scatters",
                    "dist_in_abs_lens"]

# public record fields (the JAX engine's ring fields, in its order)
REC_FIELDS = ["pos_x", "pos_y", "pos_z", "time", "dir_theta", "dir_phi",
              "wavelength", "cherenkov_dist", "num_scatters", "weight",
              "identifier", "dom", "start_x", "start_y", "start_z",
              "start_time", "start_theta", "start_phi", "group_velocity",
              "dist_in_abs_lens"]
# the scatter-history record fields, (N, capacity, H) each, in the order of
# RecState.rings
HIST_FIELDS = ["hist_x", "hist_y", "hist_z", "hist_abs"]


class SlotState(NamedTuple):
    """Per-slot propagation state; every field is a float32 (N,) tensor.
    The CUDA kernel keeps the same fields, stacked as an (NSF, N) tensor
    (propagate/kernel.py)."""
    photons_left: torch.Tensor  # photons this slot still has to spawn
    in_flight: torch.Tensor     # 1.0 while a live photon occupies the slot
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    w0: torch.Tensor            # hit weight: step.weight / bias(lambda)
    inv_gv: torch.Tensor        # group slowness [ns/m]
    abs_left: torch.Tensor      # remaining absorption budget [abs. lengths]
    gs: torch.Tensor            # 1/l_sca = gs * b400[layer]
    pa: torch.Tensor            # 1/l_abs = pa*a_dust400 + qa + ra*delta_tau
    qa: torch.Tensor
    ra: torch.Tensor


class RecState(NamedTuple):
    """Per-slot record state, carried beside SlotState only when
    cfg.save_photons (SlotState is the kernel's main-path layout and stays
    as it is).  Every field is a float32 (N,) tensor.  The CUDA kernel's
    record mode keeps every field but total_path as extra state rows
    (propagate/kernel.py REC_STATE_FIELDS)."""
    wlen: torch.Tensor          # wavelength [nm]
    abs_init: torch.Tensor      # absorption budget at spawn [abs. lengths]
    n_scat: torch.Tensor        # scatters so far
    dist_abs: torch.Tensor      # abs_init - abs_left at the last record
    start_x: torch.Tensor       # emission point, time and direction
    start_y: torch.Tensor
    start_z: torch.Tensor
    start_t: torch.Tensor
    start_dx: torch.Tensor
    start_dy: torch.Tensor
    start_dz: torch.Tensor
    total_path: torch.Tensor    # path length so far [m] (engine rings only)
    # scatter-history rings (hist_x, hist_y, hist_z, hist_abs), (N, H)
    # each, with photon_history_entries > 0; engine only
    rings: Optional[tuple] = None


class ScoreState(NamedTuple):
    """Per-slot state of the score-function estimator (uses_score(cfg)),
    carried beside SlotState by the engine only."""
    log_lik: torch.Tensor       # log-likelihood of the photon's sampled
                                # scatter events so far


class Accumulators(NamedTuple):
    hist: torch.Tensor         # (n_doms * n_bins,) float32 weighted hits
    n_generated: torch.Tensor  # () float64 photons spawned
    n_hits: torch.Tensor       # () float64 photons detected
    weight_hits: torch.Tensor  # () float64 sum of deposited weights
    n_work: torch.Tensor       # () float64 slot-iterations with a photon
    # record rings, (N, photon_capacity_per_slot) float32 per REC_FIELDS
    # entry ((N, capacity, H) per HIST_FIELDS entry with history rings),
    # and the (N,) int32 records per slot; None without rings
    rec_count: Optional[torch.Tensor] = None
    rec: Optional[dict] = None


class PropagationResult(NamedTuple):
    hist: torch.Tensor          # (n_doms, n_bins)
    n_generated: torch.Tensor
    n_hits: torch.Tensor
    weight_hits: torch.Tensor
    n_iterations: int
    # fused-path counter vector (propagate/kernel.py CNT_* layout, float64,
    # on the device); None on the engine path
    diag_totals: Optional[torch.Tensor] = None
    # photon records (cfg.save_photons): a dict of REC_FIELDS tensors and
    # the record counts.  The engine gives (N, capacity) rings and (N,)
    # counts; the fused path and Simulation.run_steps give one (1, R) row
    # and [R] (hits/photons.compact_records)
    rec_count: Optional[torch.Tensor] = None
    rec: Optional[dict] = None

    @property
    def diagnostics(self) -> Optional[dict]:
        """Host-side dict of the fused counters (syncs the device)."""
        if self.diag_totals is None:
            return None
        with P.wait("diagnostics"):
            t = self.diag_totals.detach().cpu().numpy().astype(np.float64)
        return {"generated": t[0], "hits": t[1], "weight_sum": t[2],
                "dropped": t[3], "abandoned": t[4], "queued": t[5],
                "work": t[6], "stalled": t[7]}


def horizon(cfg: PropagationConfig) -> Optional[float]:
    """The fixed absorption horizon [absorption lengths], or None when the
    budget is sampled: fixed_abs_lens when set (the tabulator's
    PROPAGATE_FOR_FIXED_NUMBER_OF_ABSORPTION_LENGTHS), else 46 for the
    expected estimator (photonics' 1e-20 survival), as
    clsim_tpu/propagate/engine.py:171-175."""
    if cfg.fixed_abs_lens > 0.0:
        return float(cfg.fixed_abs_lens)
    return 46.0 if cfg.estimator == "expected" else None


def uses_score(cfg: PropagationConfig) -> bool:
    """Whether the score-function term is carried (it needs the expected
    estimator with detached trajectories)."""
    return bool(cfg.score_function and cfg.estimator == "expected"
                and cfg.detach_trajectories)


def check_supported(cfg: PropagationConfig, medium: MediumProperties):
    """Raise ValueError for an unknown estimator and for a tabulated medium
    without its tables."""
    reason = medium.missing_tables()
    if reason:
        raise ValueError(reason)
    if cfg.estimator not in ("detect", "expected"):
        raise ValueError(f"unknown estimator {cfg.estimator!r}")


# ---------------------------------------------------------------------------
# photon creation (createPhotonFromTrack, propagation_kernel.c.cl:132-184)
# ---------------------------------------------------------------------------

def _create_photons(state: SlotState, steps: StepBatch,
                    medium: MediumProperties, spectra: SpectrumTable,
                    cfg: PropagationConfig, u, fresh):
    """Spawn a new photon from each slot's step where `fresh` is set.
    Returns (state, wavelengths sampled for every lane)."""
    u_shift, u_wlen, u_azi, u_abs = u[0], u[1], u[2], u[3]

    shift = steps.length * u_shift
    px = steps.x + steps.dir_x * shift
    py = steps.y + steps.dir_y * shift
    pz = steps.z + steps.dir_z * shift
    # time advance at the particle's speed (c * beta)
    pt = steps.t + shift / (C_LIGHT * steps.beta)

    wlen = sample_wavelength_dispatch(spectra, steps.source_type, u_wlen)

    n_phase = medium.phase_ref_index(wlen)
    cos_c = torch.clamp(1.0 / (steps.beta * n_phase), max=1.0)
    sin_c = safe_sqrt(1.0 - cos_c * cos_c)
    cdx, cdy, cdz = scatter_direction_by_angle(
        cos_c, sin_c, steps.dir_x, steps.dir_y, steps.dir_z, u_azi)
    # flasher sources (source_type >= 1) keep the step direction untouched
    is_cherenkov = steps.source_type == 0
    ndx = torch.where(is_cherenkov, cdx, steps.dir_x)
    ndy = torch.where(is_cherenkov, cdy, steps.dir_y)
    ndz = torch.where(is_cherenkov, cdz, steps.dir_z)

    inv_gv = 1.0 / medium.group_velocity(wlen)
    h = horizon(cfg)
    if h is not None:
        abs_init = torch.full_like(px, h)
    else:
        abs_init = -torch.log(rng.uniform_oc(u_abs))
    gs = medium.scat_coeff(wlen)
    pa, qa, ra = medium.abs_coeffs(wlen)
    # saveHit weight contract (propagation_kernel.c.cl:370)
    w0 = steps.weight / torch.clamp(wavelength_bias(spectra, wlen), min=1e-20)

    sel = lambda new, old: torch.where(fresh, new, old)
    return state._replace(
        x=sel(px, state.x), y=sel(py, state.y), z=sel(pz, state.z),
        t=sel(pt, state.t),
        dx=sel(ndx, state.dx), dy=sel(ndy, state.dy), dz=sel(ndz, state.dz),
        w0=sel(w0, state.w0), inv_gv=sel(inv_gv, state.inv_gv),
        abs_left=sel(abs_init, state.abs_left),
        gs=sel(gs, state.gs), pa=sel(pa, state.pa), qa=sel(qa, state.qa),
        ra=sel(ra, state.ra)), wlen


def _spawn_records(rstate: RecState, state: SlotState, wlen, fresh):
    """Spawn-time record state of fresh photons (I3Photon start fields);
    `state` already holds the fresh photons."""
    sel = lambda new, old: torch.where(fresh, new, old)
    zero = torch.zeros_like(wlen)
    rings = rstate.rings
    if rings is not None:
        # a fresh photon starts with an empty scatter history
        rings = tuple(torch.where(fresh[:, None], 0.0, r) for r in rings)
    return RecState(
        wlen=sel(wlen, rstate.wlen), abs_init=sel(state.abs_left,
                                                  rstate.abs_init),
        n_scat=sel(zero, rstate.n_scat), dist_abs=rstate.dist_abs,
        start_x=sel(state.x, rstate.start_x),
        start_y=sel(state.y, rstate.start_y),
        start_z=sel(state.z, rstate.start_z),
        start_t=sel(state.t, rstate.start_t),
        start_dx=sel(state.dx, rstate.start_dx),
        start_dy=sel(state.dy, rstate.start_dy),
        start_dz=sel(state.dz, rstate.start_dz),
        total_path=sel(zero, rstate.total_path), rings=rings)


def _record_values(state: SlotState, rstate: RecState, steps: StepBatch,
                   cfg: PropagationConfig, dom_xyz, u, active, hit, absorbed,
                   hit_dist, hit_dom, d_prop, t_hit, w_hit, tbin):
    """The record block (the JAX engine's, engine.py:634-681): which lanes
    record this iteration and the raw record of every lane.

    A lane records at its hit, or with save_all_photons at its absorption
    point (prescaled on u7, dom 0, collision ignored,
    propagation_kernel.c.cl:800-826).  The position is relative to the DOM
    centre moved toward the closest-approach plane, which undoes the
    pancake flattening (propagation_kernel.c.cl:340-355).  Returns
    (rec_mask, raw, dist): raw maps REC_QUEUE_FIELDS and flat_idx (dom *
    n_bins + time bin), weight, dom and slot to (N,) float32 tensors; dist
    is the distance of the record point along the segment."""
    if cfg.save_all_photons:
        rec_mask = active & absorbed
        if cfg.save_all_prescale < 1.0:
            rec_mask = rec_mask & (u[7] < cfg.save_all_prescale)
        dist = d_prop
        dom = torch.zeros_like(hit_dom)
    else:
        rec_mask = hit & active
        dist, dom = hit_dist, hit_dom
    ctr = dom_xyz[dom]
    ddx, ddy, ddz = ctr[:, 0], ctr[:, 1], ctr[:, 2]
    if cfg.pancake_factor != 1.0:
        pxr, pyr, pzr = state.x - ddx, state.y - ddy, state.z - ddz
        par = pxr * state.dx + pyr * state.dy + pzr * state.dz
        f = (cfg.pancake_factor - 1.0) / cfg.pancake_factor
        ddx = ddx + f * (pxr - par * state.dx)
        ddy = ddy + f * (pyr - par * state.dy)
        ddz = ddz + f * (pzr - par * state.dz)
    f32 = lambda a: a.to(torch.float32)
    raw = dict(
        pos_x=state.x + dist * state.dx - ddx,
        pos_y=state.y + dist * state.dy - ddy,
        pos_z=state.z + dist * state.dz - ddz,
        time=t_hit, dir_x=state.dx, dir_y=state.dy, dir_z=state.dz,
        wavelength=rstate.wlen, identifier=f32(steps.identifier),
        start_x=rstate.start_x, start_y=rstate.start_y,
        start_z=rstate.start_z, start_time=rstate.start_t,
        start_dx=rstate.start_dx, start_dy=rstate.start_dy,
        start_dz=rstate.start_dz, inv_gv=state.inv_gv,
        num_scatters=rstate.n_scat,
        dist_in_abs_lens=rstate.abs_init - state.abs_left,
        flat_idx=f32(dom * cfg.hist_n_bins + tbin), weight=w_hit,
        dom=f32(dom), slot=f32(torch.arange(dom.shape[0], device=dom.device)))
    return rec_mask, raw, dist


def _ring_write(acc: Accumulators, rec_mask, raw, rstate: RecState, dist,
                cfg: PropagationConfig) -> Accumulators:
    """Write the masked lanes' records into their rings at rec_count %
    capacity (oldest overwritten), by index: each lane writes only its own
    row, so the scatter is conflict-free and needs no host sync."""
    theta, phi = cart_to_sph(raw["dir_x"], raw["dir_y"], raw["dir_z"])
    s_theta, s_phi = cart_to_sph(raw["start_dx"], raw["start_dy"],
                                 raw["start_dz"])
    vals = dict(raw, dir_theta=theta, dir_phi=phi, start_theta=s_theta,
                start_phi=s_phi, cherenkov_dist=rstate.total_path + dist,
                group_velocity=1.0 / raw["inv_gv"])
    lane = torch.arange(rec_mask.shape[0], device=rec_mask.device)
    pos = (acc.rec_count % cfg.photon_capacity_per_slot).to(torch.int64)
    for k in REC_FIELDS:
        ring = acc.rec[k]
        ring[lane, pos] = torch.where(rec_mask, vals[k], ring[lane, pos])
    if rstate.rings is not None:
        # the photon's scatter history goes with its record
        for k, hist in zip(HIST_FIELDS, rstate.rings):
            ring = acc.rec[k]
            ring[lane, pos] = torch.where(rec_mask[:, None], hist,
                                          ring[lane, pos])
    return acc._replace(rec_count=acc.rec_count + rec_mask.to(torch.int32))


def _ring_append(rings: tuple, n_scat, do_scatter, values) -> tuple:
    """Append one entry per scattering lane to its (N, H) history rings at
    n_scat % H (the oldest overwritten), functionally."""
    H = rings[0].shape[1]
    pos = (n_scat.to(torch.int64) % H)[:, None]
    return tuple(r.scatter(1, pos, torch.where(
        do_scatter, v, r.gather(1, pos)[:, 0])[:, None])
        for r, v in zip(rings, values))


# ---------------------------------------------------------------------------
# layered-ice optical depth walk (propagation_kernel.c.cl:598-696)
# ---------------------------------------------------------------------------

def _segment_distances(state: SlotState, medium: MediumProperties,
                       cfg: PropagationConfig, sca_budget, abs_budget,
                       with_score: bool = False, tally: Optional[dict] = None,
                       active=None):
    """Convert the scattering budget (in scattering lengths) and absorption
    budget (in absorption lengths, anisotropy-corrected) to meters through
    the layered medium, both capped at cfg.max_segment_m.

    Returns (d_prop, absorbed, scattered, abs_left_after): d_prop is the
    distance this segment covers before collision limiting, abs_left_after
    the remaining (corrected) absorption budget after d_prop.

    with_score also returns (tau_s_traced, inv_s_fin, t_done), the
    ingredients of the segment's scattering log-likelihood: the scattering
    depth of the completed layer crossings with the coefficients traced and
    the crossing lengths detached, the final layer's scattering
    coefficient, and the distance of the completed crossings
    (clsim_tpu/propagate/engine.py:201-340).

    `tally` (a dict) gains "walk", the walk steps of the `active` lanes:
    crossings + 1, at most max_layer_steps + 1 a lane, the CUDA kernel's
    CNT_WALK.  It changes none of the outputs."""
    T = medium.layer_height
    L = medium.n_layers

    shift = tilt_z_shift(medium.tilt, state.x, state.y, state.z)
    z_eff = state.z - shift
    j0 = medium.layer_for_z(z_eff)

    dz = state.dz
    going_up = dz >= 0.0
    dirsign = torch.where(going_up, 1, -1)
    abs_dz = torch.abs(dz)
    vertical = abs_dz < EPSILON

    big = torch.full_like(dz, BIG)
    boundary_z = medium.layer_bottom_z(j0) + torch.where(
        going_up, T, torch.zeros_like(T))
    safe_dz = torch.where(vertical, torch.ones_like(dz), dz)
    t_bound0 = torch.where(vertical, big, (boundary_z - z_eff) / safe_dz)
    # photons outside the layer grid can get a negative first boundary
    # distance; the reference's walk never runs in that situation either
    t_bound0 = torch.where(t_bound0 < 0.0, big, t_bound0)
    t_step = torch.where(vertical, big, T / torch.clamp(abs_dz, min=1e-20))

    def layer_vals(k):
        """(inv_s, inv_a) of layer j0 + k*dirsign, edge-clamped."""
        j = torch.clamp(j0 + k * dirsign, 0, L - 1)
        return (state.gs * medium.b400[j],
                state.pa * medium.a_dust400[j] + state.qa
                + state.ra * medium.delta_tau[j])

    K = cfg.max_layer_steps
    max_seg = cfg.max_segment_m
    zeros = torch.zeros_like(dz)
    t_done, t_bound = zeros, t_bound0
    tau_s, tau_a = sca_budget, abs_budget
    done = torch.zeros_like(going_up)
    d_scat, d_abs = zeros, zeros
    inv_a = torch.ones_like(dz)
    tau_s_traced, inv_s_fin = zeros, torch.ones_like(dz)
    for k in range(K + 1):
        if tally is not None:
            tally["walk"] = tally.get("walk", 0) + (~done & active).sum()
        inv_s_k, inv_a_k = layer_vals(k)
        d_s = t_done + tau_s / inv_s_k
        d_a = t_done + tau_a / inv_a_k
        # stop walking at the extreme layers (the reference extends them to
        # infinity), when either budget exhausts before the boundary, or
        # once past the segment cap
        cur_j = j0 + k * dirsign
        at_edge = torch.where(going_up, cur_j >= L - 1, cur_j <= 0)
        exhaust = t_bound >= torch.minimum(d_s, d_a)
        past_cap = t_bound >= max_seg
        cross = (~done) & (~at_edge) & (~exhaust) & (~past_cap)
        finalize = (~done) & (~cross)

        d_scat = torch.where(finalize, d_s, d_scat)
        d_abs = torch.where(finalize, d_a, d_abs)
        inv_a = torch.where(finalize, inv_a_k, inv_a)
        if with_score:
            inv_s_fin = torch.where(finalize, inv_s_k, inv_s_fin)

        dt = t_bound - t_done
        tau_s = torch.where(cross, tau_s - dt * inv_s_k, tau_s)
        tau_a = torch.where(cross, tau_a - dt * inv_a_k, tau_a)
        if with_score:
            tau_s_traced = torch.where(
                cross, tau_s_traced + dt.detach() * inv_s_k, tau_s_traced)
        t_done = torch.where(cross, t_bound, t_done)
        t_bound = torch.where(cross, t_bound + t_step, t_bound)
        done = done | finalize
    # lanes that crossed K+1 times without finalizing: close them in the
    # outermost layer of the window
    inv_s_last, inv_a_last = layer_vals(K)
    d_scat = torch.where(done, d_scat, t_done + tau_s / inv_s_last)
    d_abs = torch.where(done, d_abs, t_done + tau_a / inv_a_last)
    inv_a = torch.where(done, inv_a, inv_a_last)
    if with_score:
        inv_s_fin = torch.where(done, inv_s_fin, inv_s_last)

    absorbed = d_abs < d_scat
    d_prop = torch.clamp(torch.minimum(d_scat, d_abs), max=max_seg)
    capped = (~absorbed & (d_scat > max_seg)) | (absorbed & (d_abs > max_seg))
    absorbed = absorbed & ~capped
    scattered = (~absorbed) & (~capped)

    # score mode: the sampled segment length belongs to the trajectory law
    # that the score term carries; letting it also flow into the absorption
    # bookkeeping would count it twice (engine.py:326-333 of the JAX package)
    d_for_abs = d_prop.detach() if with_score else d_prop
    abs_left_after = torch.clamp(tau_a - (d_for_abs - t_done) * inv_a, min=0.0)
    abs_left_after = torch.where(absorbed, zeros, abs_left_after)
    if with_score:
        return (d_prop, absorbed, scattered, abs_left_after,
                (tau_s_traced, inv_s_fin, t_done))
    return d_prop, absorbed, scattered, abs_left_after


# ---------------------------------------------------------------------------
# collision detection (sparse_collision_kernel.c.cl)
# ---------------------------------------------------------------------------

def _check_collisions_bruteforce(state: SlotState, geo: DetectorGeometry,
                                 cfg: PropagationConfig, d_prop, active):
    """O(N x D) exact sphere test against every DOM -- the validation oracle
    for the culled path and the right choice for small test geometries."""
    R = geo.collision_radius
    ox = geo.dom_x[None, :] - state.x[:, None]
    oy = geo.dom_y[None, :] - state.y[:, None]
    oz = geo.dom_z[None, :] - state.z[:, None]
    dr2 = ox * ox + oy * oy + oz * oz
    urdot = (ox * state.dx[:, None] + oy * state.dy[:, None]
             + oz * state.dz[:, None])
    discr = urdot * urdot - dr2 + R * R
    sq = safe_sqrt(discr) / cfg.pancake_factor
    smin1 = urdot - sq
    has_xy = (state.dx * state.dx + state.dy * state.dy) > 0.0
    good = (discr >= 0.0) & (urdot + sq >= 0.0) & (smin1 >= 0.0) \
        & (smin1 < d_prop[:, None]) & active[:, None] & has_xy[:, None]
    smin1 = torch.where(good, smin1, torch.full_like(smin1, BIG))
    best, hit_dom = torch.min(smin1, dim=1)
    hit = best < BIG
    hit_dist = torch.where(hit, best, d_prop)
    return hit, hit_dist, hit_dom


def _check_collisions(state: SlotState, geo: DetectorGeometry,
                      cfg: PropagationConfig, d_prop, active):
    """Find the closest DOM intersection within d_prop along the ray: a dense
    2-D cull + z cull over all strings, then the sphere test against every
    DOM slot of the top-K nearest candidate strings.

    Returns (hit, hit_dist, hit_dom): hit_dist <= d_prop is the entry-point
    distance smin1 (sparse_collision_kernel.c.cl:109-158), hit_dom the flat
    DOM index."""
    x, y, z = state.x, state.y, state.z
    dx, dy, dz = state.dx, state.dy, state.dz
    n = x.shape[0]
    R = geo.collision_radius
    R2 = R * R
    pancake = cfg.pancake_factor

    dir_xy2 = dx * dx + dy * dy
    has_xy = dir_xy2 > 0.0
    inv_dir_xy2 = 1.0 / torch.clamp(dir_xy2, min=1e-20)

    # ---- 2D string cull + ranking (dense over all strings) ----
    sx = geo.string_x[None, :]   # (1, S)
    sy = geo.string_y[None, :]
    rx = sx - x[:, None]         # (N, S)
    ry = sy - y[:, None]
    # closest approach of the 2D ray, clamped to the STATIC segment cap (the
    # cull ranks independently of this segment's d_prop, as in the kernel)
    t2d = torch.clamp((rx * dx[:, None] + ry * dy[:, None])
                      * inv_dir_xy2[:, None], 0.0, cfg.max_segment_m)
    cx = x[:, None] + dx[:, None] * t2d - sx
    cy = y[:, None] + dy[:, None] * t2d - sy
    dist2 = cx * cx + cy * cy

    pass_r = dist2 <= (geo.string_max_r[None, :] ** 2)
    # z cull (…OnString, sparse_collision_kernel.c.cl:67-70)
    pass_z = ~((dz[:, None] > 0) & (z[:, None] > geo.string_max_z[None, :] + R)) \
        & ~((dz[:, None] < 0) & (z[:, None] < geo.string_min_z[None, :] - R))
    candidate = pass_r & pass_z & has_xy[:, None] & active[:, None]
    ranked = torch.where(candidate, dist2, torch.full_like(dist2, BIG))

    hit_found = torch.zeros(n, dtype=torch.bool, device=x.device)
    hit_dist = d_prop
    hit_dom = torch.zeros(n, dtype=torch.int64, device=x.device)

    M = geo.string_dom_rel.shape[1]
    slot_iota = torch.arange(M, dtype=torch.float32, device=x.device)[None, :]
    feats_all = geo.string_features[:, (0, 1, 4, 5, 6)]
    for _k in range(cfg.strings_per_photon):
        s_min, s_idx = torch.min(ranked, dim=1)                   # (N,)
        s_ok = s_min < BIG
        ranked = ranked.scatter(1, s_idx[:, None], BIG)

        feats = feats_all[s_idx]                                  # (N, 5)
        rel = geo.string_dom_rel[s_idx]                           # (N, M, 4)
        dom_xx = feats[:, 0:1] + rel[:, :, 0]
        dom_yy = feats[:, 1:2] + rel[:, :, 1]
        dom_zz = feats[:, 2:3] + feats[:, 3:4] * slot_iota + rel[:, :, 2]
        slot_dom = feats[:, 4:5] + slot_iota                      # flat idx
        ox = dom_xx - x[:, None]
        oy = dom_yy - y[:, None]
        oz = dom_zz - z[:, None]
        valid = (rel[:, :, 3] > 0.5) & s_ok[:, None]

        dr2 = ox * ox + oy * oy + oz * oz
        urdot = ox * dx[:, None] + oy * dy[:, None] + oz * dz[:, None]
        discr = urdot * urdot - dr2 + R2
        sq = safe_sqrt(discr) / pancake
        smin1 = urdot - sq
        smin2 = urdot + sq
        good = valid & (discr >= 0.0) & (smin2 >= 0.0) & (smin1 >= 0.0) \
            & (smin1 < hit_dist[:, None])
        sm = torch.where(good, smin1, torch.full_like(smin1, BIG))
        best, jm = torch.min(sm, dim=1)
        dom_best = slot_dom.gather(1, jm[:, None])[:, 0]

        found = best < BIG
        hit_found = hit_found | found
        hit_dom = torch.where(found, dom_best.to(torch.int64), hit_dom)
        hit_dist = torch.where(found, best, hit_dist)

    return hit_found, hit_dist, hit_dom


# ---------------------------------------------------------------------------
# one propagation loop iteration
# ---------------------------------------------------------------------------

def _score_of_scatter(medium: MediumProperties, cos_s, u_branch):
    """Log-density of the sampled scattering angle under the Liu / HG
    mixture, with the sample detached and the phase-function parameters
    traced (the angle part of the score, engine.py:736-751 of the JAX
    package)."""
    g = medium.scattering.mean_cos
    f = medium.scattering.liu_fraction
    c = cos_s.detach()
    beta_l = (1.0 - g) / (1.0 + g)
    half = torch.clamp((1.0 + c) * 0.5, 1e-12, 1.0)
    log_liu = -torch.log(2.0 * beta_l) + (1.0 / beta_l - 1.0) * torch.log(half)
    denom = torch.clamp(1.0 + g * g - 2.0 * g * c, min=1e-12)
    log_hg = (torch.log(torch.clamp(0.5 * (1.0 - g * g), min=1e-30))
              - 1.5 * torch.log(denom))
    fcl = torch.clamp(f, 1e-12, 1.0 - 1e-12)
    return torch.where(u_branch < f, torch.log(fcl) + log_liu,
                       torch.log(1.0 - fcl) + log_hg)


def _scatter_cos(medium: MediumProperties, u):
    """cos of the scattering angle from u5 (branch) and u6 (sample): the
    Liu / HG mixture, or for water the Rayleigh cubic mixed with the
    tabulated (Petzold) angle, cos applied to the sampled angle
    (clsim_tpu/propagate/engine.py:711-724)."""
    sc = medium.scattering
    if sc.kind == "icecube":
        return mixed_cos(sc.mean_cos, sc.liu_fraction, u[5], u[6])
    angle = sample_interpolated_fast(sc.table_cos, sc.table_cdf[0],
                                     sc.table_cdf[1], u[6])
    return torch.where(u[5] < sc.liu_fraction, rayleigh_cos(u[6]),
                       torch.cos(angle))


def _deposit(hist, cfg: PropagationConfig, hit, hit_dom, t_hit, w_hit):
    """Add the iteration's deposits to the flat histogram (functional
    index_add: the histogram may carry gradients).  Misses add weight 0 to
    bin 0 of DOM 0, which keeps the deposit free of host syncs.  Returns
    (hist, time bin of each lane)."""
    nb = cfg.hist_n_bins
    tbin_f = (t_hit - cfg.hist_t_min) / cfg.hist_dt
    base = hit_dom * nb
    if not cfg.soft_binning:
        tbin = torch.clamp(tbin_f, 0.0, nb - 1).to(torch.int64)
        idx = torch.where(hit, base + tbin, torch.zeros_like(tbin))
        return hist.index_add(0, idx, w_hit), tbin
    # soft binning: split linearly between the bin and its upper neighbour
    fl = torch.floor(tbin_f)
    frac_hi = torch.clamp(tbin_f - fl, 0.0, 1.0)
    lo = torch.clamp(fl, 0.0, nb - 1).to(torch.int64)
    hi = torch.clamp(lo + 1, max=nb - 1)
    zero = torch.zeros_like(lo)
    hist = hist.index_add(0, torch.where(hit, base + lo, zero),
                          w_hit * (1.0 - frac_hi))
    hist = hist.index_add(0, torch.where(hit, base + hi, zero),
                          w_hit * frac_hi)
    return hist, lo


def _iteration(i, state: SlotState, acc: Accumulators, steps: StepBatch,
               medium: MediumProperties, geo: Optional[DetectorGeometry],
               spectra: SpectrumTable, cfg: PropagationConfig,
               generator: Optional[torch.Generator] = None, uniforms=None,
               collide=None, rstate: Optional[RecState] = None,
               dom_xyz=None, emit=None, enabled=None,
               score: Optional[ScoreState] = None,
               tally: Optional[dict] = None):
    """One iteration over all slots.  `uniforms`: a (T, 8, N) tensor
    (iteration i reads row i) or a callable i -> (8, N) block (the threefry
    modes); otherwise an (8, N) block is drawn from `generator`.  `collide`
    replaces the dense collision test: collide(state, d_prop, active) ->
    (hit, hit_dist, hit_dom) (the kernel's plain version passes its
    SubPlan test).

    With cfg.save_photons, `rstate` and `dom_xyz` ((n_doms, 3) DOM
    centres) are required; the iteration's records go to the rings in
    `acc`, or, when `emit` is given, to emit(rec_mask, raw) (see
    _record_values).  `enabled` ((N,) bool) leaves the other lanes
    untouched this iteration.  `score` is required when uses_score(cfg).
    `tally` (a dict) gains the layer-walk steps ("walk",
    _segment_distances) and, in sea water (a tabulated scattering angle),
    the scatters ("scat") and those below the u5 branch threshold
    ("rayleigh"): the CUDA kernel's counts.  Returns (state, acc, rstate,
    score)."""
    n = state.x.shape[0]
    if callable(uniforms):
        u = uniforms(i)
    elif uniforms is not None:
        u = uniforms[i]
    else:
        u = torch.rand((8, n), generator=generator, device=state.x.device,
                       dtype=torch.float32)
    expected = cfg.estimator == "expected"
    detach = expected and cfg.detach_trajectories
    use_score = uses_score(cfg)

    # --- spawn new photons into empty slots ---
    fresh = (state.in_flight < 0.5) & (state.photons_left > 0.5)
    if enabled is not None:
        fresh = fresh & enabled
    state, wlen = _create_photons(state, steps, medium, spectra, cfg, u,
                                  fresh)
    if rstate is not None:
        rstate = _spawn_records(rstate, state, wlen, fresh)
    if use_score:
        # a fresh photon starts with an empty sampled-event log-likelihood
        score = ScoreState(log_lik=torch.where(
            fresh, torch.zeros_like(score.log_lik), score.log_lik))
    freshf = fresh.to(state.x.dtype)
    state = state._replace(in_flight=torch.maximum(state.in_flight, freshf),
                           photons_left=state.photons_left - freshf)
    active = state.in_flight > 0.5
    if enabled is not None:
        active = active & enabled
    acc = acc._replace(
        n_generated=acc.n_generated + fresh.sum(),
        n_work=acc.n_work + active.sum())

    # --- anisotropy correction in/out (propagation_kernel.c.cl:615-694) ---
    abs_corr = abs_len_scaling(medium.anisotropy, state.dx, state.dy, state.dz)
    sca_budget = -torch.log(rng.uniform_oc(u[4]))
    abs_budget = state.abs_left * abs_corr

    if use_score:
        d_prop, absorbed, scattered, abs_left, (tau_acc, inv_s_fin, t_done) \
            = _segment_distances(state, medium, cfg, sca_budget, abs_budget,
                                 with_score=True, tally=tally, active=active)
        # this segment's scattering depth: traced coefficients times the
        # detached geometry
        tau_seg_s = tau_acc + torch.clamp(
            (torch.clamp(d_prop, max=cfg.max_segment_m) - t_done).detach(),
            min=0.0) * inv_s_fin
    else:
        d_prop, absorbed, scattered, abs_left = _segment_distances(
            state, medium, cfg, sca_budget, abs_budget, tally=tally,
            active=active)
    if detach:
        # detached sampling: the path geometry is a fixed sample; gradients
        # flow through the optical-depth weights, not chaotic positions
        d_prop = d_prop.detach()

    # --- collisions ---
    if collide is not None:
        hit, hit_dist, hit_dom = collide(state, d_prop, active)
    elif cfg.collision_mode == "bruteforce":
        hit, hit_dist, hit_dom = _check_collisions_bruteforce(
            state, geo, cfg, d_prop, active)
    else:
        hit, hit_dist, hit_dom = _check_collisions(state, geo, cfg, d_prop,
                                                   active)
    hit = hit & active

    # absorption depth of this segment (uncorrected units) and before it,
    # for the expected estimator, taken before the stopping rule zeroes it
    tau_seg = state.abs_left - abs_left / abs_corr

    if cfg.stop_on_detection and not expected:
        d_prop = torch.where(hit, hit_dist, d_prop)
        absorbed = absorbed & ~hit
        scattered = scattered & ~hit
        abs_left = torch.where(hit, torch.zeros_like(abs_left), abs_left)

    abs_left = abs_left / abs_corr

    # --- deposit hits ---
    w_hit = torch.where(hit, state.w0, torch.zeros_like(state.w0))
    if expected:
        # continuous absorption: every DOM entry deposits the survival
        # probability to the entry point, interpolated within the segment
        # (propagation_kernel.c.cl:289-290); the photon passes through.
        # where-guarded division: max(d, eps) would leave 1/eps^2 in the
        # tangents of dead lanes (d_prop == 0)
        tau_start = horizon(cfg) - state.abs_left
        has_dp = d_prop > 0.0
        frac = torch.where(
            has_dp, hit_dist / torch.where(has_dp, d_prop,
                                           torch.ones_like(d_prop)),
            torch.zeros_like(d_prop))
        w_hit = w_hit * torch.exp(-(tau_start + frac * tau_seg))
        if use_score:
            # likelihood-ratio factor exp(L - sg L) == 1 in the primal; its
            # gradient is the score of every sampled event up to the deposit
            l_dep = score.log_lik - frac.detach() * tau_seg_s
            w_hit = w_hit * torch.exp(l_dep - l_dep.detach())
        if cfg.expected_angular_poly is not None:
            # the DOM's angular acceptance, folded in where the direction is
            # known (I3PhotonToMCPEConverter.cxx:466-475)
            ax, ay, az = cfg.pmt_axis
            cos_eta = torch.clamp(-(state.dx * ax + state.dy * ay
                                    + state.dz * az), -1.0, 1.0)
            ang = torch.zeros_like(cos_eta)
            for c in reversed(cfg.expected_angular_poly):
                ang = ang * cos_eta + c
            w_hit = w_hit * torch.clamp(ang, min=0.0)
    t_hit = state.t + state.inv_gv * hit_dist
    hist, tbin = _deposit(acc.hist, cfg, hit, hit_dom, t_hit, w_hit)
    acc = acc._replace(
        hist=hist,
        n_hits=acc.n_hits + hit.sum(),
        weight_hits=acc.weight_hits + w_hit.sum(dtype=torch.float64))

    # --- photon records ---
    if cfg.save_photons:
        rec_mask, raw, rdist = _record_values(
            state, rstate, steps, cfg, dom_xyz, u, active, hit, absorbed,
            hit_dist, hit_dom, d_prop, t_hit, w_hit, tbin)
        rstate = rstate._replace(dist_abs=torch.where(
            rec_mask, raw["dist_in_abs_lens"], rstate.dist_abs))
        if emit is not None:
            emit(rec_mask, raw)
        else:
            acc = _ring_write(acc, rec_mask, raw, rstate, rdist, cfg)

    # --- advance ---
    dp = torch.where(active, d_prop, torch.zeros_like(d_prop))
    state = state._replace(
        x=state.x + state.dx * dp,
        y=state.y + state.dy * dp,
        z=state.z + state.dz * dp,
        t=state.t + state.inv_gv * dp,
        abs_left=torch.where(active, abs_left, state.abs_left))
    if rstate is not None:
        rstate = rstate._replace(total_path=rstate.total_path + dp)

    # --- scatter survivors ---
    do_scatter = scattered & active
    if tally is not None and medium.scattering.kind != "icecube":
        rayleigh = do_scatter & (u[5] < medium.scattering.liu_fraction)
        tally["scat"] = tally.get("scat", 0) + do_scatter.sum()
        tally["rayleigh"] = tally.get("rayleigh", 0) + rayleigh.sum()
    pdx, pdy, pdz = pre_scatter_transform(medium.anisotropy,
                                          state.dx, state.dy, state.dz)
    cos_s = _scatter_cos(medium, u)
    if use_score:
        # this segment's sampled-event log-likelihood: the survival over
        # the traveled distance, and for scattered lanes the distance
        # density's log b_eff and the angle density at the detached cosine
        # (a tabulated water phase function carries no parametric angle
        # score, clsim_tpu/propagate/engine.py:752)
        log_s = torch.log(torch.clamp(inv_s_fin, min=1e-30))
        if medium.scattering.kind == "icecube":
            log_s = log_s + _score_of_scatter(medium, cos_s, u[5])
        d_l = -tau_seg_s + torch.where(scattered, log_s,
                                       torch.zeros_like(tau_seg_s))
        score = ScoreState(log_lik=torch.where(
            active, score.log_lik + d_l, score.log_lik))
    sin_s = safe_sqrt(1.0 - cos_s * cos_s)
    sdx, sdy, sdz = scatter_direction_by_angle(cos_s, sin_s, pdx, pdy, pdz,
                                               u[7])
    sdx, sdy, sdz = post_scatter_transform(medium.anisotropy, sdx, sdy, sdz)
    if detach:
        sdx, sdy, sdz = sdx.detach(), sdy.detach(), sdz.detach()
    state = state._replace(
        dx=torch.where(do_scatter, sdx, state.dx),
        dy=torch.where(do_scatter, sdy, state.dy),
        dz=torch.where(do_scatter, sdz, state.dz))
    if rstate is not None:
        if rstate.rings is not None:
            # ring-append the scatter point and its depth in absorption
            # lengths (propagation_kernel.c.cl:833-837)
            rstate = rstate._replace(rings=_ring_append(
                rstate.rings, rstate.n_scat, do_scatter,
                (state.x, state.y, state.z,
                 rstate.abs_init - state.abs_left)))
        rstate = rstate._replace(n_scat=rstate.n_scat + do_scatter.to(
            rstate.n_scat.dtype))

    # --- retire absorbed / detected photons (the reference kills a photon
    # whenever its remaining budget drops below EPSILON,
    # propagation_kernel.c.cl:536-596) ---
    died = active & (absorbed | (state.abs_left < EPSILON))
    if cfg.stop_on_detection and not expected:
        died = died | hit
    state = state._replace(in_flight=torch.where(
        died, torch.zeros_like(state.in_flight), state.in_flight))
    return state, acc, rstate, score


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _init_state(steps: StepBatch) -> SlotState:
    n = steps.x.shape[0]
    dev = steps.x.device
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    # benign finite coefficients for never-spawned slots (every use is gated
    # on in_flight)
    return SlotState(
        photons_left=steps.num_photons.to(torch.float32),
        in_flight=zf, x=zf, y=zf, z=zf, t=zf, dx=zf, dy=zf, dz=ones,
        w0=zf, inv_gv=torch.full((n,), 1.0 / 0.2, dtype=torch.float32,
                                 device=dev),
        abs_left=zf, gs=ones, pa=zf, qa=ones, ra=zf)


def _init_rec_state(n: int, device, history_entries: int = 0) -> RecState:
    zf = torch.zeros(n, dtype=torch.float32, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    rings = None
    if history_entries > 0:
        rings = tuple(torch.zeros((n, history_entries), dtype=torch.float32,
                                  device=device) for _ in HIST_FIELDS)
    return RecState(wlen=torch.full((n,), 400.0, device=device),
                    abs_init=ones, n_scat=zf, dist_abs=zf, start_x=zf,
                    start_y=zf, start_z=zf, start_t=zf, start_dx=zf,
                    start_dy=zf, start_dz=ones, total_path=zf, rings=rings)


def _init_acc(n_doms: int, cfg: PropagationConfig, device,
              n_rings: int = 0) -> Accumulators:
    """Accumulators; with n_rings > 0 (and cfg.save_photons) also record
    rings for that many slots."""
    z64 = lambda: torch.zeros((), dtype=torch.float64, device=device)
    rec = rec_count = None
    if cfg.save_photons and n_rings > 0:
        shape = (n_rings, cfg.photon_capacity_per_slot)
        rec = {f: torch.zeros(shape, dtype=torch.float32, device=device)
               for f in REC_FIELDS}
        if cfg.photon_history_entries > 0:
            hshape = shape + (cfg.photon_history_entries,)
            rec.update({f: torch.zeros(hshape, dtype=torch.float32,
                                       device=device) for f in HIST_FIELDS})
        rec_count = torch.zeros(n_rings, dtype=torch.int32, device=device)
    return Accumulators(
        hist=torch.zeros(n_doms * cfg.hist_n_bins, dtype=torch.float32,
                         device=device),
        n_generated=z64(), n_hits=z64(), weight_hits=z64(), n_work=z64(),
        rec_count=rec_count, rec=rec)


def dom_centres(geo: DetectorGeometry) -> torch.Tensor:
    """(n_doms, 3) float32 DOM centres (the record block's origin)."""
    return torch.stack([geo.dom_x, geo.dom_y, geo.dom_z], 1).to(
        torch.float32)


def propagate(steps: StepBatch, medium: MediumProperties,
              geo: DetectorGeometry, spectra: SpectrumTable,
              seed: int, cfg: PropagationConfig,
              max_iterations: int = 0,
              uniforms=None, key=None) -> PropagationResult:
    """Propagate all photons of a slot-assigned step batch (tensors on one
    device; one step per slot, see sources.assign_steps_to_slots).

    With max_iterations == 0 the loop runs until every slot is drained;
    a positive value runs exactly that many iterations.  Random numbers
    come from a torch.Generator seeded with `seed`, unless
      * `uniforms` ((T, 8, N) float32) replaces the stream and sets T
        iterations: the shared-stream contract with the JAX engine and the
        kernel, or
      * `key` (a threefry key, ops/rng.py) draws iteration i's block as
        rng.uniforms(rng.iter_key(key, i), (N,), 8): the JAX engine's
        stream for the same key.
    With cfg.save_photons the result carries the record rings
    (photon_capacity_per_slot per slot), and with photon_history_entries
    also each record's scatter history (HIST_FIELDS).  Differentiable with
    respect to the medium tensors (see the module docstring)."""
    check_supported(cfg, medium)
    check_source_types(*source_type_range(steps.source_type),
                       int(spectra.x.shape[0]))
    if uniforms is not None and key is not None:
        raise ValueError("uniforms and key are exclusive")
    device = steps.x.device
    n = steps.x.shape[0]
    generator = None
    if uniforms is not None:
        max_iterations = int(uniforms.shape[0])
    elif key is not None:
        k = rng.as_key(key, device)
        uniforms = lambda i: rng.uniforms(rng.iter_key(k, i), (n,), 8)
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    state = _init_state(steps)
    acc = _init_acc(geo.n_doms, cfg, device, n_rings=n)
    rstate = dom_xyz = score = None
    if cfg.save_photons:
        rstate = _init_rec_state(n, device, cfg.photon_history_entries)
        dom_xyz = dom_centres(geo)
    if uses_score(cfg):
        score = ScoreState(log_lik=torch.zeros(n, dtype=torch.float32,
                                               device=device))

    i = 0
    while True:
        if max_iterations > 0:
            if i >= max_iterations:
                break
        elif not bool(((state.in_flight > 0.5)
                       | (state.photons_left > 0.5)).any()):
            break
        state, acc, rstate, score = _iteration(
            i, state, acc, steps, medium, geo, spectra, cfg,
            generator=generator, uniforms=uniforms, rstate=rstate,
            dom_xyz=dom_xyz, score=score)
        i += 1

    return PropagationResult(
        hist=acc.hist.reshape(geo.n_doms, cfg.hist_n_bins),
        n_generated=acc.n_generated,
        n_hits=acc.n_hits,
        weight_hits=acc.weight_hits,
        n_iterations=i, rec_count=acc.rec_count, rec=acc.rec)
