"""The fused propagation kernel's host side, its plain version and its
wrapper (PyTorch counterpart of clsim_tpu.propagate.kernel).

The JAX package runs `iters_per_call` propagation iterations per launch of
one Pallas kernel (clsim_tpu/propagate/kernel.py::_make_kernel).  Here the
same work is the hand-written CUDA kernel csrc/propagate.cu: one thread per
photon slot, which spawns, walks the layers, tests for collision, deposits
its hit into the histogram with atomicAdd and scatters, up to
`iters_per_call` times per launch.  There is no hit queue, so
compact_scatter_add and the queue flush have no counterpart and
CNT_DROPPED is always 0.

Photon records (spec.records, B5) are the kernel's RECORDS instantiation:
the record state rides as extra state rows, and each record is appended to
a device buffer of REC_COLUMNS rows whose capacity per launch the call
loop chooses.  A thread whose record finds the buffer full keeps it pending in
its state and leaves its loop; the next launch writes it first, so no
record is lost (the CUDA form of the TPU kernel's pending registers).

This module holds
  * the collision planning, ported from the JAX package (numpy; the same
    SubPlans and cell tables),
  * build_tables: flat float32 tables for the kernel (per-layer arrays,
    spectrum CDF, bias grid, tilt grid, per-SubPlan cell->candidate table
    [sx, sy, maxr^2, dom_offset] or the global plan's card table, one
    list per fine cell and azimuth sector, which the kernel and its plain
    version both read, the DOM residual and per-string tables, the
    wavelength tables of a tabulated medium and the scattering-angle CDF),
  * run_fused_iterations: the wrapper.  On CUDA tensors it launches the
    kernel (or raises); on CPU tensors it runs run_fused_iterations_plain,
    the same function in plain PyTorch built on engine._iteration,
  * plan_call: the spec and the tables of a call, in a geometry part and a
    medium part, each kept while its inputs are the same objects with
    their tensors unedited, so that a stream of batches plans once,
  * propagate_fused / _run_fused: the call loop that launches the kernel
    until no slot is alive or max_calls is reached, repacking the slots
    between launches (repack_slots, the JAX do_repack) and launching the
    next call over the live prefix alone (the kernel's n_active).

The expected estimator (spec.expected: survival-weight deposits, soft
binning, the angular polynomial, whose coefficients the kernel reads from a
device table of any length), non-stopping detect and the fixed absorption
horizon (B6) are the kernel's deposit modes, and in-kernel threefry
(spec.threefry, B8b) its third random-number mode, in every deposit mode
and with records: the kernel reads a (2T,) table of per-iteration keys
folded on the host by ops/rng.py and draws bit-exactly the stream of
rng.uniforms, so the engine run with the same key (the fit's backward,
propagate/diff.py, or a golden's slot batch) consumes the same numbers
without a materialized (T, 8, N) stream.

Collision (B3) and media (B7) are the kernel's COLL and MED template
arguments (kernel_coll / kernel_med): COLL 0 the per-subdetector SubPlans,
1 the global cell plan with the analytic candidate-DOM test (affine
geometries that SubPlans refuse, such as IceCube with DeepCore at the
default 90 m segment cap), 2 the global cell plan with the dense test over
every DOM of a string (surveyed geometries, off the z0 + m*dz ladder); MED
0 the closed-form icecube medium, 1 tabulated wavelength factors (water or
photonics-table ice) with the Liu/HG scattering mixture, 2 tabulated
factors with the tabulated (Petzold) angle mixed with Rayleigh (sea
water), 3 the closed-form factors with the tabulated angle mixed with
Rayleigh (B5: e.g. the Antares angle on IceCube ice).  Every (COLL, MED)
pair is built with every deposit mode, each with Philox or an external
stream and with threefry: stopping detect with or without records,
non-stopping detect, the fixed horizon, the expected estimator.

Stacked spectra (flashers, B4) are read per slot: the kernel offsets its
(n_tables, 3, n_spec) spectrum table by the step's source_type and
locates the wavelength in that table alone, as the engine's
sample_wavelength_dispatch does; a non-uniform bias grid is located by
binary search over its (2, n_bias) table.  A source_type without a
stacked spectrum is refused on the host (check_source_types), so the
kernel never reads past its table.  Tilt and anisotropy may be on or off,
and photon records (with SAVE_ALL and its prescale) may be on with
stopping detect.  spec_unsupported() names why any other configuration is
refused (records with the B6 modes and a one-point bias grid, as in the
JAX package; the static limits of the collision loops and the tilt grid),
and the wrapper raises rather than fall back.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import DetectorGeometry, to_numpy as _to_numpy
from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.rotations import cart_to_sph
from ..ops.spectrum import SpectrumTable, check_source_types
from ..types import PropagationConfig, StepBatch, tensor_leaves
from ..util import profiling as P
from . import engine as E


def to_numpy(a, dtype=None):
    """geometry.to_numpy, its read a "wait" span of site "to_numpy": the
    plan's host copies of the geometry's and the medium's tensors."""
    with P.wait("to_numpy"):
        return _to_numpy(a, dtype)


STATE_FIELDS = list(E.SlotState._fields)
NSF = len(STATE_FIELDS)
# extra state rows of the record mode: the record state (without the
# engine-only total_path and scatter-history rings) and `pend`, the flat
# (dom, time-bin) index of a record that did not fit into its launch's
# buffer (-1: none).  A recorded photon is dead, so x/y/z hold its record
# position, t its time, and the pending record is rebuilt from the state
# rows.
_ENGINE_REC = ("total_path", "rings")
REC_STATE_FIELDS = [f for f in E.RecState._fields
                    if f not in _ENGINE_REC] + ["pend"]
NRSF = len(REC_STATE_FIELDS)
STEP_FIELDS = ["x", "y", "z", "t", "dir_x", "dir_y", "dir_z",
               "length", "beta", "weight", "source_type", "identifier"]
NST = len(STEP_FIELDS)

# columns of one record in the device buffer (float32 each): the JAX
# kernel's 19 queue fields, the flat (dom, time-bin) index, the weight and
# the slot (an internal column: records land in no fixed order, and tests
# match them on (slot, dom))
REC_QUEUE_FIELDS = E.REC_QUEUE_FIELDS
REC_COLUMNS = REC_QUEUE_FIELDS + ["flat_idx", "weight", "slot"]
NRC = len(REC_COLUMNS)

# counter vector layout, as in the JAX package (CNT_DROPPED stays 0: hits
# go straight into the histogram; CNT_QUEUED counts deposited hits, or in
# record mode the records written), plus CNT_STALLED: launches whose
# record buffer filled (their stalled records went to the next launch), and
# the data-dependent work of the B3 and B7 paths that their bound counts
# (0 elsewhere): of the global plans, CNT_TESTED strings given the
# ray-sphere test, CNT_CAND candidates of the cells' lists culled, CNT_CULL
# those that passed the 2-D cull (and got the z pass), CNT_ROWS DOMs given
# the sphere test; of sea water, CNT_SCAT scatters and CNT_RAYLEIGH those
# that drew the Rayleigh branch.  Every instantiation counts CNT_WALK, the
# layer-walk steps of live slot-iterations (crossings + 1, at most
# max_layer_steps + 1 each), and two diagnostics of its own that the plain
# version leaves 0: CNT_WARPS, warp-iterations with a live lane,
# CNT_SPAWN_WARPS, warp-iterations that ran the spawn path, and each warp's
# clock cycles (lane 0's) in the block's barriers (CNT_WAIT), in the
# propagate stage (CNT_PROP) and in the spawn stage (CNT_SPAWN_CYC), and of
# the propagate stage's, on the global plans, those of the collision test
# (CNT_COLL_CYC) and of its cull (CNT_CULL_CYC).
(CNT_GEN, CNT_HITS, CNT_WSUM, CNT_DROPPED, CNT_ALIVE, CNT_QUEUED,
 CNT_WORK, CNT_STALLED, CNT_TESTED, CNT_CAND, CNT_CULL, CNT_ROWS, CNT_SCAT,
 CNT_RAYLEIGH, CNT_WALK, CNT_WARPS, CNT_SPAWN_WARPS, CNT_WAIT, CNT_PROP,
 CNT_SPAWN_CYC, CNT_COLL_CYC, CNT_CULL_CYC) = range(22)
N_CNT = 22
# the kernel's own counts after the TALLIES, which the plain version leaves 0
KERNEL_ONLY = (CNT_WARPS, CNT_SPAWN_WARPS, CNT_WAIT, CNT_PROP, CNT_SPAWN_CYC,
               CNT_COLL_CYC, CNT_CULL_CYC)
# the tallies of the plain version, in counter order from CNT_TESTED on
TALLIES = ("tested", "cand", "cull", "rows", "scat", "rayleigh", "walk")

# static limits of csrc/propagate.cu (array sizes in its parameter block)
MAX_PLANS = 4
MAX_ROUNDS = 4
MAX_TILT_D = 16
MAX_DOM_CAND = 16

# launches of the CUDA kernel, MODE_LAUNCHES[kernel_mode(spec)] per
# instantiation (the wrapper adds one per launch): mode 0 is the main path
# (stopping detect with Philox or an external stream), MODE_RECORDS its
# record mode, and every other mode one of the B6 deposit modes, the fit's
# expected + threefry, or a COLL x MED instantiation with or without records
MODE_LAUNCHES = collections.Counter()

# the kernel carries no scatter-history rings, as the JAX kernel carries none
# (clsim_tpu/propagate/kernel.py:1833); the engine serves them, and
# dispatch.propagate_auto sends a ring run there (ROADMAP.md queue A, A8)
HISTORY_REFUSED = ("the CUDA kernel does not carry photon scatter-history "
                   "rings (photon_history_entries); the engine serves them "
                   "(dispatch.propagate_auto; ROADMAP.md queue A, A8)")

# geometries that SubPlans refuse (each plan_collision that falls back to the
# global plan adds one; `reason` is the last refusal), as in the JAX package
SUBPLAN_FALLBACKS = {"count": 0, "reason": None}


# ---------------------------------------------------------------------------
# collision planning (numpy, as in the JAX package)
# ---------------------------------------------------------------------------

class SubPlan(NamedTuple):
    """Static per-subdetector collision plan (hashable; lives inside
    FusedSpec.sub_plans).  The form of the reference's per-subdetector
    cell grids + per-stringset z-layer tables
    (sparse_collision_kernel.c.cl:305-460 DO_CHECK macros,
    I3CLSimHelperGenerateGeometrySource per-stringSet tables): strings are
    grouped by their (z0, dz, nd) DOM grid, each group gets its OWN 2-D
    cell cull, candidate count sized by its own dz, and a test-round count
    PROVEN sufficient by static geometry -- so a dense infill (DeepCore)
    no longer taxes every main-array lane with its fine z-granularity."""
    n_cells: int          # padded cell-table width for this group
    K_cand: int           # padded candidate strings per cell
    x0: float
    y0: float
    inv_cell: float
    nx: int
    ny: int
    n_dom_cand: int       # z-window candidates (from THIS group's dz)
    rounds: int           # closest-string test rounds (static-geometry
                          # bound: > max simultaneous culled strings never
                          # helps, see _max_simultaneous)
    uz_z0: float          # shared DOM z-grid of the group
    uz_dz: float
    uz_nd: float
    minz: float           # z-extent for the cull's pass_z test
    maxz: float
    row_off: int          # first row of this group's block in cell_tab


def fused_supported(medium: MediumProperties, spectra: SpectrumTable,
                    cfg: PropagationConfig) -> Optional[str]:
    """None if the fused driver handles this configuration, else the reason
    (the configuration checks of the JAX package; the CUDA kernel's own,
    narrower gate is spec_unsupported)."""
    reason = medium.missing_tables()
    if reason:
        return reason
    if cfg.estimator == "detect":
        if cfg.soft_binning:
            return "soft binning is fused only with estimator='expected'"
    elif cfg.estimator != "expected":
        return f"estimator {cfg.estimator!r} not fused"
    if cfg.save_photons:
        if cfg.estimator != "detect" or not cfg.stop_on_detection:
            return "photon records fused only with stopping detect"
        if cfg.photon_history_entries > 0:
            return "photon scatter-history records not fused"
    return None


def _affine_collision_plan(geo: DetectorGeometry, cfg: PropagationConfig):
    """(affine_ok, n_candidates): whether every DOM sits exactly at
    z0 + m*dz on its (vertical) string, and how many candidate indices the
    max segment length can overlap.  Mirrors the reference's geometry-
    specialized codegen (GenerateGeometrySource emits per-stringset layer
    tables only when the layout allows)."""
    rel = to_numpy(geo.string_dom_rel)       # (S, M, 4): dx dy dz valid
    valid = rel[:, :, 3] > 0.5
    if not valid.any():
        return False, 0
    for c in range(3):
        if np.abs(np.where(valid, rel[:, :, c], 0.0)).max() > 1e-4:
            return False, 0
    feats = to_numpy(geo.string_features)
    nd = feats[:, 7]
    dzf = feats[:, 5]
    multi = nd > 1
    if np.any(multi & (dzf == 0.0)):
        return False, 0
    min_dz = float(np.abs(dzf[multi]).min()) if multi.any() else 1.0
    margin = geo.collision_radius + 1.0
    # the kernel anchors its candidate enumeration at ceil(lowest needed
    # index), so ceil(span) + 1 indices always cover the window (at most
    # floor(span)+1 integers fit in a span, +1 for the fractional anchor)
    n_cand = int(np.ceil((cfg.max_segment_m + 2 * margin) / min_dz)) + 1
    if n_cand > 16:
        return False, 0
    return True, n_cand


def general_window(geo: DetectorGeometry, cfg: PropagationConfig):
    """The z-window of the general plan's DOM rows: (half, n_win).

    A row the general test accepts has 0 <= smin1 < d_prop; with
    pancake_factor >= 1 its entry point lies on the segment inside the DOM's
    sphere of radius r, so the DOM's z lies within r of the segment's
    z-range, and its string's fitted ladder row z0 + m * dz within r + rz of
    it, rz the string's largest |residual z| over its valid rows.  The
    kernel and the plain version test only the rows m of that range widened
    by 1 m for rounding, as the affine plan's z-window does: half[s] =
    (r + 1 + rz_s) / |dz_s| ladder rows on each side of the segment's
    z-range.  A string with no ladder (|dz_s| < 1e-3 m) and every string
    when pancake_factor < 1 keep every row (half = BIG).  n_win (<= M) is
    the most rows a window holds at the max_segment_m cap: floor(span) + 1
    integers fit in a span, + 1 for rounding."""
    rel = to_numpy(geo.string_dom_rel, np.float64)        # (S, M, 4)
    feats = to_numpy(geo.string_features, np.float64)
    valid = rel[..., 3] > 0.5
    M = rel.shape[1]
    rz = np.where(valid, np.abs(rel[..., 2]), 0.0).max(axis=1)
    dzf = np.abs(feats[:, 5])
    ladder = dzf >= 1e-3
    if cfg.pancake_factor < 1.0:
        ladder[:] = False
    half = np.where(ladder, (geo.collision_radius + 1.0 + rz)
                    / np.where(ladder, dzf, 1.0), E.BIG)
    n_win = max([int(np.floor(cfg.max_segment_m / dzf[s] + 2.0 * half[s]))
                 + 2 for s in np.nonzero(ladder)[0]]
                + [int(valid[s].sum()) for s in np.nonzero(~ladder)[0]])
    return half.astype(np.float32), min(n_win, M)


def _grid_search(sx, sy, reach, max_cells=512, n_feat=10):
    """Pick the cheapest 2-D cell grid for one string set: per grid cell,
    the candidate list is every string reachable from a segment starting in
    that cell (within max_segment + string reach).  Returns
    (cell, nx, ny, lists, Kp, NCp, gx0, gy0)."""
    gx0 = float((sx - reach).min())
    gx1 = float((sx + reach).max())
    gy0 = float((sy - reach).min())
    gy1 = float((sy + reach).max())
    base = float(reach.max())

    best = None
    for mult in (0.5, 0.75, 1.0, 1.5, 2.0, 4.0, 1e9):
        cell = base * mult
        nx = max(int(np.ceil((gx1 - gx0) / cell)), 1)
        ny = max(int(np.ceil((gy1 - gy0) / cell)), 1)
        if nx * ny > max_cells:
            continue
        lists = []
        kmax = 1
        for i in range(nx):
            bx0, bx1 = gx0 + i * cell, gx0 + (i + 1) * cell
            ddx = np.maximum(np.maximum(bx0 - sx, sx - bx1), 0.0)
            for j in range(ny):
                by0, by1 = gy0 + j * cell, gy0 + (j + 1) * cell
                ddy = np.maximum(np.maximum(by0 - sy, sy - by1), 0.0)
                cand = np.nonzero(np.hypot(ddx, ddy) <= reach)[0]
                lists.append(cand)
                kmax = max(kmax, len(cand))
        Kp = -(-kmax // 8) * 8
        NCp = -(-(nx * ny) // 8) * 8
        # the JAX package's cost model (tuned for its TPU kernel), kept
        # unchanged so that both packages plan the same grid
        tiles = -(-n_feat * Kp // 128)
        cost = 2 * NCp + 26 * Kp + 6 * tiles * NCp
        if best is None or cost < best[0]:
            best = (cost, cell, nx, ny, lists, Kp, NCp)
    _, cell, nx, ny, lists, Kp, NCp = best
    return cell, nx, ny, lists, Kp, NCp, gx0, gy0


def _max_simultaneous(sx, sy, maxr, seg) -> int:
    """Static upper bound on how many strings of this set one segment can
    cull simultaneously: two strings can both pass the point-to-segment
    test only if their 2-D separation <= segment length + both radial
    reaches, so any co-passing set lies inside every member's
    possible-pair neighborhood -- the max neighborhood size (incl. self)
    bounds the set.  Test rounds beyond this bound provably never find
    anything (the reference tests every culled string,
    sparse_collision_kernel.c.cl:462-587; engine parity holds because the
    engine's extra global rounds also find nothing)."""
    sx = np.asarray(sx, np.float64)
    sy = np.asarray(sy, np.float64)
    maxr = np.asarray(maxr, np.float64)
    D = np.hypot(sx[:, None] - sx[None, :], sy[:, None] - sy[None, :])
    possible = D <= seg + maxr[:, None] + maxr[None, :]
    return int(possible.sum(axis=1).max())


def plan_collision(geo: DetectorGeometry, cfg: PropagationConfig):
    """Unified host-side collision planning: per-subdetector SubPlans when
    the geometry allows, else the single global cell plan.  Returns
    (cell_tab_np, plan_dict).

    Every fallback is counted in SUBPLAN_FALLBACKS.  It is warned about only
    where a split was possible and was refused: an affine geometry of at
    least 20 strings that a budget refused.  The JAX package warns for every
    geometry without SubPlans (clsim_tpu/propagate/kernel.py:1956), tiny
    test geometries and surveyed ones included, where the global plan is no
    loss."""
    sub, reason, by_budget = _subdet_plans(geo, cfg)
    if sub is not None:
        cell_tab, plans = sub
        return cell_tab, dict(sub_plans=plans)
    SUBPLAN_FALLBACKS["count"] += 1
    SUBPLAN_FALLBACKS["reason"] = reason
    if by_budget and int(geo.n_strings) >= 20:
        import warnings
        warnings.warn(
            "per-subdetector collision split refused for this geometry "
            f"({reason}); using the single global collision plan "
            "(reference handles <=9 subdetectors, "
            "sparse_collision_kernel.c.cl DO_CHECK)",
            UserWarning, stacklevel=3)
    return _cell_plan(geo, cfg)


def _subdet_plans(geo: DetectorGeometry, cfg: PropagationConfig):
    """Build per-subdetector SubPlans when the geometry allows: affine
    DOM placement and few (z0, dz, nd) groups, each uniform within itself.
    Returns ((cell_tab, plans), None, False) or (None, reason, by_budget)
    -- the caller falls back to the legacy single global plan and surfaces
    the reason; by_budget says that the group budget or the parity budget
    refused a split the geometry allowed."""
    affine_ok, _ = _affine_collision_plan(geo, cfg)
    if not affine_ok:
        return None, ("non-affine DOM placement (DOMs off the z0+m*dz "
                      "ladder or z-candidate window > 16)"), False
    feats = to_numpy(geo.string_features, np.float64)   # (S, 8)
    keys = [tuple(np.round(feats[s, [4, 5, 7]], 6)) for s in
            range(feats.shape[0])]
    groups = {}
    for s, k in enumerate(keys):
        groups.setdefault(k, []).append(s)
    if len(groups) > 4:
        return None, (f"{len(groups)} (z0, dz, nd) string groups exceed "
                      "the 4-SubPlan budget"), True
    sxa = to_numpy(geo.string_x, np.float64)
    sya = to_numpy(geo.string_y, np.float64)
    smaxr = to_numpy(geo.string_max_r, np.float64)
    margin = geo.collision_radius + 1.0
    seg = float(cfg.max_segment_m)

    plans = []
    blocks = []
    row_off = 0
    width = 0
    for key, idx in sorted(groups.items(), key=lambda kv: -len(kv[1])):
        idx = np.asarray(idx)
        z0, dzf, nd = key
        dz_abs = abs(dzf) if nd > 1 else 1.0
        n_cand = int(np.ceil((seg + 2 * margin) / dz_abs)) + 1
        if n_cand > 16:
            return None, (f"group dz={dz_abs:.1f} m needs {n_cand} "
                          "z-candidates (> 16) at max_segment_m="
                          f"{seg:.0f}"), False
        rounds = min(cfg.strings_per_photon,
                     _max_simultaneous(sxa[idx], sya[idx], smaxr[idx], seg))
        reach = seg + smaxr[idx] + 1.0
        cell, nx, ny, lists, Kp, NCp, gx0, gy0 = _grid_search(
            sxa[idx], sya[idx], reach, n_feat=4)
        # per-group table block: 4 feature-major rows [sx, sy, maxr2, off]
        tab = np.zeros((4 * Kp, NCp), np.float32)
        tab[2 * Kp:3 * Kp, :] = -1.0       # maxr2 padding fails the cull
        maxr2 = smaxr ** 2
        for ci, cand in enumerate(lists):
            for k, s_local in enumerate(cand):
                s = int(idx[s_local])
                col = [feats[s, 0], feats[s, 1], maxr2[s], feats[s, 6]]
                for f in range(4):
                    tab[f * Kp + k, ci] = col[f]
        z1 = z0 + dzf * (nd - 1)
        plans.append(SubPlan(
            n_cells=NCp, K_cand=Kp, x0=gx0, y0=gy0, inv_cell=1.0 / cell,
            nx=nx, ny=ny, n_dom_cand=n_cand, rounds=rounds,
            uz_z0=float(z0), uz_dz=float(dzf if dzf != 0.0 else 1.0),
            uz_nd=float(nd), minz=float(min(z0, z1)),
            maxz=float(max(z0, z1)), row_off=row_off))
        blocks.append(tab)
        row_off += tab.shape[0]
        width = max(width, NCp)
    # engine parity: the engine tests the global top-strings_per_photon by
    # rank; the split tests up to sum(rounds) strings.  When every group's
    # rounds equal its static max-simultaneous bound and the total fits in
    # the engine's budget, both test the FULL culled set -- identical
    # accept sets.  Otherwise fall back to the global plan.
    if sum(p.rounds for p in plans) > cfg.strings_per_photon \
            and len(plans) > 1:
        return None, ("per-group round sum "
                      f"{sum(p.rounds for p in plans)} exceeds the "
                      f"engine's strings_per_photon="
                      f"{cfg.strings_per_photon} parity budget"), True
    cell_tab = np.zeros((row_off, width), np.float32)
    r = 0
    for tab in blocks:
        # padding columns beyond a narrow group's width keep maxr2 = -1
        cell_tab[r:r + tab.shape[0], :tab.shape[1]] = tab
        cell_tab[r + (tab.shape[0] // 4) * 2:
                 r + (tab.shape[0] // 4) * 3, tab.shape[1]:] = -1.0
        r += tab.shape[0]
    return (cell_tab, tuple(plans)), None, False


def _cell_plan(geo: DetectorGeometry, cfg: PropagationConfig):
    """Static 2-D cell-grid cull plan (numpy; geometry is static).

    The analog of the reference's per-subdetector cell grid
    (I3CLSimHelperGenerateGeometrySource.cxx cell tables;
    sparse_collision_kernel.c.cl:194-460): precompute, per grid cell, every
    string a segment *starting* in that cell could reach within
    max_segment_m + string_max_r (string_max_r already includes the
    collision radius).  Equivalent to the dense all-strings cull because a
    string outside that reach can never pass the point-to-segment test.

    Returns (cell_tab, plan): cell_tab is (10*K_cand, NC_pad) f32 with
    feature-major rows [sx, sy, maxr2, off, minz, maxz, z0, dzf, nd, sidx]
    per candidate (optional blocks last so specialized modes can fetch a
    prefix); plan carries the static grid constants for the spec.
    """
    sx = to_numpy(geo.string_x, np.float64)
    sy = to_numpy(geo.string_y, np.float64)
    smaxr = to_numpy(geo.string_max_r, np.float64)
    feats = to_numpy(geo.string_features, np.float64)   # (S, 8)
    reach = float(cfg.max_segment_m) + smaxr + 1.0        # (S,) per string
    cell, nx, ny, lists, Kp, NCp, gx0, gy0 = _grid_search(sx, sy, reach,
                                                          n_feat=10)

    tab = np.zeros((10 * Kp, NCp), np.float32)
    tab[2 * Kp:3 * Kp, :] = -1.0          # maxr2: padding fails the cull
    tab[7 * Kp:8 * Kp, :] = 1.0           # dzf: keep index math finite
    tab[8 * Kp:9 * Kp, :] = 1.0           # nd
    tab[9 * Kp:10 * Kp, :] = -1.0         # sidx: padding selects nothing
    maxr2 = to_numpy(geo.string_max_r, np.float64) ** 2
    for ci, cand in enumerate(lists):
        for k, s in enumerate(cand):
            # feature order [sx sy maxr2 off minz maxz z0 dzf nd sidx]:
            # specialized modes fetch a prefix
            col = [feats[s, 0], feats[s, 1], maxr2[s], feats[s, 6],
                   feats[s, 2], feats[s, 3], feats[s, 4],
                   feats[s, 5] if feats[s, 5] != 0.0 else 1.0,
                   feats[s, 7], float(s)]
            for f in range(10):
                tab[f * Kp + k, ci] = col[f]
    plan = dict(n_cull_cells=NCp, K_cand=Kp, cell_x0=gx0, cell_y0=gy0,
                inv_cell=1.0 / cell, cell_nx=nx, cell_ny=ny)
    return tab, plan


# ---------------------------------------------------------------------------
# kernel specialization and the spec gate
# ---------------------------------------------------------------------------

class FusedSpec(NamedTuple):
    """Static kernel specialization: the fields of the JAX package's
    FusedSpec that the CUDA kernel and its gate read."""
    n_slots: int
    iters_per_call: int
    K: int                 # layer-walk window (max_layer_steps)
    L: int                 # medium layers
    n_spec: int            # spectrum table length
    n_tables: int          # stacked spectra (flashers when > 1)
    n_bias: int
    bias_uniform: bool
    nz_tilt: int           # tilt z-grid points (0 = tilt disabled)
    nd_tilt: int
    aniso: bool
    hist_n_bins: int
    n_doms: int
    sub_plans: tuple       # per-subdetector SubPlans; () = global plan
    expected: bool
    stopping: bool
    records: bool
    rec_all: bool          # SAVE_ALL_PHOTONS: record at the absorption point
    rec_prescale: float    # SAVE_ALL_PHOTONS_PRESCALE
    fixed_abs: bool       # fixed horizon in detect mode (expected has one)
    soft: bool            # soft time binning (expected)
    ang_poly: tuple       # angular acceptance polynomial (expected)
    pmt_axis: tuple
    horizon: float        # fixed absorption horizon [absorption lengths]
    threefry: bool        # in-kernel threefry draws from a key table
    medium_tables: bool   # gs/pa/qa/ra from uniform-grid wavelength tables
    scat_table: bool      # tabulated scattering angle mixed with Rayleigh
    # the global plan (B3; read when sub_plans is empty), as the JAX
    # package's FusedSpec holds it
    affine_doms: bool     # DOMs exactly on z0 + m*dz: analytic DOM window
    n_dom_cand: int       # z-window DOM candidates of the affine test
    n_win: int            # DOM rows of the general test's z-window, at most
    n_string_rounds: int  # closest culled strings tested (strings_per_photon)
    K_cand: int           # padded candidate strings per cell
    n_cull_cells: int     # padded nx*ny cell count
    cell_x0: float
    cell_y0: float
    inv_cell: float
    cell_nx: int
    cell_ny: int
    # tabulated media (B7)
    n_wtab: int           # wavelength-grid points of the medium tables
    ref_table: bool       # phase/group index tabulated too
    n_scat: int           # points of the scattering-angle CDF
    cfg: PropagationConfig


def fused_spec(medium: MediumProperties, geo: DetectorGeometry,
               spectra: SpectrumTable, cfg: PropagationConfig,
               n_slots: int, iters_per_call: int, threefry: bool = False):
    """Plan the collision test and build the kernel spec (the estimator
    fields as clsim_tpu/propagate/kernel.py:2160-2172 computes them).
    Returns (spec, cell_tab) with cell_tab in the JAX package's layout."""
    fields, cell_tab = geometry_fields(geo, cfg, n_slots, iters_per_call,
                                       threefry)
    return FusedSpec(**medium_fields(medium, spectra), **fields), cell_tab


def geometry_fields(geo: DetectorGeometry, cfg: PropagationConfig,
                    n_slots: int, iters_per_call: int, threefry: bool):
    """The FusedSpec fields that the geometry, the config, the slots, the
    iterations a launch and the draws set: the collision plan
    (plan_collision) and the estimator's fields.  Returns (fields,
    cell_tab)."""
    cell_tab, plan = plan_collision(geo, cfg)
    affine_ok, n_cand = _affine_collision_plan(geo, cfg)
    return dict(
        n_slots=int(n_slots),
        iters_per_call=int(iters_per_call),
        K=cfg.max_layer_steps,
        hist_n_bins=cfg.hist_n_bins,
        n_doms=int(geo.n_doms),
        sub_plans=tuple(plan.get("sub_plans", ())),
        expected=cfg.estimator == "expected",
        stopping=cfg.stop_on_detection,
        records=bool(cfg.save_photons),
        rec_all=bool(cfg.save_photons and cfg.save_all_photons),
        rec_prescale=float(cfg.save_all_prescale),
        fixed_abs=cfg.fixed_abs_lens > 0 and cfg.estimator == "detect",
        soft=bool(cfg.soft_binning),
        ang_poly=tuple(float(c) for c in cfg.expected_angular_poly or ()),
        pmt_axis=tuple(float(a) for a in cfg.pmt_axis),
        horizon=(float(cfg.fixed_abs_lens) if cfg.fixed_abs_lens > 0
                 else 46.0),
        threefry=bool(threefry),
        affine_doms=bool(affine_ok),
        n_dom_cand=int(n_cand),
        n_win=(0 if affine_ok or plan.get("sub_plans")
               else general_window(geo, cfg)[1]),
        n_string_rounds=int(cfg.strings_per_photon),
        K_cand=int(plan.get("K_cand", 8)),
        n_cull_cells=int(plan.get("n_cull_cells", 8)),
        cell_x0=float(plan.get("cell_x0", 0.0)),
        cell_y0=float(plan.get("cell_y0", 0.0)),
        inv_cell=float(plan.get("inv_cell", 1.0)),
        cell_nx=int(plan.get("cell_nx", 1)),
        cell_ny=int(plan.get("cell_ny", 1)),
        cfg=cfg), cell_tab


def medium_fields(medium: MediumProperties, spectra: SpectrumTable) -> dict:
    """The FusedSpec fields that the medium and the spectra set: layers,
    spectrum and bias tables, tilt and anisotropy, the tabulated media's
    tables (the tabulator's kernel reads the same)."""
    bx = to_numpy(spectra.bias_x, np.float64)
    tilt = medium.tilt
    tabulated = medium.medium_kind != "icecube"
    wtab = (medium.water_abs_inv if medium.medium_kind == "water"
            else medium.fac_qa)
    return dict(
        L=medium.n_layers,
        n_spec=int(spectra.x.shape[1]),
        n_tables=int(spectra.x.shape[0]),
        n_bias=int(bx.shape[0]),
        bias_uniform=bool(bx.shape[0] < 2 or np.allclose(
            np.diff(bx), bx[1] - bx[0], rtol=1e-5)),
        nz_tilt=int(tilt.z_corrections.shape[1]) if tilt.enabled else 0,
        nd_tilt=int(tilt.distances.shape[0]) if tilt.enabled else 0,
        aniso=bool(medium.anisotropy.enabled),
        medium_tables=tabulated,
        scat_table=medium.scattering.kind != "icecube",
        n_wtab=int(wtab.shape[0]) if tabulated else 0,
        ref_table=medium.ref_n_table is not None,
        n_scat=(int(medium.scattering.table_cos.shape[0])
                if medium.scattering.kind != "icecube" else 0))


def spec_unsupported(spec: FusedSpec) -> Optional[str]:
    """None if the CUDA kernel serves this spec, else why not."""
    if spec.records and (spec.expected or not spec.stopping
                         or spec.fixed_abs):
        return ("photon records are fused only with stopping detect, as in "
                "the JAX package (clsim_tpu/propagate/kernel.py:1830-1834): "
                "records with the B6 deposit modes or a fixed horizon are "
                "not in the CUDA kernel")
    if spec.n_bias < 2:
        return (f"the bias grid has {spec.n_bias} point(s); the kernel "
                "interpolates between two at least, as the JAX kernel "
                "does (clsim_tpu/propagate/kernel.py:2327 reads bias_x[1])")
    if spec.threefry and 8 * spec.n_slots >= 2 ** 32:
        return ("threefry draws need 8 * n_slots < 2**32 (one 32-bit "
                "counter per element of an iteration's (8, N) block)")
    if (len(spec.sub_plans) > MAX_PLANS
            or any(p.rounds > MAX_ROUNDS or p.n_dom_cand > MAX_DOM_CAND
                   for p in spec.sub_plans)
            or (not spec.sub_plans
                and (spec.n_string_rounds > MAX_ROUNDS
                     or spec.n_dom_cand > MAX_DOM_CAND))
            or spec.nd_tilt > MAX_TILT_D):
        return (f"spec exceeds the kernel's static limits (<= {MAX_PLANS} "
                f"SubPlans, <= {MAX_ROUNDS} rounds, <= {MAX_DOM_CAND} DOM "
                f"candidates, <= {MAX_TILT_D} tilt distances: the sizes "
                "of register arrays in its collision loops and of its "
                "parameter block; ROADMAP.md B5)")
    return None


# collision (COLL) and medium (MED) instantiations of csrc/propagate.cu
COLL_SUBPLANS, COLL_AFFINE, COLL_GENERAL = 0, 1, 2
MED_CLOSED, MED_TABLES, MED_WATER, MED_CLOSED_SCAT = 0, 1, 2, 3


def kernel_coll(spec: FusedSpec) -> int:
    """COLL of the instantiation: SubPlans, the global affine plan, or the
    global plan with the dense DOM test."""
    if spec.sub_plans:
        return COLL_SUBPLANS
    return COLL_AFFINE if spec.affine_doms else COLL_GENERAL


def kernel_med(spec: FusedSpec) -> int:
    """MED of the instantiation: the closed-form wavelength factors or the
    wavelength tables, each with the Liu/HG scattering mixture or with the
    tabulated scattering angle mixed with Rayleigh (the JAX kernel sets
    scat_table apart from medium_tables, clsim_tpu/propagate/kernel.py:
    2179-2181)."""
    if not spec.medium_tables:
        return MED_CLOSED_SCAT if spec.scat_table else MED_CLOSED
    return MED_WATER if spec.scat_table else MED_TABLES


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

class FusedTables(NamedTuple):
    """Device tables of one (medium, geometry, spectra, config)."""
    medium: MediumProperties      # the plain version reads these two
    spectra: SpectrumTable
    layers: torch.Tensor          # (3, L): b400, a_dust400, delta_tau
    spec_tab: torch.Tensor        # (n_tables, 3, n_spec): x, acu, beta of
                                  # every stacked spectrum
    bias_tab: torch.Tensor        # (2, n_bias): the bias grid x and values y
    tilt_zc: torch.Tensor         # (nd, nz) tilt z-corrections (or (1,))
    cells: torch.Tensor           # flat candidates: (sum n_cells*K_cand,
                                  # 4) per SubPlan, or the global plan's
                                  # card table (card_cull_table; its
                                  # parameters in `scalars`), which the
                                  # plain version reads too (card_lists)
    plan_cells: tuple             # per SubPlan: (n_cells, K_cand, 4) view
    plan_offsets: tuple           # per SubPlan: first candidate row
    doms: torch.Tensor            # (n_doms, 4) DOM centres x, y, z, 0
    scalars: dict                 # values of the parameter block's
                                  # fields, by name
    rel: torch.Tensor             # (S, M, 4) DOM residuals dx, dy, dz, valid
                                  # (general path; else (1, 1, 4) zeros)
    strings: torch.Tensor         # (S, 4) string x, y, z0, dz of the fitted
                                  # DOM ladder (general path; else (1, 4))
    wtab: torch.Tensor            # (rows, n_wtab) gs, pa, qa, ra [, n, g]
                                  # on the medium's wavelength grid (or (1,))
    scat: torch.Tensor            # (3, n_scat) angle, CDF, density (or (1,))
    ang: torch.Tensor             # (n_ang,) the expected estimator's angular
                                  # polynomial, ascending powers (or (1,))


# The card's cull table (COLL 1, 2).  The JAX package's lists
# (plan_collision's cell table) hold every string a segment from anywhere
# in a coarse cell could reach in any direction; a string passes the cull
# only within string_max_r of the capped segment in the photon's own
# direction, a strip.  So the card reads one list per (fine cell, azimuth
# sector): every string whose cull disc meets the region that segments from
# the closed cell, pointing into the closed sector and at most
# max_segment_m long, sweep.  Candidates stay in ascending string index, as
# in the JAX lists, so the ranking picks the same strings.  The kernel and
# its plain version read the same table (card_lists).  It must stay well
# inside the card's 50 MB L2.
CULL_TABLE_BUDGET = 8 << 20      # bytes
# sub-sectors a quadrant at most: the kernel's c_tan holds one threshold
# less (csrc/propagate.cuh Params)
CULL_MAX_SUB = 8
# widening of each cell, of the segment cap and of each string's cull disc
# (m), and of each sector (rad), far beyond float32's rounding of the
# kernel's cell index, sector comparisons and point-to-segment distance
_CULL_EDGE = 0.01
_CULL_ANGLE = 1e-4
# the arc of a sector is bounded by chords of at most this angle (rad): the
# region then overshoots by max_segment_m * (1 / cos(0.025) - 1), 3 cm at
# 90 m
_CULL_CHORD = 0.05


def sector_scalars(m: int) -> dict:
    """The parameter block's sector fields for m sub-sectors a quadrant (m =
    0: one sector): c_sectors, c_qmul, c_m and c_tan, float32 tan(k pi /
    (2 m)) for k = 1 .. m - 1, then BIG up to CULL_MAX_SUB - 1 entries."""
    mm = max(m, 1)
    t = np.full(CULL_MAX_SUB - 1, E.BIG, np.float32)
    t[:mm - 1] = np.tan(np.arange(1, mm) * np.pi / (2 * mm)).astype(
        np.float32)
    return dict(c_sectors=max(4 * m, 1), c_qmul=m, c_m=mm,
                c_tan=[float(v) for v in t])


def cull_sector(dx, dy, sc: dict) -> torch.Tensor:
    """The kernel's azimuth sector of 2-D directions (float32 tensors) under
    the sector fields of `sc` (sector_scalars).  Comparisons only: the
    quadrant q = (dx < 0) + 2 (dy < 0), and within it j, the thresholds
    c_tan that |dy| exceeds times |dx|, at most c_m - 1; sector
    q c_qmul + j."""
    ax, ay = dx.abs(), dy.abs()
    j = sum((ay > t * ax).to(torch.int64) for t in sc["c_tan"])
    q = (dx < 0).to(torch.int64) + 2 * (dy < 0).to(torch.int64)
    return q * sc["c_qmul"] + torch.clamp(j, max=sc["c_m"] - 1)


def card_lists(cells: torch.Tensor, sc: dict, x, y, dx, dy):
    """The card's cull lists that photons at (x, y) heading (dx, dy) read
    (float32 tensors; `cells` card_cull_table's rows on their device, `sc`
    its fields): the list of each photon's fine cell and sector, found as
    the kernel finds it, gathered up to the longest list: (entries (N, L,
    4): sx, sy, maxr2, string index; counts (N,)).  Past its list's count
    an entry has maxr2 = -1, which passes no cull, and string 0."""
    def cell(v, v0, n):
        return torch.clamp(torch.floor((v - v0) * sc["c_inv_cell"]), 0,
                           n - 1).to(torch.int64)
    lid = ((cell(x, sc["c_x0"], sc["c_nx"]) * sc["c_ny"]
            + cell(y, sc["c_y0"], sc["c_ny"])) * sc["c_sectors"]
           + cull_sector(dx, dy, sc))
    hd = cells[sc["c_hdr"]:sc["c_ent"]].view(torch.int32).reshape(-1, 2)[
        lid].to(torch.int64)
    k = torch.arange(max(sc["max_list"], 1), device=x.device)
    ent = cells[torch.clamp(sc["c_ent"] + hd[:, :1] + k,
                            max=cells.shape[0] - 1)]
    ent = torch.where((k < hd[:, 1:])[..., None], ent,
                      ent.new_tensor([0.0, 0.0, -1.0, 0.0]))
    return ent, hd[:, 1]


def _hull(p: np.ndarray) -> np.ndarray:
    """The convex hull of points (n, 2), counter-clockwise (Andrew's monotone
    chain)."""
    p = p[np.lexsort((p[:, 1], p[:, 0]))]
    cross = lambda o, a, b: ((a[0] - o[0]) * (b[1] - o[1])
                             - (a[1] - o[1]) * (b[0] - o[0]))
    half = []
    for seq in (p, p[::-1]):
        h = []
        for q in seq:
            while len(h) >= 2 and cross(h[-2], h[-1], q) <= 0.0:
                h.pop()
            h.append(q)
        half.append(h[:-1])
    return np.asarray(half[0] + half[1])


def _sector_region(sector: int, m: int, h: float, seg: float) -> np.ndarray:
    """The region, relative to a cell's lower corner, that segments from the
    cell [0, h]^2 into the sector sweep, widened by _CULL_EDGE and
    _CULL_ANGLE: the hull of the cell's corners plus a circumscribed fan of
    the sector's disc slice (radius seg)."""
    q, j = divmod(sector, m)
    w = np.pi / (2 * m)
    lo, hi = j * w - _CULL_ANGLE, (j + 1) * w + _CULL_ANGLE
    # the folded angle th -> the azimuth: reflections by the signs of dx, dy
    phi = {0: lambda th: th, 1: lambda th: np.pi - th,
           2: lambda th: -th, 3: lambda th: np.pi + th}[q]
    a, b = sorted((phi(lo), phi(hi)))
    k = max(1, int(np.ceil((b - a) / _CULL_CHORD)))
    r = (seg + _CULL_EDGE) / np.cos((b - a) / (2 * k))
    ang = a + (b - a) * np.arange(k + 1) / k
    fan = np.concatenate([[[0.0, 0.0]],
                          r * np.stack([np.cos(ang), np.sin(ang)], 1)])
    e = _CULL_EDGE
    corners = np.array([[-e, -e], [h + e, -e], [h + e, h + e], [-e, h + e]])
    return _hull((corners[:, None, :] + fan[None, :, :]).reshape(-1, 2))


def _half_planes(poly: np.ndarray):
    """(normals (E, 2), offsets (E,)) of a convex polygon's edges (CCW):
    a point X is inside where normals @ X <= offsets."""
    e = np.roll(poly, -1, 0) - poly
    nrm = np.stack([e[:, 1], -e[:, 0]], 1) / np.hypot(e[:, 0],
                                                      e[:, 1])[:, None]
    return nrm, (nrm * poly).sum(1)


def _sector_lists(sx, sy, reach, x0, y0, h, nx, ny, m, seg):
    """(list index, string) of every candidate of the table with cells of
    h from (x0, y0), nx x ny of them, and 4 m sectors: list (i ny + j) 4m +
    sector holds the strings whose disc of radius reach (m) meets the
    sector's region (_sector_region) from the cell's corner (x0 + i h,
    y0 + j h).  Sorted by list, then string."""
    S = 4 * m
    ids, strs = [], []
    n = sx.shape[0]
    rr = reach + _CULL_EDGE
    for sec in range(S):
        poly = _sector_region(sec, m, h, seg)
        nrm, off = _half_planes(poly)
        (qx0, qy0), (qx1, qy1) = poly.min(0), poly.max(0)
        # cells whose corner o has s - o inside the region's box +- reach
        ilo = np.ceil((sx - qx1 - rr - x0) / h).astype(np.int64) - 1
        jlo = np.ceil((sy - qy1 - rr - y0) / h).astype(np.int64) - 1
        wi = int(np.ceil((qx1 - qx0 + 2 * rr.max()) / h)) + 3
        wj = int(np.ceil((qy1 - qy0 + 2 * rr.max()) / h)) + 3
        ci = ilo[:, None, None] + np.arange(wi)[None, :, None]
        cj = jlo[:, None, None] + np.arange(wj)[None, None, :]
        ci, cj = np.broadcast_arrays(ci, cj)
        ok = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny)
        s = np.broadcast_to(np.arange(n)[:, None, None], ok.shape)[ok]
        ci, cj = ci[ok], cj[ok]
        # every edge moved out by the string's reach: a superset of the
        # points within reach of the region
        px, py = sx[s] - (x0 + ci * h), sy[s] - (y0 + cj * h)
        hit = (px[:, None] * nrm[:, 0] + py[:, None] * nrm[:, 1]
               - off).max(1) <= rr[s]
        ids.append((ci[hit] * ny + cj[hit]) * S + sec)
        strs.append(s[hit])
    ids, strs = np.concatenate(ids), np.concatenate(strs)
    order = np.lexsort((strs, ids))
    return ids[order], strs[order]


def card_cull_table(spec: FusedSpec, cell_tab: np.ndarray,
                    half: Optional[np.ndarray] = None,
                    budget: int = CULL_TABLE_BUDGET):
    """The card's cull table of the global plan and its parameters:
    (rows, scalars), rows a (R, 4) float32 array, scalars the Params fields
    c_* (csrc/propagate.cuh) by name and max_list, the longest list's
    count.

    Derived from the JAX package's cell table `cell_tab` (plan_collision)
    and its values: per string its (minz, maxz, z0, dzf) and (nd, dom
    offset, float32(1 / dzf), half) (`half` the general plan's z-window or
    0), then one (offset, count) pair of int32 a list, then every list's
    cull entries (sx, sy, maxr2, string index), consecutive and not
    padded.  The lists are per (fine cell, azimuth sector) (_sector_lists,
    cull_sector): the cell size h (the JAX cell over 2, 4, ... 32) and the
    sub-sectors a quadrant m (1, 2, 4, 8) minimise the load groups a
    slot-iteration expects past the list's header (ceil(count / 4)
    averaged over the sectors and the cells whose centre a string's cull
    can reach) plus the table's bytes over `budget` (a table of the budget
    costs a load group: the L1 misses a larger table brings), among the
    tables that fit `budget`.  Where none fits, the
    lists are the JAX package's, per coarse cell (m = 0: one sector)."""
    K, nc = spec.K_cand, spec.n_cull_cells
    blk = cell_tab[:10 * K, :nc].reshape(10, K, nc)
    sidx = blk[9].astype(np.int64)
    n_str = int(sidx.max()) + 1
    per = np.zeros((n_str, 12), np.float32)
    kk, cc = np.nonzero(sidx >= 0)
    per[sidx[kk, cc], :10] = blk[:, kk, cc].T
    per[:, 10] = 1.0 / per[:, 7].astype(np.float64)
    if half is not None:
        per[:, 11] = half[:n_str]
    sx, sy = per[:, 0].astype(np.float64), per[:, 1].astype(np.float64)
    reach = np.sqrt(per[:, 2].astype(np.float64))
    seg = float(spec.cfg.max_segment_m)
    cell_j = 1.0 / spec.inv_cell
    x0, y0 = float(np.float32(spec.cell_x0)), float(np.float32(spec.cell_y0))
    ext_x, ext_y = spec.cell_nx * cell_j, spec.cell_ny * cell_j
    # where a segment can reach some string's cull disc
    near = seg + reach.max() + _CULL_EDGE

    def entry_rows(n_lists, n_ent):
        return 2 * n_str + -(-n_lists // 2) + n_ent

    def design(kh, km):
        """(cost, ids, strings, inv_cell, nx, ny, m) of cells of the JAX
        cell over 2^(kh + 1) and m = 2^km, or None beyond the budget."""
        inv = float(np.float32(2 ** (kh + 1) / cell_j))
        h = 1.0 / inv       # the cell the kernel's float32 index sees
        m = 2 ** km
        nx, ny = int(np.ceil(ext_x / h)), int(np.ceil(ext_y / h))
        n_lists = nx * ny * 4 * m
        if 16 * entry_rows(n_lists, 0) > budget:
            return None
        ids, strs = _sector_lists(sx, sy, reach, x0, y0, h, nx, ny, m, seg)
        nbytes = 16 * entry_rows(n_lists, ids.size)
        if nbytes > budget:
            return None
        cx = x0 + (np.arange(nx) + 0.5) * h
        cy = y0 + (np.arange(ny) + 0.5) * h
        near2 = ((cx[:, None, None] - sx) ** 2
                 + (cy[None, :, None] - sy) ** 2).min(-1) <= near ** 2
        cnt = np.bincount(ids, minlength=n_lists).reshape(nx * ny, -1)
        groups = float((-(-cnt[near2.reshape(-1)] // 4)).mean())
        return groups + nbytes / budget, ids, strs, inv, nx, ny, m

    # descend on the grid of designs from (JAX cell / 8, 8 sectors) to the
    # neighbour of least cost until none costs less
    seen = {}
    at, best = None, None
    nxt = (2, 1)
    while nxt is not None and nxt != at:
        at, nxt = nxt, None
        for kh, km in ((at[0], at[1]), (at[0] - 1, at[1]), (at[0] + 1, at[1]),
                       (at[0], at[1] - 1), (at[0], at[1] + 1)):
            if not (0 <= kh < 5 and 0 <= km < 4):
                continue
            if (kh, km) not in seen:
                seen[kh, km] = design(kh, km)
            d = seen[kh, km]
            if d is not None and (best is None or d[0] < best[0]):
                best, nxt = d, (kh, km)
    if best is None:
        # the JAX package's lists, one sector a coarse cell
        lid, ks = np.nonzero(sidx.T >= 0)
        strs = sidx.T[lid, ks]
        best = (0.0, lid, strs, float(np.float32(spec.inv_cell)),
                spec.cell_nx, spec.cell_ny, 0)
    _, ids, strs, inv, nx, ny, m = best
    sectors = sector_scalars(m)
    n_lists = nx * ny * sectors["c_sectors"]
    cnt = np.bincount(ids, minlength=n_lists)
    hdr = np.zeros((-(-n_lists // 2) * 2, 2), np.int32)
    hdr[:n_lists, 1] = cnt
    hdr[:n_lists, 0] = np.cumsum(cnt) - cnt
    ent = np.zeros((strs.size, 4), np.float32)
    ent[:, :3] = per[strs, :3]
    ent[:, 3] = strs
    lad = per[:, [8, 3, 10, 11]]        # nd, dom offset, 1 / dzf, half
    rows = np.concatenate([per[:, 4:8], lad,
                           hdr.reshape(-1, 4).view(np.float32), ent])
    return rows, dict(
        c_x0=x0, c_y0=y0, c_inv_cell=inv, c_nx=nx, c_ny=ny, c_lad=n_str,
        c_hdr=2 * n_str, c_ent=2 * n_str + hdr.shape[0] // 2,
        max_list=int(cnt.max()), **sectors)


def medium_tables(medium: MediumProperties) -> np.ndarray:
    """(rows, n_wtab) wavelength tables of a tabulated medium: the factors
    gs, pa, qa, ra (water: scattering, 0, absorption, 0), then the phase
    and group index when tabulated (the JAX package's wtab rows,
    clsim_tpu/propagate/kernel.py:2252-2269, without the (k, k+1) pairs)."""
    if medium.medium_kind == "water":
        zero = torch.zeros_like(medium.water_abs_inv)
        facs = [medium.water_scat_inv, zero, medium.water_abs_inv, zero]
    else:
        facs = [medium.fac_gs, medium.fac_pa, medium.fac_qa, medium.fac_ra]
    if medium.ref_n_table is not None:
        facs += [medium.ref_n_table, medium.ref_g_table]
    return np.stack([to_numpy(f, np.float32) for f in facs])


def build_tables(spec: FusedSpec, medium: MediumProperties,
                 geo: DetectorGeometry, spectra: SpectrumTable,
                 cell_tab: np.ndarray) -> FusedTables:
    """Flat float32 tables on the medium's device.  The cell table is
    re-laid out from the JAX package's feature-major block per SubPlan
    ([sx|sy|maxr2|off] rows x cells) to [cell][candidate][4], so a thread
    reads its cell's candidates as consecutive 16-byte entries; the global
    plan's to the card's lists per fine cell and azimuth sector
    (card_cull_table).  The general path
    reads the DOM residuals as (S, M) float4 rows beside a float4 per
    string (clsim_tpu/propagate/kernel.py:2294-2306 builds the same from
    string_dom_rel and string_features)."""
    return _join_tables(
        geometry_tables(spec, geo, cell_tab, medium.b400.device),
        medium_part_tables(medium, spectra, spec.medium_tables,
                           spec.scat_table))


def _join_tables(geom: dict, med: dict) -> FusedTables:
    """FusedTables of geometry_tables' and medium_part_tables' entries, the
    scalars of both in one dict."""
    return FusedTables(**{**geom, **med,
                          "scalars": {**med["scalars"], **geom["scalars"]}})


def _upload(a, dev) -> torch.Tensor:
    """A float32 copy of `a` on `dev`, its read a "wait" span of site
    "tables_h2d"."""
    with P.wait("tables_h2d"):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=dev).contiguous()


def geometry_tables(spec: FusedSpec, geo: DetectorGeometry,
                    cell_tab: np.ndarray, dev) -> dict:
    """FusedTables' entries that the geometry and the config set, on `dev`:
    the cell tables, the DOM centres, the general path's DOM residuals and
    strings, the angular polynomial and the scalars of the collision sphere,
    the segment cap and the histogram.  They read only spec's geometry
    fields (geometry_fields)."""
    def f32(a):
        return _upload(a, dev)
    blocks, views, offsets, off = [], [], [], 0
    for p in spec.sub_plans:
        blk = cell_tab[p.row_off:p.row_off + 4 * p.K_cand, :p.n_cells]
        blk = blk.reshape(4, p.K_cand, p.n_cells).transpose(2, 1, 0)
        blocks.append(blk.reshape(-1, 4))
        offsets.append(off)
        off += p.n_cells * p.K_cand
    general = kernel_coll(spec) == COLL_GENERAL
    cfg = spec.cfg
    sc = dict(
        r=float(geo.collision_radius), r2=float(geo.collision_radius) ** 2,
        inv_pancake=1.0 / cfg.pancake_factor,
        max_seg=float(cfg.max_segment_m),
        hist_t0=float(cfg.hist_t_min), hist_dt=float(cfg.hist_dt))
    if spec.sub_plans:
        cells = f32(np.concatenate(blocks))
    else:
        half = general_window(geo, spec.cfg)[0] if general else None
        rows, cull_sc = card_cull_table(spec, cell_tab, half)
        cells = f32(rows)
        sc.update(cull_sc)
    for p, o in zip(spec.sub_plans, offsets):
        views.append(cells[o:o + p.n_cells * p.K_cand].view(
            p.n_cells, p.K_cand, 4))
    rel = (f32(to_numpy(geo.string_dom_rel)) if general
           else torch.zeros((1, 1, 4), device=dev))
    strings = (f32(to_numpy(geo.string_features)[:, [0, 1, 4, 5]])
               if general else torch.zeros((1, 4), device=dev))
    ang = (f32(np.asarray(spec.ang_poly, np.float32)) if spec.ang_poly
           else torch.zeros(1, device=dev))
    return dict(
        cells=cells, plan_cells=tuple(views), plan_offsets=tuple(offsets),
        doms=torch.nn.functional.pad(E.dom_centres(geo), (0, 1)).to(
            dev).contiguous(),
        scalars=sc, rel=rel, strings=strings,
        ang=ang)


def medium_part_tables(medium: MediumProperties, spectra: SpectrumTable,
                       tabulated: bool, scat_table: bool) -> dict:
    """FusedTables' entries that the medium and the spectra set, on the
    medium's device: medium_device_tables, the scattering-angle CDF (with
    `scat_table`), medium_scalars and the two objects themselves."""
    sc_ = medium.scattering
    scat = (_upload(torch.stack([sc_.table_cos.reshape(-1),
                                 sc_.table_cdf[0], sc_.table_cdf[1]]).cpu(),
                    medium.b400.device)
            if scat_table else torch.zeros(1, device=medium.b400.device))
    return dict(medium=medium, spectra=spectra,
                **medium_device_tables(medium, spectra, tabulated),
                scat=scat, scalars=medium_scalars(medium, spectra))


def medium_device_tables(medium: MediumProperties, spectra: SpectrumTable,
                         tabulated: bool) -> dict:
    """The float32 tables of the medium and the spectra on the medium's
    device: layers (3, L), spec_tab (n_tables, 3, n_spec), bias_tab
    (2, n_bias), tilt_zc (nd, nz) or (1,), and wtab (medium_tables) or
    (1,) unless `tabulated`."""
    dev = medium.b400.device
    tl = medium.tilt
    return dict(
        layers=torch.stack([medium.b400, medium.a_dust400,
                            medium.delta_tau]).to(torch.float32).contiguous(),
        spec_tab=torch.stack([spectra.x, spectra.acu, spectra.beta],
                             1).to(torch.float32).contiguous(),
        bias_tab=torch.stack([spectra.bias_x, spectra.bias_y]).to(
            torch.float32).contiguous(),
        tilt_zc=(tl.z_corrections.to(torch.float32).contiguous()
                 if tl.enabled else torch.zeros(1, device=dev)),
        wtab=(torch.as_tensor(medium_tables(medium), dtype=torch.float32,
                              device=dev).contiguous() if tabulated
              else torch.zeros(1, device=dev)))


def medium_scalars(medium: MediumProperties, spectra: SpectrumTable) -> dict:
    """The parameter block's scalars of the medium (layers, wavelength
    factors, scattering, anisotropy, tilt) and of the spectra's bias grid,
    as Python floats (lists for n, g and tilt_d)."""
    an, tl = medium.anisotropy, medium.tilt

    def host(t):
        with P.wait("medium_scalars"):
            return float(torch.as_tensor(t).detach().cpu())
    bx = to_numpy(spectra.bias_x, np.float64)
    sc = dict(
        z_start=host(medium.layers_z_start),
        layer_h=host(medium.layer_height),
        alpha=host(medium.alpha), kappa=host(medium.kappa),
        abs_a=host(medium.abs_A), abs_b=host(medium.abs_B),
        abs_d=host(medium.abs_D), abs_e=host(medium.abs_E),
        mean_cos=host(medium.scattering.mean_cos),
        liu_frac=host(medium.scattering.liu_fraction),
        bias_x0=float(bx[0]),
        bias_inv_dx=1.0 / float(bx[1] - bx[0]) if bx.shape[0] > 1 else 1.0,
        wtab_x0=float(medium.water_wlen_first),
        wtab_inv_dx=1.0 / float(medium.water_wlen_step),
        n=[host(v) for v in medium.ref_index.n],
        g=[host(v) for v in medium.ref_index.g])
    if an.enabled:
        with P.wait("medium_scalars", 4):
            k1 = torch.exp(torch.as_tensor(an.mag_along).cpu())
            k2 = torch.exp(torch.as_tensor(an.mag_perp).cpu())
            cos_az = torch.cos(torch.as_tensor(an.azimuth).cpu())
            sin_az = torch.sin(torch.as_tensor(an.azimuth).cpu())
        # host tensors from here on
        sc.update(an_ca=float(cos_az), an_sa=float(sin_az), an_k1=float(k1),
                  an_k2=float(k2), an_kz=float(1.0 / (k1 * k2)))
    if tl.enabled:
        sc.update(tilt_z0=host(tl.first_z), tilt_dz=host(tl.z_spacing),
                  tilt_ca=host(tl.azimuth_cos), tilt_sa=host(tl.azimuth_sin),
                  tilt_d=[host(v) for v in tl.distances])
    return sc


# ---------------------------------------------------------------------------
# the plan of a call, reused while its inputs are unchanged
# ---------------------------------------------------------------------------

# entries each part of the plan keeps, the least recently used dropped
# first: a fit builds a new medium every step (diff.replace_leaves), whose
# medium part then misses every time while the geometry part hits
PLAN_CACHE_SIZE = 4
_PLAN_LOCK = threading.Lock()


def _versions(objs: tuple) -> tuple:
    """The _version of every floating-point tensor of `objs` (NamedTuples
    of tensors): an in-place edit of any of them changes the tuple."""
    return tuple(t._version for o in objs for _, t in tensor_leaves(o))


class _PartCache:
    """One part of the plan, per inputs, least recently used first.  An
    entry matches where its inputs are the very objects given (held by the
    entry, so that a recycled id() never matches), their tensors' versions
    are unchanged and the rest of its key is equal."""

    def __init__(self):
        self.entries = []         # [(objs, versions, key, value)]

    def _index(self, objs: tuple, vers: tuple, key: tuple):
        for i, (o, v, k, _) in enumerate(self.entries):
            if all(a is b for a, b in zip(o, objs)) and v == vers \
                    and k == key:
                return i
        return None

    def find(self, objs: tuple, key: tuple):
        """(the matching entry's value or None, the versions of objs)."""
        vers = _versions(objs)
        with _PLAN_LOCK:
            i = self._index(objs, vers, key)
            if i is None:
                return None, vers
            self.entries.append(self.entries.pop(i))
            return self.entries[-1][3], vers

    def put(self, objs: tuple, vers: tuple, key: tuple, value):
        """Keep `value` as the newest entry, in place of an equal one that
        another thread built meanwhile."""
        with _PLAN_LOCK:
            i = self._index(objs, vers, key)
            if i is not None:
                del self.entries[i]
            self.entries.append((objs, vers, key, value))
            del self.entries[:-PLAN_CACHE_SIZE]


# the geometry part: geometry_fields and geometry_tables of (geometry,
# config, n_slots, iters_per_call, threefry, device); the medium part:
# medium_fields and medium_part_tables of (medium, spectra)
GEOMETRY_PLANS = _PartCache()
MEDIUM_PLANS = _PartCache()


def clear_plans():
    """Drop every kept plan and the inputs and device tables it holds: the
    next call plans anew."""
    with _PLAN_LOCK:
        GEOMETRY_PLANS.entries.clear()
        MEDIUM_PLANS.entries.clear()


def plan_call(medium: MediumProperties, geo: DetectorGeometry,
              spectra: SpectrumTable, cfg: PropagationConfig, n_slots: int,
              iters_per_call: int, threefry: bool = False):
    """(spec, tables) of fused_spec and build_tables, each of their two
    parts (GEOMETRY_PLANS, MEDIUM_PLANS) built once and reused while its
    inputs are unchanged; the spec and the tables equal a fresh build's.
    Counts "plan_reuse" where both parts were kept, else "plan_build"."""
    dev = medium.b400.device
    med, m_vers = MEDIUM_PLANS.find((medium, spectra), ())
    gkey = (cfg, int(n_slots), int(iters_per_call), bool(threefry), dev)
    geom, g_vers = GEOMETRY_PLANS.find((geo,), gkey)
    P.count("plan_build" if med is None or geom is None else "plan_reuse")
    if med is None:
        fields = medium_fields(medium, spectra)
        med = fields, medium_part_tables(medium, spectra,
                                         fields["medium_tables"],
                                         fields["scat_table"])
        MEDIUM_PLANS.put((medium, spectra), m_vers, (), med)
    if geom is None:
        fields, cell_tab = geometry_fields(geo, cfg, n_slots,
                                           iters_per_call, threefry)
        spec = FusedSpec(**med[0], **fields)
        geom = fields, geometry_tables(spec, geo, cell_tab, dev)
        GEOMETRY_PLANS.put((geo,), g_vers, gkey, geom)
    spec = FusedSpec(**med[0], **dict(geom[0], cfg=cfg))
    return spec, _join_tables(geom[1], med[1])


def pack_steps(steps: StepBatch) -> torch.Tensor:
    """(NST, N) float32 step rows in STEP_FIELDS order."""
    return torch.stack([getattr(steps, f).to(torch.float32)
                        for f in STEP_FIELDS]).contiguous()


def init_state(steps: StepBatch, records: bool = False) -> torch.Tensor:
    """(NSF, N) float32 slot state in STATE_FIELDS order; with `records`
    (NSF + NRSF, N), the REC_STATE_FIELDS rows after it."""
    rows = list(E._init_state(steps))
    if records:
        n, dev = steps.x.shape[0], steps.x.device
        rs = E._init_rec_state(n, dev)
        rows += [getattr(rs, f) for f in REC_STATE_FIELDS[:-1]]
        rows.append(torch.full((n,), -1.0, device=dev))
    return torch.stack(rows).contiguous()


def records_from_rows(rows: torch.Tensor, n_bins: int) -> dict:
    """The public record dict (REC_FIELDS, each (1, R) float32) from raw
    (R, NRC) record rows, derived on the rows' device as the JAX call loop
    does on the host (kernel.py:2687-2714): directions as (theta, phi),
    group velocity 1/inv_gv, cherenkov_dist (time - start_time) * group
    velocity, dom from the flat index.  SAVE_ALL records carry weight 0."""
    f = dict(zip(REC_COLUMNS, rows.to(torch.float32).unbind(1)))
    theta, phi = cart_to_sph(f["dir_x"], f["dir_y"], f["dir_z"])
    s_theta, s_phi = cart_to_sph(f["start_dx"], f["start_dy"],
                                 f["start_dz"])
    inv_gv = torch.clamp(f["inv_gv"], min=1e-20)
    rec = dict(f, dir_theta=theta, dir_phi=phi, start_theta=s_theta,
               start_phi=s_phi, group_velocity=1.0 / inv_gv,
               cherenkov_dist=(f["time"] - f["start_time"]) / inv_gv,
               dom=torch.floor(f["flat_idx"] / n_bins))
    return {k: rec[k][None, :] for k in E.REC_FIELDS}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _check_collisions_subplan(state: E.SlotState, tables: FusedTables,
                              spec: FusedSpec, d_prop, active):
    """The kernel's per-subdetector collision test in plain PyTorch
    (clsim_tpu/propagate/kernel.py:1160-1269): per string group, the slot's cell
    selects <= K_cand candidate strings, the 2-D cull ranks them, the
    `rounds` closest get the ray-sphere test against the n_dom_cand DOMs of
    the z-window, and the minimum entry distance over all groups wins."""
    sc = tables.scalars
    x, y, z = state.x, state.y, state.z
    dx, dy, dz = state.dx, state.dy, state.dz
    R, R2 = sc["r"], sc["r2"]
    max_seg = sc["max_seg"]
    dir_xy2 = dx * dx + dy * dy
    live = active & (dir_xy2 > 0.0)
    inv_dir_xy2 = 1.0 / torch.clamp(dir_xy2, min=1e-20)
    best_all = d_prop
    dom_all = torch.zeros_like(x, dtype=torch.int64)
    margin = R + 1.0
    for sp, cells in zip(spec.sub_plans, tables.plan_cells):
        cxi = torch.clamp(torch.floor((x - sp.x0) * sp.inv_cell), 0, sp.nx - 1)
        cyi = torch.clamp(torch.floor((y - sp.y0) * sp.inv_cell), 0, sp.ny - 1)
        cand = cells[(cxi * sp.ny + cyi).to(torch.int64)]   # (N, K_cand, 4)
        rx = cand[..., 0] - x[:, None]
        ry = cand[..., 1] - y[:, None]
        bd2 = rx * dx[:, None] + ry * dy[:, None]
        A2 = rx * rx + ry * ry
        pass_z = ~((dz > 0) & (z > sp.maxz + R)) & ~((dz < 0) & (z < sp.minz - R))
        t2d = torch.clamp(bd2 * inv_dir_xy2[:, None], 0.0, max_seg)
        cx = rx - dx[:, None] * t2d
        cy = ry - dy[:, None] * t2d
        d2 = cx * cx + cy * cy
        ranked = torch.where((d2 <= cand[..., 2]) & (pass_z & live)[:, None],
                             d2, torch.full_like(d2, E.BIG))
        inv_dzf = 1.0 / sp.uz_dz
        m1 = (z - sp.uz_z0) * inv_dzf
        m2 = m1 + dz * (d_prop * inv_dzf)
        mlo = torch.ceil(torch.minimum(m1, m2) - margin * abs(inv_dzf))
        cand_m = torch.clamp(
            mlo[:, None] + torch.arange(sp.n_dom_cand, device=x.device,
                                        dtype=x.dtype), 0.0, sp.uz_nd - 1.0)
        oz = sp.uz_z0 + sp.uz_dz * cand_m - z[:, None]          # (N, NC)
        for _r in range(sp.rounds):
            mi, sidx = torch.min(ranked, dim=1)
            ranked = ranked.scatter(1, sidx[:, None], E.BIG)
            pick = lambda a: a.gather(1, sidx[:, None])
            urdot = pick(bd2) + oz * dz[:, None]
            dr2 = pick(A2) + oz * oz
            discr = urdot * urdot - dr2 + R2
            smin1 = urdot - torch.sqrt(torch.clamp(discr, min=0.0)) \
                * sc["inv_pancake"]
            good = (mi < E.BIG)[:, None] & (discr >= 0.0) & (smin1 >= 0.0) \
                & (smin1 < best_all[:, None])
            best, jm = torch.min(torch.where(good, smin1,
                                             torch.full_like(smin1, E.BIG)),
                                 dim=1)
            better = best < best_all
            dom = pick(cand[..., 3])[:, 0].to(torch.int64) \
                + cand_m.gather(1, jm[:, None])[:, 0].to(torch.int64)
            best_all = torch.where(better, best, best_all)
            dom_all = torch.where(better, dom, dom_all)
    hit = best_all < d_prop
    return hit, torch.where(hit, best_all, d_prop), dom_all


def _tally(tally: Optional[dict], key: str, n):
    if tally is not None:
        tally[key] = tally.get(key, 0) + n


def _check_collisions_global(state: E.SlotState, tables: FusedTables,
                             spec: FusedSpec, d_prop, active, tally=None):
    """The kernel's global-plan collision test in plain PyTorch: the slot's
    fine cell and azimuth sector select a list of the card's table
    (card_lists), whose candidate strings the 2-D cull ranks by the static
    segment cap with the z pass of each candidate's extent
    (clsim_tpu/propagate/kernel.py:947-1003), and the n_string_rounds
    closest get the ray-sphere test: against the n_dom_cand DOMs of the
    z-window from the ceil anchor on an affine geometry (:1270-1381), or
    against the DOMs of the string's residual rows otherwise (:1382-1456),
    there only the rows of the segment's z-window (general_window: the
    same accept set as every row, so the same hits, distances and DOMs).
    The minimum entry distance over the rounds wins.  The
    kernel's counts of this work (candidates, cull passes, strings and DOMs
    tested: TALLIES) are added to the dict `tally` when given."""
    sc = tables.scalars
    x, y, z = state.x, state.y, state.z
    dx, dy, dz = state.dx, state.dy, state.dz
    R, R2, max_seg = sc["r"], sc["r2"], sc["max_seg"]
    dir_xy2 = dx * dx + dy * dy
    live = active & (dir_xy2 > 0.0)
    inv_dir_xy2 = 1.0 / torch.clamp(dir_xy2, min=1e-20)
    ent, n_ent = card_lists(tables.cells, sc, x, y, dx, dy)    # (N, L, 4)
    sidx = ent[..., 3].to(torch.int64)
    zext = tables.cells[sidx]             # minz, maxz, z0, dzf a string
    rx = ent[..., 0] - x[:, None]
    ry = ent[..., 1] - y[:, None]
    bd2 = rx * dx[:, None] + ry * dy[:, None]
    A2 = rx * rx + ry * ry
    pass_z = ~((dz[:, None] > 0) & (z[:, None] > zext[..., 1] + R)) \
        & ~((dz[:, None] < 0) & (z[:, None] < zext[..., 0] - R))
    t2d = torch.clamp(bd2 * inv_dir_xy2[:, None], 0.0, max_seg)
    cx = rx - dx[:, None] * t2d
    cy = ry - dy[:, None] * t2d
    d2 = cx * cx + cy * cy
    culled = (d2 <= ent[..., 2]) & live[:, None]
    _tally(tally, "cand", torch.where(live, n_ent, 0).sum())
    _tally(tally, "cull", culled.sum())
    ranked = torch.where(culled & pass_z, d2, torch.full_like(d2, E.BIG))
    best_all = d_prop
    dom_all = torch.zeros_like(x, dtype=torch.int64)
    big = lambda a: torch.full_like(a, E.BIG)
    for _r in range(spec.n_string_rounds):
        mi, k = torch.min(ranked, dim=1)
        ranked = ranked.scatter(1, k[:, None], E.BIG)
        ok = (mi < E.BIG)[:, None]
        _tally(tally, "tested", ok.sum())
        s = sidx.gather(1, k[:, None])[:, 0]
        # nd, dom offset, 1 / dzf, the z-window's half-width
        nd, off, inv_dzf, half = tables.cells[sc["c_lad"] + s].unbind(1)
        off = off.to(torch.int64)
        if spec.affine_doms:
            z0, dzf = tables.cells[s, 2], tables.cells[s, 3]
            m1 = (z - z0) * inv_dzf
            m2 = m1 + dz * d_prop * inv_dzf
            mlo = torch.ceil(torch.minimum(m1, m2)
                             - (R + 1.0) * torch.abs(inv_dzf))
            m = torch.minimum(torch.clamp(
                mlo[:, None] + torch.arange(spec.n_dom_cand, device=x.device,
                                            dtype=x.dtype), min=0.0),
                (nd - 1.0)[:, None])                      # (N, n_dom_cand)
            oz = z0[:, None] + dzf[:, None] * m - z[:, None]
            urdot = bd2.gather(1, k[:, None]) + oz * dz[:, None]
            dr2 = A2.gather(1, k[:, None]) + oz * oz
            valid = ok
        else:
            # the rows mlo..mhi of the segment's z-window on the string's
            # fitted ladder (general_window), n_win wide at most
            st = tables.strings[s]                        # (N, 4)
            m1 = (z - st[:, 2]) * inv_dzf
            m2 = m1 + dz * d_prop * inv_dzf
            mlo = torch.clamp(torch.ceil(torch.minimum(m1, m2) - half),
                              min=0.0)
            mhi = torch.minimum(torch.floor(torch.maximum(m1, m2) + half),
                                nd - 1.0)
            m = mlo[:, None] + torch.arange(spec.n_win, device=x.device,
                                            dtype=x.dtype)   # (N, n_win)
            M = tables.rel.shape[1]
            rel = tables.rel[s[:, None],
                             torch.clamp(m, max=M - 1.0).to(torch.int64)]
            ox = st[:, 0:1] + rel[..., 0] - x[:, None]
            oy = st[:, 1:2] + rel[..., 1] - y[:, None]
            oz = st[:, 2:3] + st[:, 3:4] * m + rel[..., 2] - z[:, None]
            dr2 = ox * ox + oy * oy + oz * oz
            urdot = ox * dx[:, None] + oy * dy[:, None] + oz * dz[:, None]
            valid = ok & (m <= mhi[:, None]) & (rel[..., 3] > 0.5)
        _tally(tally, "rows", valid.sum() * (spec.n_dom_cand
                                             if spec.affine_doms else 1))
        discr = urdot * urdot - dr2 + R2
        smin1 = urdot - torch.sqrt(torch.clamp(discr, min=0.0)) \
            * sc["inv_pancake"]
        good = valid & (discr >= 0.0) & (smin1 >= 0.0) \
            & (smin1 < best_all[:, None])
        best, jm = torch.min(torch.where(good, smin1, big(smin1)), dim=1)
        better = best < best_all
        dom = off + m.gather(1, jm[:, None])[:, 0].to(torch.int64)
        best_all = torch.where(better, best, best_all)
        dom_all = torch.where(better, dom, dom_all)
    hit = best_all < d_prop
    return hit, torch.where(hit, best_all, d_prop), dom_all


def _seed64(seed: int, call_no: int) -> int:
    return int(np.random.SeedSequence([int(seed) & (2 ** 63 - 1),
                                       int(call_no)]).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)


# default record-buffer capacity per launch: 2**21 records of NRC float32
# columns (185 MB).  Propagation in record mode drains in one launch when
# its records fit; SAVE_ALL at the main path's 1.8e7 photons takes ~9
# launches at prescale 1, each stall costing only a relaunch.
REC_CAPACITY = 1 << 21


def default_rec_capacity(spec: FusedSpec) -> int:
    """Records one launch can produce at most: one per slot and iteration,
    plus one pending record per slot, bounded by REC_CAPACITY."""
    return min(REC_CAPACITY, spec.n_slots * (spec.iters_per_call + 1))


class _RecordBuffer:
    """The kernel's record buffer in plain PyTorch.  Records are written in
    slot order until `capacity` are in; the lanes whose record does not fit
    are returned and sit out the rest of the launch with it pending (the
    CUDA kernel's stall rule, where the order is that of the atomics)."""

    def __init__(self, capacity: int):
        self.capacity, self.rows, self.n, self.stalled = capacity, [], 0, 0

    def push(self, lanes, cols: dict):
        room = max(self.capacity - self.n, 0)
        fit = lanes[:room]
        if fit.numel():
            self.rows.append(torch.stack([cols[c][fit] for c in REC_COLUMNS],
                                         1))
            self.n += int(fit.numel())
        self.stalled += int(lanes.numel() - fit.numel())
        return lanes[room:]

    def result(self, device):
        return (torch.cat(self.rows) if self.rows
                else torch.zeros((0, NRC), device=device))


def _pending_columns(st: E.SlotState, rs: E.RecState, sb: StepBatch, pend,
                     rec_all: bool) -> dict:
    """Record columns rebuilt from the state rows of dead, recorded photons
    (x/y/z hold the record position, t the record time)."""
    n = st.x.shape[0]
    return dict(
        pos_x=st.x, pos_y=st.y, pos_z=st.z, time=st.t, dir_x=st.dx,
        dir_y=st.dy, dir_z=st.dz, wavelength=rs.wlen,
        identifier=sb.identifier.to(torch.float32), start_x=rs.start_x,
        start_y=rs.start_y, start_z=rs.start_z, start_time=rs.start_t,
        start_dx=rs.start_dx, start_dy=rs.start_dy, start_dz=rs.start_dz,
        inv_gv=st.inv_gv, num_scatters=rs.n_scat, dist_in_abs_lens=rs.dist_abs,
        flat_idx=pend, weight=torch.zeros_like(st.w0) if rec_all else st.w0,
        slot=torch.arange(n, device=st.x.device, dtype=torch.float32))


def run_fused_iterations_plain(state, steps, tables: FusedTables,
                               spec: FusedSpec, *, uniforms=None, keys=None,
                               seed=0, call_no=0, hist=None,
                               rec_capacity=None, n_active=None):
    """The kernel's computation in plain PyTorch: up to iters_per_call
    iterations of engine._iteration on the kernel's state layout, with the
    kernel's collision test.  Updates `state` in place and returns
    the histogram with this launch's deposits added to `hist` (allocated
    when None).  The collision test is the kernel's: SubPlans, or the
    global plan (affine or general) when the spec has none; tabulated media
    need nothing more (engine._iteration reads tables.medium).  Its random numbers come from a torch.Generator unless
    `uniforms` (T, 8, N) is given, or, with spec.threefry, from `keys`, the
    (2T,) table of per-iteration threefry keys (iteration i draws
    rng.uniforms(keys[2i:2i+2], (N,), 8), as the kernel does).

    With spec.records the records of the engine's record block are kept
    as (R, NRC) rows under the kernel's capacity rule (_RecordBuffer), and
    the return value gains them (see run_fused_iterations).

    `n_active` (default: every slot) runs the first n_active slots alone,
    as the kernel's launch over the live prefix does: the slots past it
    are left untouched, and slot s still reads column s of the stream (the
    kernel's row stride stays n_slots)."""
    # the score function's primal factor is exp(0) = 1: the kernel and its
    # plain version compute the primal only
    cfg = dataclasses.replace(spec.cfg, score_function=False)
    dev = state.device
    full, n_all = state, state.shape[1]
    n_active = _check_active(n_all if n_active is None else n_active, n_all)
    if n_active < n_all:
        state, steps = state[:, :n_active], steps[:, :n_active]
        if uniforms is not None:
            uniforms = uniforms[:, :, :n_active]
    st = E.SlotState(*state[:NSF].unbind(0))
    sb = StepBatch(**{f: steps[k] for k, f in enumerate(STEP_FIELDS)},
                   num_photons=st.photons_left)
    acc = E._init_acc(spec.n_doms, cfg, dev)
    if hist is not None:
        acc = acc._replace(hist=hist)
    generator = None
    if spec.threefry:
        if keys is None or uniforms is not None:
            raise ValueError("threefry mode draws from `keys` alone")
        uniforms = lambda i: rng.uniforms(keys[2 * i:2 * i + 2], (n_all,),
                                          8)[:, :n_active]
    elif uniforms is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(_seed64(seed, call_no))
    tally = {}
    if spec.sub_plans:
        collide = lambda s, d, a: _check_collisions_subplan(s, tables, spec,
                                                            d, a)
    else:
        collide = lambda s, d, a: _check_collisions_global(s, tables, spec,
                                                           d, a, tally)
    rs = emit = enabled = None
    if spec.records:
        rows = state[NSF:].unbind(0)
        rs = E.RecState(*rows[:-1], total_path=torch.zeros_like(st.x))
        pend = rows[-1].clone()
        buf = _RecordBuffer(default_rec_capacity(spec) if rec_capacity is None
                            else rec_capacity)
        enabled = torch.ones_like(pend, dtype=torch.bool)
        # pending records from the last launch go first
        lanes = torch.nonzero(pend >= 0.0)[:, 0]
        if lanes.numel():
            stalled = buf.push(lanes, _pending_columns(st, rs, sb, pend,
                                                       spec.rec_all))
            written = lanes[:lanes.numel() - stalled.numel()]
            pend[written] = -1.0
            enabled[stalled] = False
        recorded = []
        emit = lambda mask, raw: recorded.append((mask, raw))
    for i in range(spec.iters_per_call):
        if i % 16 == 0:
            live = (st.in_flight > 0.5) | (st.photons_left > 0.5)
            if not bool((live if enabled is None else live & enabled).any()):
                break
        st, acc, rs, _ = E._iteration(
            i, st, acc, sb, tables.medium, None, tables.spectra, cfg,
            generator=generator, uniforms=uniforms, collide=collide,
            rstate=rs, dom_xyz=tables.doms[:, :3], emit=emit,
            enabled=enabled, tally=tally)
        if spec.records:
            # the photon is dead: its x/y/z keep the record position
            mask, raw = recorded.pop()
            st = st._replace(**{a: torch.where(mask, raw["pos_" + a], v)
                                for a, v in (("x", st.x), ("y", st.y),
                                             ("z", st.z))})
            stalled = buf.push(torch.nonzero(mask)[:, 0], raw)
            pend[stalled] = raw["flat_idx"][stalled]
            enabled[stalled] = False
    rows = list(st)
    alive = (st.in_flight > 0.5) | (st.photons_left > 0.5)
    if spec.records:
        rows += [getattr(rs, f) for f in REC_STATE_FIELDS[:-1]] + [pend]
        alive = alive | (pend >= 0.0)
    state.copy_(torch.stack(rows))
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    queued = f64(buf.n) if spec.records else acc.n_hits
    stalled = f64(float(spec.records and buf.stalled > 0))
    counters = torch.stack([acc.n_generated, acc.n_hits, acc.weight_hits,
                            zero, alive.sum().to(torch.float64), queued,
                            acc.n_work, stalled]
                           + [f64(tally.get(k, 0)) for k in TALLIES]
                           + [zero] * len(KERNEL_ONLY)).to(torch.float64)
    if spec.records:
        return full, acc.hist, counters, buf.result(dev)
    return full, acc.hist, counters


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

class _Plan(ctypes.Structure):
    """struct PlanParams of csrc/propagate.cuh (all fields 4 bytes)."""
    _fields_ = ([(n, ctypes.c_float) for n in (
        "x0", "y0", "inv_cell", "uz_z0", "uz_dz", "inv_dz", "uz_nd", "minz",
        "maxz")]
        + [(n, ctypes.c_int) for n in (
            "nx", "ny", "k_cand", "n_dom_cand", "rounds", "cell_off")])


class _Params(ctypes.Structure):
    """struct Params of csrc/propagate.cuh (all fields 4 bytes)."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "n_slots", "iters", "K", "L", "n_spec", "n_bias", "nz_tilt",
        "nd_tilt", "aniso", "nbins", "n_plans", "use_uniforms", "n_tables",
        "bias_uniform")]
        + [(n, ctypes.c_uint) for n in ("it0", "seed_lo", "seed_hi")]
        + [(n, ctypes.c_float) for n in (
            "z_start", "layer_h", "alpha", "kappa", "abs_a", "abs_b",
            "abs_d", "abs_e", "an_ca", "an_sa", "an_k1", "an_k2", "an_kz",
            "mean_cos", "liu_frac", "r", "r2", "inv_pancake", "max_seg",
            "hist_t0", "hist_dt", "tilt_z0", "tilt_dz", "tilt_ca",
            "tilt_sa", "bias_x0", "bias_inv_dx")]
        + [("n", ctypes.c_float * 5), ("g", ctypes.c_float * 5),
           ("tilt_d", ctypes.c_float * MAX_TILT_D),
           ("plans", _Plan * MAX_PLANS)]
        + [(n, ctypes.c_int) for n in ("rec_cap", "rec_all")]
        + [(n, ctypes.c_float) for n in ("rec_prescale", "rec_fpk",
                                         "horizon")]
        + [(n, ctypes.c_int) for n in ("soft", "n_ang")]
        + [(n, ctypes.c_float) for n in ("pmt_ax", "pmt_ay", "pmt_az")]
        + [(n, ctypes.c_float) for n in ("c_x0", "c_y0", "c_inv_cell")]
        + [(n, ctypes.c_int) for n in ("c_nx", "c_ny", "c_sectors", "c_qmul",
                                       "c_m", "c_lad", "c_hdr", "c_ent")]
        + [("c_tan", ctypes.c_float * (CULL_MAX_SUB - 1))]
        + [(n, ctypes.c_int) for n in ("n_dom_cand", "n_rounds", "m_rel")]
        + [(n, ctypes.c_float) for n in ("wtab_x0", "wtab_inv_dx")]
        + [(n, ctypes.c_int) for n in ("n_wtab", "ref_table", "n_scat")]
        + [(n, ctypes.c_float) for n in (
            "inv_layer_h", "inv_tilt_dz", "an_il1", "an_il2", "an_il3",
            "an_b2", "an_ik1", "an_ik2", "an_ikz", "liu_beta")]
        + [("n_active", ctypes.c_int)])


def _recip(x) -> float:
    """float32(1 / x) of a float32 value x (0 for x == 0, a field the kernel
    does not read then); as the double is rounded once to float32, it equals
    the card's IEEE 1.0f / x."""
    x = float(np.float32(x))
    return float(np.float32(1.0 / x)) if x != 0.0 else 0.0


def _reciprocals(p) -> None:
    """Fill the parameter block's fields that hold float32(1 / x) of another
    field x (of x's float32 square for an_il*: the kernel multiplies where
    it divided), B2 and the Liu exponent, in float32 as the kernel would
    compute them."""
    f = np.float32
    p.inv_layer_h, p.inv_tilt_dz = _recip(p.layer_h), _recip(p.tilt_dz)
    ks = (p.an_k1, p.an_k2, p.an_kz)
    il = [_recip(f(k) * f(k)) for k in ks]
    p.an_il1, p.an_il2, p.an_il3 = il
    p.an_b2 = float(f(il[0]) + f(il[1]) + f(il[2]))
    p.an_ik1, p.an_ik2, p.an_ikz = (_recip(k) for k in ks)
    g = f(p.mean_cos)
    p.liu_beta = float((f(1.0) - g) / (f(1.0) + g))


def medium_params(fields, sc: dict, n_slots: int, K: int,
                  horizon: float) -> _Params:
    """A parameter block with its medium, spectrum and walk fields set:
    `fields` holds medium_fields' entries (a dict or a FusedSpec), `sc`
    medium_scalars' and max_seg; the other fields are 0."""
    get = fields.get if isinstance(fields, dict) else \
        lambda k: getattr(fields, k)
    p = _Params()
    p.n_slots, p.n_active, p.K, p.horizon = n_slots, n_slots, K, horizon
    for name in ("L", "n_spec", "n_bias", "nz_tilt", "nd_tilt", "n_tables",
                 "n_wtab", "n_scat", "aniso", "bias_uniform", "ref_table"):
        setattr(p, name, int(get(name)))
    for name, _ in _Params._fields_:
        if name in sc and not isinstance(sc[name], list):
            setattr(p, name, sc[name])
    p.n[:] = sc["n"]
    p.g[:] = sc["g"]
    for j, d in enumerate(sc.get("tilt_d", [])):
        p.tilt_d[j] = d
    _reciprocals(p)
    return p


def _params(spec: FusedSpec, tables: FusedTables, use_uniforms: bool,
            seed: int, call_no: int, rec_capacity: int = 0) -> _Params:
    p = medium_params(spec, tables.scalars, spec.n_slots, spec.K,
                      spec.horizon)
    p.iters, p.nbins = spec.iters_per_call, spec.hist_n_bins
    p.n_plans, p.use_uniforms = len(spec.sub_plans), int(use_uniforms)
    p.it0 = (call_no * spec.iters_per_call) & 0xFFFFFFFF
    s = int(seed) & (2 ** 64 - 1)
    p.seed_lo, p.seed_hi = s & 0xFFFFFFFF, s >> 32
    for k, (sp, off) in enumerate(zip(spec.sub_plans, tables.plan_offsets)):
        q = p.plans[k]
        q.x0, q.y0, q.inv_cell = sp.x0, sp.y0, sp.inv_cell
        q.uz_z0, q.uz_dz, q.inv_dz = sp.uz_z0, sp.uz_dz, 1.0 / sp.uz_dz
        q.uz_nd, q.minz, q.maxz = sp.uz_nd, sp.minz, sp.maxz
        q.nx, q.ny, q.k_cand = sp.nx, sp.ny, sp.K_cand
        q.n_dom_cand, q.rounds, q.cell_off = sp.n_dom_cand, sp.rounds, off
    pancake = spec.cfg.pancake_factor
    p.rec_cap, p.rec_all = rec_capacity, int(spec.rec_all)
    p.rec_prescale = spec.rec_prescale
    p.rec_fpk = (pancake - 1.0) / pancake   # the engine's un-pancake factor
    p.soft = int(spec.soft)
    p.n_ang = len(spec.ang_poly)
    p.pmt_ax, p.pmt_ay, p.pmt_az = spec.pmt_axis
    p.c_tan[:] = tables.scalars.get("c_tan", [0.0] * (CULL_MAX_SUB - 1))
    p.n_dom_cand, p.n_rounds = spec.n_dom_cand, spec.n_string_rounds
    p.m_rel = tables.rel.shape[1]
    return p


# kernel modes of csrc/propagate.cu (the `mode` argument of its entry
# points): the deposit mode, flags for threefry draws, the fixed horizon and
# records, and COLL and MED in two bits each
DEP_STOP, DEP_PASS, DEP_EXPECTED = 0, 1, 2
MODE_THREEFRY, MODE_FIXED, MODE_RECORDS = 4, 8, 16
COLL_SHIFT, MED_SHIFT = 5, 7


def kernel_mode(spec: FusedSpec) -> int:
    """The instantiation of the CUDA kernel that serves `spec`: deposit
    mode | MODE_THREEFRY | MODE_FIXED | MODE_RECORDS | COLL << COLL_SHIFT |
    MED << MED_SHIFT.  The main path is mode 0, its record mode (SubPlans,
    closed-form medium) MODE_RECORDS; each launch counts in
    MODE_LAUNCHES[mode]."""
    dep = (DEP_EXPECTED if spec.expected
           else DEP_STOP if spec.stopping else DEP_PASS)
    return (dep | (MODE_THREEFRY if spec.threefry else 0)
            | (MODE_FIXED if spec.fixed_abs else 0)
            | (MODE_RECORDS if spec.records else 0)
            | kernel_coll(spec) << COLL_SHIFT | kernel_med(spec) << MED_SHIFT)


def _check_tensor(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(state, steps, tables: FusedTables, spec: FusedSpec, uniforms,
            seed, call_no, hist, rec_capacity=None, keys=None,
            n_active=None):
    reason = spec_unsupported(spec)
    if reason:
        raise NotImplementedError(reason)
    dev = state.device
    N = spec.n_slots
    f32 = torch.float32
    rows = NSF + (NRSF if spec.records else 0)
    _check_tensor("state", state, (rows, N), f32, dev)
    _check_tensor("steps", steps, (NST, N), f32, dev)
    for name in ("layers", "spec_tab", "bias_tab", "tilt_zc", "cells", "doms",
                 "rel", "strings", "wtab", "scat", "ang"):
        _check_tensor(name, getattr(tables, name), None, f32, dev)
    if tables.doms.shape != (spec.n_doms, 4):
        raise ValueError("DOM table does not match the spec")
    if tables.layers.shape != (3, spec.L) or \
            tables.spec_tab.shape != (spec.n_tables, 3, spec.n_spec) or \
            tables.bias_tab.shape != (2, spec.n_bias) or \
            tables.ang.numel() < len(spec.ang_poly):
        raise ValueError("tables do not match the spec")
    if uniforms is not None:
        _check_tensor("uniforms", uniforms, None, f32, dev)
        if (uniforms.dim() != 3 or uniforms.shape[0] < spec.iters_per_call
                or tuple(uniforms.shape[1:]) != (8, N)):
            raise ValueError(f"uniforms must be (>= {spec.iters_per_call}, "
                             f"8, {N}), got {tuple(uniforms.shape)}")
    keys32 = None
    if spec.threefry:
        if keys is None or uniforms is not None:
            raise ValueError("threefry mode draws from `keys` alone")
        _check_tensor("keys", keys, (2 * spec.iters_per_call,), torch.int64,
                      dev)
        # the uint32 words as the int32 bit patterns the kernel reads
        keys32 = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(
            torch.int32).contiguous()
    n_hist = spec.n_doms * spec.hist_n_bins
    if hist is None:
        hist = torch.zeros(n_hist, dtype=f32, device=dev)
    _check_tensor("hist", hist, (n_hist,), f32, dev)
    # generated, hits, alive, work, then the TALLIES (those before "walk"
    # zero where COLL and MED are 0) and the KERNEL_ONLY counts
    cnt_i = torch.zeros(4 + len(TALLIES) + len(KERNEL_ONLY),
                        dtype=torch.int64, device=dev)
    cnt_w = torch.zeros(1, dtype=torch.float64, device=dev)
    cap = 0
    if spec.records:
        cap = (default_rec_capacity(spec) if rec_capacity is None
               else int(rec_capacity))
        if cap < 1:
            raise ValueError("record capacity must be positive")
        rec_buf = torch.empty((cap, NRC), dtype=f32, device=dev)
        rec_cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    params = _params(spec, tables, uniforms is not None, seed, call_no, cap)
    params.n_active = _check_active(N if n_active is None else n_active, N)

    from .._build import load
    lib = load()
    ptr = lambda t: None if t is None else t.data_ptr()
    mode = kernel_mode(spec)
    args = [mode, ctypes.addressof(params), ptr(state), ptr(steps),
            ptr(uniforms), ptr(tables.layers), ptr(tables.spec_tab),
            ptr(tables.bias_tab), ptr(tables.tilt_zc), ptr(tables.cells),
            ptr(hist), ptr(cnt_i), ptr(cnt_w), ptr(tables.rel),
            ptr(tables.strings), ptr(tables.wtab), ptr(tables.scat)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if spec.records:
        rc = lib.clsim_propagate_records(
            *args, ptr(tables.doms), ptr(rec_buf), ptr(rec_cnt), ptr(keys32),
            stream)
    else:
        rc = lib.clsim_propagate(*args, ptr(tables.ang), ptr(keys32), stream)
    if rc != 0:
        raise RuntimeError("propagation kernel launch failed: "
                           + lib.clsim_error_string(rc).decode())
    MODE_LAUNCHES[mode] += 1
    c = cnt_i.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    if not spec.records:
        counters = torch.cat([torch.stack([c[0], c[1], cnt_w[0], zero, c[2],
                                           c[1], c[3], zero]), c[4:]])
        return state, hist, counters
    with P.wait("rec_count"):
        n_rec = int(rec_cnt)      # appends tried; those past cap stalled
    n_written = min(n_rec, cap)
    f64 = lambda v: torch.tensor(float(v), dtype=torch.float64, device=dev)
    counters = torch.cat([torch.stack([c[0], c[1], cnt_w[0], zero, c[2],
                                       f64(n_written), c[3],
                                       f64(n_rec > cap)]), c[4:]])
    return state, hist, counters, rec_buf[:n_written].clone()


def run_fused_iterations(state, steps, tables: FusedTables, spec: FusedSpec,
                         *, uniforms=None, keys=None, seed=0, call_no=0,
                         hist=None, rec_capacity=None, n_active=None):
    """Run up to spec.iters_per_call propagation iterations on every slot.

    state (NSF, N) float32 ((NSF + NRSF, N) with spec.records) is updated in
    place; hits are deposited into hist (n_doms * n_bins,) float32,
    allocated when None (the plain version returns a new tensor).  Returns (state, hist, counters), counters a
    float64 (N_CNT,) tensor in the CNT_* layout; with spec.records
    (state, hist, counters, rows), rows the (R, NRC) float32 records this
    launch wrote (REC_COLUMNS; at most rec_capacity, default
    default_rec_capacity(spec)).  With spec.threefry the draws come from
    `keys`, the (2 * iters_per_call,) int64 table of per-iteration threefry
    keys (rng.key_table).  `n_active` (default: every slot) launches over
    the first n_active slots only, the live prefix that repack_slots
    leaves: the grid covers them, the slots past them keep their state
    bit for bit, and n_slots stays every row's stride (the random numbers
    of slot s are keyed or read at s whatever n_active is).  CUDA tensors
    launch the CUDA kernel (or raise); CPU tensors run
    run_fused_iterations_plain."""
    if state.device.type == "cuda":
        return _launch(state, steps, tables, spec, uniforms, seed, call_no,
                       hist, rec_capacity, keys=keys, n_active=n_active)
    if state.device.type == "cpu":
        return run_fused_iterations_plain(
            state, steps, tables, spec, uniforms=uniforms, keys=keys,
            seed=seed, call_no=call_no, hist=hist,
            rec_capacity=rec_capacity, n_active=n_active)
    raise ValueError(f"no propagation kernel for device {state.device}")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

# threads a block of csrc/propagate.cuh (BLOCK): a launch over the live
# prefix covers the live slots rounded up to whole blocks
BLOCK = 256
# the call loop repacks between launches while fewer than this share of the
# slots is alive (the JAX call loop's rule, kernel.py:2571-2575)
REPACK_BELOW = 0.9


def _check_active(n_active, n_slots: int) -> int:
    n_active = int(n_active)
    if not 0 < n_active <= n_slots:
        raise ValueError(f"n_active must be in [1, {n_slots}], got "
                         f"{n_active}")
    return n_active


def live_prefix(n_live: int, n_slots: int) -> int:
    """The slots a launch covers after repack_slots left `n_live` live
    slots in front: n_live rounded up to whole blocks, at most n_slots."""
    return min(n_slots, -(-int(n_live) // BLOCK) * BLOCK)


def repack_slots(state, steps_p, balance: bool = False):
    """Balance, then stable-partition the slots between two launches: the
    counterpart of the JAX call loop's do_repack
    (clsim_tpu/propagate/kernel.py:2501-2555), line for line, in torch ops
    on the tensors' device (cumsums and scatters, no sort, no host sync).

    `state` is the (NSF, N) slot state, `steps_p` the (NST, N) step rows.
    Balance (optional): the k-th slot with at least 2 photons left gives
    floor(left / 2) of them to the k-th drained slot, with a copy of its
    step row (identifier included, so hits stay attributed), ranks taken
    from two cumsums.  Photons of one step are i.i.d. given its fields, so
    splitting a slot's remaining count over two slots with independent
    random streams leaves the distribution as it was.  Partition: a stable
    partition, live slots first, state and step rows together.

    The live rule is the kernel's own (csrc/propagate.cuh: a photon in
    flight or photons left, in_flight > 0.5 or photons_left > 0.5).  The
    JAX rule adds `pend > 0`, the TPU kernel's deferred-hit queue; the CUDA
    kernel deposits each hit when it finds it and has no such queue, so
    that term is 0 here.

    Returns (state, steps_p, n_live): new tensors, and the live count as a
    0-d int64 tensor on the device."""
    if state.shape[0] != NSF or steps_p.shape[0] != NST:
        raise ValueError(f"repack_slots takes ({NSF}, N) state and ({NST}, "
                         f"N) step rows, got {tuple(state.shape)} and "
                         f"{tuple(steps_p.shape)}")
    dev = state.device
    n = state.shape[1]
    left, inf = state[0], state[1]
    iota = torch.arange(n, device=dev)
    if balance:
        dead = (left <= 0.5) & (inf <= 0.5)
        donor = left >= 2.0
        drank = torch.cumsum(donor.long(), 0) - 1
        rrank = torch.cumsum(dead.long(), 0) - 1
        n_pairs = torch.minimum(drank[-1], rrank[-1]) + 1
        # rank -> slot; the sentinel column n takes the slots of no rank
        donor_by_rank = torch.full((n + 1,), n, dtype=torch.long, device=dev)
        donor_by_rank.scatter_(0, torch.where(donor, drank, n), iota)
        recip_by_rank = torch.full((n + 1,), n, dtype=torch.long, device=dev)
        recip_by_rank.scatter_(0, torch.where(dead, rrank, n), iota)
        valid = iota < n_pairs
        d_idx = torch.where(valid, donor_by_rank[:n], 0)
        r_idx = torch.where(valid, recip_by_rank[:n], 0)
        give = torch.where(valid, torch.floor(left[d_idx] * 0.5),
                           torch.zeros((), device=dev))
        # invalid pairs add 0 at slot 0
        left = left.index_add(0, d_idx, -give).index_add(0, r_idx, give)
        state = torch.cat([left[None], state[1:]])
        moved = steps_p.index_select(1, d_idx)
        padded = torch.cat([steps_p, steps_p.new_zeros((NST, 1))], 1)
        padded[:, torch.where(valid, r_idx, n)] = moved
        steps_p = padded[:, :n]
    live = (left > 0.5) | (state[1] > 0.5)
    livei = live.long()
    n_live_inc = torch.cumsum(livei, 0)
    pos = torch.where(live, n_live_inc - 1,
                      n_live_inc[-1] + torch.cumsum(1 - livei, 0) - 1)
    perm = torch.zeros(n, dtype=torch.long, device=dev).scatter_(0, pos,
                                                                 iota)
    both = torch.cat([state, steps_p]).index_select(1, perm)
    return (both[:NSF].contiguous(), both[NSF:].contiguous(),
            n_live_inc[-1])


def _run_fused(state, steps_p, tables: FusedTables, spec: FusedSpec, seed,
               max_calls: int, uniforms=None, rec_capacity=None, keys=None,
               repack: bool = False, balance: bool = False):
    """Launch until no slot is alive or max_calls is reached; photons still
    alive after the last call are reported as abandoned (CNT_ALIVE).  With
    `repack`, between two launches while 0 < alive < REPACK_BELOW * N, the
    slots are repacked (repack_slots, with `balance`) and the next launch
    covers the live prefix alone (live_prefix); the one host sync a launch
    reads the alive count and, with balance, the donor count, from which
    the live count after the repack follows.  With spec.records every
    launch's records are kept and the result carries them in the flat
    contract: rec a dict of (1, R) tensors, rec_count [R] (the JAX call
    loop's, kernel.py:2687-2722); records never repack, as in the JAX
    package."""
    if repack and spec.records:
        raise ValueError("the record mode does not repack")
    dev = state.device
    n = spec.n_slots
    hist = torch.zeros(spec.n_doms * spec.hist_n_bins, dtype=torch.float32,
                       device=dev)
    totals = torch.zeros(N_CNT, dtype=torch.float64, device=dev)
    calls, alive, chunks, n_active = 0, 0.0, [], n
    for call_no in range(max_calls):
        out = run_fused_iterations(
            state, steps_p, tables, spec, uniforms=uniforms, keys=keys,
            seed=seed, call_no=call_no, hist=hist, rec_capacity=rec_capacity,
            n_active=n_active)
        state, hist, cnt = out[:3]
        if spec.records:
            chunks.append(out[3])
        totals += cnt
        calls += 1
        last = call_no == max_calls - 1
        with P.wait("alive"):
            if repack and balance and not last:
                alive, donors = torch.stack([
                    cnt[CNT_ALIVE], (state[0] >= 2.0).sum().to(cnt.dtype)]
                ).tolist()
            else:
                alive, donors = float(cnt[CNT_ALIVE]), 0.0
        if alive == 0.0:
            break
        if repack and not last and alive < REPACK_BELOW * n:
            with P.span("repack"):
                state, steps_p, _ = repack_slots(state, steps_p, balance)
                # balance makes one drained slot live for each donor it
                # pairs
                n_active = live_prefix(alive + min(donors, n - alive), n)
    with P.wait("totals"):
        totals[CNT_ALIVE] = alive
        if P.recording_on() and not spec.sub_plans:
            # the global plans' cull: candidates loaded and live
            # slot-iterations, read after the last launch's alive count
            cand, work = totals[[CNT_CAND, CNT_WORK]].tolist()
            P.count("k1_candidates", cand)
            P.count("k1_slot_iterations", work)
    rec = rec_count = None
    if spec.records:
        rows = torch.cat(chunks)
        rec = records_from_rows(rows, spec.hist_n_bins)
        rec_count = torch.tensor([rows.shape[0]], dtype=torch.int32,
                                 device=dev)
    return E.PropagationResult(
        hist=hist.reshape(spec.n_doms, spec.hist_n_bins),
        n_generated=totals[CNT_GEN], n_hits=totals[CNT_HITS],
        weight_hits=totals[CNT_WSUM],
        n_iterations=calls * spec.iters_per_call,
        diag_totals=totals, rec_count=rec_count, rec=rec), totals


def propagate_fused(steps: StepBatch, medium: MediumProperties,
                    geo: DetectorGeometry, spectra: SpectrumTable,
                    seed: int, cfg: PropagationConfig,
                    iters_per_call: int = 4096,
                    max_calls: int = 256,
                    uniforms=None, rec_capacity: int = REC_CAPACITY,
                    threefry_key=None, repack: bool = True,
                    balance: bool = False,
                    allow_uniform_replay: bool = False):
    """Drive the fused kernel until all photons are drained.

    `steps` are slot-assigned tensors on the propagation device.
    `repack` (the JAX package's default, on) repacks the slots between
    launches while 0 < alive < 0.9 N, live slots first, and launches the
    next call over the live prefix alone; `balance` (off by default) also
    hands half the photons of the slots with >= 2 left to drained slots
    (repack_slots).  The record mode never repacks, as in the JAX package.
    `uniforms`: optional (T >= iters_per_call, 8, n_slots) float32 stream
    (parity mode; requires max_calls=1, unless `allow_uniform_replay`:
    then every call replays rows [0, iters_per_call) of the stream, for
    conservation checks, and repacks as any run).  `threefry_key`: optional threefry
    key (ops/rng.py), exclusive with `uniforms`, with any estimator and with
    records: the kernel draws in-kernel the stream
    rng.make_uniform_stream(threefry_key, iters_per_call, N) would hold,
    from the folded per-iteration keys (requires max_calls=1: the key table
    covers one call's iterations, as in the JAX package).  With
    cfg.save_photons each launch writes at most `rec_capacity` records
    (fewer when the workload has fewer photons).  A record that does not
    fit stalls its slot until the next launch, which a threefry run does
    not have (its one call's keys would be reused); so a threefry record
    run needs room for every record, rec_capacity >= the photons + 1, and
    raises otherwise (the JAX kernel would drop the records past its queue,
    CNT_DROPPED).  The collision plan and the device tables are kept
    between calls while their inputs are unchanged (plan_call).  Returns
    (PropagationResult, totals) with totals the float64 CNT_* vector."""
    if cfg.save_photons and cfg.photon_history_entries > 0:
        raise NotImplementedError(HISTORY_REFUSED)
    reason = fused_supported(medium, spectra, cfg)
    if reason:
        raise ValueError(f"fused path unsupported: {reason}")
    if uniforms is not None and max_calls != 1 and not allow_uniform_replay:
        raise ValueError("external uniforms (parity mode) require "
                         "max_calls=1: each call would replay the same "
                         "uniform stream (pass allow_uniform_replay=True "
                         "for conservation checks where that is "
                         "acceptable)")
    if threefry_key is not None:
        if uniforms is not None:
            raise ValueError("threefry_key and uniforms are exclusive")
        if max_calls != 1:
            raise ValueError("threefry_key requires max_calls=1 (the key "
                             "table covers one call's iterations)")
    n = int(steps.x.shape[0])
    with P.span("plan"):
        # one sync: the largest per-slot photon count and the source_type
        # range
        with P.wait("check"):
            top, lo, hi = torch.stack([a.to(torch.int64) for a in (
                steps.num_photons.max(), steps.source_type.min(),
                steps.source_type.max())]).tolist()
        if top >= 2 ** 24:
            raise ValueError("per-slot photon counts must stay below 2^24 "
                             "(float32 slot state); use more slots")
        check_source_types(lo, hi, int(spectra.x.shape[0]))
        spec, tables = plan_call(medium, geo, spectra, cfg, n,
                                 iters_per_call,
                                 threefry=threefry_key is not None)
        reason = spec_unsupported(spec)
        if reason:
            raise NotImplementedError(reason)
        keys = None
        if threefry_key is not None:
            # per-iteration folded keys, bit-identical to rng.iter_key
            keys = rng.key_table(threefry_key, iters_per_call).to(
                steps.x.device)
        if spec.records:
            # a run records at most one record per photon
            with P.wait("rec_photons"):
                photons = int(steps.num_photons.sum())
            if threefry_key is not None and int(rec_capacity) < photons + 1:
                raise ValueError(
                    f"threefry_key with save_photons needs rec_capacity >= "
                    f"the photons + 1 ({photons + 1}), got "
                    f"{int(rec_capacity)}: a record that finds the buffer "
                    "full waits for the next launch, and the key table "
                    "covers one call")
            rec_capacity = min(int(rec_capacity), photons + 1)
    # the state and the packed steps go in as temporaries: a repack in
    # _run_fused then frees them
    return _run_fused(init_state(steps, spec.records), pack_steps(steps),
                      tables, spec, seed, max_calls, uniforms=uniforms,
                      rec_capacity=rec_capacity, keys=keys,
                      repack=repack and not spec.records, balance=balance)
