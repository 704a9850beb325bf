"""Detector geometry: DOM positions plus the precomputed culling tables used
by the collision test (PyTorch counterpart of clsim_tpu.geometry).

Replacement for the reference's geometry codegen
(private/opencl/I3CLSimHelperGenerateGeometrySource.cxx): instead of emitting
OpenCL source with baked-in constants and per-stringset tables, we build dense
tables once on the host with numpy (bit-identical to the JAX package's) and
move them to the requested device:

  * per-string nominal (x, y), z-range, max lateral DOM deviation
  * per-string dense DOM slots (S, M): exact position, validity, global index
  * per-string z-layer -> DOM-slot lookup (S, L): a layer maps to a DOM if the
    DOM *sphere* (radius = R * oversize) overlaps the layer, matching
    divideIntoLayers (…GenerateGeometrySource.cxx:376-430)

The engine (propagate/engine.py) culls all strings densely and tests the
top-K nearest; the CUDA kernel uses the per-subdetector cell grid that
propagate/kernel.py plans from these tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import DOM_RADIUS

EMPTY = -1


def to_numpy(a, dtype=None):
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class DetectorGeometry(NamedTuple):
    # flat per-DOM arrays (D,)
    dom_x: torch.Tensor
    dom_y: torch.Tensor
    dom_z: torch.Tensor
    dom_string_id: torch.Tensor   # original string IDs (for output mapping)
    dom_om_id: torch.Tensor       # original OM numbers

    # per-string arrays (S,)
    string_x: torch.Tensor        # mean DOM x
    string_y: torch.Tensor
    string_min_z: torch.Tensor    # DOM center range (radius NOT included)
    string_max_z: torch.Tensor
    string_max_r: torch.Tensor    # max 2D deviation of DOMs + collision radius

    # per-string z-layer lookup (S, L) -> flat DOM index or EMPTY
    layer_start_z: torch.Tensor   # (S,)
    layer_height: torch.Tensor    # (S,)
    n_layers: torch.Tensor        # (S,) int32
    layer_to_dom: torch.Tensor    # (S, L) int32

    # dense per-string DOM slots (S, M, 4): x, y, z, flat index (-1 empty)
    string_dom_table: torch.Tensor

    # per-string collision tables, as in the JAX package:
    #  * string_features (S, 8): x, y, min_z, max_z, z0_fit, dz_fit,
    #    dom_offset, n_doms
    #  * string_dom_rel (S, M, 4): dx, dy, dz residuals vs the string
    #    position / fitted z grid and a validity flag; flat DOM index =
    #    dom_offset + slot
    string_features: torch.Tensor
    string_dom_rel: torch.Tensor

    om_radius: float             # nominal DOM radius [m] (static)
    oversize: float              # oversize factor (static)
    max_string_r: float          # global max of string_max_r (static)
    min_layer_height: float      # static, for window sizing

    @property
    def n_doms(self):
        return self.dom_x.shape[0]

    @property
    def n_strings(self):
        return self.string_x.shape[0]

    @property
    def collision_radius(self):
        """Effective collision sphere radius R * oversize
        (sparse_collision_kernel.c.cl:118)."""
        return self.om_radius * self.oversize


def build_geometry(string_ids, om_ids, xs, ys, zs,
                   om_radius: float = DOM_RADIUS,
                   oversize: float = 1.0,
                   max_layers: int = 1024,
                   device="cuda") -> DetectorGeometry:
    """Build culling tables from flat per-DOM arrays (the equivalent of
    I3CLSimSimpleGeometry, public/clsim/I3CLSimSimpleGeometry.h:39-61)."""
    string_ids = np.asarray(string_ids, np.int32)
    om_ids = np.asarray(om_ids, np.int32)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    zs = np.asarray(zs, np.float64)
    n = len(xs)
    if not (len(ys) == len(zs) == len(string_ids) == len(om_ids) == n):
        raise ValueError("geometry arrays must have equal length")

    # group DOMs by string in the flat arrays so a DOM's flat index is
    # string_dom_offset + slot (computed arithmetically in the engine)
    order = np.argsort(string_ids, kind="stable")
    string_ids = string_ids[order]
    om_ids = om_ids[order]
    xs, ys, zs = xs[order], ys[order], zs[order]

    r_col = om_radius * oversize

    unique_strings = np.unique(string_ids)
    n_strings = len(unique_strings)

    s_x = np.zeros(n_strings)
    s_y = np.zeros(n_strings)
    s_minz = np.zeros(n_strings)
    s_maxz = np.zeros(n_strings)
    s_maxr = np.zeros(n_strings)
    layer_start = np.zeros(n_strings)
    layer_h = np.zeros(n_strings)
    n_layers = np.zeros(n_strings, np.int32)

    tables = []
    for si, sid in enumerate(unique_strings):
        sel = np.nonzero(string_ids == sid)[0]
        sx, sy = xs[sel].mean(), ys[sel].mean()
        s_x[si], s_y[si] = sx, sy
        s_minz[si], s_maxz[si] = zs[sel].min(), zs[sel].max()
        dev = np.sqrt((xs[sel] - sx) ** 2 + (ys[sel] - sy) ** 2)
        s_maxr[si] = dev.max() + r_col

        lo = zs[sel].min() - r_col
        hi = zs[sel].max() + r_col
        span = max(hi - lo, 4.0 * r_col)
        # choose the smallest layer count for which no layer overlaps two
        # different DOM spheres
        nl = max(len(sel), 1)
        while True:
            h = span / nl
            table = np.full(nl, EMPTY, np.int64)
            conflict = False
            for d in sel:
                zc = zs[d]
                l0 = int(np.floor((zc - r_col - lo) / h))
                l1 = int(np.floor((zc + r_col - lo) / h))
                for li in range(max(l0, 0), min(l1, nl - 1) + 1):
                    if table[li] != EMPTY and table[li] != d:
                        conflict = True
                        break
                    table[li] = d
                if conflict:
                    break
            if not conflict:
                break
            nl *= 2
            if nl > max_layers:
                raise ValueError(
                    f"string {sid}: cannot separate DOM spheres into "
                    f"<= {max_layers} z-layers (overlapping DOMs?)")
        layer_start[si] = lo
        layer_h[si] = h
        n_layers[si] = nl
        tables.append(table)

    max_nl = max(len(t) for t in tables)
    layer_to_dom = np.full((n_strings, max_nl), EMPTY, np.int64)
    for si, t in enumerate(tables):
        layer_to_dom[si, :len(t)] = t

    max_doms = max(int((string_ids == sid).sum()) for sid in unique_strings)
    dom_table = np.zeros((n_strings, max_doms, 4), np.float32)
    dom_table[:, :, 3] = -1.0
    string_features = np.zeros((n_strings, 8), np.float32)
    dom_rel = np.zeros((n_strings, max_doms, 4), np.float32)
    for si, sid in enumerate(unique_strings):
        sel = np.nonzero(string_ids == sid)[0]
        dom_table[si, :len(sel), 0] = xs[sel]
        dom_table[si, :len(sel), 1] = ys[sel]
        dom_table[si, :len(sel), 2] = zs[sel]
        dom_table[si, :len(sel), 3] = sel.astype(np.float32)

        # least-squares z grid fit; residuals go into string_dom_rel
        k = np.arange(len(sel), dtype=np.float64)
        if len(sel) > 1:
            dz_fit, z0_fit = np.polyfit(k, zs[sel], 1)
        else:
            dz_fit, z0_fit = 0.0, zs[sel][0]
        string_features[si] = [s_x[si], s_y[si], s_minz[si], s_maxz[si],
                               z0_fit, dz_fit, float(sel[0]), float(len(sel))]
        dom_rel[si, :len(sel), 0] = xs[sel] - s_x[si]
        dom_rel[si, :len(sel), 1] = ys[sel] - s_y[si]
        dom_rel[si, :len(sel), 2] = zs[sel] - (z0_fit + dz_fit * k)
        dom_rel[si, :len(sel), 3] = 1.0
        max_res = np.abs(dom_rel[si, :len(sel), :3]).max() if len(sel) else 0.0
        if max_res > 30.0:
            raise ValueError(
                f"string {sid}: DOM positions deviate {max_res:.1f} m from "
                "the per-string grid fit (the JAX package rejects such "
                "layouts; kept for identical tables)")

    t = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device=device)
    return DetectorGeometry(
        dom_x=t(xs),
        dom_y=t(ys),
        dom_z=t(zs),
        dom_string_id=t(string_ids, torch.int32),
        dom_om_id=t(om_ids, torch.int32),
        string_x=t(s_x),
        string_y=t(s_y),
        string_min_z=t(s_minz),
        string_max_z=t(s_maxz),
        string_max_r=t(s_maxr),
        layer_start_z=t(layer_start),
        layer_height=t(layer_h),
        n_layers=t(n_layers, torch.int32),
        layer_to_dom=t(layer_to_dom, torch.int32),
        string_dom_table=t(dom_table),
        string_features=t(string_features),
        string_dom_rel=t(dom_rel),
        om_radius=float(om_radius),
        oversize=float(oversize),
        max_string_r=float(s_maxr.max()),
        min_layer_height=float(layer_h.min()),
    )


def single_string_geometry(n_doms: int = 24, spacing: float = 17.0,
                           x: float = 0.0, y: float = 0.0,
                           z_top: float = 200.0, oversize: float = 1.0,
                           om_radius: float = DOM_RADIUS,
                           device="cuda") -> DetectorGeometry:
    """A minimal test detector: one vertical string of n DOMs (the analog of
    the reference benchmark's 24-DOM minimal GCD, resources/scripts/benchmark.py)."""
    zs = z_top - spacing * np.arange(n_doms)
    return build_geometry(
        string_ids=np.ones(n_doms, np.int32),
        om_ids=np.arange(1, n_doms + 1, dtype=np.int32),
        xs=np.full(n_doms, x), ys=np.full(n_doms, y), zs=zs,
        om_radius=om_radius, oversize=oversize, device=device)


def hexagonal_geometry(n_rings: int = 3, string_spacing: float = 125.0,
                       doms_per_string: int = 60, dom_spacing: float = 17.0,
                       z_top: float = 500.0, oversize: float = 1.0,
                       om_radius: float = DOM_RADIUS,
                       device="cuda") -> DetectorGeometry:
    """IceCube-like hexagonal string grid for tests/benchmarks (n_rings=5 is
    roughly the full 86-string array scale)."""
    centers = [(0.0, 0.0)]
    for ring in range(1, n_rings + 1):
        for k in range(6 * ring):
            side = k // ring
            step = k % ring
            a0 = np.pi / 3.0 * side
            a1 = np.pi / 3.0 * (side + 2)
            x = ring * np.cos(a0) + step * np.cos(a1)
            y = ring * np.sin(a0) + step * np.sin(a1)
            centers.append((x * string_spacing, y * string_spacing))
    sids, oids, xs, ys, zs = [], [], [], [], []
    for si, (cx, cy) in enumerate(centers):
        for d in range(doms_per_string):
            sids.append(si + 1)
            oids.append(d + 1)
            xs.append(cx)
            ys.append(cy)
            zs.append(z_top - d * dom_spacing)
    return build_geometry(sids, oids, xs, ys, zs,
                          om_radius=om_radius, oversize=oversize,
                          device=device)


def advise_strings_per_photon(geo: DetectorGeometry, max_segment_m: float,
                              configured: int = 2):
    """Static geometry check for the top-K closest-string collision
    approximation (cfg.strings_per_photon).

    The reference tests EVERY culled string
    (sparse_collision_kernel.c.cl:462-587); we rank candidates by 2-D
    axis distance and test only the K closest.  That is exact whenever a
    closer string that overlaps the photon's z-range cannot "shadow" a
    farther true hit -- but with *heterogeneous* z-coverage (DeepCore-style
    infill, partial strings) a near string can pass the 2-D cull while
    having no DOMs anywhere near the photon's z, pushing the true hit to
    rank K+1.

    Returns (recommended_K, reason_or_None).  Heuristic: K=2 suffices for
    homogeneous z-coverage; with heterogeneous coverage recommend
    min(max co-reachable string count, 4).
    """
    sx = to_numpy(geo.string_x, np.float64)
    sy = to_numpy(geo.string_y, np.float64)
    minz = to_numpy(geo.string_min_z, np.float64)
    maxz = to_numpy(geo.string_max_z, np.float64)
    reach = float(max_segment_m) + to_numpy(geo.string_max_r,
                                            np.float64).max()
    d2 = (sx[:, None] - sx[None, :]) ** 2 + (sy[:, None] - sy[None, :]) ** 2
    near = d2 <= reach * reach
    co_reach = int(near.sum(axis=1).max())
    # provable shadowing risk: two co-reachable strings whose DOM z-ranges
    # are disjoint (beyond the collision radius) -- a photon in one range
    # can rank the other string first yet never hit it
    rcol = float(geo.om_radius) * float(geo.oversize)
    gap = np.maximum(minz[:, None] - maxz[None, :],
                     minz[None, :] - maxz[:, None])
    hetero = bool((near & (gap > rcol)).any())
    if not hetero:
        return max(2, min(configured, co_reach)), None
    rec = min(max(3, configured), co_reach, 4)
    reason = None
    if configured < rec:
        reason = (
            f"geometry has heterogeneous string z-coverage "
            f"(min_z spread {np.ptp(minz):.0f} m, max_z spread "
            f"{np.ptp(maxz):.0f} m) and up to {co_reach} strings reachable "
            f"per segment; strings_per_photon={configured} can miss hits "
            f"shadowed by DOM-free near strings -- recommend >= {rec}")
    return rec, reason
