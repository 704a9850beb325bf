"""The tabulator's CUDA kernel (csrc/tabulate.cu): host packing, the key
tables and the launch.

The kernel runs up to `iters` tabulator iterations per launch, one thread a
photon slot, and adds each comb sub-step's weight into the float64 table on
the card with atomicAdd (the reference's TABULATE branch,
propagation_kernel.c.cl:296-304).  It reads

  * the propagation kernel's parameter block (propagate/kernel.py
    medium_params: the medium, the spectra and the layer walk; the
    collision and histogram fields stay 0) and the medium's device tables
    (medium_device_tables);
  * its own block, _TabParams: the axes (kind, per dimension min, max, data
    bins, power, Axis.index_constants and the strides of flat_index), the
    source frame, min_inv_gv and tan_theta_c, the comb's step length and
    length, and the angular acceptance;
  * the slot state: the propagation kernel's NSF rows and the comb's
    remainder, (NSF + 1, N) float32; the steps as pack_steps' (NST, N)
    rows; the int32 list of the slots the launch serves (thread t serves
    slot list[t] and draws with that slot's index), or every slot;
  * the key tables of the launch (launch_keys): iteration i's folded key and,
    with the impact axis, sub-step m's impact key, folded on the host by
    ops/rng.py, so the kernel draws the JAX package's numbers bit for bit;
  * the counters, TAB_COUNTERS, the plain version's too.

tab_unsupported names what the kernel does not serve; the wrapper raises
NotImplementedError with it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..medium.properties import MediumProperties
from ..ops import rng
from ..ops.spectrum import SpectrumTable
from ..propagate import kernel as K

TAB_MAX_DIM = 5
TAB_MAX_ANG = 16
IMPACT_SALT = 0x1A7B      # folded into the iteration key for impact draws
# iterations a kernel launch (a host sync each) while more than half the
# slots live, and after that, when the launches serve the live slots alone
TAB_LAUNCH_ITERS = 512
TAB_TAIL_ITERS = 128

# the launch's counters, in this order (csrc/tabulate.cu CNT_*, the weight
# sum second): nonzero comb sub-steps, their float64 weight sum, sub-steps
# tested (inside their segment), live slot-iterations, layer-walk steps,
# slots alive at the end, photons made, and the kernel-only counts
# (KERNEL_ONLY, 0 in the plain version): the table atomics (one a nonzero
# sub-step); warp-iterations run (with a live lane); the comb's
# lane-slots its rounds took (32 x rounds, summed over warp-iterations);
# and each warp's clock cycles (lane 0's) in the spawn, the walk, the
# comb's coordinates and bins, its weights and table atomics, and the
# advance and scatter
TAB_COUNTERS = ("entries", "weight", "substeps", "work", "walk", "alive",
                "generated", "atomics", "warps", "comb_slots",
                "cyc_spawn", "cyc_walk", "cyc_coords", "cyc_weight",
                "cyc_scatter")
KERNEL_ONLY = TAB_COUNTERS[7:]
N_TAB_INT = len(TAB_COUNTERS) - 1
LAUNCHES = {"tabulate": 0}   # kernel launches (the plain version counts none)


class _TabParams(ctypes.Structure):
    """struct TabParams of csrc/tabulate.cu."""
    _fields_ = ([("n_bins", ctypes.c_longlong),
                 ("stride", ctypes.c_longlong * TAB_MAX_DIM),
                 ("step_len", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in ("n_slots", "iters", "n_sub",
                                               "n_ang", "n_list")]
                + [(n, ctypes.c_int * TAB_MAX_DIM) for n in ("ax_n",
                                                             "ax_pow")]
                + [(n, ctypes.c_float * TAB_MAX_DIM) for n in (
                    "ax_min", "ax_max", "ax_scale", "ax_off", "ax_ipow")]
                + [(n, ctypes.c_float) for n in (
                    "src_x", "src_y", "src_z", "src_t", "src_dx", "src_dy",
                    "src_dz", "src_px", "src_py", "src_pz", "min_inv_gv",
                    "tan_theta_c")]
                + [("ang", ctypes.c_float * TAB_MAX_ANG)])


class TabBlock(NamedTuple):
    """What one tabulate() run hands the kernel: both parameter blocks, the
    medium's device tables and the instantiation."""
    params: K._Params
    tab: _TabParams
    tables: dict          # layers, spec_tab, bias_tab, tilt_zc, wtab
    mode: int             # MED | CYL << 1 | IMPACT << 2
    n_sub: int            # comb sub-steps a segment, at most
    impact: bool
    unsupported: Optional[str]


def tab_mode(medium: MediumProperties, axes) -> int:
    """The instantiation: MED 0 for closed-form ice, 1 for a tabulated
    medium (photonics tables or water: they spawn alike, and the tabulator
    scatters every medium by the HG / Liu mixture); CYL; IMPACT."""
    med = int(medium.medium_kind != "icecube")
    cyl = int(getattr(axes, "kind", "spherical") == "cylindrical")
    return med | cyl << 1 | int(bool(axes.impact_angle)) << 2


TOO_MANY_SLOTS = ("tabulator draws need 9 * n_slots < 2**32 (one 32-bit "
                  "counter per element of an iteration's (9, N) block)")


def tab_unsupported(fields: dict, axes, n_ang: int) -> Optional[str]:
    """None if the kernel serves this medium, these axes and this angular
    acceptance, else why not (the slot count is checked at each launch:
    TOO_MANY_SLOTS)."""
    if fields["n_bias"] < 2:
        return (f"the bias grid has {fields['n_bias']} point(s); the kernel "
                "interpolates between two at least")
    if fields["nd_tilt"] > K.MAX_TILT_D:
        return (f"the tilt has {fields['nd_tilt']} distances, the kernel "
                f"takes <= {K.MAX_TILT_D}")
    if getattr(axes, "kind", None) not in ("spherical", "cylindrical"):
        return f"axes of kind {getattr(axes, 'kind', None)!r}"
    if not axes.impact_angle and not 1 <= n_ang <= TAB_MAX_ANG:
        return (f"the angular acceptance has {n_ang} coefficients, the "
                f"kernel takes 1 to {TAB_MAX_ANG}")
    return None


def pack(medium: MediumProperties, spectra: SpectrumTable, source, axes,
         angular_coeffs, cfg, step_length: float, min_inv_gv: float,
         tan_theta_c: float, horizon: float, n_sub: int) -> TabBlock:
    """Both parameter blocks of a tabulate() run (n_slots and iters are set
    per launch) and the medium's device tables."""
    fields = K.medium_fields(medium, spectra)
    sc = K.medium_scalars(medium, spectra)
    sc["max_seg"] = float(cfg.max_segment_m)
    params = K.medium_params(fields, sc, 0, cfg.max_layer_steps, horizon)
    tab = _TabParams()
    tab.n_bins = axes.n_bins
    tab.step_len = float(step_length)
    tab.n_sub = n_sub
    for a, (ax, stride) in enumerate(zip(axes.axes, axes.strides)):
        scale, offset = ax.index_constants()
        tab.stride[a] = stride
        tab.ax_n[a], tab.ax_pow[a] = ax.n_bins, ax.power
        tab.ax_min[a], tab.ax_max[a] = ax.min, ax.max
        tab.ax_scale[a], tab.ax_off[a] = scale, offset
        tab.ax_ipow[a] = 1.0 / ax.power
    host = lambda t: [float(v) for v in torch.as_tensor(t).detach().cpu(
        ).reshape(-1).to(torch.float32)]
    tab.src_x, tab.src_y, tab.src_z = host(source.pos)
    (tab.src_t,) = host(source.time)
    tab.src_dx, tab.src_dy, tab.src_dz = host(source.dir)
    tab.src_px, tab.src_py, tab.src_pz = host(source.perp)
    tab.min_inv_gv, tab.tan_theta_c = min_inv_gv, tan_theta_c
    ang = host(angular_coeffs)
    tab.n_ang = len(ang)
    for j, c in enumerate(ang[:TAB_MAX_ANG]):
        tab.ang[j] = c
    return TabBlock(
        params=params, tab=tab,
        tables=K.medium_device_tables(medium, spectra,
                                      fields["medium_tables"]),
        mode=tab_mode(medium, axes), n_sub=n_sub,
        impact=bool(axes.impact_angle),
        unsupported=tab_unsupported(fields, axes, tab.n_ang))


class TabKeys(NamedTuple):
    """The key tables of one launch, int64 (uint32 words): iteration i0 + i's
    key at [i] and, with the impact axis, sub-step m's impact key at
    [i, m]."""
    iter: torch.Tensor              # (iters, 2)
    impact: Optional[torch.Tensor]  # (iters, n_sub, 2) or None


def launch_keys(key, i0: int, iters: int, n_sub: int, impact: bool,
                device) -> TabKeys:
    """The key tables of iterations i0 .. i0 + iters - 1 of a batch with key
    `key`, folded on the CPU (a few hundred small integer ops) and copied to
    `device`."""
    k = rng.as_key(key, "cpu")
    ik = rng.fold_in(k, torch.arange(i0, i0 + iters, dtype=torch.int64))
    sub = None
    if impact:
        sub = rng.fold_in(rng.fold_in(ik, IMPACT_SALT)[:, None, :],
                          torch.arange(n_sub, dtype=torch.int64))
        sub = sub.to(device)
    return TabKeys(iter=ik.to(device), impact=sub)


def _words(t: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64, as the int32 bit patterns the kernel
    reads."""
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(
        torch.int32).contiguous()


def launch(block: TabBlock, state: torch.Tensor, steps: torch.Tensor,
           keys: TabKeys, table: torch.Tensor,
           slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel for keys.iter.shape[0] iterations on the current
    stream, one thread for each slot of `slots` (int32, the live slots in
    any order; None serves every slot): `state` ((NSF + 1, N) float32) is
    updated in place and `table` (axes.n_bins float64) receives the
    deposits.  Returns the float64 TAB_COUNTERS vector on the device (no
    host sync).  Raises NotImplementedError for inputs the kernel does not
    serve, ValueError for an empty slot list and RuntimeError when the
    launch fails."""
    if block.unsupported:
        raise NotImplementedError(block.unsupported)
    dev = state.device
    n = state.shape[1]
    iters = int(keys.iter.shape[0])
    K._check_tensor("state", state, (K.NSF + 1, n), torch.float32, dev)
    K._check_tensor("steps", steps, (K.NST, n), torch.float32, dev)
    K._check_tensor("table", table, (block.tab.n_bins,), torch.float64, dev)
    K._check_tensor("keys", keys.iter, (iters, 2), torch.int64, dev)
    if block.impact:
        K._check_tensor("impact keys", keys.impact, (iters, block.n_sub, 2),
                        torch.int64, dev)
    for name, t in block.tables.items():
        K._check_tensor(name, t, None, torch.float32, dev)
    n_list = n
    if slots is not None:
        n_list = int(slots.shape[0])
        K._check_tensor("slots", slots, (n_list,), torch.int32, dev)
        if n_list == 0:
            raise ValueError("an empty slot list: nothing to launch")
    if 9 * n >= 2 ** 32:
        raise NotImplementedError(TOO_MANY_SLOTS)
    params = K._Params.from_buffer_copy(block.params)
    params.n_slots = n
    tab = _TabParams.from_buffer_copy(block.tab)
    tab.n_slots, tab.iters, tab.n_list = n, iters, n_list
    cnt_i = torch.zeros(N_TAB_INT, dtype=torch.int64, device=dev)
    cnt_w = torch.zeros(1, dtype=torch.float64, device=dev)
    w_keys = _words(keys.iter)
    w_sub = _words(keys.impact) if block.impact else None

    from .._build import load
    lib = load()
    ptr = lambda t: None if t is None else t.data_ptr()
    tb = block.tables
    rc = lib.clsim_tabulate(
        block.mode, ctypes.addressof(params), ctypes.addressof(tab),
        ptr(state), ptr(steps), ptr(slots), ptr(w_keys), ptr(w_sub),
        ptr(tb["layers"]),
        ptr(tb["spec_tab"]), ptr(tb["bias_tab"]), ptr(tb["tilt_zc"]),
        ptr(tb["wtab"]), ptr(table), ptr(cnt_i), ptr(cnt_w),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("tabulator kernel launch failed: "
                           + lib.clsim_error_string(rc).decode())
    LAUNCHES["tabulate"] += 1
    c = cnt_i.to(torch.float64)
    return torch.cat([c[:1], cnt_w, c[1:]])
