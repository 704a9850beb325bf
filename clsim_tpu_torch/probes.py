"""Probe kernels: the Hopper counterparts of the JAX package's Pallas
cost-model probes (scripts/probe_pallas*.py, P1-P15), as four CUDA kernels
(csrc/probes.cu) that measure what bounds the photon propagation kernel on
the card:

    probe_fetch    (H1) table reads, latency hiding, divergence
    probe_state    (H2) state in registers, shared or local memory
    probe_ops      (H3) the cost of an op, Philox draws
    probe_deposit  (H4) atomics, appends, scans, transposes

Each wrapper launches its kernel for CUDA tensors (and raises when the
launch fails) and runs its plain PyTorch version, `*_plain`, for CPU
tensors; LAUNCHES counts the kernel launches of each.  Every variant
computes what its TPU probe computes: the same inputs give the same outputs,
exactly where the kernel rounds every product and sum on its own as the
plain version does, within the tolerance `run_probes` states elsewhere.

    python -m clsim_tpu_torch.probes     # every probe on the card, a table

runs `run_probes` at the propagation kernel's full width (262,144 lanes)
and prints each variant's time, the plain version's, the bound, the
library call's where one PyTorch call computes the function, and the
figure the variant measures.  The module imports neither JAX nor the JAX
package: the probes' sizes are copied below.
"""

from __future__ import annotations

import ctypes
import math
import re
import statistics

import numpy as np
import torch

# ---------------------------------------------------------------------------
# the TPU probes' sizes (scripts/probe_pallas*.py)
# ---------------------------------------------------------------------------

LANES = 262144                  # probes 4-9's G x BLK: 32 x 8,192
P1_S = 88                       # probe_pallas.py: S, C, R
P2_C, P2_S = 16, 88
P3_DRAWS, P3_SEG = 10, 128
P4_T, P5_R = 8, 24
P6_C, P6_S, P6_T = 16, 88, 32
P7_S, P7_C, P7_T, P7_BLK = 88, 64, 64, 4096   # probe_pallas2.py
P8_S, P8_C, P8_T, P8_SP, P8_BLK = 176, 64, 32, 88, 4096   # probe_pallas3.py
P9_S, P9_C, P9_T = 176, 32, 64               # probe_pallas4.py
P10_T, P10_VPU_OPS = 64, 60                  # probe_pallas5.py, 5b.py
P12_T, P12_CAND = 64, 10                     # probe_pallas6.py
P13_NF, P13_T = 24, 256                      # probe_pallas7.py
P14_NF, P14_T = 18, 512                      # probe_pallas8.py
P15_T = 256                                  # probe_pallas9.py
HIST_BINS = 512                 # types.py: PropagationConfig.hist_n_bins
HEX61_DOMS, IC86_DOMS = 3660, 5080

PB = 256                        # threads a block (csrc/probes.cu)
SMEM_PER_SM = 233472            # 228 KB of shared memory an SM (H100)
SMEM_BLOCK_RESERVED = 1024      # reserved by the runtime for each block

MEM = {"global": 0, "shared": 1, "const": 2}
FETCH = {"select_min": 0, "gather": 1, "gather_sum": 2, "chain_sin": 3,
         "chain": 4, "overlap": 5, "cull": 6, "candidates": 7}
STATE = {"reg": 0, "shared": 1, "local": 2}
OPS = {"fma": 0, "muladd": 1, "reshape": 2, "div": 3, "div_fast": 4,
       "transc": 5, "transc_fast": 6, "philox": 7}
DEPOSIT = {"hist_atomic": 0, "hist_warp": 1, "append_atomic": 2,
           "append_warp": 3, "cursor": 4, "compact": 5, "scan": 6,
           "transpose": 7, "store": 8, "count": 9}
CHAIN_INDEX = {"mod37": 0, "frac": 1, "const": 2}
OVERLAP = {"chain": 0, "alu": 1, "both": 2, "ilp2": 3}

# kernel launches of each probe kernel (a plain integer each)
LAUNCHES = {"fetch": 0, "state": 0, "ops": 0, "deposit": 0}

MASK = 0xFFFFFFFF


class ProbeArgs(ctypes.Structure):
    """csrc/probes.cu ProbeArgs, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("a", "b", "tab", "idx", "out", "bits", "cnt")]
                + [(n, ctypes.c_int) for n in
                   ("L", "T", "S", "C", "n", "idx_mode", "seg", "tab_floats",
                    "wrap", "key0", "key1", "threads")]
                + [(n, ctypes.c_float) for n in ("m", "c0")])


_LIB = None


def _lib():
    """The kernel library with the probes' argtypes declared."""
    global _LIB
    if _LIB is None:
        from ._build import load
        lib = load()
        vp, i = ctypes.c_void_p, ctypes.c_int
        for name, args in (("clsim_probe_fetch", [i, i, i, vp, i, i, vp]),
                           ("clsim_probe_state", [i, i, i, vp, i, vp]),
                           ("clsim_probe_ops", [i, i, vp, i, i, vp]),
                           ("clsim_probe_deposit", [i, vp, i, vp]),
                           ("clsim_probe_set_const", [vp, i, vp]),
                           ("clsim_probe_args_size", []),
                           ("clsim_probe_const_floats", []),
                           ("clsim_main_occupancy", [])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        if lib.clsim_probe_args_size() != ctypes.sizeof(ProbeArgs):
            raise RuntimeError("ProbeArgs size mismatch between csrc/probes.cu"
                               " and probes.py")
        _LIB = lib
    return _LIB


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"probe kernel {what} failed: "
                           + _lib().clsim_error_string(rc).decode())


def _args(**kw):
    p = ProbeArgs()
    for k, v in kw.items():
        setattr(p, k, _ptr(v) if isinstance(v, torch.Tensor) else v)
    return p


def _contig(*ts):
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError("probe inputs must be contiguous")


def pad_for_blocks(blocks_per_sm):
    """Dynamic shared memory a block must hold so that at most
    `blocks_per_sm` blocks reside on an SM (None: no cap)."""
    if blocks_per_sm is None:
        return 0
    return SMEM_PER_SM // (blocks_per_sm + 1) - SMEM_BLOCK_RESERVED + 8


# ---------------------------------------------------------------------------
# H1 probe_fetch
# ---------------------------------------------------------------------------

def _chain_index_plain(a, mode, S):
    aa = a.abs()
    if mode == 0:
        return (aa * 37.0).to(torch.int64) % S
    if mode == 1:
        return torch.floor((aa - torch.floor(aa)) * float(S)).to(torch.int64)
    return torch.full_like(a, 3, dtype=torch.int64)


def _rows(tab, width):
    """(w0, w5) of every table row: fields 0 and 5 of a (C, S) table, or the
    first two columns of an (S, 2) or (S, 4) one."""
    return (tab[0], tab[5]) if width == 1 else (tab[:, 0], tab[:, 1])


def _fetch_step_plain(a, tab, width, mode):
    w0, w5 = _rows(tab, width)
    j = _chain_index_plain(a, mode, w0.shape[0])
    return (w0[j] * 1e-3 + w5[j] * 1e-4) + a * 0.999


def _vpu_step_plain(b):
    for _ in range(P10_VPU_OPS // 3):
        b = b * 1.0000001 + 1e-9
        b = torch.where(b > 2.0, b - 1.0, b)
    return b


def probe_fetch_plain(var, *, a=None, tab=None, idx=None, T=0,
                      idx_mode="mod37", width=1, overlap="chain", **_):
    """The plain version of probe_fetch's variant `var` (see probe_fetch)."""
    mode = CHAIN_INDEX[idx_mode]
    if var == "select_min":
        S, L = tab.shape
        lanes = torch.arange(L, device=tab.device)
        sel = tab[idx.long(), lanes]
        mi = tab.min(0).values
        rows = torch.arange(S, device=tab.device)[:, None].expand(S, L)
        im = torch.where(tab == mi, rows, -1).max(0).values
        return torch.stack([sel, mi, im.float()])
    if var == "gather":
        return tab[:, idx.long()]
    if var == "gather_sum":
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        j = idx.long()
        for i in range(T):
            acc = acc + tab[0][j + i % 3]
        return acc
    if var == "chain_sin":
        x, S = a, tab.shape[1]
        for _ in range(T):
            j = (x.abs() * 7.0).to(torch.int64) % S
            v = ((tab[0][j] + tab[1][j]) + tab[2][j]) + tab[3][j]
            x = torch.sin(x) + 0.001 * v
        return x
    if var == "chain":
        for _ in range(T):
            a = _fetch_step_plain(a, tab, width, mode)
        return a
    if var == "overlap":
        kind = OVERLAP[overlap]
        x, b = a, a * 0.5
        for _ in range(T):
            if kind != 1:
                a = _fetch_step_plain(a, tab, width, mode)
            if kind in (1, 2):
                b = _vpu_step_plain(b)
        return a + b
    if var == "cull":
        sx, sy = tab[:, 0:1], tab[:, 1:2]
        S = tab.shape[0]
        rows = torch.arange(S, device=tab.device)[:, None]
        for _ in range(T):
            rx = sx - a
            ry = sy - a * 0.5
            t2 = torch.clamp(rx * 0.3 + ry * 0.7, 0.0, 50.0)
            d2 = (rx + t2) * (rx + t2) + (ry - t2) * (ry - t2)
            ranked = torch.where(d2 < 1e4, d2, torch.full_like(d2, 1e30))
            mi = ranked.min(0).values
            im = torch.where(ranked == mi, rows, -1).max(0).values
            a = a * 0.999 + tab[im, 0] * 1e-6
        return a
    if var == "candidates":
        n = idx.long()
        for _ in range(T):
            acc = a
            for c in range(int(n.max()) if n.numel() else 0):
                b = a * (1.0 + 1e-7 * c)
                for _ in range(7):
                    b = b * 1.0000001 + 1e-9
                    b = torch.clamp(b - 1e-9, min=0.0)
                    b = torch.where(b > 2.0, b - 1.0, b)
                acc = torch.where(c < n, torch.minimum(acc, b), acc)
            a = acc
        return a
    raise ValueError(f"unknown probe_fetch variant {var!r}")


def probe_fetch(var, *, a=None, tab=None, idx=None, T=0, idx_mode="mod37",
                width=1, overlap="chain", mem="global", blocks_per_sm=None):
    """H1 (csrc/probes.cu probe_fetch) on CUDA tensors, its plain version on
    CPU tensors.  Variants (TPU probe):

      select_min  P1     tab (S, L) f32, idx (L,) i32 -> (3, L): tab[idx,
                         l], the column min, its last index (as f32)
      gather      P2, P7 k7   tab (C, S), idx (L,) -> (C, L) = tab[:, idx]
      gather_sum  P7 k8  tab (C, S), idx (L,), T -> (L,) = sum over i < T
                         of tab[0, idx + i % 3], in order
      chain_sin   P6     a (L,), tab (C >= 4, S), T -> (L,)
      chain       P8 k_fetch, P9, P10/P11 chainA   a (L,), T dependent
                         reads a = w0 1e-3 + w5 1e-4 + 0.999 a; tab (C >=
                         6, S) (width 1: fields 0 and 5), (S, 2) or (S, 4)
                         (width 2, 4: columns 0 and 1); idx_mode mod37
                         (int(|a| 37) % S), frac (floor(frac|a| S)) or
                         const (row 3)
      overlap     P10, P11   a + b after T steps of the chain ("chain"),
                         of P10's 60-op ALU step on b = a / 2 ("alu"),
                         both in one thread ("both"), or the chain of two
                         lanes a thread ("ilp2")
      cull        P8 k_cull  a (L,), tab (88, 8) string columns, T -> (L,)
      candidates  P12    a (L,), idx (L,) i32 candidates a lane, T -> (L,)

    mem: the table in global memory ("global", read through __ldg),
    staged in shared memory by each block ("shared") or in __constant__
    memory ("const"); blocks_per_sm caps the resident blocks with dynamic
    shared memory (the occupancy the chain runs at)."""
    dev = (a if a is not None else tab).device
    if dev.type == "cpu":
        return probe_fetch_plain(var, a=a, tab=tab, idx=idx, T=T,
                                 idx_mode=idx_mode, width=width,
                                 overlap=overlap)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    _contig(a, tab, idx)
    v, m = FETCH[var], MEM[mem]
    lib = _lib()
    L = (a if a is not None else idx).shape[-1]
    threads = L // 2 if var == "overlap" and overlap == "ilp2" else L
    if var == "select_min":
        S, C = tab.shape[0], 0
        out = torch.empty((3, L), dtype=torch.float32, device=dev)
    elif var == "gather":
        C, S = tab.shape
        out = torch.empty((C, L), dtype=torch.float32, device=dev)
    elif var == "cull":
        S, C = tab.shape
        out = torch.empty(L, dtype=torch.float32, device=dev)
    elif tab is None:
        S = C = 0
        out = torch.empty(L, dtype=torch.float32, device=dev)
    else:
        S = tab.shape[1] if width == 1 else tab.shape[0]
        C = tab.shape[0] if width == 1 else width
        out = torch.empty(L, dtype=torch.float32, device=dev)
    n_tab = 0 if tab is None else tab.numel()
    if m == MEM["const"]:
        if n_tab > lib.clsim_probe_const_floats():
            raise ValueError(f"a table of {n_tab} floats does not fit the "
                             "64 KB constant bank")
        _check(lib.clsim_probe_set_const(_ptr(tab), n_tab, _stream(tab)),
               "constant copy")
    smem = max(pad_for_blocks(blocks_per_sm),
               4 * n_tab if m == MEM["shared"] else 0)
    p = _args(a=a, tab=tab, idx=idx, out=out, L=L, T=T, S=S, C=C,
              n=OVERLAP[overlap], idx_mode=CHAIN_INDEX[idx_mode],
              tab_floats=n_tab, threads=threads)
    _check(lib.clsim_probe_fetch(v, m, width, ctypes.byref(p), smem, 0,
                                 _stream(out)), f"fetch[{var}]")
    LAUNCHES["fetch"] += 1
    return out


def fetch_occupancy(var, mem="global", width=1, smem=0):
    """Resident blocks per SM of a probe_fetch instantiation at `smem`
    bytes of dynamic shared memory."""
    return _lib().clsim_probe_fetch(FETCH[var], MEM[mem], width,
                                    ctypes.byref(ProbeArgs()), smem, 1, None)


# ---------------------------------------------------------------------------
# H2 probe_state
# ---------------------------------------------------------------------------

def probe_state_plain(a, *, T, touched=None, step_kind=1, reduce=False, **_):
    """The plain version of probe_state (see probe_state)."""
    nf = a.shape[0]
    touched = nf if touched is None else touched
    st = a.clone()
    for i in range(T):
        k = torch.tensor(float(i), dtype=torch.float32) * 1e-9 \
            if step_kind else 1e-9
        st[:touched] = st[:touched] * 1.0000001 + k
    if not reduce:
        return st
    acc = st[0]
    for f in range(1, nf):
        acc = acc + st[f]
    return acc


def probe_state(a, *, T, touched=None, step_kind=1, reduce=False,
                space="reg", minb=1):
    """H2 (P13, P14): a (NF, L) f32 state, NF 18 or 24; T steps of c = c *
    1.0000001 + k on the first `touched` fields (k = 1e-9 with step_kind 0
    as P13, i * 1e-9 with step_kind 1 as P14); returns the (NF, L) state or,
    with reduce, the (L,) sum of its fields in order (P13).  space: the
    state in registers ("reg"), in shared memory ("shared") or in a local
    array ("local"); minb: __launch_bounds__(256, minb), 1-4 with "reg"."""
    dev = a.device
    if dev.type == "cpu":
        return probe_state_plain(a, T=T, touched=touched,
                                 step_kind=step_kind, reduce=reduce)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    _contig(a)
    nf, L = a.shape
    out = torch.empty(L if reduce else (nf, L), dtype=torch.float32,
                      device=dev)
    p = _args(a=a, out=out, L=L, T=T, C=nf if touched is None else touched,
              n=step_kind, idx_mode=int(bool(reduce)))
    _check(_lib().clsim_probe_state(STATE[space], nf, minb, ctypes.byref(p),
                                    0, _stream(out)), f"state[{space}]")
    LAUNCHES["state"] += 1
    return out


def state_occupancy(space, nf, minb=1):
    return _lib().clsim_probe_state(STATE[space], nf, minb,
                                    ctypes.byref(ProbeArgs()), 1, None)


# ---------------------------------------------------------------------------
# H3 probe_ops
# ---------------------------------------------------------------------------

def philox4x32_10_plain(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (csrc/philox.cuh) on int64 tensors holding uint32
    words: the four output words.  The 32 x 32-bit products are taken in
    16-bit halves so that no int64 overflows."""
    def mul(m, x):
        lo_p, hi_p = m * (x & 0xFFFF), m * (x >> 16)
        return ((((hi_p & 0xFFFF) << 16) + lo_p) & MASK,
                (hi_p + (lo_p >> 16)) >> 16)
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=c0.device) & MASK
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=c0.device) & MASK
    for _ in range(10):
        lo0, hi0 = mul(0xD2511F53, c0)
        lo1, hi1 = mul(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & MASK
        k1 = (k1 + 0xBB67AE85) & MASK
    return c0, c1, c2, c3


def _transc_step_plain(a):
    a = torch.sin(a) + torch.cos(a) * 0.1
    a = torch.exp(-a.abs()) + torch.log1p(a.abs())
    a = torch.pow(a.abs(), 0.73) + torch.sqrt(a.abs())
    return a * 0.5


def p3_tail_plain(acc):
    """P3's deterministic tail (probe_pallas.py:101): sin + cos + exp(-acc)
    + log1p(acc), added in that order."""
    return ((torch.sin(acc) + torch.cos(acc)) + torch.exp(-acc)) \
        + torch.log1p(acc)


def probe_ops_plain(var, *, a, b=None, T, n=1, m=1.0, c0=0.0, wrap=False,
                    key=(0, 0), **_):
    """The plain version of probe_ops (see probe_ops); "fma" and
    "div_fast" round as the multiply, add and IEEE division do, and
    "transc_fast" takes the library functions."""
    if var == "fma":
        for i in range(T):
            k = b + torch.tensor(float(i), dtype=torch.float32) * 1e-9
            for _ in range(n):
                a = a * 1.0000001 + k
        return a
    if var == "muladd":
        for _ in range(T):
            for _ in range(n):
                a = a * m + c0
                if wrap:
                    a = torch.where(a > 2.0, a - 1.0, a)
        return a
    if var == "reshape":
        for _ in range(T):
            a = (a + 1.0) * 1.0000001
        return a
    if var in ("div", "div_fast"):
        for i in range(T):
            d = (b + torch.tensor(float(i), dtype=torch.float32) * 1e-9) \
                + 1.001
            for _ in range(n):
                a = a / d
        return a
    if var in ("transc", "transc_fast"):
        for _ in range(T):
            a = _transc_step_plain(a)
        return a
    if var == "philox":
        L = a.shape[0]
        lane = torch.arange(L, dtype=torch.int64, device=a.device)
        zero = torch.zeros_like(lane)
        acc = torch.zeros(L, dtype=torch.float32, device=a.device)
        bits = None
        for i in range(T):
            r = philox4x32_10_plain(torch.full_like(lane, i), lane, zero,
                                    zero, key[0], key[1])
            if i == 0:
                bits = torch.stack(r)
            acc = acc + (r[0] >> 8).to(torch.float32) * (1.0 / 16777216.0)
        return p3_tail_plain(acc), bits
    raise ValueError(f"unknown probe_ops variant {var!r}")


def probe_ops(var, *, a, b=None, T, n=1, m=1.0, c0=0.0, wrap=False,
              key=(0, 0), blocks_per_sm=None):
    """H3 on CUDA tensors, its plain version on CPU tensors.  a, b (L,) f32:

      fma n          P15: T x n fused a = a * 1.0000001 + (b + i 1e-9),
                     n in 5, 10, 20, 40
      muladd n       P7 k10 (n 25, m 1.0000001, c0 1e-7), P8 k_elem (n 25,
                     c0 1e-9, wrap: a - 1 where a > 2), P12 flat (n 21):
                     T x n separately rounded a * m + c0
      reshape        P7 k6: T x a = (a + 1) * 1.0000001
      div, div_fast  P15 div: T x n a = a / (b + i 1e-9 + 1.001), n 5 or
                     10: IEEE division, or __fdividef (n 10)
      transc, transc_fast    P7 k13: T steps of sin, cos, exp, log1p, pow
                     0.73 and sqrt, with the CUDA math library (the
                     propagation kernel's build) or the intrinsics
      philox         P3: T draws of Philox4x32-10 at counter (i, lane, 0,
                     0) under `key`, u = (x >> 8) 2^-24 accumulated;
                     returns (sin + cos + exp(-acc) + log1p(acc), the four
                     words of the first draw as (4, L) int64)

    blocks_per_sm caps the resident blocks with dynamic shared memory."""
    dev = a.device
    if dev.type == "cpu":
        return probe_ops_plain(var, a=a, b=b, T=T, n=n, m=m, c0=c0,
                               wrap=wrap, key=key)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    _contig(a, b)
    L = a.shape[0]
    out = torch.empty(L, dtype=torch.float32, device=dev)
    bits = (torch.empty((4, L), dtype=torch.int32, device=dev)
            if var == "philox" else None)
    k0, k1 = (int(k) & MASK for k in key)
    as_i32 = lambda k: k - (1 << 32) if k >= 1 << 31 else k
    p = _args(a=a, b=b, out=out, bits=bits, L=L, T=T, m=m, c0=c0,
              wrap=int(bool(wrap)), key0=as_i32(k0), key1=as_i32(k1))
    _check(_lib().clsim_probe_ops(OPS[var], n, ctypes.byref(p),
                                  pad_for_blocks(blocks_per_sm), 0,
                                  _stream(out)), f"ops[{var}]")
    LAUNCHES["ops"] += 1
    if var == "philox":
        return out, bits.to(torch.int64) & MASK
    return out


def ops_occupancy(var, n=1, blocks_per_sm=None):
    return _lib().clsim_probe_ops(OPS[var], n, ctypes.byref(ProbeArgs()),
                                  pad_for_blocks(blocks_per_sm), 1, None)


# ---------------------------------------------------------------------------
# H4 probe_deposit
# ---------------------------------------------------------------------------

def probe_deposit_plain(var, *, a=None, idx=None, tab=None, n_bins=0,
                        cap=0, T=0, seg=0, threshold=0.0, L=0, C=128, **_):
    """The plain version of probe_deposit (see probe_deposit)."""
    if var in ("hist_atomic", "hist_warp"):
        hist = torch.zeros(n_bins, dtype=torch.float32, device=a.device)
        ok = idx >= 0
        return hist.index_add_(0, idx[ok].long(), a[ok])
    if var in ("append_atomic", "append_warp"):
        # (lane, i) in lane order, then i
        ll, ii = torch.nonzero((idx >= 0).t(), as_tuple=True)
        v = a[ii, ll]
        rec = torch.stack([ll.float(), ii.float(), v, torch.zeros_like(v)], 1)
        return rec[:cap], int(rec.shape[0])
    if var == "cursor":
        out = torch.zeros((8, a.shape[0]), dtype=torch.float32,
                          device=a.device)
        row = 0
        for i in range(T):
            out[row] = out[row] + a * float(i + 1)
            row += i % 2 == 0
        return out
    if var == "compact":
        segs = a.reshape(-1, seg)
        hit = segs > threshold
        pos = torch.cumsum(hit.to(torch.int64), 1) - 1
        out = torch.zeros_like(segs)
        rows = torch.arange(segs.shape[0], device=a.device)[:, None] \
            .expand_as(segs)
        out[rows[hit], pos[hit]] = segs[hit]
        return out.reshape(-1), hit.sum(1).to(torch.int32)
    if var == "scan":
        return torch.cumsum(a.reshape(-1, seg), 1).reshape(-1)
    if var == "transpose":
        return a.t().contiguous()
    if var == "store":
        return (tab * 2.0)[:, None].expand(tab.shape[0], L).contiguous()
    if var == "count":
        vals = torch.arange(C, dtype=torch.float32, device=a.device)
        return (a[None, :] == vals[:, None]).sum(1).to(torch.float32)
    raise ValueError(f"unknown probe_deposit variant {var!r}")


def probe_deposit(var, *, a=None, idx=None, tab=None, n_bins=0, cap=0, T=0,
                  seg=0, threshold=0.0, L=0, C=128):
    """H4 on CUDA tensors, its plain version on CPU tensors:

      hist_atomic, hist_warp   a (K, L) weights at bins idx (K, L) i32 (-1:
                     none) -> the (n_bins,) histogram: one float atomicAdd
                     a deposit, or one a distinct bin of the warp
      append_atomic, append_warp   records (lane, i, a[i, lane], 0) of the
                     (i, lane) with idx >= 0 -> ((cap, 4) records, count);
                     the kernel's order is the atomics' (compare sorted),
                     the plain version's (lane, i)
      cursor         P4: a (L,), T -> (8, L)
      compact        P8 k_deposit: per segment of `seg` lanes the values >
                     threshold in order -> ((L,) zero-padded, (L / seg,)
                     counts i32)
      scan           P7 k12 (seg 4,096), P3's cumsum (seg 128): the
                     inclusive scan of each segment
      transpose      P5: a (R, C) -> (C, R)
      store          P7 k9: tab (S,) -> (S, L) = tab * 2 broadcast
      count          P7 k11: a (L,) -> (C,) f32, the lanes equal to c"""
    ref = a if a is not None else tab
    dev = ref.device
    if dev.type == "cpu":
        return probe_deposit_plain(var, a=a, idx=idx, tab=tab, n_bins=n_bins,
                                   cap=cap, T=T, seg=seg,
                                   threshold=threshold, L=L, C=C)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    _contig(a, idx, tab)
    f32 = torch.float32
    cnt = out = None
    kw = {}
    if var in ("hist_atomic", "hist_warp"):
        K, L = idx.shape
        out = torch.zeros(n_bins, dtype=f32, device=dev)
        kw = dict(T=K)
    elif var in ("append_atomic", "append_warp"):
        K, L = idx.shape
        out = torch.zeros((cap, 4), dtype=f32, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        kw = dict(T=K, n=cap)
    elif var == "cursor":
        L = a.shape[0]
        out = torch.empty((8, L), dtype=f32, device=dev)
        kw = dict(T=T)
    elif var in ("compact", "scan"):
        L = a.shape[0]
        out = (torch.zeros if var == "compact" else torch.empty)(
            L, dtype=f32, device=dev)
        if var == "compact":
            cnt = torch.empty(L // seg, dtype=torch.int32, device=dev)
        kw = dict(seg=seg, c0=threshold)
    elif var == "transpose":
        R, C_ = a.shape
        L = R * C_
        out = torch.empty((C_, R), dtype=f32, device=dev)
        kw = dict(S=R, C=C_)
    elif var == "store":
        out = torch.empty((tab.shape[0], L), dtype=f32, device=dev)
        kw = dict(S=tab.shape[0])
    elif var == "count":
        L = a.shape[0]
        cnt = torch.zeros(C, dtype=torch.int32, device=dev)
        kw = dict(C=C)
    p = _args(a=a, idx=idx, tab=tab, out=out, cnt=cnt, L=L, **kw)
    _check(_lib().clsim_probe_deposit(DEPOSIT[var], ctypes.byref(p), 0,
                                      _stream(ref)), f"deposit[{var}]")
    LAUNCHES["deposit"] += 1
    if var in ("append_atomic", "append_warp"):
        return out, cnt
    if var == "compact":
        return out, cnt
    if var == "count":
        return cnt.to(f32)
    return out


def deposit_occupancy(var):
    return _lib().clsim_probe_deposit(DEPOSIT[var], ctypes.byref(ProbeArgs()),
                                      1, None)


# ---------------------------------------------------------------------------
# ptxas's registers and spills, from the build log
# ---------------------------------------------------------------------------

def ptxas_info(log):
    """{mangled kernel name: dict(registers, stack, spill_stores,
    spill_loads)} from nvcc -Xptxas -v output."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return info


def state_ptxas(info, space, nf, minb):
    """ptxas_info's entry of probe_state<space, nf, minb> (None if the log
    holds no such kernel: a cached build)."""
    key = f"probe_stateILi{STATE[space]}ELi{nf}ELi{minb}E"
    return next((v for k, v in info.items() if key in k), None)


# ---------------------------------------------------------------------------
# the probe run
# ---------------------------------------------------------------------------

HBM_BYTES_S = 3.35e12           # H100 SXM
FP32_PEAK = 67e12               # H100 SXM dense float32 (an FMA is 2)


SLEEP_CYCLES = 2_000_000        # ~1 ms of the card's clock


def _cuda_ms(fn, reps=5):
    """(the last result, the median milliseconds of `reps` runs of fn, each
    between CUDA events).  The device first sleeps ~1 ms, so that the
    launches of fn are queued by the time the first event is reached and
    the events time the device, not the host's launch overhead (a probe
    kernel takes tens of microseconds)."""
    times, out = [], None
    sleep = getattr(torch.cuda, "_sleep", None)
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if sleep is not None:
            sleep(SLEEP_CYCLES)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return out, statistics.median(times)


def _bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_PEAK * 1e3
    return (t_o, "operations") if t_o > t_b else (t_b, "bytes")


def _max_abs(x, y):
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def _exact(out, ref):
    """Equal bit for bit (tuples element by element); returns the max abs
    error (0.0)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        if not torch.equal(o, r):
            raise AssertionError(f"not equal: max abs {_max_abs(o, r):.3g}")
    return 0.0


def _close(atol=0.0, rtol=0.0, flips=0.0):
    """A check: |out - ref| <= atol + rtol |ref| on all but a `flips`
    fraction of the lanes; returns the max abs error over the others."""
    def check(out, ref):
        err = (out.double() - ref.double()).abs()
        bad = err > atol + rtol * ref.double().abs()
        n_bad = int(bad.sum())
        if n_bad > flips * err.numel():
            raise AssertionError(f"{n_bad} of {err.numel()} outside atol "
                                 f"{atol:g} rtol {rtol:g} (max abs "
                                 f"{float(err.max()):.3g})")
        return float(err[~bad].max()) if n_bad < err.numel() else 0.0
    return check


def _sum_close(rel):
    """Atomic and scan sums: |out - ref| <= rel x the total |ref|."""
    def check(out, ref):
        err = _max_abs(out, ref)
        tot = float(ref.double().abs().sum())
        if err > rel * tot:
            raise AssertionError(f"max abs {err:.3g} > {rel:g} x {tot:.6g}")
        return err
    return check


def _scan_close(seg):
    """A scan in float32: each prefix within 2^-20 of its segment's sum of
    |x| (the block scan adds in another order than the sequential cumsum)."""
    def check(out, ref):
        err = (out.double() - ref.double()).abs().reshape(-1, seg)
        lim = ref.double().abs().reshape(-1, seg).max(1).values * 2.0 ** -20
        if not bool((err.max(1).values <= lim + 1e-30).all()):
            raise AssertionError(f"scan max abs {float(err.max()):.3g}")
        return float(err.max())
    return check


def _records_equal(out, ref):
    """Append: the kernel's records, sorted by (lane, i), equal the plain
    version's; the counts equal."""
    (rec, cnt), (rec_p, n_p) = out, ref
    n = int(cnt.reshape(-1)[0]) if isinstance(cnt, torch.Tensor) else cnt
    if n != n_p:
        raise AssertionError(f"appended {n}, plain {n_p}")
    rec = rec[:n]
    order = torch.argsort(rec[:, 0] * 64.0 + rec[:, 1])
    return _exact(rec[order], rec_p.to(rec.device))


def _hist_inputs(rng, L, rate, n_doms, device):
    """Deposits at `rate` a lane (K = ceil(rate) chances, each taken with
    rate / K): half of a warp's deposits on the warp's own DOM and time
    (+- 3 bins), the rest on a DOM and time drawn over the detector, as
    the photons of one step share their DOMs; weights ~ U(0.5, 1.5)."""
    K = max(1, math.ceil(rate))
    n_w = L // 32
    w_dom = rng.integers(0, n_doms, n_w).repeat(32)
    w_bin = rng.integers(3, HIST_BINS - 3, n_w).repeat(32)
    own = rng.random((K, L)) < 0.5
    dom = np.where(own, w_dom, rng.integers(0, n_doms, (K, L)))
    tbin = np.where(own, w_bin + rng.integers(-3, 4, (K, L)),
                    rng.integers(0, HIST_BINS, (K, L)))
    bins = np.where(rng.random((K, L)) < rate / K, dom * HIST_BINS + tbin, -1)
    t = lambda x, d: torch.as_tensor(np.ascontiguousarray(x, d),
                                     device=device)
    return (t(bins, np.int32),
            t(rng.uniform(0.5, 1.5, (K, L)), np.float32))


def run_probes(device="cuda", L=LANES, hit_rate=29340 / LANES,
               expected_rate=2 * 2781 / LANES, reps=5, log=print):
    """Every probe variant at L lanes on the card: the kernel (median of
    `reps` by CUDA events) against its plain version on the same inputs,
    with the variant's tolerance; its bound (the larger of the bytes it
    must move over HBM_BYTES_S and its operations, counted from
    csrc/probes.cu with an FMA as 2, over FP32_PEAK); the library call's
    time where one PyTorch call computes the function; the figure it
    measures.  hit_rate and expected_rate are the histogram deposits a
    slot of the propagation kernel makes in one launch on the main path
    (detect) and in the expected mode (two per DOM entry with soft
    binning); the defaults are what chip_smoke.py counted on an H100:
    29,340 hits in phase 2's main-path launch and 2,781 DOM entries in
    8a's expected mode on ic86, at 262,144 slots.

    Returns a list of dicts: p (TPU probe), kernel, variant, ms, plain_ms,
    bound_ms, bound_by, library_ms, err, figure (text), and the derived
    numbers (e.g. ns_step)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probes run on the card (device='cuda')")
    from . import _build
    lib = _lib()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(2026)
    dev = lambda x, dt=np.float32: torch.as_tensor(
        np.ascontiguousarray(x, dt), device=device)
    rand = lambda *shape: dev(rng.random(shape))
    rows = []

    def waves(threads, blocks):
        return math.ceil(threads / (max(blocks, 1) * sms * PB))

    def case(p, kernel, variant, run_k, run_p, check, nbytes, ops,
             figure=None, library=None, occ=None, threads=L):
        run_k()                                   # warm-up (and build)
        out, ms = _cuda_ms(run_k, reps)
        ref, plain_ms = _cuda_ms(run_p, 1)
        try:
            err = check(out, ref)
        except AssertionError as e:
            raise AssertionError(f"probe {p} {kernel}[{variant}]: {e}")
        lib_ms = _cuda_ms(library, reps)[1] if library else None
        bound, by = _bound(nbytes, ops)
        row = dict(p=p, kernel=kernel, variant=variant, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=lib_ms, err=err, blocks_per_sm=occ,
                   threads=threads,
                   waves=waves(threads, occ) if occ else None)
        if figure:
            row.update(figure(ms, row))
        rows.append(row)
        log(f"  {p:<4} {kernel}[{variant}]: {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})"
            + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
            + f", max abs err {err:.3g}"
            + (f", {occ} blocks/SM" if occ else "")
            + (f"; {row['text']}" if "text" in row else ""))
        return out

    def per_step(T, unit="dependent step"):
        """ns a thread spends on one step, time / (T x waves), at the
        resident blocks the row states; and the steps of all threads a
        second."""
        def f(ms, row):
            ns = ms * 1e6 / (T * row["waves"])
            g = row["threads"] * T / (ms * 1e-3) / 1e9
            return dict(ns_step=ns, g_steps=g,
                        text=f"{ns:.2f} ns a thread per {unit}, "
                             f"{g:.4g} G {unit}s/s")
        return f

    def rate(count, unit):
        def f(ms, row):
            r = count / (ms * 1e-3)
            return dict(rate=r, text=f"{r:.4g} {unit}/s")
        return f

    def bandwidth(nbytes):
        def f(ms, row):
            g = nbytes / (ms * 1e-3) / 1e9
            return dict(gb_s=g, text=f"{g:.1f} GB/s")
        return f

    fo = lambda var, mem="global", width=1, smem=0: fetch_occupancy(
        var, mem, width, smem)
    occ_k1 = lib.clsim_main_occupancy()
    if occ_k1 < 1:
        raise RuntimeError("no occupancy for the main path's kernel")
    log(f"  the main path's propagation kernel: {occ_k1} blocks of 256 "
        f"a SM ({occ_k1 * 8} of 64 warps), {sms} SMs")

    # ---- H1 probe_fetch -------------------------------------------------
    tab1 = rand(P1_S, L)
    idx1 = dev(rng.integers(0, P1_S, L), np.int32)
    case("P1", "fetch", "select_min",
         lambda: probe_fetch("select_min", tab=tab1, idx=idx1),
         lambda: probe_fetch_plain("select_min", tab=tab1, idx=idx1),
         _exact, 4 * (P1_S * L + L + 3 * L), 7 * P1_S * L,
         bandwidth(4 * (P1_S * L + 4 * L)), occ=fo("select_min"))
    for p, C, S in (("P2", P2_C, P2_S), ("P7", P7_C, P7_S)):
        tab = dev(rng.random((C, S)) * 1000 - 500)
        idx = dev(rng.integers(0, S, L), np.int32)
        idx_l = idx.long()
        for mem in ("global", "shared", "const"):
            case(p, "fetch", f"gather C={C} {mem}",
                 lambda: probe_fetch("gather", tab=tab, idx=idx, mem=mem),
                 lambda: probe_fetch_plain("gather", tab=tab, idx=idx),
                 _exact, 4 * (C * S + L + C * L), 0,
                 bandwidth(4 * (L + C * L)),
                 library=lambda: tab[:, idx_l],
                 occ=fo("gather", mem, smem=4 * C * S if mem == "shared"
                        else 0))
    tab7 = dev(rng.random((P7_C, P7_S)) * 100)
    j7 = dev(rng.integers(0, P7_S - 3, L), np.int32)
    case("P7", "fetch", "gather_sum k8",
         lambda: probe_fetch("gather_sum", tab=tab7, idx=j7, T=P7_T),
         lambda: probe_fetch_plain("gather_sum", tab=tab7, idx=j7, T=P7_T),
         _exact, 4 * (P7_C * P7_S + 2 * L), 4 * P7_T * L,
         per_step(P7_T, unit="read"), occ=fo("gather_sum"))
    tab6, x6 = rand(P6_C, P6_S), rand(L)
    # sinf on both sides; a lane whose |x| 7 lies within an ulp of an
    # integer takes the other row if the two sins differ by an ulp
    case("P6", "fetch", "chain_sin",
         lambda: probe_fetch("chain_sin", a=x6, tab=tab6, T=P6_T),
         lambda: probe_fetch_plain("chain_sin", a=x6, tab=tab6, T=P6_T),
         _close(atol=1e-5, flips=1e-3), 4 * (P6_C * P6_S + 2 * L),
         10 * P6_T * L, per_step(P6_T), occ=fo("chain_sin"))

    def chain(p, variant, tab, T, width=1, mem="global", idx_mode="mod37",
              blocks=None):
        x = rand(L)
        smem = max(pad_for_blocks(blocks),
                   4 * tab.numel() if mem == "shared" else 0)
        return case(p, "fetch", variant,
                    lambda: probe_fetch("chain", a=x, tab=tab, T=T,
                                        width=width, mem=mem,
                                        idx_mode=idx_mode,
                                        blocks_per_sm=blocks),
                    lambda: probe_fetch_plain("chain", a=x, tab=tab, T=T,
                                              width=width,
                                              idx_mode=idx_mode),
                    _exact, 4 * (tab.numel() + 2 * L), 10 * T * L,
                    per_step(T, unit="dependent read"),
                    occ=fo("chain", mem, width, smem))

    tab8 = dev(rng.random((P8_C, P8_S)) * 100 - 50)
    chain("P8", "chain k_fetch (64, 176) global", tab8, P8_T)
    # P9's table rounded to its 2-split (hi + lo of bf16), as the TPU reads it
    t9 = rng.random((P9_C, P9_S)).astype(np.float32)
    hi = torch.as_tensor(t9).to(torch.bfloat16).to(torch.float32)
    lo = (torch.as_tensor(t9) - hi).to(torch.bfloat16).to(torch.float32)
    tab9 = (hi + lo).to(device)
    pair = torch.stack([tab9[0], tab9[5]], 1).contiguous()
    quad = torch.cat([pair, torch.zeros_like(pair)], 1).contiguous()
    for mem in ("global", "shared", "const"):
        chain("P9", f"chain (32, 176) f32 {mem}", tab9, P9_T, mem=mem)
    chain("P9", "chain (176, 2) float2 global", pair, P9_T, width=2)
    chain("P9", "chain (176, 4) float4 global", quad, P9_T, width=4)
    chain("P9", "chain const index global", tab9, P9_T, idx_mode="const")
    # 1, 2, 4 blocks a SM and the main path's own (the account's (c))
    for blocks in sorted({1, 2, 4, occ_k1}):
        chain("P9", f"chain (32, 176) global, {blocks} blocks/SM", tab9,
              P9_T, blocks=blocks)
    for n_doms, spaces in ((HEX61_DOMS, ("global", "shared", "const")),
                           (IC86_DOMS, ("global", "shared"))):
        doms = dev(np.c_[rng.uniform(-600, 600, (n_doms, 3)),
                         np.full(n_doms, 0.1651)])
        for mem in spaces:
            chain("P9", f"DOM table ({n_doms}, 4) float4 {mem}", doms, P9_T,
                  width=4, mem=mem, idx_mode="frac")
        chain("P9", f"DOM table ({n_doms}, 4) float4 global, "
              f"{occ_k1} blocks/SM", doms, P9_T, width=4, idx_mode="frac",
              blocks=occ_k1)

    x10 = rand(L)
    for kind in ("chain", "alu", "both", "ilp2"):
        th = L // 2 if kind == "ilp2" else L
        ops = (10 * (kind != "alu") + 80 * (kind in ("alu", "both"))) \
            * P10_T * L
        case("P10", "fetch", f"overlap {kind}",
             lambda: probe_fetch("overlap", a=x10, tab=tab9, T=P10_T,
                                 idx_mode="frac", overlap=kind),
             lambda: probe_fetch_plain("overlap", a=x10, tab=tab9, T=P10_T,
                                       idx_mode="frac", overlap=kind),
             _exact, 4 * (tab9.numel() + 2 * L), ops, per_step(P10_T),
             occ=fo("overlap"), threads=th)
    cols = dev(rng.random((P8_SP, 8)) * 100)
    x8 = rand(L)
    for mem in ("global", "shared", "const"):
        case("P8", "fetch", f"cull {mem}",
             lambda: probe_fetch("cull", a=x8, tab=cols, T=P8_T, mem=mem),
             lambda: probe_fetch_plain("cull", a=x8, tab=cols, T=P8_T),
             _exact, 4 * (cols.numel() + 2 * L), 17 * P8_SP * P8_T * L,
             per_step(P8_T * P8_SP, unit="string"),
             occ=fo("cull", mem, smem=4 * cols.numel() if mem == "shared"
                    else 0))
    x12 = rand(L)
    n_div = rng.integers(1, P12_CAND + 1, L)
    for kind, n in (("uniform 10", np.full(L, P12_CAND)),
                    ("divergent 1-10", n_div),
                    ("coherent (sorted) 1-10", np.sort(n_div))):
        nc = dev(n, np.int32)
        case("P12", "fetch", f"candidates {kind}",
             lambda: probe_fetch("candidates", a=x12, idx=nc, T=P12_T),
             lambda: probe_fetch_plain("candidates", a=x12, idx=nc,
                                       T=P12_T),
             _exact, 4 * 3 * L, 46 * int(n.sum()) * P12_T,
             per_step(P12_T, unit="candidate loop"),
             occ=fo("candidates"))

    # ---- H2 probe_state -------------------------------------------------
    info = ptxas_info(_build.BUILD_INFO.get("log", ""))
    for p, nf, T, kw in (("P14", P14_NF, P14_T, dict(step_kind=1)),
                         ("P13", P13_NF, P13_T,
                          dict(step_kind=0, reduce=True))):
        x = rand(nf, L)
        for space, minb in ([("reg", m) for m in (1, 2, 3, 4)]
                            + [("shared", 1), ("local", 1)]):
            pt = state_ptxas(info, space, nf, minb)
            regs = (f"{pt.get('registers')} registers, "
                    f"{pt.get('spill_stores')} bytes spilled"
                    if pt else "not in this build's log")

            def fig(ms, row, nf=nf, T=T, regs=regs):
                ns = ms * 1e6 / (T * nf * row["waves"])
                return dict(ns_update=ns, ptxas=regs,
                            text=f"{ns:.3f} ns a thread per field update; "
                                 f"{regs}")
            case(p, "state", f"NF={nf} {space} minb={minb}",
                 lambda: probe_state(x, T=T, space=space, minb=minb, **kw),
                 lambda: probe_state_plain(x, T=T, **kw), _exact,
                 4 * (nf * L + (L if kw.get("reduce") else nf * L)),
                 2 * nf * T * L, fig, occ=state_occupancy(space, nf, minb))
        if p == "P13":
            case(p, "state", f"NF={nf} reg, 4 fields touched",
                 lambda: probe_state(x, T=T, touched=4, **kw),
                 lambda: probe_state_plain(x, T=T, touched=4, **kw), _exact,
                 4 * (nf + 1) * L, 2 * 4 * T * L, per_step(T),
                 occ=state_occupancy("reg", nf))

    # ---- H3 probe_ops ---------------------------------------------------
    a15, b15 = rand(L) + 0.5, rand(L) + 0.5
    for n in (5, 10, 20, 40):
        # one rounding fewer per op than the plain multiply and add:
        # <= 1 ulp an op, T n ops
        case("P15", "ops", f"fma n={n}",
             lambda: probe_ops("fma", a=a15, b=b15, T=P15_T, n=n),
             lambda: probe_ops_plain("fma", a=a15, b=b15, T=P15_T, n=n),
             _close(rtol=P15_T * n * 2.0 ** -23), 4 * 3 * L,
             2 * n * P15_T * L, per_step(P15_T * n, unit="FMA"),
             occ=ops_occupancy("fma", n))
    case("P15", "ops", f"fma n=40, {occ_k1} blocks/SM",
         lambda: probe_ops("fma", a=a15, b=b15, T=P15_T, n=40,
                           blocks_per_sm=occ_k1),
         lambda: probe_ops_plain("fma", a=a15, b=b15, T=P15_T, n=40),
         _close(rtol=P15_T * 40 * 2.0 ** -23), 4 * 3 * L,
         2 * 40 * P15_T * L, per_step(P15_T * 40, unit="FMA"),
         occ=ops_occupancy("fma", 40, occ_k1))
    # P15's inputs divide a by ~2 2,560 times: a reaches the subnormals,
    # where IEEE division takes its slow path; b = 0 (d = 1.001) keeps a
    # normal and prices the division the propagation kernel runs
    b0 = torch.zeros_like(b15)
    for n, var, b, label, blocks in (
            (5, "div", b15, "", None), (10, "div", b15, "", None),
            (10, "div_fast", b15, "", None),
            (10, "div", b0, ", b=0 (no subnormals)", None),
            (10, "div_fast", b0, ", b=0 (no subnormals)", None),
            (10, "div", b0, f", b=0, {occ_k1} blocks/SM", occ_k1)):
        # __fdividef: <= 2 ulp a division against IEEE's 0.5
        chk = _exact if var == "div" else _close(
            atol=1e-37, rtol=P15_T * n * 2.0 ** -21)
        case("P15", "ops", f"{var} n={n}{label}",
             lambda: probe_ops(var, a=a15, b=b, T=P15_T, n=n,
                               blocks_per_sm=blocks),
             lambda: probe_ops_plain(var, a=a15, b=b, T=P15_T, n=n),
             chk, 4 * 3 * L, n * P15_T * L,
             per_step(P15_T * n, unit="division"),
             occ=ops_occupancy(var, n, blocks))
    x7 = rand(L)
    for p, label, var, n, T, kw in (
            ("P7", "reshape k6", "reshape", 1, P7_T, {}),
            ("P7", "muladd k10 n=25", "muladd", 25, P7_T,
             dict(m=1.0000001, c0=1e-7)),
            ("P8", "muladd k_elem n=25 wrap", "muladd", 25, P8_T,
             dict(m=1.0000001, c0=1e-9, wrap=True)),
            ("P12", "muladd flat n=21", "muladd", 21, P12_T,
             dict(m=1.0000001, c0=1e-9))):
        case(p, "ops", label,
             lambda: probe_ops(var, a=x7, T=T, n=n, **kw),
             lambda: probe_ops_plain(var, a=x7, T=T, n=n, **kw), _exact,
             4 * 2 * L, 2 * n * T * L, per_step(T * n, unit="op pair"),
             occ=ops_occupancy(var, n))
    # the chain contracts to its fixed point: the library functions differ
    # by an ulp or two at most; the intrinsics' documented error (2^-21.4
    # absolute for __sinf, 2 ulp + |x| for __expf, ...) stays below 1e-3
    for var, atol, blocks in (("transc", 1e-5, None),
                              ("transc_fast", 1e-3, None),
                              ("transc", 1e-5, occ_k1)):
        case("P7", "ops", f"{var} k13"
             + (f", {blocks} blocks/SM" if blocks else ""),
             lambda: probe_ops(var, a=x7, T=P7_T, blocks_per_sm=blocks),
             lambda: probe_ops_plain(var, a=x7, T=P7_T), _close(atol=atol),
             4 * 2 * L, 14 * P7_T * L, per_step(P7_T, unit="6-function step"),
             occ=ops_occupancy(var, 1, blocks))
    key = (0x243F6A88, 0x85A308D3)
    zero = torch.zeros(L, dtype=torch.float32, device=device)
    for T in (P3_DRAWS, 100):
        # the bits bit for bit, the tail within the library's ulps
        tail = _close(atol=1e-5)
        out3 = case("P3", "ops", f"philox T={T}",
                    lambda: probe_ops("philox", a=zero, T=T, key=key),
                    lambda: probe_ops_plain("philox", a=zero, T=T, key=key),
                    lambda o, r: max(_exact(o[1], r[1]), tail(o[0], r[0])),
                    4 * 5 * L, 110 * T * L, per_step(T, unit="draw"),
                    occ=ops_occupancy("philox"))
        if T == P3_DRAWS:
            t3 = out3[0]

    # ---- H4 probe_deposit -----------------------------------------------
    for label, r, n_doms in (("detect rate (hex61)", hit_rate, HEX61_DOMS),
                             ("expected rate (ic86)", expected_rate,
                              IC86_DOMS)):
        bins, w = _hist_inputs(rng, L, r, n_doms, device)
        nb = n_doms * HIST_BINS
        n_dep = int((bins >= 0).sum())
        for var in ("hist_atomic", "hist_warp"):
            hist = torch.zeros(nb, dtype=torch.float32, device=device)
            ok = bins >= 0
            bins_ok, w_ok = bins[ok].long(), w[ok]
            case("H4", "deposit", f"{var} {label}, {n_dep} deposits",
                 lambda: probe_deposit(var, a=w, idx=bins, n_bins=nb),
                 lambda: probe_deposit_plain(var, a=w, idx=bins, n_bins=nb),
                 _sum_close(1e-5), 4 * (2 * bins.numel() + nb), n_dep,
                 rate(n_dep, "deposits"),
                 library=lambda: hist.index_add_(0, bins_ok, w_ok),
                 occ=deposit_occupancy(var))
    flags = dev(np.zeros((1, L)), np.int32)
    vals = rand(1, L)
    for var in ("append_atomic", "append_warp"):
        case("P4", "deposit", f"{var} every lane",
             lambda: probe_deposit(var, a=vals, idx=flags, cap=L),
             lambda: probe_deposit_plain(var, a=vals, idx=flags, cap=L),
             _records_equal, 4 * (2 * L + 4 * L), L, rate(L, "appends"),
             occ=deposit_occupancy(var))
    x4 = rand(L)
    case("P4", "deposit", "cursor",
         lambda: probe_deposit("cursor", a=x4, T=P4_T),
         lambda: probe_deposit_plain("cursor", a=x4, T=P4_T), _exact,
         4 * 9 * L, 2 * P4_T * L, bandwidth(4 * 9 * L),
         occ=deposit_occupancy("cursor"))
    x5 = rand(P5_R, L)
    case("P5", "deposit", f"transpose ({P5_R}, {L})",
         lambda: probe_deposit("transpose", a=x5),
         lambda: probe_deposit_plain("transpose", a=x5), _exact,
         4 * 2 * P5_R * L, 0, bandwidth(4 * 2 * P5_R * L),
         library=lambda: x5.t().contiguous(),
         occ=deposit_occupancy("transpose"))
    xd = rand(L)
    case("P8", "deposit", f"compact seg={P8_BLK}",
         lambda: probe_deposit("compact", a=xd, seg=P8_BLK, threshold=0.999),
         lambda: probe_deposit_plain("compact", a=xd, seg=P8_BLK,
                                     threshold=0.999),
         _exact, 4 * 2 * L, 4 * L, bandwidth(4 * 2 * L),
         occ=deposit_occupancy("compact"))
    for p, seg, x in (("P7", P7_BLK, xd), ("P3", P3_SEG, t3)):
        case(p, "deposit", f"scan seg={seg}",
             lambda: probe_deposit("scan", a=x, seg=seg),
             lambda: probe_deposit_plain("scan", a=x, seg=seg),
             _scan_close(seg), 4 * 2 * L, 2 * L, bandwidth(4 * 2 * L),
             library=lambda: torch.cumsum(x.view(-1, seg), 1),
             occ=deposit_occupancy("scan"))
    col = rand(P7_S)
    case("P7", "deposit", "store k9",
         lambda: probe_deposit("store", tab=col, L=L),
         lambda: probe_deposit_plain("store", tab=col, L=L), _exact,
         4 * (P7_S + P7_S * L), P7_S * L, bandwidth(4 * P7_S * L),
         occ=deposit_occupancy("store"))
    xc = dev(rng.integers(0, 160, L))
    case("P7", "deposit", "count k11",
         lambda: probe_deposit("count", a=xc),
         lambda: probe_deposit_plain("count", a=xc), _exact, 4 * (L + 128),
         3 * L, rate(L, "lanes counted"), occ=deposit_occupancy("count"))
    return rows


# the row of each kernel that stands for it in a kernels line: the P7
# gather (one PyTorch call computes it), P14's register state, P15's
# longest FMA chain, the histogram deposit at the main path's hit rate
REPRESENTATIVE = {
    "fetch": ("P7", "gather C=64 global"),
    "state": ("P14", "NF=18 reg minb=1"),
    "ops": ("P15", "fma n=40"),
    "deposit": ("H4", "hist_atomic detect rate (hex61)")}

# the TPU kernels each probe kernel replaces
REPLACES = {
    "fetch": "scripts/probe_pallas.py:46 :78 :197, probe_pallas2.py:29 "
             "(k7, k8), probe_pallas3.py:42 (k_fetch, k_cull), "
             "probe_pallas4.py:54, probe_pallas5.py:118, "
             "probe_pallas5b.py:131, probe_pallas6.py:75",
    "state": "scripts/probe_pallas7.py:67, probe_pallas8.py:128",
    "ops": "scripts/probe_pallas.py:110, probe_pallas2.py:29 (k6, k10, "
           "k13), probe_pallas3.py:42 (k_elem), probe_pallas9.py:47",
    "deposit": "scripts/probe_pallas.py:140 :160, probe_pallas2.py:29 "
               "(k9, k11, k12), probe_pallas3.py:42 (k_deposit)"}


def representative(rows, kernel):
    p, prefix = REPRESENTATIVE[kernel]
    return next(r for r in rows if r["kernel"] == kernel and r["p"] == p
                and r["variant"].startswith(prefix))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the probes run on a CUDA GPU; none is available")
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    rows = run_probes("cuda")
    print(f"{'P':<4} {'kernel[variant]':<58} {'ms':>9} {'plain ms':>9} "
          f"{'bound ms':>9} {'lib ms':>8}  figure")
    for r in rows:
        lib_ms = "" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{r['p']:<4} {r['kernel'] + '[' + r['variant'] + ']':<58} "
              f"{r['ms']:9.4f} {r['plain_ms']:9.3f} {r['bound_ms']:9.4f} "
              f"{lib_ms:>8}  {r.get('text', '')}")
    print("launches", LAUNCHES)


if __name__ == "__main__":
    main()
