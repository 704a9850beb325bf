"""The probe kernels' plain versions (clsim_tpu_torch/probes.py) against the
JAX package's Pallas probes P1-P15 (scripts/probe_pallas*.py) on the same
numpy-seeded inputs at a small size.

Each probe script is loaded by path with its `pl.pallas_call` run in
interpret mode and its size globals (BLK, RB, G, T, ROWS) made small; a
kernel whose loop count is written into its body runs its fori_loops to at
most T_CAP trips.  Where the TPU kernel computes through a one-hot matrix
product split into bf16 parts, the port reads the table rounded as the
split rounds it, so that both read the same values.  P3's hardware random
bits have no CPU lowering: its deterministic tail runs on the same
accumulated u, and the plain Philox4x32-10 is held to Random123's known
answers.

Tolerances: gathers, selects, arg-mins, counts, transposes and compactions
equal exactly; multiply-add chains within rtol 1e-6 (XLA may contract a
multiply and an add into one FMA where the port rounds twice: one ulp an
op over a few dozen ops); chains through a data-dependent index run at T =
2-4 (an index |a| 37 or |x| 7 within an ulp of an integer picks another
row when the two sides differ by an ulp, and the chain then diverges); the
transcendentals within 1e-5 (numpy/XLA's and torch's CPU libraries differ
by an ulp or two); scans within 2^-20 of the segment's sum of |x|.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 9)."""

import functools
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from clsim_tpu_torch import probes as P

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "scripts")
T_CAP = 4
f32 = jnp.float32


class _Lax:
    """jax.lax with every fori_loop cut to at most `cap` trips."""

    def __init__(self, cap):
        self.cap = cap

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def fori_loop(self, lo, hi, body, init):
        return jax.lax.fori_loop(lo, min(hi, self.cap), body, init)


class _Jax:
    def __init__(self, cap):
        self.lax = _Lax(cap)

    def __getattr__(self, name):
        return getattr(jax, name)


def load_probe(name, cap=None, **sizes):
    """scripts/<name>.py with pallas_call in interpret mode, its size
    globals replaced, and (cap) its fori_loops cut to `cap` trips."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, ds=pl.ds)
    if cap is not None:
        mod.jax = _Jax(cap)
    for k, v in sizes.items():
        setattr(mod, k, v)
    return mod


def call(kernel, out_shape, *inputs, **kw):
    """The kernel on whole arrays in interpret mode."""
    return pl.pallas_call(kernel, out_shape=out_shape, interpret=True,
                          **kw)(*inputs)


def t(x):
    return torch.as_tensor(np.array(x))


def split2(tab):
    """The value a 2-split (bf16 hi + bf16 lo) one-hot product reads."""
    x = torch.as_tensor(np.array(tab, np.float32))
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).to(torch.float32)


def assert_close(a, b, atol=0.0, rtol=1e-6, ops=0):
    """Within atol + rtol |b|; a chain of `ops` multiply-adds gets 2 ulp an
    op (XLA's contraction into FMAs against the port's two roundings)."""
    rtol = max(rtol, ops * 2.0 ** -22)
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def grid_lanes(x):
    """A (G * rows, 128) grid input as lanes: row-major, block by block."""
    return torch.as_tensor(np.asarray(x, np.float32).reshape(-1))


# ---------------------------------------------------------------------------
# one case a TPU probe
# ---------------------------------------------------------------------------

def p1(rng):
    mod = load_probe("probe_pallas")
    tab = rng.random((mod.S, 128)).astype(np.float32)
    tab[5, :7] = tab[40, :7] = -1.0           # ties: the last index wins
    idx = rng.integers(0, mod.S, (1, 128)).astype(np.int32)
    out = call(mod.k1, jax.ShapeDtypeStruct((3, 128), f32), tab, idx)
    port = P.probe_fetch("select_min", tab=t(tab), idx=t(idx[0]))
    np.testing.assert_array_equal(port.numpy(), np.asarray(out))


def p2(rng):
    mod = load_probe("probe_pallas")
    tabT = (rng.random((mod.C, mod.S)) * 1000 - 500).astype(np.float32)
    idx = rng.integers(0, mod.S, (1, 128)).astype(np.int32)
    out, _ = call(mod.k2, (jax.ShapeDtypeStruct((mod.C, 128), f32),) * 2,
                  tabT, idx)
    port = P.probe_fetch("gather", tab=t(tabT), idx=t(idx[0]))
    np.testing.assert_array_equal(port.numpy(), np.asarray(out))


def p3(rng):
    """k3 with its hardware draws replaced by a hash of the lane (the same
    bits at every one of the 10 draws, as a traced loop body sees one; the
    kernel may capture no constant): the accumulated u, the tail, the lane
    cumsum and the stacked row equal the port's P3 tail and segment scan
    on the same u."""
    mod = load_probe("probe_pallas")
    mult = 0x9E3779B1

    def lane_bits(shape):
        iota = lambda d: jax.lax.broadcasted_iota(jnp.uint32, shape, d)
        return (iota(0) * jnp.uint32(128) + iota(1)) * jnp.uint32(mult)

    mod.pltpu = types.SimpleNamespace(prng_seed=lambda s: None,
                                      prng_random_bits=lane_bits)
    bits = (torch.arange(mod.R * 128, dtype=torch.int64) * mult) & P.MASK
    out = np.asarray(call(mod.k3, jax.ShapeDtypeStruct((mod.R + 1, 128), f32),
                          jnp.asarray([1234], jnp.int32)))
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    acc = torch.zeros_like(u)
    for _ in range(P.P3_DRAWS):
        acc = acc + u
    tail = P.p3_tail_plain(acc)
    scan = P.probe_deposit("scan", a=tail, seg=P.P3_SEG).reshape(mod.R, 128)
    seg_abs = tail.abs().reshape(mod.R, 128).sum(1, keepdim=True).numpy()
    assert (np.abs(scan.numpy() - out[:mod.R]) <= 1e-5 + 2.0 ** -20
            * seg_abs).all()
    assert_close(out[mod.R], tail[:128] * 3.0, atol=1e-5)


def p4(rng):
    mod = load_probe("probe_pallas")
    x = rng.random((1, 128)).astype(np.float32)
    out = call(mod.k4, jax.ShapeDtypeStruct((8, 128), f32), x,
               scratch_shapes=[pltpu.SMEM((1,), jnp.int32)])
    port = P.probe_deposit("cursor", a=t(x[0]), T=P.P4_T)
    assert_close(port.numpy(), np.asarray(out), ops=2)
    # the cursor advances after the even steps: rows x, 5x, 9x, 13x, 8x
    assert_close(port[:5, 0], x[0, 0] * np.array([1, 5, 9, 13, 8]))


def p5(rng):
    mod = load_probe("probe_pallas")
    x = rng.random((P.P5_R, 128)).astype(np.float32)
    out = call(mod.k4b, jax.ShapeDtypeStruct((128, P.P5_R), f32), x)
    port = P.probe_deposit("transpose", a=t(x))
    np.testing.assert_array_equal(port.numpy(), np.asarray(out))


def p6(rng):
    """k5's sin chain at T_CAP of its 32 iterations (an index chain)."""
    mod = load_probe("probe_pallas", cap=T_CAP)
    G, R, C, S = 2, mod.R, mod.C, mod.S
    tabT = rng.random((C, S)).astype(np.float32)
    state = rng.random((G, R, 128)).astype(np.float32)
    out = pl.pallas_call(
        mod.k5, out_shape=jax.ShapeDtypeStruct((G, R, 128), f32),
        grid=(G,), interpret=True,
        in_specs=[pl.BlockSpec((C, S), lambda i: (0, 0)),
                  pl.BlockSpec((1, R, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, R, 128), lambda i: (i, 0, 0)))(
            tabT, state)
    port = P.probe_fetch("chain_sin", a=t(state.reshape(-1)), tab=t(tabT),
                         T=T_CAP)
    assert_close(port.numpy(), np.asarray(out).reshape(-1), atol=1e-5)


def p7(rng):
    """probe_pallas2's k6-k13 at BLK 256, loops cut to T_CAP."""
    BLK, RB = 256, 2
    mod = load_probe("probe_pallas2", cap=T_CAP, BLK=BLK, RB=RB)
    S, C = mod.S, mod.C
    x32 = rng.random((RB, 128)).astype(np.float32)
    xf = rng.random((1, BLK)).astype(np.float32)
    tab = (rng.random((C, S)) * 100).astype(np.float32)
    j32 = rng.integers(0, S, (RB, 128)).astype(np.int32)
    jidx = rng.integers(0, S - 3, (1, BLK)).astype(np.int32)
    col = rng.random((S, 1)).astype(np.float32)
    sd = jax.ShapeDtypeStruct
    # k6: (a + 1) * 1.0000001
    out = call(mod.k6, sd((RB, 128), f32), x32)
    assert_close(P.probe_ops("reshape", a=t(x32.reshape(-1)), T=T_CAP),
                 np.asarray(out).reshape(-1), ops=T_CAP)
    # k7: tab[:, j]
    out = call(mod.k7, sd((C, RB, 128), f32), tab, j32)
    port = P.probe_fetch("gather", tab=t(tab), idx=t(j32.reshape(-1)))
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(out).reshape(C, -1))
    # k8: sum of tab[0, j + i % 3]
    out = call(mod.k8, sd((1, BLK), f32), tab, jidx)
    assert_close(P.probe_fetch("gather_sum", tab=t(tab), idx=t(jidx[0]),
                               T=T_CAP), np.asarray(out)[0], ops=T_CAP)
    # k9: the (S, 1) column broadcast, doubled
    out = call(mod.k9, sd((S, BLK), f32), col)
    port = P.probe_deposit("store", tab=t(col[:, 0]), L=BLK)
    np.testing.assert_array_equal(port.numpy(), np.asarray(out))
    # k10: 25 multiply-adds a step
    out = call(mod.mk_elem((RB, 128)), sd((RB, 128), f32), x32)
    assert_close(P.probe_ops("muladd", a=t(x32.reshape(-1)), T=T_CAP, n=25,
                             m=1.0000001, c0=1e-7),
                 np.asarray(out).reshape(-1), ops=25 * T_CAP)
    # k11: the lanes equal to each of 0..127
    xc = rng.integers(0, 160, (1, BLK)).astype(np.float32)
    out = call(mod.k11, sd((1, 128), f32), xc)
    np.testing.assert_array_equal(
        P.probe_deposit("count", a=t(xc[0])).numpy(), np.asarray(out)[0])
    # k12: the roll cumsum over BLK lanes
    out = np.asarray(call(mod.k12, sd((1, BLK), f32), xf))[0]
    port = P.probe_deposit("scan", a=t(xf[0]), seg=BLK).numpy()
    assert (np.abs(port - out) <= 2.0 ** -20 * np.abs(xf).sum() + 1e-6).all()
    # k13: the transcendental chain
    out = call(mod.k13, sd((RB, 128), f32), x32)
    assert_close(P.probe_ops("transc", a=t(x32.reshape(-1)), T=T_CAP),
                 np.asarray(out).reshape(-1), atol=1e-5, rtol=0)


def p8(rng):
    """probe_pallas3 at BLK 256, G 2, T 2 (index chains)."""
    BLK, RB, G, T = 256, 2, 2, 2
    mod = load_probe("probe_pallas3", BLK=BLK, RB=RB, G=G, T=T)
    x = rng.random((G * RB, 128)).astype(np.float32)
    tab = (rng.random((mod.C, mod.S)) * 100 - 50).astype(np.float32)
    cols = (rng.random((mod.SP, 8)) * 100).astype(np.float32)
    fixed = lambda shape: pl.BlockSpec(shape, lambda i: (0, 0))
    lanes = grid_lanes(x)
    out = mod.grid_call(mod.k_elem)(x)
    assert_close(P.probe_ops("muladd", a=lanes, T=T, n=25, m=1.0000001,
                             c0=1e-9, wrap=True),
                 np.asarray(out).reshape(-1), ops=25 * T)
    out = mod.grid_call(mod.k_fetch, extra_specs=[fixed(tab.shape)])(tab, x)
    assert_close(P.probe_fetch("chain", a=lanes, tab=t(tab), T=T),
                 np.asarray(out).reshape(-1), ops=3 * T)
    out = mod.grid_call(mod.k_cull, extra_specs=[fixed(cols.shape)])(cols, x)
    assert_close(P.probe_fetch("cull", a=lanes, tab=t(cols), T=T),
                 np.asarray(out).reshape(-1), ops=T)
    # k_deposit at one iteration: row 0 of each block holds its first 128
    # values above 0.999 in lane order (a block has up to ~128 of them)
    mod1 = load_probe("probe_pallas3", BLK=BLK, RB=RB, G=G, T=1)
    xd = (0.998 + 0.002 * rng.random((G * RB, 128))).astype(np.float32)
    out = np.asarray(mod1.grid_call(mod1.k_deposit)(xd)).reshape(G, RB, 128)
    vals, cnt = P.probe_deposit("compact", a=grid_lanes(xd), seg=BLK,
                                threshold=0.999)
    vals = vals.reshape(G, BLK).numpy()
    for g in range(G):
        n = min(int(cnt[g]), 128)
        assert n > 50
        np.testing.assert_array_equal(vals[g, :n], out[g, 0, :n])
    assert_close(out[:, 1:], xd.reshape(G, RB, 128)[:, 1:] * 0.9995)


def p9(rng):
    """probe_pallas4's five variants at BLK 256, G 2, T 4 on its table
    rounded to the 2-split (the packed variants pick their parity by a
    lerp w0 + par (w1 - w0), within an ulp of the row)."""
    BLK, RB, G, T = 256, 2, 2, T_CAP
    mod = load_probe("probe_pallas4", BLK=BLK, RB=RB, G=G, T=T)
    variants = mod.make_variants()
    tab = split2(variants["fetch_f32"][1][1][0])
    x = rng.random((G * RB, 128)).astype(np.float32)
    lanes = grid_lanes(x)
    for name, idx_mode, atol in (("fetch_f32", "mod37", 0.0),
                                 ("fetch_i16", "mod37", 0.0),
                                 ("fetch_const", "const", 0.0),
                                 ("fetch_pack2", "frac", 1e-6),
                                 ("fetch_pack4", "frac", 1e-6)):
        k, (especs, eins) = variants[name]
        out = mod.grid_call(k, extra_in=eins, extra_specs=especs)(x)
        port = P.probe_fetch("chain", a=lanes, tab=tab, T=T,
                             idx_mode=idx_mode)
        assert_close(port, np.asarray(out).reshape(-1), atol=atol, ops=3 * T)
    # the card's float2 / float4 layouts of the same rows
    pair = torch.stack([tab[0], tab[5]], 1).contiguous()
    quad = torch.cat([pair, torch.zeros_like(pair)], 1).contiguous()
    ref = P.probe_fetch("chain", a=lanes, tab=tab, T=T)
    for tb, w in ((pair, 2), (quad, 4)):
        np.testing.assert_array_equal(
            P.probe_fetch("chain", a=lanes, tab=tb, T=T, width=w), ref)


def _overlap(rng, name, cat):
    """P10 (P11 with cat): probe_pallas5(b)'s fetch_step / fetch_cat_step
    and vpu_step, eagerly, against the port's overlap variants."""
    mod = load_probe(name)
    S, C, T = mod.S, mod.C, T_CAP
    tab = jnp.asarray(rng.random((C, S)), f32)
    hi, lo = mod.split2(tab)
    x = jnp.asarray(rng.random((2, 128)), f32)
    iota = jax.lax.broadcasted_iota(jnp.int32, (S, x.size), 0)
    catt = jnp.concatenate([hi, lo], 0)
    step = ((lambda a: mod.fetch_cat_step(catt, iota, a, S)) if cat
            else (lambda a: mod.fetch_step(hi, lo, iota, a, S)))
    rounded = split2(tab)
    for kind in ("chain", "alu", "both", "ilp2"):
        a, b = x, x * 0.5
        for _ in range(T):
            if kind != "alu":
                a = step(a)
            if kind in ("alu", "both"):
                b = mod.vpu_step(b)
        port = P.probe_fetch("overlap", a=t(x).reshape(-1), tab=rounded, T=T,
                             idx_mode="frac", overlap=kind)
        assert_close(port, np.asarray(a + b).reshape(-1), ops=23 * T)


def p10(rng):
    _overlap(rng, "probe_pallas5", cat=False)


def p11(rng):
    _overlap(rng, "probe_pallas5b", cat=True)


def p12(rng):
    BLK, RB, G, T = 256, 2, 2, T_CAP
    mod = load_probe("probe_pallas6", BLK=BLK, RB=RB, G=G, T=T)
    x = rng.random((G * RB, 128)).astype(np.float32)
    lanes = grid_lanes(x)
    ten = torch.full(lanes.shape, P.P12_CAND, dtype=torch.int32)
    for kind in ("small", "big"):
        assert_close(P.probe_fetch("candidates", a=lanes, idx=ten, T=T),
                     np.asarray(mod.make(kind)(x)).reshape(-1), ops=22 * T)
    assert_close(P.probe_ops("muladd", a=lanes, T=T, n=21, m=1.0000001,
                             c0=1e-9),
                 np.asarray(mod.make("flat")(x)).reshape(-1), ops=21 * T)


def p13(rng):
    BLK, RB, G, T, NF = 256, 2, 2, T_CAP, P.P13_NF
    mod = load_probe("probe_pallas7", BLK=BLK, RB=RB, G=G, T=T)
    x = rng.random((G * RB, 128)).astype(np.float32)
    lanes = grid_lanes(x)
    fields = torch.stack([lanes * (1.0 + 0.001 * k) for k in range(NF)])
    for kind, touched in (("many_carries", NF), ("few_ops", 4)):
        port = P.probe_state(fields, T=T, touched=touched, step_kind=0,
                             reduce=True)
        assert_close(port, np.asarray(mod.make(kind)(x)).reshape(-1),
                     ops=T + NF)
    port = P.probe_state(lanes[None], T=T, step_kind=0)[0]
    assert_close(port, np.asarray(mod.make("one_carry")(x)).reshape(-1),
                 ops=T)


def p14(rng):
    BLK, RB, G, T, NF = 256, 2, 2, T_CAP, P.P14_NF
    mod = load_probe("probe_pallas8", BLK=BLK, RB=RB, G=G, T=T)
    x = rng.random((G * NF * RB, 128)).astype(np.float32)
    # (G, NF, RB, 128) blocks -> (NF, lanes)
    fields = torch.as_tensor(x.reshape(G, NF, RB * 128).transpose(1, 0, 2)
                             .reshape(NF, -1).copy())
    for kind, touched in (("carry18all", NF), ("carry18", 1)):
        out = np.asarray(jax.jit(mod.make(kind))(x))
        out = out.reshape(G, NF, RB * 128).transpose(1, 0, 2).reshape(NF, -1)
        assert_close(P.probe_state(fields, T=T, touched=touched), out, ops=T)
    # scratchall writes field 0 alone: the carry plus the scratch copy of
    # the same chain, twice the port's field 0
    out = np.asarray(jax.jit(mod.make("scratchall"))(x))
    out = out.reshape(G, NF, RB * 128)[:, 0].reshape(-1)
    assert_close(2.0 * P.probe_state(fields, T=T)[0], out, ops=T)


def p15(rng):
    BLK, RB, G, T = 256, 2, 2, T_CAP
    ROWS = 5 * RB
    mod = load_probe("probe_pallas9", BLK=BLK, RB=RB, G=G, T=T, ROWS=ROWS)
    x = (rng.random((G * 2 * ROWS, 128)) + 0.5).astype(np.float32)
    blocks = x.reshape(G, 2, ROWS * 128)
    a, b = t(blocks[:, 0].reshape(-1).copy()), t(blocks[:, 1].reshape(-1)
                                                 .copy())
    for n, div in ((5, False), (10, False), (5, True), (10, True)):
        out = np.asarray(jax.jit(mod.make(n, div=div))(x)).reshape(G, 2, -1)
        port = P.probe_ops("div" if div else "fma", a=a, b=b, T=T, n=n)
        assert_close(port, out[:, 0].reshape(-1), ops=2 * n * T)
        np.testing.assert_array_equal(out[:, 1], blocks[:, 1])


CASES = {f"P{i}": f for i, f in enumerate(
    (p1, p2, p3, p4, p5, p6, p7, p8, p9, p10, p11, p12, p13, p14, p15),
    start=1)}


@pytest.mark.parametrize("probe", list(CASES))
def test_plain_version_matches_pallas_probe(probe):
    CASES[probe](np.random.default_rng(int(probe[1:])))


# ---------------------------------------------------------------------------
# Philox, imports, CPU dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_plain_philox_known_answers(counter, key, expected):
    """Random123's known-answer vectors for philox4x32 with 10 rounds."""
    c = [torch.tensor([v], dtype=torch.int64) for v in counter]
    out = P.philox4x32_10_plain(*c, *key)
    assert tuple(int(w[0]) for w in out) == expected


def test_probes_import_no_jax():
    """`import clsim_tpu_torch.probes` (and the package) loads neither JAX
    nor the JAX package nor a probe script."""
    code = ("import sys, clsim_tpu_torch, clsim_tpu_torch.probes; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'clsim_tpu', 'scripts') or 'probe_pallas' in m]"
            "; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(SCRIPTS)
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cpu_tensors_take_the_plain_version():
    """Each wrapper runs its plain version for CPU tensors: the same
    outputs, no kernel launch counted, the kernel library never loaded."""
    rng = np.random.default_rng(0)
    before = dict(P.LAUNCHES)
    x = torch.as_tensor(rng.random(256).astype(np.float32))
    tab = torch.as_tensor(rng.random((8, 40)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 37, 256).astype(np.int32))
    kw = dict(a=x, tab=tab, T=3)
    assert torch.equal(P.probe_fetch("chain", **kw),
                       P.probe_fetch_plain("chain", **kw))
    assert torch.equal(P.probe_fetch("gather", tab=tab, idx=idx),
                       tab[:, idx.long()])
    st = torch.stack([x, x * 2.0])
    assert torch.equal(P.probe_state(st, T=5), P.probe_state_plain(st, T=5))
    assert torch.equal(P.probe_ops("fma", a=x, b=x, T=2, n=5),
                       P.probe_ops_plain("fma", a=x, b=x, T=2, n=5))
    assert torch.equal(P.probe_deposit("scan", a=x, seg=128),
                       torch.cumsum(x.reshape(2, 128), 1).reshape(-1))
    assert P.LAUNCHES == before
    assert P._LIB is None
