"""The port's repack between kernel launches (propagate/kernel.repack_slots,
the call loop's repack and balance, the kernel's live prefix n_active)
against the JAX call loop's do_repack (clsim_tpu/propagate/kernel.py
:2501-2555): a numpy transcription of it, the JAX package's own multi-call
run of tests/test_kernel.py's uneven queues, and the plain version's prefix
launch.  The CUDA kernel's n_active runs only on a GPU
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import test_kernel as TK

from clsim_tpu.propagate import kernel as KJ
from clsim_tpu_torch.propagate import kernel as KT

from test_torch_engine import port_inputs

torch.set_num_threads(1)

NSF, NST = KT.NSF, KT.NST
N_JAX = 1024       # the JAX kernel's smallest slot count (block_lanes 1024)


def jax_do_repack(st, sp, balance):
    """tests' numpy transcription of the JAX do_repack
    (clsim_tpu/propagate/kernel.py:2501-2555) on unpacked (NSF, N) state
    and (NST, N) step rows, with the JAX state's `pend` (its deferred-hit
    register, a row the port's state does not have) at 0; `.at[].set(...,
    mode="drop")` drops the sentinel index N."""
    st, sp = st.copy(), sp.copy()
    left, inf = st[0], st[1]
    pend = np.zeros_like(left)
    N = left.shape[0]
    iota = np.arange(N, dtype=np.int32)
    if balance:
        dead = (left <= 0.5) & (inf <= 0.5) & (pend <= 0.0)
        donor_mask = left >= 2.0
        drank = np.cumsum(donor_mask.astype(np.int32)) - 1
        rrank = np.cumsum(dead.astype(np.int32)) - 1
        n_pairs = min(drank[-1], rrank[-1]) + 1

        def by_rank(mask, rank):
            out = np.full(N, N, np.int32)
            idx = np.where(mask, rank, N)
            keep = idx < N
            out[idx[keep]] = iota[keep]
            return out
        donor_by_rank = by_rank(donor_mask, drank)
        recip_by_rank = by_rank(dead, rrank)
        valid = iota < n_pairs
        d_idx = np.where(valid, donor_by_rank, 0)
        r_idx = np.where(valid, recip_by_rank, 0)
        givev = np.where(valid, np.floor(left[d_idx] * np.float32(0.5)),
                         np.float32(0.0)).astype(np.float32)
        left = left.copy()
        np.add.at(left, d_idx, -givev)
        np.add.at(left, r_idx, givev)
        st[0] = left
        moved = np.take(sp, d_idx, axis=1)
        tgt = np.where(valid, r_idx, N)
        keep = tgt < N
        sp[:, tgt[keep]] = moved[:, keep]
    live = (left > 0.5) | (inf > 0.5) | (pend > 0.0)
    livei = live.astype(np.int32)
    n_live_inc = np.cumsum(livei)
    pos = np.where(live, n_live_inc - 1,
                   n_live_inc[-1] + np.cumsum(1 - livei) - 1)
    perm = np.zeros(N, np.int32)
    perm[pos] = iota
    both = np.take(np.concatenate([st, sp], axis=0), perm, axis=1)
    return both[:NSF], both[NSF:], int(n_live_inc[-1])


def random_slots(n, kind, seed):
    """(NSF, N) state and (NST, N) step rows: photons left 0-9 (integers,
    as the kernel keeps them), in_flight 0/1, the other rows random floats,
    identifiers distinct; `kind` "mixed", "all_live", "all_drained" or
    "one_live"."""
    r = np.random.default_rng(seed)
    st = r.standard_normal((NSF, n)).astype(np.float32)
    st[0] = r.integers(0, 10, n) * (r.random(n) < 0.5)
    st[1] = r.random(n) < 0.3
    if kind == "all_live":
        st[0] = np.maximum(st[0], 1.0)
    elif kind in ("all_drained", "one_live"):
        st[0], st[1] = 0.0, 0.0
        if kind == "one_live":
            st[0, n // 3] = 7.0
    sp = r.standard_normal((NST, n)).astype(np.float32)
    sp[KT.STEP_FIELDS.index("identifier")] = np.arange(n) + 1000
    sp[KT.STEP_FIELDS.index("source_type")] = r.integers(0, 3, n)
    return st.astype(np.float32), sp


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("kind", ["mixed", "all_live", "all_drained",
                                  "one_live"])
def test_repack_slots_equals_the_jax_do_repack(kind, balance):
    """repack_slots equals the numpy transcription of the JAX do_repack bit
    for bit: the permuted state, the step rows (the donors' rows copied to
    their recipients) and the live count."""
    for n, seed in ((300, 1), (1024, 2)):
        st, sp = random_slots(n, kind, seed)
        st_j, sp_j, live_j = jax_do_repack(st, sp, balance)
        st_t, sp_t, live_t = KT.repack_slots(torch.from_numpy(st),
                                             torch.from_numpy(sp), balance)
        np.testing.assert_array_equal(st_t.numpy(), st_j)
        np.testing.assert_array_equal(sp_t.numpy(), sp_j)
        assert int(live_t) == live_j
        # photons are moved, never made or lost; live slots come first
        assert st_t[0].sum() == float(st[0].sum())
        live = (st_t[0] > 0.5) | (st_t[1] > 0.5)
        assert bool(live[:live_j].all()) and not bool(live[live_j:].any())
    if kind == "mixed" and balance:
        assert live_j > int(((st[0] > 0.5) | (st[1] > 0.5)).sum())


def uneven_inputs(n):
    """tests/test_kernel.py's workload at n slots with its balance test's
    uneven queues (slot i has i % 9 photons), for both packages."""
    import jax.numpy as jnp
    from clsim_tpu.types import StepBatch
    old = TK.N
    TK.N = n
    try:
        medium, geo, spectra, cfg, steps, u = TK._workload()
    finally:
        TK.N = old
    steps = StepBatch(*[jnp.asarray(f) for f in steps])._replace(
        num_photons=jnp.asarray((np.arange(n) % 9).astype(np.int32)))
    return medium, geo, spectra, cfg, steps, u


@pytest.mark.parametrize("flush_every", [1, 4])
@pytest.mark.parametrize("balance", [False, True])
def test_repack_conserves_and_matches_the_jax_call_loop(balance,
                                                        flush_every):
    """The uneven queues of tests/test_kernel.py::
    test_kernel_balance_conserves_and_drains through the port's
    propagate_fused on the CPU (the plain version a launch) with repack on,
    balance off and on, one replayed stream: every photon generated,
    nothing abandoned or dropped, the histogram's sum the hit weight (rel
    1e-5); and the JAX package's own run of the same workload (interpret
    mode, allow_uniform_replay, the same repack and balance) drains the
    same photons.

    What was found: with flush_every=1 the JAX kernel flushes its
    pending-hit register (`pend`) in every iteration, no lane ends a call
    with a pending hit, both loops repack the same slots into the same
    order and read the same stream columns after it, and the two runs
    agree bit for bit (equal hits, histogram L1 0); they are held here to
    hits within max(2, 1%) and L1 <= 2e-3.  With flush_every=4 (the JAX
    test's) a lane that detected keeps its hit pending until the flush and
    spawns no photon meanwhile, so already the first call generates
    another count (3,120 against the port's 3,129 on this workload) and the
    `pend > 0` term of the JAX live rule keeps such lanes live at a repack:
    the trajectories differ, and the counts alone are held."""
    inputs = uneven_inputs(N_JAX)
    medium_j, geo_j, spectra_j, cfg_j, steps_j, u_j = inputs
    res_j, tot_j = KJ.propagate_fused(
        steps_j, medium_j, geo_j, spectra_j, seed=5, cfg=cfg_j,
        iters_per_call=TK.T, flush_every=flush_every, queue_rows=32,
        block_lanes=1024, max_calls=64, repack=True, balance=balance,
        interpret=True, uniforms=u_j, allow_uniform_replay=True)
    steps, medium, geo, spectra, cfg, u = port_inputs(*inputs)
    res, tot = KT.propagate_fused(
        steps, medium, geo, spectra, 5, cfg, iters_per_call=TK.T,
        max_calls=64, uniforms=u, allow_uniform_replay=True, repack=True,
        balance=balance)
    photons = float(steps.num_photons.sum())
    assert float(tot[KT.CNT_GEN]) == photons == float(tot_j[KJ.CNT_GEN])
    assert float(tot[KT.CNT_ALIVE]) == 0.0 == float(tot_j[KJ.CNT_ALIVE])
    assert float(tot[KT.CNT_DROPPED]) == 0.0 == float(tot_j[KJ.CNT_DROPPED])
    np.testing.assert_allclose(float(res.hist.double().sum()),
                               float(tot[KT.CNT_WSUM]), rtol=1e-5)
    # the repack acted: more calls than one, fewer slot-iterations than
    # the whole grid at every call
    assert res.n_iterations > TK.T
    assert float(tot[KT.CNT_WORK]) < N_JAX * res.n_iterations
    if flush_every != 1:
        return
    hits, hits_j = float(tot[KT.CNT_HITS]), float(tot_j[KJ.CNT_HITS])
    assert hits_j > 20
    assert abs(hits - hits_j) <= max(2.0, 0.01 * hits_j)
    assert res.n_iterations == int(res_j.n_iterations)
    h_j = np.asarray(res_j.hist, np.float64).reshape(-1)
    h_t = res.hist.double().numpy().reshape(-1)
    assert np.abs(h_j - h_t).sum() <= 2e-3 * h_j.sum() + 1e-6


def test_balance_drains_in_fewer_iterations():
    """Balance splits the deep queues: on the same replayed stream the
    call loop with repack and balance drains the uneven queues in fewer
    iterations than without repack (conservation held in each)."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*uneven_inputs(N_JAX))
    iters = {}
    for name, kw in (("off", dict(repack=False)),
                     ("balance", dict(repack=True, balance=True))):
        res, tot = KT.propagate_fused(
            steps, medium, geo, spectra, 5, cfg, iters_per_call=TK.T,
            max_calls=64, uniforms=u, allow_uniform_replay=True, **kw)
        assert float(tot[KT.CNT_GEN]) == float(steps.num_photons.sum())
        assert float(tot[KT.CNT_ALIVE]) == 0.0
        iters[name] = res.n_iterations
    assert iters["balance"] < iters["off"]


def test_external_stream_needs_allow_uniform_replay():
    """An external stream with max_calls > 1 is refused unless
    allow_uniform_replay is set, as in the JAX package."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    with pytest.raises(ValueError, match="allow_uniform_replay"):
        KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                           iters_per_call=TK.T, max_calls=2, uniforms=u)
    _, tot = KT.propagate_fused(steps, medium, geo, spectra, 0, cfg,
                                iters_per_call=TK.T, max_calls=2, uniforms=u,
                                allow_uniform_replay=True)
    assert float(tot[KT.CNT_GEN]) > 0


def test_plain_prefix_launch_leaves_the_rest_untouched():
    """The plain version's n_active runs the first n_active slots alone:
    the slots past it keep their state bit for bit, and the run equals a
    full run whose other slots are drained (same stream columns)."""
    steps, medium, geo, spectra, cfg, u = port_inputs(*TK._workload())
    n, n_act = TK.N, 768
    spec, cell_tab = KT.fused_spec(medium, geo, spectra, cfg, n, TK.T)
    tables = KT.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = KT.pack_steps(steps)
    state0 = KT.init_state(steps)
    # the slots past the prefix hold a stale, drained photon
    state0[2:, n_act:] = torch.randn(NSF - 2, n - n_act,
                                     generator=torch.Generator().manual_seed(1))
    state0[:2, n_act:] = 0.0
    state_a, hist_a, cnt_a = KT.run_fused_iterations(
        state0.clone(), steps_p, tables, spec, uniforms=u, n_active=n_act)
    assert torch.equal(state_a[:, n_act:], state0[:, n_act:])
    state_b, hist_b, cnt_b = KT.run_fused_iterations(
        state0.clone(), steps_p, tables, spec, uniforms=u)
    assert torch.equal(state_a[:, :n_act], state_b[:, :n_act])
    assert torch.equal(hist_a, hist_b)
    for c in (KT.CNT_GEN, KT.CNT_HITS, KT.CNT_WSUM, KT.CNT_ALIVE,
              KT.CNT_WORK, KT.CNT_WALK):
        assert float(cnt_a[c]) == float(cnt_b[c])
    assert float(cnt_a[KT.CNT_GEN]) > 0
    for bad in (0, n + 1):
        with pytest.raises(ValueError, match="n_active"):
            KT.run_fused_iterations(state0.clone(), steps_p, tables, spec,
                                    uniforms=u, n_active=bad)
    assert KT.live_prefix(1, n) == KT.BLOCK
    assert KT.live_prefix(KT.BLOCK + 1, n) == 2 * KT.BLOCK
    assert KT.live_prefix(n - 1, n) == n
