"""The tabulator kernel's plain version (tabulator/table.py
tabulate_iterations_plain, the interface of csrc/tabulate.cu) against the
JAX package's tabulator on the same inputs, on the CPU: its key tables and
draws against jax.random bit for bit (and the kernel's threefry rounds,
written out in numpy, against the same), iterations against the JAX raw
chunk and whole tables against clsim_tpu.tabulator.tabulate in four
configurations (spherical, cylindrical, spherical with the impact axis, and
spherical in a tilted anisotropic ice), a table that does not depend on
the iterations a launch or on the launches' schedule, launches on a list
of live slots, the iteration cap, and the counters.

Tolerances are tests/test_torch_tabulator.py's: positions within 2e-3
(abs) / 1e-4 (rel), remainders 1e-4, the depth so far 1e-5 (abs) and, as
the positions (in an anisotropic ice it follows the direction), 1e-4
(rel); tables (after 32 iterations and whole) L1 <= 2e-3 of the total with
equal n_photons.
The small size (64 slots, 10 m segments, 4-12-bin axes) keeps the file
near 40 s on one worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import _beam_steps, _spectra

from clsim_tpu.hits.acceptance import dom_angular_sensitivity as ang_j
from clsim_tpu.medium.anisotropy import AnisotropyParams
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.medium.tilt import TiltParams
from clsim_tpu.propagate import engine as EJ
from clsim_tpu.tabulator import axes as AXJ
from clsim_tpu.tabulator import table as TJ
from clsim_tpu.types import PropagationConfig as CfgJ
from clsim_tpu.types import StepBatch as StepsJ

from clsim_tpu_torch import convert as C
from clsim_tpu_torch.ops import rng as R
from clsim_tpu_torch.propagate import kernel as K
from clsim_tpu_torch.tabulator import axes as AXT
from clsim_tpu_torch.tabulator import kernel as TK
from clsim_tpu_torch.tabulator import table as TT
from clsim_tpu_torch.types import PropagationConfig as CfgT

torch.set_num_threads(1)

L1_TOL = 2e-3
SLOTS = 64
SEG = 10.0          # max_segment_m: 12 sub-steps a segment

SPH = [(0.0, 200.0, 12, 2), (0.0, 180.0, 6, 1), (-1.0, 1.0, 10, 1),
       (0.0, 2000.0, 12, 2)]
CYL = [(0.0, 200.0, 12, 2), (0.0, np.pi, 6, 1), (-200.0, 200.0, 10, 1),
       (0.0, 2000.0, 12, 2)]
IMP = [(0.0, 200.0, 10, 2), (0.0, 180.0, 4, 1), (-1.0, 1.0, 6, 1),
       (0.0, 2000.0, 10, 2), (-1.0, 1.0, 8, 1)]
# (axes kind, specs, photons a slot, seed, tilted anisotropic ice)
CASES = {"spherical": ("spherical", SPH, 2, 5, False),
         "cylindrical": ("cylindrical", CYL, 2, 5, False),
         "impact": ("spherical", IMP, 2, 7, False),
         "spherical, tilt + anisotropy": ("spherical", SPH, 2, 9, True)}


def tilted_aniso(medium):
    """tests/test_kernel.py's anisotropy and tilt on the JAX medium."""
    r = np.random.default_rng(3)
    nd, nz = 4, 9
    return medium._replace(
        anisotropy=AnisotropyParams(
            azimuth=jnp.float32(3.9), mag_along=jnp.float32(0.04),
            mag_perp=jnp.float32(-0.08), enabled=True),
        tilt=TiltParams(
            distances=jnp.asarray([-800.0, -200.0, 300.0, 900.0]),
            first_z=jnp.float32(-400.0), z_spacing=jnp.float32(100.0),
            z_corrections=jnp.asarray(20.0 * r.standard_normal((nd, nz)),
                                      jnp.float32),
            azimuth_cos=jnp.float32(np.cos(3.93)),
            azimuth_sin=jnp.float32(np.sin(3.93)), enabled=True))


def case_inputs(name):
    """Both packages' inputs of one case: (JAX medium, spectra, steps, cfg,
    axes, source), (the port's)."""
    kind, specs, photons, _, tilt = CASES[name]
    medium = ice_j(b400=0.005, a_dust400=0.01)
    if tilt:
        medium = tilted_aniso(medium)
    cfg = CfgJ(n_slots=SLOTS, max_segment_m=SEG, max_layer_steps=6)
    # a beam tilted off +x, so that the tilt and the anisotropy act
    direction = (0.8, 0.36, 0.48) if tilt else (1.0, 0.0, 0.0)
    steps = _beam_steps(SLOTS, photons, direction=direction)
    cls = {"spherical": "SphericalAxes", "cylindrical": "CylindricalAxes"}
    aj = getattr(AXJ, cls[kind])([AXJ.Axis(*s) for s in specs])
    at = getattr(AXT, cls[kind])([AXT.Axis(*s) for s in specs])
    args = (0.0, 0.0, 0.0, 0.0, np.pi / 2, np.pi)     # along +x
    port = (C.medium_from_numpy(C.numpy_tree(medium), device="cpu"),
            C.spectra_from_numpy(C.numpy_tree(_spectra()), device="cpu"),
            C.steps_from_numpy(C.numpy_tree(steps), device="cpu"),
            CfgT(**dataclasses.asdict(cfg)), at,
            TT.make_reference_source(*args, device="cpu"))
    return (medium, _spectra(), steps, cfg, aj,
            TJ.make_reference_source(*args)), port


def port_plan(port):
    mt, st, stp, cfgt, at, src = port
    return TT._table_plan(mt, st, src, at, None, cfgt, 1.0, 46.0)[0]


# --- random numbers --------------------------------------------------------

MASK = np.uint64(0xFFFFFFFF)


def threefry_bits_np(k0, k1, c1):
    """csrc/propagate.cuh threefry_bits written out in numpy (uint64 holding
    uint32 words): the round macro x0 += x1; x1 = rotl(x1, r) ^ x0, the key
    injections, and the two words XORed."""
    k0, k1 = np.uint64(k0), np.uint64(k1)
    k2 = np.uint64(0x1BD11BDA) ^ k0 ^ k1
    x0 = np.full_like(c1, k0)
    x1 = (c1 + k1) & MASK
    ks = (k0, k1, k2)
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & MASK) \
                ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & MASK
    return x0 ^ x1


def tf_u01_np(bits):
    """csrc/propagate.cuh tf_u01: the mantissa's float in [1, 2), minus 1."""
    f = ((bits >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32)
    return f.view(np.float32) - np.float32(1.0)


def test_key_tables_and_draws_match_jax_random():
    """launch_keys' tables of a launch from iteration 40 and the draws the
    kernel makes from them (rows 0-8 of slot s at element r * N + s; the
    impact draws of sub-step m at s and N + s) against jax.random, and the
    int32 words the kernel reads."""
    n, i0, iters, n_sub = 50, 40, 3, 4
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    keys = TK.launch_keys(R.fold_in(R.base_key(5), 2), i0, iters, n_sub,
                          True, "cpu")
    assert keys.iter.shape == (iters, 2)
    assert keys.impact.shape == (iters, n_sub, 2)
    words = TK._words(keys.iter).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, keys.iter.numpy())
    s = np.arange(n, dtype=np.uint64)
    for k in range(iters):
        kj = jax.random.fold_in(key, i0 + k)
        assert keys.iter[k].tolist() == np.asarray(kj).tolist()
        u9 = np.asarray(jax.random.uniform(kj, (9, n)))
        np.testing.assert_array_equal(
            R.uniforms(keys.iter[k], (n,), 9).numpy(), u9)
        k0, k1 = keys.iter[k].tolist()
        for r in range(9):
            np.testing.assert_array_equal(
                tf_u01_np(threefry_bits_np(k0, k1, np.uint64(r * n) + s)),
                u9[r])
        sj = jax.random.fold_in(kj, TT.IMPACT_SALT)
        for m in range(n_sub):
            uj = np.asarray(jax.random.uniform(jax.random.fold_in(sj, m),
                                               (2, n)))
            assert keys.impact[k, m].tolist() == np.asarray(
                jax.random.fold_in(sj, m)).tolist()
            s0, s1 = keys.impact[k, m].tolist()
            np.testing.assert_array_equal(
                tf_u01_np(threefry_bits_np(s0, s1, s)), uj[0])
            np.testing.assert_array_equal(
                tf_u01_np(threefry_bits_np(s0, s1, np.uint64(n) + s)), uj[1])


# --- the plain version against the JAX package -----------------------------

def jax_chunk_table(jax_in, n_bins, seed, n_chunks):
    """The JAX raw chunk's first n_chunks chunks of batch 0 of `seed`: its
    comb entries added into a float64 table, and the final state."""
    medium, spectra, steps, cfg, aj, src = jax_in
    cfg = dataclasses.replace(cfg, fixed_abs_lens=46.0,
                              stop_on_detection=False)
    chunk = TJ._make_tabulate_chunk(medium, spectra, src, ang_j(), cfg, aj,
                                    1.0, jnp.float32(4.42),
                                    jnp.float32(0.85))
    b = StepsJ(*[jnp.asarray(f) for f in steps])
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    state, rem = EJ._init_state(b), jnp.zeros(SLOTS, jnp.float32)
    table = np.zeros(n_bins)
    for c in range(n_chunks):
        state, rem, idx, w, _ = chunk.raw(b, key, state, rem,
                                          jnp.int32(16 * c))
        np.add.at(table, np.asarray(idx).ravel(),
                  np.asarray(w, np.float64).ravel())
    return table, state, rem


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_iterations_match_jax(name):
    """32 iterations of tabulate_iterations_plain (two launches of 16) against
    two JAX raw chunks on the same key: the deposited table bin by bin and
    the state; then the whole table through tabulate() against the JAX
    tabulate() on the same seed."""
    jax_in, port = case_inputs(name)
    mt, st, stp, cfgt, at, src = port
    seed = CASES[name][3]
    # the chunk comparison runs at the test constants 4.42 / 0.85, as
    # test_chunk_matches_jax_chunk does
    cfg46 = dataclasses.replace(cfgt, fixed_abs_lens=46.0,
                                stop_on_detection=False)
    body = TT._make_tabulate_body(mt, st, src, TT.dom_angular_sensitivity(
        device="cpu"), cfg46, at, 1.0, 4.42, 0.85)
    plan = port_plan(port)._replace(body=body)
    table_j, sj, rj = jax_chunk_table(jax_in, at.n_bins, seed, 2)
    state = TT.init_state(stp)
    table = torch.zeros(at.n_bins, dtype=torch.float64)
    key = R.fold_in(R.base_key(seed), 0)
    for c in range(2):
        keys = TK.launch_keys(key, 16 * c, 16, plan.block.n_sub,
                              plan.block.impact, "cpu")
        TT.tabulate_iterations_plain(plan, state, K.pack_steps(stp), keys,
                                     table)
    l1 = np.abs(table.numpy() - table_j).sum() / np.abs(table_j).sum()
    print(f"{name}: 32 iterations, table L1 {l1:.3e} of the total")
    assert l1 <= L1_TOL and table_j.sum() > 0
    got = dict(zip(K.STATE_FIELDS, state[:K.NSF].numpy()))
    np.testing.assert_array_equal(got["in_flight"] > 0.5,
                                  np.asarray(sj.in_flight))
    # with anisotropy the depth of a segment depends on the direction, so
    # it takes the positions' relative tolerance besides 1e-5
    np.testing.assert_allclose(
        46.0 - got["abs_left"],
        np.asarray(sj.abs_lens_initial - sj.abs_lens_left), atol=1e-5,
        rtol=1e-4)
    np.testing.assert_allclose(state[K.NSF].numpy(), np.asarray(rj),
                               atol=1e-4)
    for f in ("x", "y", "z", "dx", "dy", "dz"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(sj, f)),
                                   atol=2e-3, rtol=1e-4, err_msg=f)

    medium, spectra, steps, cfg, aj, src_j = jax_in
    tj = TJ.tabulate([steps], medium, spectra, src_j, seed=seed, axes=aj,
                     cfg=cfg)
    tally = {}
    tt = TT.tabulate([stp], mt, st, src, seed=seed, axes=at, cfg=cfgt,
                     tally=tally)
    assert tt.n_photons == tj.n_photons == SLOTS * CASES[name][2]
    l1 = np.abs(tt.values - tj.values).sum() / np.abs(tj.values).sum()
    print(f"{name}: whole table L1 {l1:.3e} of the total")
    assert l1 <= L1_TOL
    assert tally["generated"] == tt.n_photons


# --- launches, the cap and the counters ------------------------------------

@pytest.fixture(scope="module")
def spherical():
    """The spherical case's port inputs, plan and full run (tally and raw
    table, in launches of 16)."""
    _, port = case_inputs("spherical")
    plan = port_plan(port)
    tally = {}
    mt, st, stp, cfgt, at, src = port
    TT.tabulate([stp], mt, st, src, seed=3, axes=at, cfg=cfgt, tally=tally)
    return port, plan, tally


def test_table_does_not_depend_on_launch_length(spherical):
    """Launches of 16 and 64 iterations fill the same raw table, bit for
    bit: iterations past a slot's last photon change nothing."""
    port, plan, tally = spherical
    stp, at = port[2], port[4]
    key = R.fold_in(R.base_key(3), 0)
    t64 = torch.zeros(at.n_bins, dtype=torch.float64)
    t_64 = {}
    n64 = TT._tabulate_batch(plan, stp, key, t64, t_64, launch_iters=64)
    assert torch.equal(t64, tally["raw"])
    assert n64 % 64 == 0 and n64 >= tally["iterations"]
    assert t_64["syncs"] < tally["syncs"]
    for k in ("entries", "substeps", "work", "walk", "generated"):
        assert t_64[k] == tally[k], k


@pytest.mark.parametrize("launch_iters,tail_iters", [(16, 4), (512, 128)])
def test_tail_schedule_matches_fixed_launches(spherical, launch_iters,
                                              tail_iters):
    """The shortened tail (launches of tail_iters once no more than half
    the slots live, each on the live slots alone) against fixed launches of
    launch_iters on every slot: the same table bit for bit, the same
    counters, and the iterations of the same run cut at a shorter launch's
    end (no more, and fewer by less than one long launch)."""
    port, plan, _ = spherical
    stp, at = port[2], port[4]
    key = R.fold_in(R.base_key(3), 0)
    out = []
    for tail in (tail_iters, launch_iters):
        table, tally = torch.zeros(at.n_bins, dtype=torch.float64), {}
        n = TT._tabulate_batch(plan, stp, key, table, tally,
                               launch_iters=launch_iters, tail_iters=tail)
        out.append((n, table, tally))
    (n_s, t_s, c_s), (n_f, t_f, c_f) = out
    assert torch.equal(t_s, t_f)
    for k in ("entries", "substeps", "work", "walk", "generated", "weight"):
        assert c_s[k] == c_f[k], k
    assert n_f - launch_iters < n_s <= n_f
    assert n_f % launch_iters == 0 and (n_s - launch_iters) % tail_iters == 0


def test_compacted_slot_list_matches_full_run(spherical):
    """The plain version on the list of live slots (live_slots, ascending,
    and the same list reversed) after a first launch gives the state of a
    run on every slot bit for bit, the same counters and the same table
    within 1e-12 relative; the slots off the list keep their state."""
    port, plan, _ = spherical
    stp, at = port[2], port[4]
    key = R.fold_in(R.base_key(3), 0)
    sp = K.pack_steps(stp)
    state = TT.init_state(stp)
    keys = TK.launch_keys(key, 0, 42, plan.block.n_sub, False, "cpu")
    c0 = TT.tabulate_iterations_plain(plan, state, sp, keys,
                                      torch.zeros(at.n_bins,
                                                  dtype=torch.float64))
    alive = int(c0[TK.TAB_COUNTERS.index("alive")])
    assert 0 < alive < SLOTS
    live = TT.live_slots(state, alive)
    assert live.dtype == torch.int32
    want = torch.nonzero((state[1] > 0.5) | (state[0] > 0.5)).flatten()
    assert torch.equal(live.long(), want)
    keys = TK.launch_keys(key, 42, 8, plan.block.n_sub, False, "cpu")
    runs = []
    for slots in (None, live, live.flip(0)):
        st, tb = state.clone(), torch.zeros(at.n_bins, dtype=torch.float64)
        c = TT.tabulate_iterations_plain(plan, st, sp, keys, tb, slots)
        runs.append((st, tb, c))
    (s_all, t_all, c_all) = runs[0]
    assert float(t_all.sum()) > 0
    for st, tb, c in runs[1:]:
        assert torch.equal(st, s_all)
        assert torch.equal(c, c_all)
        np.testing.assert_allclose(tb.numpy(), t_all.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(t_all.abs().max()))
    off = torch.ones(SLOTS, dtype=torch.bool)
    off[live.long()] = False
    assert torch.equal(s_all[:, off], state[:, off])


def test_kernel_only_counters_are_named(spherical):
    """TAB_COUNTERS names the kernel-only counts (atomics, warp-iterations,
    the comb's lane-slots and each stage's clock cycles) after the shared
    ones, the library's count of integer counters is N_TAB_INT, and the
    plain version and a CPU run report 0 for each."""
    port, plan, tally = spherical
    assert TK.TAB_COUNTERS[:7] == ("entries", "weight", "substeps", "work",
                                   "walk", "alive", "generated")
    assert TK.KERNEL_ONLY == ("atomics", "warps", "comb_slots", "cyc_spawn",
                              "cyc_walk", "cyc_coords", "cyc_weight",
                              "cyc_scatter")
    assert TK.N_TAB_INT == len(TK.TAB_COUNTERS) - 1 == 14
    stp, at = port[2], port[4]
    keys = TK.launch_keys(R.base_key(3), 0, 4, plan.block.n_sub, False,
                          "cpu")
    c = dict(zip(TK.TAB_COUNTERS, TT.tabulate_iterations_plain(
        plan, TT.init_state(stp), K.pack_steps(stp), keys,
        torch.zeros(at.n_bins, dtype=torch.float64)).tolist()))
    assert c["work"] > 0 and c["substeps"] > 0
    for k in TK.KERNEL_ONLY:
        assert c[k] == 0 and tally[k] == 0, k


def test_iteration_cap_cuts_a_prefix(spherical):
    """max_iterations (the batch's 65,536 cap in tabulate) cuts the run
    after exactly that many iterations, the last launch shortened: the table
    equals a run of one launch of that length, and is a prefix of the full
    run's deposits."""
    port, plan, tally = spherical
    stp, at = port[2], port[4]
    key = R.fold_in(R.base_key(3), 0)
    cap = 40
    assert cap < tally["iterations"]
    cut, one = (torch.zeros(at.n_bins, dtype=torch.float64)
                for _ in range(2))
    t_cut = {}
    assert TT._tabulate_batch(plan, stp, key, cut, t_cut, launch_iters=16,
                              max_iterations=cap) == cap
    assert t_cut["syncs"] == 3
    assert TT._tabulate_batch(plan, stp, key, one, launch_iters=cap,
                              max_iterations=cap) == cap
    assert torch.equal(cut, one)
    full = tally["raw"]
    assert 0 < float(cut.sum()) < float(full.sum())
    assert bool((cut <= full + 1e-12).all())
    assert t_cut["substeps"] < tally["substeps"]


def test_counters_match_the_eager_chunk(spherical):
    """The plain version's counters against the eager chunk's buffers on
    the same key: nonzero entries, weight and alive slots equal, the table's
    sum the weight, the photons made the photons spent, and atomics 0 (a
    kernel-only count)."""
    port, plan, tally = spherical
    mt, st, stp, cfgt, at, src = port
    cfg = dataclasses.replace(cfgt, fixed_abs_lens=46.0,
                              stop_on_detection=False)
    min_inv_gv = plan.block.tab.min_inv_gv
    tan_theta_c = plan.block.tab.tan_theta_c
    chunk = TT._make_tabulate_chunk(mt, st, src, TT.dom_angular_sensitivity(
        device="cpu"), cfg, at, 1.0, min_inv_gv, tan_theta_c)
    key = R.fold_in(R.base_key(3), 0)
    s_c, r_c = TT.E._init_state(stp), torch.zeros(SLOTS)
    state = TT.init_state(stp)
    table = torch.zeros(at.n_bins, dtype=torch.float64)
    weight = 0.0
    for c in range(2):
        s_c, r_c, _, w_buf, alive = chunk(stp, key, s_c, r_c, 16 * c)
        keys = TK.launch_keys(key, 16 * c, 16, plan.block.n_sub, False,
                              "cpu")
        cnt = dict(zip(TK.TAB_COUNTERS, TT.tabulate_iterations_plain(
            plan, state, K.pack_steps(stp), keys, table).tolist()))
        assert cnt["entries"] == int((w_buf != 0).sum())
        assert cnt["weight"] == float(w_buf.sum(dtype=torch.float64))
        assert cnt["alive"] == int(alive)
        assert cnt["atomics"] == 0
        weight += cnt["weight"]
    np.testing.assert_allclose(float(table.sum()), weight, rtol=1e-12)
    assert torch.equal(state[K.NSF], r_c)
    spent = float((stp.num_photons.float() - s_c.photons_left).sum())
    raw = tally["raw"]
    np.testing.assert_allclose(float(raw.sum()), tally["weight"], rtol=1e-12)
    assert tally["generated"] == float(stp.num_photons.sum())
    assert spent > 0 and tally["substeps"] >= tally["entries"] > 0
    assert tally["walk"] > 0 and tally["atomics"] == 0


def test_normalization_is_numpy_division(spherical):
    """tabulate's values are the raw table divided by the spatial cells'
    norm (bin volume / (step length * DOM area)), bit for bit numpy's
    float64 division, slab by slab when the slabs are small."""
    port, _, tally = spherical
    at = port[4]
    raw = tally["raw"].numpy().reshape(at.shape)
    norm = np.ones(at.shape[:3])
    norm[1:-1, 1:-1, 1:-1] = at.bin_volumes() / (np.pi * 0.16510 ** 2)
    want = raw / norm[..., None]
    got = TT._normalized(tally["raw"], at.shape, norm)
    np.testing.assert_array_equal(got, want)
    small = TT.NORM_CHUNK_BYTES
    try:
        TT.NORM_CHUNK_BYTES = 8 * raw[0].size * 3   # slabs of 3 rows
        np.testing.assert_array_equal(
            TT._normalized(tally["raw"], at.shape, norm), want)
    finally:
        TT.NORM_CHUNK_BYTES = small


def test_unsupported_inputs_are_named():
    """tab_unsupported names a one-point bias grid, an empty or too long
    angular acceptance and a third axes kind; launch refuses 9 N >= 2**32
    and the plan of a served input carries no reason."""
    _, port = case_inputs("spherical")
    plan = port_plan(port)
    assert plan.block.unsupported is None
    fields = K.medium_fields(port[0], port[1])
    assert "bias grid" in TK.tab_unsupported(dict(fields, n_bias=1), port[4],
                                             11)
    assert "angular" in TK.tab_unsupported(fields, port[4], 0)
    assert "angular" in TK.tab_unsupported(fields, port[4],
                                           TK.TAB_MAX_ANG + 1)

    class Odd:
        kind, impact_angle = "odd", False

    assert "odd" in TK.tab_unsupported(fields, Odd(), 11)
    with pytest.raises(NotImplementedError, match="bias grid"):
        TK.launch(plan.block._replace(unsupported=TK.tab_unsupported(
            dict(fields, n_bias=1), port[4], 11)), TT.init_state(port[2]),
            K.pack_steps(port[2]), TK.launch_keys(
                R.base_key(0), 0, 1, plan.block.n_sub, False, "cpu"),
            torch.zeros(port[4].n_bins, dtype=torch.float64))
