"""The CUDA propagation kernel against its plain PyTorch version on the card
(same tensors, same uniform stream).  Needs a CUDA GPU and skips elsewhere;
the module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("aniso,tilt", [(False, False), (True, True)])
def test_cuda_kernel_matches_plain_version(aniso, tilt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 8192, 16
    medium, geo, spectra, cfg, steps, u = chip_smoke.small_workload(
        n, T, aniso, tilt, dev)
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = K.pack_steps(steps)
    launches = K.MODE_LAUNCHES[0]
    _, h_k, c_k = K.run_fused_iterations(K.init_state(steps), steps_p,
                                         tables, spec, uniforms=u)
    _, h_p, c_p = K.run_fused_iterations_plain(K.init_state(steps), steps_p,
                                               tables, spec, uniforms=u)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[0] == launches + 1
    # tests/test_kernel.py::_compare tolerances
    chip_smoke.compare("cuda test", c_k, h_k, c_p, h_p)


@pytest.mark.cuda
def test_cuda_records_match_plain_version():
    """The record mode (RECORDS instantiation) against its plain version on
    the test_kernel workload with aniso + tilt and save_photons: the
    histogram checks above, one record per hit, and the records matched on
    (slot, dom) within tests/test_kernel.py:523-529's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 8192, 16
    medium, geo, spectra, cfg, steps, u = chip_smoke.small_workload(
        n, T, True, True, dev)
    cfg = dataclasses.replace(cfg, save_photons=True)
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p, state0 = K.pack_steps(steps), K.init_state(steps, True)
    launches = K.MODE_LAUNCHES[K.MODE_RECORDS]
    _, h_k, c_k, r_k = K.run_fused_iterations(state0.clone(), steps_p,
                                              tables, spec, uniforms=u)
    _, h_p, c_p, r_p = K.run_fused_iterations_plain(state0.clone(), steps_p,
                                                    tables, spec, uniforms=u)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[K.MODE_RECORDS] == launches + 1
    chip_smoke.compare("cuda records test", c_k, h_k, c_p, h_p)
    for c, r in ((c_k, r_k), (c_p, r_p)):
        assert r.shape[0] == float(c[K.CNT_HITS]) == float(c[K.CNT_QUEUED])
        assert float(c[K.CNT_DROPPED]) == 0.0
    # every record of the smaller set matches (FMA contraction may move a
    # hit, within compare's hit-count allowance)
    n_ok, n_k, n_p = chip_smoke.match_records("cuda records test", r_k, r_p,
                                              cfg.hist_n_bins)
    assert n_ok == min(n_k, n_p)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(estimator="expected", soft_binning=True,
         expected_angular_poly=(0.3, 0.6)),
    dict(stop_on_detection=False), dict(fixed_abs_lens=8.0)])
def test_cuda_deposit_modes_match_plain_version(change):
    """The B6 deposit modes (expected, non-stopping, fixed horizon) against
    their plain version on a shared stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 8192, 16
    medium, geo, spectra, cfg, steps, u = chip_smoke.small_workload(
        n, T, True, True, dev)
    cfg = dataclasses.replace(cfg, **change)
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = K.pack_steps(steps)
    mode = K.kernel_mode(spec)
    launches = K.MODE_LAUNCHES[mode]
    _, h_k, c_k = K.run_fused_iterations(K.init_state(steps), steps_p,
                                         tables, spec, uniforms=u)
    _, h_p, c_p = K.run_fused_iterations_plain(K.init_state(steps), steps_p,
                                               tables, spec, uniforms=u)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[mode] == launches + 1
    chip_smoke.compare("cuda deposit mode", c_k, h_k, c_p, h_p)


@pytest.mark.cuda
def test_cuda_threefry_matches_stream_and_diff_runs():
    """In-kernel threefry draws the stream rng.make_uniform_stream holds
    (equal counts, histograms equal up to atomic order), and
    propagate_expected_diff gives a finite gradient on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.propagate.diff import propagate_expected_diff
    dev = torch.device("cuda", 0)
    n, T, key = 8192, 16, (0x80000001, 5)
    medium, geo, spectra, cfg, steps, _ = chip_smoke.small_workload(
        n, T, True, True, dev)
    cfg = dataclasses.replace(cfg, estimator="expected", soft_binning=True)
    run_t, _, _ = chip_smoke.kernel_run(medium, geo, spectra, cfg, steps, T,
                                        key=key)
    run_s, _, _ = chip_smoke.kernel_run(
        medium, geo, spectra, cfg, steps, T,
        uniforms=rng.make_uniform_stream(rng.as_key(key, dev), T, n))
    tf_mode = K.DEP_EXPECTED | K.MODE_THREEFRY
    launches = K.MODE_LAUNCHES[tf_mode]
    _, h_t, c_t = run_t()
    _, h_s, c_s = run_s()
    assert K.MODE_LAUNCHES[tf_mode] == launches + 1
    assert float(c_t[K.CNT_GEN]) == float(c_s[K.CNT_GEN])
    assert float(c_t[K.CNT_HITS]) == float(c_s[K.CNT_HITS])
    assert float((h_t - h_s).abs().sum()) <= 1e-5 * float(h_s.sum())
    b = medium.b400.clone().requires_grad_(True)
    h = propagate_expected_diff(steps, medium._replace(b400=b), geo, spectra,
                                key, cfg, n_iterations=T)
    g = torch.autograd.grad(h.sum(), b)[0]
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("glob", [False, True])
@pytest.mark.parametrize("mode", ["stop", "pass", "fixed", "pass,fixed",
                                  "records"])
def test_cuda_threefry_detect_modes_match_stream_and_plain(mode, glob,
                                                           monkeypatch):
    """In-kernel threefry in every detect mode and with records (chip_smoke
    phase 13a's check at 8,192 slots, on the main-path configuration and
    on ic86): the kernel against the same kernel fed
    rng.make_uniform_stream of the key (equal counts, histograms equal up
    to atomic order, equal record counts) and against its plain version
    with the key table (phase 2's tolerances, records matched on (slot,
    dom)); its own instantiation launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    monkeypatch.setattr(chip_smoke, "N_SLOTS", 8192)
    dev = torch.device("cuda", 0)
    key = rng.as_key(chip_smoke.TF_KEY)
    main = chip_smoke.main_path_inputs(dev)
    medium, geo, spectra, cfg, steps, _ = (chip_smoke.on_ic86(main, dev)
                                           if glob else main)
    uni = rng.make_uniform_stream(key.to(dev), chip_smoke.PHASE2_T, 8192)
    cfg = dataclasses.replace(cfg, **chip_smoke.TF_MODES[mode])
    before = K.MODE_LAUNCHES.copy()
    out = chip_smoke.tf_against(chip_smoke.tf_entry(mode, glob),
                                (medium, geo, spectra, cfg, steps, uni), key)
    torch.cuda.synchronize()
    assert out["mode"] & K.MODE_THREEFRY
    # a warm-up and five timed threefry launches
    assert K.MODE_LAUNCHES[out["mode"]] - before[out["mode"]] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("threefry", [False, True])
def test_cuda_hole_ice_polynomial_matches_plain_version(threefry):
    """The expected estimator with the 11-coefficient hole-ice polynomial,
    read from the angular table, on the fit workload at 8,192 slots:
    kernel against plain version (phase 2's tolerances), on a shared
    stream and with threefry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.hits.acceptance import HOLE_ICE_H2_50CM
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 8192, chip_smoke.FIT_T
    medium, geo, spectra, cfg, steps = chip_smoke.fit_workload(dev, n)
    cfg = dataclasses.replace(cfg, expected_angular_poly=tuple(
        float(c) for c in HOLE_ICE_H2_50CM["coefficients"]))
    key = rng.as_key(chip_smoke.FIT_KEY)
    src = (dict(key=key) if threefry else dict(
        uniforms=rng.make_uniform_stream(key.to(dev), T, n)))
    run_k, spec, tables = chip_smoke.kernel_run(medium, geo, spectra, cfg,
                                                steps, T, **src)
    run_p, _, _ = chip_smoke.kernel_run(medium, geo, spectra, cfg, steps, T,
                                        plain=True, **src)
    assert tables.ang.numel() == len(spec.ang_poly) == 11
    mode = K.kernel_mode(spec)
    launches = K.MODE_LAUNCHES[mode]
    _, h_k, c_k = run_k()
    _, h_p, c_p = run_p()
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[mode] == launches + 1
    chip_smoke.compare("cuda hole-ice polynomial", c_k, h_k, c_p, h_p)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["propagate[closed-scat]",
                                   "propagate[expected,closed-scat]"])
def test_cuda_closed_ice_with_tabulated_angle_matches_plain_version(
        entry, monkeypatch):
    """The closed-form ice with the Antares scattering angle (the kernel's
    MED_CLOSED_SCAT; chip_smoke phase 13d's check at 8,192 slots) in detect
    and expected mode against its plain version on a shared stream: phase
    2's tolerances, the tabulated angle's scatter counts within max(2,
    1%)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    monkeypatch.setattr(chip_smoke, "N_SLOTS", 8192)
    dev = torch.device("cuda", 0)
    medium, geo, spectra, cfg, steps, uni = chip_smoke.closed_scat_inputs(dev)
    cfg = dataclasses.replace(cfg, **chip_smoke.CLOSED_SCAT[entry])
    out = chip_smoke.check_instantiation(
        entry, (medium, geo, spectra, cfg, steps, uni), False)
    assert out["mode"] >> K.MED_SHIFT == K.MED_CLOSED_SCAT


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [
    "propagate[global]", "propagate[general]", "propagate[water]",
    "propagate[photonics]", "propagate[records,global]",
    "propagate[records,general]", "propagate[records,water]"])
def test_cuda_b3_b7_instantiations_match_plain_version(entry, monkeypatch):
    """Each instantiation of the global collision plans (B3) and the
    tabulated media (B7) against its plain version on a shared stream
    (chip_smoke phase 7a's workloads at 8,192 slots): phase 2's
    tolerances, records matched on (slot, dom), the bound's counts
    (candidates, cull passes, strings and DOMs tested, water's scatters)
    equal within max(2, 1%), one launch of its own instantiation per
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    monkeypatch.setattr(chip_smoke, "N_SLOTS", 8192)
    dev = torch.device("cuda", 0)
    records = entry.startswith("propagate[records")
    base = "propagate[" + entry[len("propagate[records,"):] if records \
        else entry
    name, inputs = {e: (n, i) for e, n, i in
                    chip_smoke.phase7_cases(dev)}[base]
    before = sum(K.MODE_LAUNCHES.values())
    out = chip_smoke.check_instantiation(name, inputs, records)
    torch.cuda.synchronize()
    # warm-up and five timed runs, all of this instantiation
    assert K.MODE_LAUNCHES[out["mode"]] >= 6
    assert sum(K.MODE_LAUNCHES.values()) - before == 6


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [
    "propagate[flasher]", "propagate[flasher,global]", "propagate[bias]",
    "propagate[flasher,records]", "propagate[flasher,records,global]",
    "propagate[expected,global]", "propagate[expected,general]",
    "propagate[expected,water]", "propagate[pass,global]",
    "propagate[fixed,global]", "propagate[expected,photonics]"])
def test_cuda_flasher_and_global_modes_match_plain_version(entry,
                                                            monkeypatch):
    """Stacked flasher spectra and the non-uniform bias grid (K1·B4), and
    the deposit modes on the global plans and the media (K1·B3/B7 ×
    B6/B8b), against their plain version on a shared stream (chip_smoke
    phase 8a's workloads at 8,192 slots): phase 2's tolerances (L1 <= 4e-3
    on the non-uniform bias), records matched on (slot, dom), the bound's
    counts within max(2, 1%), one launch of its own instantiation per
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    monkeypatch.setattr(chip_smoke, "N_SLOTS", 8192)
    dev = torch.device("cuda", 0)
    name, inputs, records, l1_tol = {
        e: (n, i, r, t)
        for e, n, i, r, t in chip_smoke.phase8_cases(dev)}[entry]
    before = sum(K.MODE_LAUNCHES.values())
    out = chip_smoke.check_instantiation(name, inputs, records, l1_tol)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[out["mode"]] >= 6
    assert sum(K.MODE_LAUNCHES.values()) - before == 6


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fetch", "state", "ops", "deposit"])
def test_cuda_probe_kernel_matches_plain_version(kernel):
    """Each probe kernel (csrc/probes.cu) against its plain version at 8,192
    lanes: bit for bit where the kernel rounds as the plain version does,
    the scan within 2^-20 of its segment's sum; each wrapper counts its
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from clsim_tpu_torch import probes as P
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    L = 8192
    x = torch.rand(L, generator=g, device=dev)
    before = P.LAUNCHES[kernel]
    if kernel == "fetch":
        tab = torch.rand((32, 176), generator=g, device=dev)
        ref = P.probe_fetch_plain("chain", a=x, tab=tab, T=16)
        for mem in ("global", "shared", "const"):
            assert torch.equal(P.probe_fetch("chain", a=x, tab=tab, T=16,
                                             mem=mem), ref)
        n = 3
    elif kernel == "state":
        st = torch.rand((18, L), generator=g, device=dev)
        ref = P.probe_state_plain(st, T=32)
        for space in ("reg", "shared", "local"):
            assert torch.equal(P.probe_state(st, T=32, space=space), ref)
        n = 3
    elif kernel == "ops":
        kw = dict(a=x, T=8, n=25, m=1.0000001, c0=1e-9, wrap=True)
        assert torch.equal(P.probe_ops("muladd", **kw),
                           P.probe_ops_plain("muladd", **kw))
        kw = dict(a=x, b=torch.zeros_like(x), T=8, n=10)
        assert torch.equal(P.probe_ops("div", **kw),
                           P.probe_ops_plain("div", **kw))
        n = 2
    else:
        out = P.probe_deposit("scan", a=x, seg=4096)
        ref = P.probe_deposit_plain("scan", a=x, seg=4096)
        assert float((out - ref).abs().max()) <= 2.0 ** -20 * 4096
        xt = torch.rand((24, L), generator=g, device=dev)
        assert torch.equal(P.probe_deposit("transpose", a=xt),
                           xt.t().contiguous())
        n = 2
    torch.cuda.synchronize()
    assert P.LAUNCHES[kernel] == before + n


@pytest.mark.cuda
def test_cuda_probe_philox_bits():
    """The propagation kernel's Philox4x32-10 (csrc/philox.cuh) in the probe
    kernel against the plain version bit for bit; lane 0's first draw
    (counter 0, key 0) is Random123's known answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from clsim_tpu_torch import probes as P
    z = torch.zeros(4096, dtype=torch.float32, device="cuda")
    out, bits = P.probe_ops("philox", a=z, T=10, key=(0, 0))
    ref_out, ref_bits = P.probe_ops_plain("philox", a=z, T=10, key=(0, 0))
    assert torch.equal(bits, ref_bits)
    assert float((out - ref_out).abs().max()) <= 1e-5
    assert [int(w) for w in bits[:, 0]] == [0x6627e8d5, 0xe169c58d,
                                            0xbc57ac4c, 0x9b00dbd8]


@pytest.mark.cuda
def test_cuda_walk_count_matches_plain_on_main_path(monkeypatch):
    """The kernel's layer-walk steps (CNT_WALK) against its plain version's
    on the main path's configuration (hex61, the seeded 171-layer ice, 90 m
    segments) at 8,192 slots, within max(2, 1%); one warp-iteration a warp
    an iteration while every slot is live, and fewer spawn-path lanes than
    the 32 a spawning warp held before the spawn was compacted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    monkeypatch.setattr(chip_smoke, "N_SLOTS", 8192)
    dev = torch.device("cuda", 0)
    medium, geo, spectra, cfg, steps, u = chip_smoke.main_path_inputs(dev)
    n, T = 8192, chip_smoke.PHASE2_T
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = K.pack_steps(steps)
    _, h_k, c_k = K.run_fused_iterations(K.init_state(steps), steps_p,
                                         tables, spec, uniforms=u)
    _, h_p, c_p = K.run_fused_iterations_plain(K.init_state(steps), steps_p,
                                               tables, spec, uniforms=u)
    torch.cuda.synchronize()
    chip_smoke.compare("cuda walk test", c_k, h_k, c_p, h_p, 1e-5)
    chip_smoke.check_walk("cuda walk test", c_k, c_p)
    assert float(c_k[K.CNT_WARPS]) == n // 32 * T
    st = chip_smoke.k1_stats(c_k)
    assert 1.0 <= st["spawn_lanes"] < 2.0


@pytest.mark.cuda
def test_cuda_record_stall_loses_no_record():
    """A record buffer of 16 a launch under the block-synchronous loop:
    launches stall, the stalled slots sit out their launch and write first
    in the next, and every hit still has its record (the histogram rebuilt
    from the records is the propagated one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    medium, geo, spectra, cfg, steps, _ = chip_smoke.small_workload(
        8192, 16, True, True, dev)
    cfg = dataclasses.replace(cfg, save_photons=True)
    launches = K.MODE_LAUNCHES[K.MODE_RECORDS]
    res, tot = K.propagate_fused(steps, medium, geo, spectra, 5, cfg,
                                 iters_per_call=16, max_calls=256,
                                 rec_capacity=16)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[K.MODE_RECORDS] > launches + 1
    n = int(res.rec_count[0])
    assert float(tot[K.CNT_GEN]) == float(steps.num_photons.sum())
    assert float(tot[K.CNT_ALIVE]) == 0.0
    assert float(tot[K.CNT_STALLED]) >= 5
    assert n == float(tot[K.CNT_HITS]) == float(tot[K.CNT_QUEUED]) > 20
    r = res.rec
    nb = cfg.hist_n_bins
    tb = torch.clamp((r["time"][0] - cfg.hist_t_min) / cfg.hist_dt, 0.0,
                     nb - 1).to(torch.int64)
    rebuilt = torch.zeros(geo.n_doms * nb, dtype=torch.float64,
                          device=dev).index_add_(
        0, r["dom"][0].to(torch.int64) * nb + tb, r["weight"][0].double())
    torch.testing.assert_close(rebuilt, res.hist.reshape(-1).double(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [
    "propagate[expected,global]", "propagate[expected,general]",
    "propagate[expected,water]", "propagate[pass,global]",
    "propagate[fixed,global]", "propagate[expected,photonics]"])
def test_cuda_fixed_horizon_steady_shape_matches_plain(entry, monkeypatch):
    """Each fixed-horizon instantiation against its plain version at the
    steady shape (chip_smoke phase 8a's inputs at 65,536 slots, advanced
    64 iterations, then 32 on the shared stream) with few photons a slot
    and short lives, so that slots drain at different iterations and a
    warp that iterates on its own leaves the loop early: 2-10 photons a
    slot and a horizon of 3 absorption lengths in ice (12 in water, whose
    photons cross a length in fewer iterations), a photon living ~12
    iterations; 6-20 photons in the non-stopping detect mode, whose
    sampled budgets last ~5.  Phase 2's tolerances and the bound's
    counts; every spawn took one photon from its slot (no slot lost); live
    slot-iterations within max(2, 1%) of the plain version's; warp-
    iterations at least the live slot-iterations over 32 and at most one a
    warp an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import numpy as np
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    n, T = 65536, chip_smoke.PHASE2_T
    monkeypatch.setattr(chip_smoke, "N_SLOTS", n)
    dev = torch.device("cuda", 0)
    name, inputs, records, l1_tol = {
        e: (nm, i, r, t)
        for e, nm, i, r, t in chip_smoke.phase8_cases(dev)}[entry]
    medium, geo, spectra, cfg, steps, uni = inputs
    if cfg.estimator == "expected" or cfg.fixed_abs_lens > 0:
        cfg = dataclasses.replace(cfg, fixed_abs_lens=(
            12.0 if entry == "propagate[expected,water]" else 3.0))
    lo, hi = (6, 21) if entry == "propagate[pass,global]" else (2, 11)
    few = torch.as_tensor(np.random.default_rng(13).integers(lo, hi, n),
                          dtype=steps.num_photons.dtype, device=dev)
    inputs = (medium, geo, spectra, cfg, steps._replace(num_photons=few),
              uni)
    state0 = chip_smoke.steady_state(inputs)
    left = K.STATE_FIELDS.index("photons_left")
    left0 = float(state0[left].double().sum())
    out = chip_smoke.check_instantiation(name, inputs, records, l1_tol,
                                         state0=state0)
    medium, geo, spectra, cfg, steps, uni = inputs
    spec, cell_tab = chip_smoke.quiet(K.fused_spec, medium, geo, spectra,
                                      cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    st_k, _, c_k = K.run_fused_iterations(state0.clone(), K.pack_steps(steps),
                                          tables, spec, uniforms=uni)
    st_p, _, c_p = K.run_fused_iterations_plain(
        state0.clone(), K.pack_steps(steps), tables, spec, uniforms=uni)
    torch.cuda.synchronize()
    assert out["hits"] > 20
    assert left0 - float(st_k[left].double().sum()) == float(
        c_k[K.CNT_GEN])
    work_k, work_p = float(c_k[K.CNT_WORK]), float(c_p[K.CNT_WORK])
    assert abs(work_k - work_p) <= max(2.0, 0.01 * work_p)
    assert work_k / 32 <= float(c_k[K.CNT_WARPS]) <= n // 32 * T
    alive_k, alive_p = float(c_k[K.CNT_ALIVE]), float(c_p[K.CNT_ALIVE])
    assert abs(alive_k - alive_p) <= max(2.0, 0.01 * alive_p)
    assert alive_k < n     # slots drained in the run


@pytest.mark.cuda
def test_cuda_rows_match_plain_on_jittered_ic86(monkeypatch):
    """The general plan's DOM rows tested (CNT_ROWS: the z-window's rows)
    kernel against plain on jittered ic86 (chip_smoke phase 7a's general
    case at 8,192 slots) within max(2, 1%), and at most n_win a tested
    string."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    n = 8192
    monkeypatch.setattr(chip_smoke, "N_SLOTS", n)
    dev = torch.device("cuda", 0)
    medium, geo, spectra, cfg, steps, uni = {
        e: i for e, _, i in chip_smoke.phase7_cases(dev)}["propagate[general]"]
    spec, cell_tab = chip_smoke.quiet(K.fused_spec, medium, geo, spectra,
                                      cfg, n, chip_smoke.PHASE2_T)
    assert K.kernel_coll(spec) == K.COLL_GENERAL
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    state0, steps_p = K.init_state(steps), K.pack_steps(steps)
    _, _, c_k = K.run_fused_iterations(state0.clone(), steps_p, tables, spec,
                                       uniforms=uni)
    _, _, c_p = K.run_fused_iterations_plain(state0.clone(), steps_p, tables,
                                             spec, uniforms=uni)
    torch.cuda.synchronize()
    rows_k, rows_p = float(c_k[K.CNT_ROWS]), float(c_p[K.CNT_ROWS])
    assert rows_p > 0
    assert abs(rows_k - rows_p) <= max(2.0, 0.01 * rows_p)
    assert rows_k <= spec.n_win * float(c_k[K.CNT_TESTED])


@pytest.mark.cuda
def test_cuda_config1_golden_from_particles():
    """chip_smoke phase 10(a) on config1: the particles through the native
    sampler and the kernel (Philox): the golden's exact n_generated, hits,
    time groups and hottest DOMs within 5 sigma of the golden, the
    weighted counts' variance from the record mode's hit weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from clsim_tpu_torch import native
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.util import golden as G
    assert native.available(), native.error()
    launches = K.MODE_LAUNCHES[0]
    res = G.run_config("config1_cascade", "cuda")
    golden = G.load_golden("config1_cascade")
    assert K.MODE_LAUNCHES[0] > launches
    assert float(res["n_generated"]) == float(golden["n_generated"])
    w = G.run_config("config1_cascade", "cuda",
                     save_photons=True)["hit_weights"]
    G.statistical_compare("config1_cascade", float(res["n_hits"]),
                          float(res["weight_hits"]), res["hist"],
                          float(golden["n_hits"]),
                          float(golden["weight_hits"]), golden["hist"],
                          weight_factor=float((w * w).sum() / w.sum()))


@pytest.mark.cuda
def test_cuda_dispatch_sends_rings_to_the_engine():
    """propagate_auto on the card: a scatter-history ring configuration runs
    the engine there (no kernel launch, rings in the records), H > 0
    without save_photons (no rings) launches the kernel, an angular
    polynomial past the parameter block's old limit of 8 coefficients
    launches the kernel (it reads them from a device table), and records
    with another deposit mode, which the kernel refuses, still raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import chip_smoke
    from clsim_tpu_torch.propagate import dispatch as D
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    medium, geo, spectra, cfg, steps, _ = chip_smoke.small_workload(
        8192, 1, False, False, dev)
    rings = dataclasses.replace(cfg, save_photons=True,
                                photon_history_entries=4)
    before = sum(K.MODE_LAUNCHES.values())
    res = D.propagate_auto(steps, medium, geo, spectra, 3, rings)
    torch.cuda.synchronize()
    assert sum(K.MODE_LAUNCHES.values()) == before
    assert res.diag_totals is None and res.hist.device == dev
    assert res.rec["hist_abs"].device == dev
    assert res.rec["hist_abs"].shape == (8192, cfg.photon_capacity_per_slot,
                                         4)
    assert float(res.n_generated) == float(steps.num_photons.sum())
    assert int(res.rec_count.sum()) == float(res.n_hits) > 0
    with pytest.raises(NotImplementedError, match="history"):
        D.propagate_auto(steps, medium, geo, spectra, 3, rings,
                         backend="fused")
    # without save_photons there are no rings: the kernel serves the run
    no_rec = dataclasses.replace(cfg, photon_history_entries=4)
    before = sum(K.MODE_LAUNCHES.values())
    res = D.propagate_auto(steps, medium, geo, spectra, 3, no_rec)
    torch.cuda.synchronize()
    assert sum(K.MODE_LAUNCHES.values()) > before
    assert res.diag_totals is not None
    assert float(res.n_generated) == float(steps.num_photons.sum())
    nine = dataclasses.replace(cfg, estimator="expected",
                               expected_angular_poly=(0.1,) * 9)
    before = K.MODE_LAUNCHES[K.DEP_EXPECTED]
    res = D.propagate_auto(steps, medium, geo, spectra, 3, nine)
    torch.cuda.synchronize()
    assert K.MODE_LAUNCHES[K.DEP_EXPECTED] > before
    assert float(res.n_generated) == float(steps.num_photons.sum())
    assert float(res.weight_hits) > 0.0
    with pytest.raises((ValueError, NotImplementedError)):
        D.propagate_auto(steps, medium, geo, spectra, 3, dataclasses.replace(
            cfg, save_photons=True, stop_on_detection=False))


@pytest.mark.cuda
def test_cuda_tabulate_matches_cpu():
    """chip_smoke phase 11(c) at a small size: a table on the card (float64,
    filled by the kernel of csrc/tabulate.cu) against the port on the CPU
    (its plain version), same seed:
    the deposited table's L1 <= 2e-3 of its total, n_photons equal, every
    comb weight landed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import numpy as np
    import chip_smoke
    axes = chip_smoke.tab_small_axes()["spherical"]
    tables = []
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        tally = {}
        table = chip_smoke.tab_call(chip_smoke.tab_inputs(dev),
                                    chip_smoke.tab_steps(256, 2, dev), 11,
                                    axes, tally)
        chip_smoke.check_table(f"tabulate on {dev.type}", table, tally, dev)
        tables.append((table.n_photons, tally["raw"].cpu().numpy()))
    (n_gpu, gpu), (n_cpu, cpu) = tables
    assert n_gpu == n_cpu == 512
    l1 = np.abs(gpu - cpu).sum() / np.abs(cpu).sum()
    assert l1 <= 2e-3, l1


@pytest.mark.cuda
def test_cuda_tabulate_runs_the_kernel(monkeypatch):
    """tabulate on a CUDA medium launches the kernel of csrc/tabulate.cu, one
    launch per TAB_LAUNCH_ITERS iterations and, in the tail, per
    TAB_TAIL_ITERS, and never runs the plain version; one launch's counters against the plain version's on the card
    (same state, steps and keys): photons made and alive slots equal,
    nonzero sub-steps and walk steps within 1%, the table's sum the weight
    sum, one atomic a nonzero sub-step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    dev = torch.device("cuda", 0)
    axes = chip_smoke.tab_small_axes()["spherical + impact"]
    inputs = chip_smoke.tab_inputs(dev)
    steps = chip_smoke.tab_steps(2048, 2, dev)
    plain = TT.tabulate_iterations_plain
    monkeypatch.setattr(TT, "tabulate_iterations_plain", None)
    before = TK.LAUNCHES["tabulate"]
    tally = {}
    chip_smoke.tab_call(inputs, steps, 5, axes, tally)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["tabulate"] - before == tally["syncs"] > 0
    # launches of TAB_LAUNCH_ITERS, then of TAB_TAIL_ITERS once at most
    # half the slots live
    n_long = (tally["iterations"] - tally["syncs"] * TK.TAB_TAIL_ITERS) // (
        TK.TAB_LAUNCH_ITERS - TK.TAB_TAIL_ITERS)
    assert 1 <= n_long <= tally["syncs"]
    assert tally["iterations"] == n_long * TK.TAB_LAUNCH_ITERS + (
        tally["syncs"] - n_long) * TK.TAB_TAIL_ITERS
    assert tally["warps"] > 0 and tally["comb_slots"] > 0
    assert tally["atomics"] == tally["entries"]   # one a nonzero sub-step
    assert abs(float(tally["raw"].sum()) - tally["weight"]) \
        <= 1e-9 * tally["weight"]
    monkeypatch.setattr(TT, "tabulate_iterations_plain", plain)

    medium, spectra, source = inputs
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                chip_smoke.tab_cfg(steps), 1.0, 46.0)
    keys = TK.launch_keys(rng.fold_in(rng.base_key(5), 0), 0, 64,
                          plan.block.n_sub, True, dev)
    sp = K.pack_steps(steps)
    out = []
    for fn in (TK.launch, None):
        table = torch.zeros(axes.n_bins, dtype=torch.float64, device=dev)
        state = TT.init_state(steps)
        c = (fn(plan.block, state, sp, keys, table) if fn else
             plain(plan, state, sp, keys, table))
        out.append((dict(zip(TK.TAB_COUNTERS, c.tolist())), table))
    (ck, tk), (cp, tp) = out
    assert ck["generated"] == cp["generated"] and ck["alive"] == cp["alive"]
    for k in ("entries", "walk", "substeps", "work"):
        assert abs(ck[k] - cp[k]) <= 0.01 * cp[k], (k, ck[k], cp[k])
    assert abs(float(tk.sum()) - ck["weight"]) <= 1e-9 * ck["weight"]
    l1 = float((tk - tp).abs().sum() / tp.abs().sum())
    assert l1 <= 2e-3, l1


@pytest.mark.cuda
def test_cuda_tabulate_compacted_matches_plain():
    """The kernel on a compacted slot list (live_slots after a first launch,
    and the same list reversed) against the plain version on the card on
    the same list, state, steps and keys: photons made and alive slots
    equal, nonzero sub-steps, sub-steps, live slot-iterations and walk
    steps within max(2, 1%), table L1 <= 2e-3, the table's sum the weight
    sum, and the slots off the list unchanged bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.tabulator import kernel as TK
    from clsim_tpu_torch.tabulator import table as TT
    dev = torch.device("cuda", 0)
    axes = chip_smoke.tab_small_axes()["spherical"]
    medium, spectra, source = chip_smoke.tab_inputs(dev)
    steps = chip_smoke.tab_steps(4096, 2, dev)
    plan, _, _ = TT._table_plan(medium, spectra, source, axes, None,
                                chip_smoke.tab_cfg(steps), 1.0, 46.0)
    key = rng.fold_in(rng.base_key(7), 0)
    sp = K.pack_steps(steps)
    state = TT.init_state(steps)
    table = torch.zeros(axes.n_bins, dtype=torch.float64, device=dev)
    keys = TK.launch_keys(key, 0, 96, plan.block.n_sub, False, dev)
    c = dict(zip(TK.TAB_COUNTERS, TK.launch(plan.block, state, sp, keys,
                                            table).tolist()))
    assert 0 < c["alive"] < 4096
    live = TT.live_slots(state, int(c["alive"]))
    off = torch.ones(4096, dtype=torch.bool, device=dev)
    off[live.long()] = False
    keys = TK.launch_keys(key, 96, 64, plan.block.n_sub, False, dev)
    for slots in (live, live.flip(0).contiguous()):
        out = []
        for fn in (lambda *a: TK.launch(plan.block, *a),
                   lambda *a: TT.tabulate_iterations_plain(plan, *a)):
            st = state.clone()
            tb = torch.zeros_like(table)
            c = dict(zip(TK.TAB_COUNTERS, fn(st, sp, keys, tb,
                                             slots).tolist()))
            assert torch.equal(st[:, off], state[:, off])
            out.append((c, tb))
        (ck, tk), (cp, tp) = out
        assert ck["generated"] == cp["generated"]
        assert ck["alive"] == cp["alive"]
        for k in ("entries", "substeps", "work", "walk"):
            assert abs(ck[k] - cp[k]) <= max(2.0, 0.01 * cp[k]), k
        assert abs(float(tk.sum()) - ck["weight"]) <= 1e-9 * ck["weight"]
        assert float((tk - tp).abs().sum() / tp.abs().sum()) <= 2e-3


@pytest.mark.cuda
def test_cuda_prefix_launch_leaves_the_rest_untouched():
    """A launch over the first n_active slots (the live prefix a repack
    leaves) keeps every slot past it bit for bit and agrees with its
    plain version over the same prefix (chip_smoke.prefix_launch_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n = 16384
    inputs = chip_smoke.uneven_inputs(dev, n=n, T=32)
    launches = K.MODE_LAUNCHES[0]
    c_k, _ = chip_smoke.prefix_launch_check(inputs, n // 2 + K.BLOCK)
    assert K.MODE_LAUNCHES[0] == launches + 2
    assert float(c_k[K.CNT_WORK]) <= (n // 2 + K.BLOCK) * 32


@pytest.mark.cuda
@pytest.mark.parametrize("balance", [False, True])
def test_cuda_repack_kernel_matches_plain(balance):
    """The call loop with repack (and balance) on a replayed stream: every
    launch against its plain version from the same state and n_active,
    the path's conservation gates (chip_smoke.repack_against_plain), and
    a launch over a prefix among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    dev = torch.device("cuda", 0)
    n = 16384
    inputs = chip_smoke.uneven_inputs(dev, n=n, T=64)
    launches, res, _ = chip_smoke.repack_against_plain(
        f"cuda test, balance {balance}", inputs, repack=True,
        balance=balance)
    assert len(launches) > 1
    assert any(a < n for a, _ in launches)
    assert launches[-1][1] == 0.0


@pytest.mark.cuda
def test_cuda_second_call_launches_on_the_kept_tables(monkeypatch):
    """propagate_fused plans a (medium, geometry) once (kernel.plan_call):
    a second call with the same inputs launches on the same device tables
    and reads no planning value back from the card (no medium_scalars,
    to_numpy or tables_h2d wait)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    from clsim_tpu_torch.util import profiling as P
    dev = torch.device("cuda", 0)
    n, T = 8192, 16
    medium, geo, spectra, cfg, steps, _ = chip_smoke.small_workload(
        n, T, True, True, dev)
    kept, plan_call = [], K.plan_call
    monkeypatch.setattr(K, "plan_call", lambda *a, **k: kept.append(
        plan_call(*a, **k)) or kept[-1])
    K.clear_plans()
    calls = []
    for _ in range(2):
        with P.recording() as rec:
            K.propagate_fused(steps, medium, geo, spectra, 5, cfg,
                              iters_per_call=T)
            torch.cuda.synchronize()
        calls.append((rec.total("plan_build"), rec.total("plan_reuse"),
                      {s["site"] for s in rec.spans("wait")}))
    K.clear_plans()
    (_, first), (_, second) = kept
    for name in ("cells", "doms", "rel", "strings", "ang", "layers",
                 "spec_tab", "bias_tab", "tilt_zc", "wtab", "scat"):
        a, b = getattr(first, name), getattr(second, name)
        assert a.is_cuda and a.data_ptr() == b.data_ptr(), name
    assert first.scalars == second.scalars
    planning = {"medium_scalars", "to_numpy", "tables_h2d"}
    assert calls[0][:2] == (1, 0) and planning <= calls[0][2]
    assert calls[1][:2] == (0, 1) and not planning & calls[1][2]
    assert {"check", "alive"} <= calls[1][2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cascade", "flash", "expected,threefry",
                                  "records"])
def test_cuda_card_cull_lists_match_coarse_lists_and_plain(case):
    """K1 on the benchmark's IC86 stand-in (ic86-production's world; the
    first 16,384 slots of an event's first slot batch, 64 iterations) with
    the card's cull table (kernel.card_cull_table) against the same kernel
    with the JAX package's coarse lists (the table's fallback, budget 0):
    the stream instantiation on a 40 TeV cascade and on a flash, the fit
    forward's (expected, threefry) and the record mode.  Equal counts of
    generated photons, hits, strings tested, cull passes, DOM rows and
    walk steps; histograms equal up to the atomics' order (L1 <= 1e-5);
    records equal record for record; the candidates loaded at most a fifth
    of the coarse lists'.  And against its plain version, which reads the
    same table (phase 2's tolerances, generated counts within 1e-4): every
    count of TALLIES, the candidates included, within phase 2's
    max(2, 1%)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import dataclasses
    import importlib
    import json
    from pathlib import Path
    import numpy as np
    import chip_smoke
    from benchmark.world import PROGRAM, program_world
    from clsim_tpu_torch.convert import steps_from_numpy
    from clsim_tpu_torch.ops import rng
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 16384, 64
    bench = Path(__file__).resolve().parent.parent / "benchmark"
    conf = json.loads((bench / "configs" / "ic86-production.json").read_text())
    world = chip_smoke.quiet(program_world, conf, dev)
    traffic = "flashes" if case == "flash" else "cascades-40tev"
    tr = json.loads((bench / "traffic" / (traffic + ".json")).read_text())
    src = importlib.import_module(f"benchmark.sources.{tr['source']}")
    desc = src.pool(tr, conf)[0]
    if case != "flash":
        # the pool's cascade 7 m from string 0's axis, so that it lights
        # DOMs within the test's iterations
        x0, y0 = (float(v[0]) for v in (world.geometry.string_x,
                                         world.geometry.string_y))
        desc = dict(desc, pos=[x0 + 6.0, y0 + 4.0, 0.0])
    event = src.sources(PROGRAM, world, desc)
    batch = world.sim.steps_from_particles(event, np.random.default_rng(22))
    steps = steps_from_numpy({k: v[:n] for k, v in batch[0]._asdict().items()},
                             dev)
    cfg = world.config
    key = keys = uni = None
    if case == "expected,threefry":
        cfg = dataclasses.replace(cfg, estimator="expected", soft_binning=True,
                                  fixed_abs_lens=8.0)
        key = rng.as_key(chip_smoke.FIT_KEY)
        keys = rng.key_table(key, T).to(dev)
    else:
        uni = torch.as_tensor(np.random.default_rng(7).random(
            (T, 8, n)).astype(np.float32), device=dev)
    records = case == "records"
    cfg = dataclasses.replace(cfg, save_photons=records)
    spec, cell_tab = chip_smoke.quiet(K.fused_spec, world.medium,
                                      world.geometry, world.spectra, cfg, n, T,
                                      threefry=key is not None)
    assert K.kernel_coll(spec) == K.COLL_AFFINE
    tables = K.build_tables(spec, world.medium, world.geometry, world.spectra,
                            cell_tab)
    assert tables.scalars["c_sectors"] > 1
    rows, sc = K.card_cull_table(spec, cell_tab, None, budget=0)
    coarse = tables._replace(cells=torch.as_tensor(rows, device=dev),
                             scalars={**tables.scalars, **sc})
    state0, steps_p = K.init_state(steps, records), K.pack_steps(steps)
    run = lambda fn, t: fn(state0.clone(), steps_p, t, spec, uniforms=uni,
                           keys=keys)
    (_, h_a, c_a, *r_a) = run(K.run_fused_iterations, tables)
    (_, h_b, c_b, *r_b) = run(K.run_fused_iterations, coarse)
    (_, h_p, c_p, *_) = run(K.run_fused_iterations_plain, tables)
    torch.cuda.synchronize()
    for k in ("CNT_GEN", "CNT_HITS", "CNT_TESTED", "CNT_CULL", "CNT_ROWS",
              "CNT_WALK", "CNT_ALIVE"):
        assert float(c_a[getattr(K, k)]) == float(c_b[getattr(K, k)]), k
    assert float(c_a[K.CNT_HITS]) > 20 and float(c_a[K.CNT_TESTED]) > 0
    hb = h_b.double()
    l1 = float((h_a.double() - hb).abs().sum() / hb.abs().sum())
    assert l1 <= 1e-5
    if records:
        def rows_sorted(r):
            r = r.double().cpu().numpy()
            return r[np.lexsort(r.T[::-1])]
        assert r_a[0].shape[0] == float(c_a[K.CNT_HITS])
        np.testing.assert_array_equal(rows_sorted(r_a[0]),
                                      rows_sorted(r_b[0]))
    assert float(c_a[K.CNT_CAND]) <= float(c_b[K.CNT_CAND]) / 5
    # generated within 1e-4: the kernel contracts FMAs, so a photon of
    # ~40,000 may end a step earlier or later than in the plain version
    chip_smoke.compare(f"card cull lists, {case}", c_a, h_a, c_p, h_p,
                       gen_rtol=1e-4)
    for i, t in enumerate(K.TALLIES):
        a, b = float(c_a[K.CNT_TESTED + i]), float(c_p[K.CNT_TESTED + i])
        assert abs(a - b) <= max(2.0, 0.01 * b), (t, a, b)
