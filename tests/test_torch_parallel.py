"""clsim_tpu_torch.parallel's sharded half against clsim_tpu.parallel: two
gloo ranks on the CPU (subprocesses of tests/torch_dist_worker.py, which
imports no JAX) against the JAX package on a 2-device mesh of the 8 virtual
CPU devices that tests/conftest.py forces.

  * the engine body against JAX make_sharded_propagate, the same key
    (tests/test_parallel.py::test_sharded_propagate_conserves_counts'
    workload): equal generated counts and hits, the histogram within the
    key-mode engine parity's tolerances (L1 <= 2e-3, hit weight rel 1e-4);
  * with_uniforms against the unsharded JAX engine on tests/test_kernel.py's
    workload (the tolerances of test_sharded_fused_matches_engine_shared_
    stream: equal generated counts, hits within max(2, 1%), L1 <= 2e-3);
  * each rank feeding its process_step_slice against one process summing
    the two slices with each rank's key or seed (rtol 1e-5; the analogue of
    test_bootstrap_two_process_psum), engine and kernel bodies;
  * Simulation(mesh=).run_steps against the JAX Simulation(mesh=) on the
    same slot batches (the key-mode tolerances);
  * the fit: the 2-rank IceFit's loss equals the JAX 2-device IceFit's
    (rel 1e-5) and its update equals -lr * (g_0 + g_1), each rank's
    gradient computed in one process (rtol 1e-3), where the JAX step is
    -lr * 2 * g_0 (ROADMAP C4);
  * bootstrap without a launcher, and records refused on a mesh (C2).
The workers start once for the module and run while the JAX side compiles
in threads.
"""

import concurrent.futures
import dataclasses
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_diff as TD
import test_kernel as TK
from test_engine import _beam_steps, _one_dom_geometry, _spectra
from test_torch_engine import compare, port_inputs

from clsim_tpu.api import Simulation as SimJ
from clsim_tpu.geometry import single_string_geometry as string_j
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.parallel import mesh as MJ
from clsim_tpu.propagate import engine as EJ
from clsim_tpu.sources import Particle as PartJ, ParticleType as PTJ
from clsim_tpu.types import PropagationConfig as CfgJ
from clsim_tpu.types import StepBatch as StepsJ

from clsim_tpu_torch.api import Simulation as SimT
from clsim_tpu_torch.geometry import single_string_geometry as string_t
from clsim_tpu_torch.medium.properties import make_homogeneous_ice as ice_t
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.parallel import bootstrap as B
from clsim_tpu_torch.parallel import mesh as M
from clsim_tpu_torch.propagate import engine as ET
from clsim_tpu_torch.sources import Particle as PartT, ParticleType as PTT
from clsim_tpu_torch.propagate.dispatch import ITERS_PER_CALL
from clsim_tpu_torch.propagate.kernel import propagate_fused
from clsim_tpu_torch.types import PropagationConfig as CfgT
from clsim_tpu_torch.types import StepBatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_SIZE",
                 "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
KEY_A = (0, 17)
KEY_C = (0, 55)
FIT_KEY = (0, 9)
FIT_LR = 1e-4
A0 = np.full(4, 0.012, np.float32)
SIM_SEED = 5
SIM_GEV = 100.0
NO_U = np.zeros((1, 8, 1), np.float32)


def jax_mesh():
    return MJ.make_mesh(jax.devices()[:2])


def slot_slice(steps, r, per):
    return StepBatch(*[f[r * per:(r + 1) * per] for f in steps])


# -- the inputs of every job, JAX objects and their port conversions -------

@functools.cache
def engine_case():
    medium = ice_j(b400=1e-9, a_dust400=0.02)
    geo = _one_dom_geometry(x=40.0, oversize=5.0)
    cfg = CfgJ(n_slots=64)                      # slots a rank
    steps = _beam_steps(64 * 2, 16)
    return (medium, geo, _spectra(), cfg, steps), \
        port_inputs(medium, geo, _spectra(), cfg, steps, NO_U)[:5]


@functools.cache
def slice_case():
    """tests/dist_worker.py's beam workload, 64 slots a rank of 16
    photons each."""
    medium = ice_j(b400=0.05, a_dust400=0.01)
    geo = string_j(n_doms=8, spacing=17.0, x=10.0, z_top=60.0, oversize=16.0)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)])
    n = 128
    r = np.random.default_rng(77)
    phi = r.uniform(0, 2 * np.pi, n)
    dz = r.uniform(-0.3, 0.3, n)
    dxy = np.sqrt(1.0 - dz ** 2)
    f32 = lambda a: np.asarray(a, np.float32)
    steps = StepsJ(
        x=f32(np.zeros(n)), y=f32(np.zeros(n)), z=f32(np.full(n, -20.0)),
        t=f32(np.zeros(n)), dir_x=f32(dxy * np.cos(phi)),
        dir_y=f32(dxy * np.sin(phi)), dir_z=f32(dz), length=f32(np.ones(n)),
        beta=f32(np.ones(n)), num_photons=np.full(n, 16, np.int32),
        weight=f32(np.ones(n)), identifier=np.zeros(n, np.int32),
        source_type=np.zeros(n, np.int32))
    return port_inputs(medium, geo, spectra, CfgJ(n_slots=64), steps, NO_U)


@functools.cache
def sim_case():
    """A 100 GeV cascade towards a 24-DOM string (~18,000 photons after the
    acceptance bias); JAX slot batches of 2 x 256 slots from the numpy step
    sampler."""
    geo = dict(n_doms=24, spacing=17.0, x=20.0, z_top=200.0, oversize=5.0)
    ice = dict(b400=0.04, a_dust400=0.006)
    sim_j = SimJ(medium=ice_j(**ice), geometry=string_j(**geo),
                 config=CfgJ(n_slots=256), mesh=jax_mesh())
    sim_j.step_generator._native = None
    particle = PartJ.cascade(PTJ.EMinus, pos=(0.0, 0.0, 0.0), time=0.0,
                             energy=SIM_GEV, zenith=np.pi / 2, azimuth=np.pi)
    batches = sim_j.steps_from_particles([particle],
                                         np.random.default_rng(SIM_SEED))
    port = dict(medium=ice_t(device="cpu", **ice),
                geo=string_t(device="cpu", **geo), cfg=CfgT(n_slots=256))
    return sim_j, batches, port


@functools.cache
def fit_case():
    medium, geo, spectra, cfg, steps = TD._setup()
    st, m, g, sp, c, _ = port_inputs(medium, geo, spectra, cfg, steps, NO_U)
    with torch.no_grad():
        target = ET.propagate(st, m, g, sp, 0, c, max_iterations=TD.T,
                              key=rng.fold_in(rng.as_key(FIT_KEY), 0)).hist
    return (medium, geo, spectra, cfg, steps), (st, m, g, sp, c, target)


def jobs():
    out = {}
    _, (st, m, g, sp, c) = engine_case()
    out["engine"] = dict(kind="propagate", steps=st, medium=m, geo=g,
                         spectra=sp, cfg=c, key=KEY_A, backend="auto")
    medium, geo, spectra, cfg, steps, u = TK._workload()
    st, m, g, sp, c, ut = port_inputs(medium, geo, spectra, cfg, steps, u)
    out["uniforms"] = dict(kind="propagate", steps=st, medium=m, geo=g,
                           spectra=sp, key=(0, 1), backend="fused",
                           cfg=dataclasses.replace(c, n_slots=TK.N // 2),
                           uniforms=ut, opts=dict(iters_per_call=TK.T))
    st, m, g, sp, c, _ = slice_case()
    for backend in ("engine", "fused"):
        out[f"slice_{backend}"] = dict(
            kind="propagate", steps=st, medium=m, geo=g, spectra=sp, cfg=c,
            key=KEY_C, backend=backend, feed="process_step_slice")
    _, batches, port = sim_case()
    out["run_steps"] = dict(kind="run_steps", seed=SIM_SEED, **port,
                            batches=[StepBatch(*[np.asarray(f) for f in b])
                                     for b in batches])
    _, (st, m, g, sp, c, target) = fit_case()
    for forward in ("engine", "fused"):
        out[f"fit_{forward}"] = dict(
            kind="fit", steps=st, medium=m, geo=g, spectra=sp, cfg=c,
            key=FIT_KEY, target=target, params={"a_dust400": A0},
            fit=dict(max_iterations=TD.T, learning_rate=FIT_LR,
                     forward=forward))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks; returns result(name) -> (rank 0's, rank 1's)
    outputs, waiting for the workers at the first call.  The tests that
    use it compute their JAX side first, the slowest first, while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("ranks")
    torch.save(jobs(), tmp / "jobs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), "2", str(tmp / "jobs.pt"),
         str(tmp)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in (0, 1)]
    state = {}

    def result(name):
        if not state:
            for p in procs:
                out = p.communicate(timeout=600)[0].decode()
                assert p.returncode == 0, out[-4000:]
            state["done"] = True
        return [dict(np.load(tmp / f"{name}.rank{r}.npz")) for r in (0, 1)]

    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def jax_fit():
    (medium, geo, spectra, cfg, steps), port = fit_case()
    mesh = jax_mesh()
    fit = MJ.IceFit(mesh, cfg, geo, spectra, max_iterations=TD.T,
                    learning_rate=FIT_LR)
    params, loss = fit.step({"a_dust400": jnp.asarray(A0)}, medium,
                            MJ.shard_steps(steps, mesh),
                            jnp.asarray(FIT_KEY, jnp.uint32),
                            jnp.asarray(port[5].numpy()))
    return np.asarray(params["a_dust400"]), float(loss)


def jax_run_steps():
    sim_j, batches, _ = sim_case()
    assert sim_j._propagate.backend == "engine"
    return sim_j.run_steps(batches, SIM_SEED)


def jax_engine():
    (medium, geo, spectra, cfg, steps), _ = engine_case()
    mesh = jax_mesh()
    run = MJ.make_sharded_propagate(mesh, cfg)
    return run(MJ.shard_steps(steps, mesh), medium, geo, spectra,
               jnp.asarray(KEY_A, jnp.uint32))


def jax_uniforms():
    medium, geo, spectra, cfg, steps, u = TK._workload()
    return EJ.propagate(steps, medium, geo, spectra,
                        jnp.asarray((0, 1), jnp.uint32), cfg,
                        uniforms=jnp.asarray(u))


@pytest.fixture(scope="module")
def jax_side(ranks):
    """The JAX package's results, computed in threads (XLA compiles with
    the interpreter lock released) while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        yield {f.__name__: pool.submit(f) for f in (
            jax_fit, jax_run_steps, jax_engine, jax_uniforms)}


def same_on_both_ranks(r0, r1):
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    return r0


def one_process_gradients(port, forward):
    """Each rank's dL/dH . dh_r/dp computed in one process, H = h_0 + h_1."""
    st, m, g, sp, c, target = port
    fit = M.IceFit(c, g, sp, max_iterations=TD.T, forward=forward)
    leaf = torch.tensor(A0, requires_grad=True)
    med = m._replace(a_dust400=leaf)
    hs = [fit.one_forward(med, slot_slice(st, r, TD.N // 2),
                          rng.fold_in(rng.as_key(FIT_KEY), r))
          for r in (0, 1)]
    total = hs[0].detach() + hs[1].detach()
    chi2 = lambda h: ((h - target) ** 2).sum() / torch.clamp(target.sum(),
                                                              min=1.0)
    grads = [torch.autograd.grad(chi2(total + h - h.detach()), leaf)[0]
             .numpy() for h in hs]
    return float(chi2(total)), grads


def test_ice_fit_two_ranks_take_the_true_gradient_jax_twice_shard_0(
        ranks, jax_side):
    """C4: the JAX IceFit's step on 2 devices is -lr * 2 * g_0; the port's
    is -lr * (g_0 + g_1), with the same loss."""
    loss, (g0, g1) = one_process_gradients(fit_case()[1], "engine")
    pj, lj = jax_side["jax_fit"].result()
    res = same_on_both_ranks(*ranks("fit_engine"))
    assert res["loss"] == pytest.approx(lj, rel=1e-5)
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    step_t, step_j = res["param_a_dust400"] - A0, pj - A0
    np.testing.assert_allclose(step_t, -FIT_LR * (g0 + g1), rtol=1e-3,
                               atol=1e-12)
    np.testing.assert_allclose(step_j, -FIT_LR * 2.0 * g0, rtol=1e-3,
                               atol=1e-12)
    # the two rules differ on this workload
    assert np.abs(g1 - g0).max() > 0.1 * np.abs(g0 + g1).max() > 0.0


def test_simulation_mesh_run_steps_matches_jax(ranks, jax_side):
    _, batches, port = sim_case()
    res_j = jax_side["jax_run_steps"].result()
    res = same_on_both_ranks(*ranks("run_steps"))
    assert str(res["backend"]) == "engine"
    compare(res_j.n_generated, res_j.n_hits, res_j.hist, res["n_generated"],
            res["n_hits"], res["hist"])
    assert res["n_hits"] == float(res_j.n_hits)
    # the port's mesh assigns n_slots x ranks slots a batch, as JAX does
    sim_t = SimT(medium=port["medium"], geometry=port["geo"],
                 config=port["cfg"], use_native=False,
                 mesh=M.PhotonMesh(group=None, rank=0, size=2,
                                   device=torch.device("cpu"), active=False))
    b_t = sim_t.steps_from_particles(
        [PartT.cascade(PTT.EMinus, pos=(0.0, 0.0, 0.0), time=0.0,
                       energy=SIM_GEV, zenith=np.pi / 2, azimuth=np.pi)],
        np.random.default_rng(SIM_SEED))
    assert [b.n_steps for b in b_t] == [int(b.x.shape[0]) for b in batches] \
        == [512] * len(batches)


def test_engine_body_matches_jax_sharded_propagate(ranks, jax_side):
    res_j = jax_side["jax_engine"].result()
    res = same_on_both_ranks(*ranks("engine"))
    assert str(res["backend"]) == "engine" and "cpu" in str(res["reason"])
    assert float(res_j.n_generated) == res["n_generated"] == 64 * 2 * 16
    assert res["n_hits"] == float(res_j.n_hits)
    compare(res_j.n_generated, res_j.n_hits, res_j.hist, res["n_generated"],
            res["n_hits"], res["hist"])
    np.testing.assert_allclose(res["weight_hits"], float(res_j.weight_hits),
                               rtol=1e-4)
    assert int(res["n_iterations"]) == int(res_j.n_iterations)


def test_with_uniforms_matches_unsharded_jax_engine(ranks, jax_side):
    acc_e = jax_side["jax_uniforms"].result()
    res = same_on_both_ranks(*ranks("uniforms"))
    assert str(res["backend"]) == "fused"
    compare(acc_e.n_generated, acc_e.n_hits, acc_e.hist, res["n_generated"],
            res["n_hits"], res["hist"])
    assert res["diag_totals"][3] == 0.0          # CNT_DROPPED
    assert int(res["n_iterations"]) == TK.T


@pytest.mark.parametrize("backend", ["engine", "fused"])
def test_process_step_slices_sum_to_one_process(ranks, backend):
    st, m, g, sp, c, _ = slice_case()
    hist, gen, hits = 0.0, 0.0, 0.0
    for r in (0, 1):
        local = slot_slice(st, r, c.n_slots)
        if backend == "engine":
            res = ET.propagate(local, m, g, sp, 0, c,
                               key=rng.fold_in(rng.as_key(KEY_C), r))
        else:
            res, _ = propagate_fused(local, m, g, sp, M.shard_seed(KEY_C, r),
                                     c, iters_per_call=ITERS_PER_CALL)
        hist = hist + res.hist.double().numpy()
        gen += float(res.n_generated)
        hits += float(res.n_hits)
    d = same_on_both_ranks(*ranks(f"slice_{backend}"))
    assert str(d["backend"]) == backend
    assert d["n_generated"] == gen == 128 * 16
    assert d["n_hits"] == hits > 20
    np.testing.assert_allclose(d["hist"], hist, rtol=1e-5, atol=1e-6)


def test_ice_fit_two_ranks_fused_forward_takes_the_true_gradient(ranks):
    _, port = fit_case()
    loss, (g0, g1) = one_process_gradients(port, "fused")
    res = same_on_both_ranks(*ranks("fit_fused"))
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    np.testing.assert_allclose(res["param_a_dust400"] - A0,
                               -FIT_LR * (g0 + g1), rtol=1e-3, atol=1e-12)


def test_ranks_bootstrap_through_the_explicit_branch(ranks):
    for r, meta in enumerate(ranks("meta")):
        assert bool(meta["initialized"]) and str(meta["backend"]) == "gloo"
        assert (int(meta["rank"]), int(meta["size"])) == (r, 2)
        assert meta["leaked"].size == 0, meta["leaked"]


def test_initialize_distributed_is_a_noop_without_a_launcher(monkeypatch):
    for v in LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)
    assert B.initialize_distributed() is False
    mesh = B.global_photon_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.active) == (0, 1, False)
    assert B.process_step_slice(1024) == slice(0, 1024)
    with pytest.raises(ValueError, match="world_size and rank"):
        B.initialize_distributed("tcp://127.0.0.1:1")
    monkeypatch.setattr(B.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(B.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(B.dist, "get_rank", lambda: 2)
    assert B.process_step_slice(1024) == slice(512, 768)
    with pytest.raises(ValueError, match="not divisible"):
        B.process_step_slice(1023)
    monkeypatch.undo()
    # nccl only when each local rank has a card of its own
    monkeypatch.setattr(B.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(B.torch.cuda, "device_count", lambda: 1)
    assert (B.default_backend(1), B.default_backend(2)) == ("nccl", "gloo")
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.make_mesh()


def test_records_refused_on_a_mesh_jax_returns_none():
    """C2: the JAX sharded propagate drops the records of a save_photons
    configuration (its result's rec is None); the port refuses it."""
    (medium, geo, spectra, cfg, steps), (st, m, g, sp, c) = engine_case()
    cfg_r = dataclasses.replace(cfg, save_photons=True)
    mesh = jax_mesh()
    run = MJ.make_sharded_propagate(mesh, cfg_r)
    out = jax.eval_shape(run, MJ.shard_steps(steps, mesh), medium, geo,
                         spectra, jnp.asarray(KEY_A, jnp.uint32))
    assert out.rec is None and out.rec_count is None
    mesh_t = M.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="C2"):
        M.make_sharded_propagate(mesh_t, dataclasses.replace(
            c, save_photons=True), medium=m, geo=g, spectra=sp)
    with pytest.raises(ValueError, match="C2"):
        SimT(medium=m, geometry=g, config=CfgT(n_slots=64, save_photons=True),
             mesh=mesh_t)
