"""The ice-fit cell of the benchmark (ic86-icefit.adam) on a small world on
the CPU: its check passes the sound program against the plain reference
(benchmark/reference/fit_check.py) and fails each planted fault and the
bfloat16 control; the written-out Adam is torch's; the
program's and the reference's slots and forwards agree; IceFit keeps the
gradient it applied; a step records its spans and counters, and nothing
while recording is off; the cell's readers and K1's fit work count."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from clsim_tpu_torch.parallel.mesh import IceFit
from clsim_tpu_torch.util import profiling as P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "toy-fit.toy-adam"
N_SLOTS, T = 2048, 16
SEED = 4000000001


def toy_config() -> dict:
    """ic86-icefit on benchmark/toy.py's detector and ice: 7 strings of 10
    DOMs, 20 layers of 20 m, the 4 layers of (-50, 50) m fitted."""
    from benchmark import toy
    c = json.loads((ROOT / "benchmark/configs/ic86-icefit.json").read_text())
    c["name"] = "toy-fit"
    c["detector"].update(toy.DETECTOR)
    c["ice"].update(toy.ICE)
    c["fit"].update(band_z_m=[-50.0, 50.0], iterations=T)
    c["propagation"]["n_slots"] = N_SLOTS
    return c


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A search root with the toy's configuration and the cell's traffic,
    and the spec with the toy cell beside ic86-icefit.adam."""
    from benchmark import harness
    root = tmp_path_factory.mktemp("toyfit")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    (root / "configs" / "toy-fit.json").write_text(json.dumps(toy_config()))
    (root / "traffic" / "toy-adam.json").write_text(
        (ROOT / "benchmark/traffic/adam.json").read_text())
    spec = harness.load_spec()
    spec["workloads"].append(dict(name=CELL, config="toy-fit",
                                  traffic="toy-adam", chips=1, why="toy"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ic86-icefit.adam" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return root, spec


def run(toy_root, trace=0, patch=None, seed=SEED):
    """One run of the toy cell through the harness.  The harness's import
    guard judges the modules the run imports: this process imported JAX
    for other tests before it (tests/conftest.py)."""
    from benchmark import harness
    root, spec = toy_root
    before = set(sys.modules)
    guard = harness.forbidden_modules
    harness.forbidden_modules = lambda mods: guard(
        [m for m in mods if m not in before])
    try:
        return harness.run_cell(
            ["--workload", CELL, "--seed", str(seed), "--seconds", "0.2",
             "--trace", str(trace)], time.perf_counter(), spec=spec,
            roots=[root], device="cpu", patch=patch)
    finally:
        harness.forbidden_modules = guard


def test_the_check_passes_the_sound_program(toy_root):
    out = run(toy_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "param_gap"}
    for c in out["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"] / 10.0
    assert set(out["metrics"]) == {"photons_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["sign_flip", "leaf_zeroed", "dom_shift",
                                   "step_skipped", "lr_doubled", "control"])
def test_each_planted_fault_fails_the_check(toy_root, fault):
    """Each fault, and the bfloat16 control in the program's place, fails
    the harness's own comparison by at least twice a limit."""
    from benchmark.control_fit import planted
    out = run(toy_root, patch=planted(fault))
    assert not out["correct"]
    worst = max(c["value"] / c["limit"] for c in out["checks"].values())
    assert worst >= 2.0
    if fault in ("step_skipped", "lr_doubled"):
        # the gradients are sound: only the update is wrong
        assert out["checks"]["grad_gap"]["value"] <= \
            out["checks"]["grad_gap"]["limit"]
        assert out["checks"]["param_gap"]["value"] >= 0.3


def test_the_written_out_adam_is_torchs():
    """fit_check.Adam, in float64, follows torch.optim.Adam with the
    configuration's settings (float32) step for step, gradients small,
    zero and large alike; a run that never stepped reads param_gap 1."""
    from benchmark.reference import fit_check as FC
    conf = toy_config()
    rng = np.random.default_rng(7)
    p0 = rng.normal(0.0, 0.2, 6).astype(np.float32)
    x = torch.tensor(p0, requires_grad=True)
    fit = conf["fit"]
    opt = torch.optim.Adam([x], lr=fit["learning_rate"],
                           betas=tuple(fit["adam_betas"]),
                           eps=fit["adam_eps"])
    grads = [(rng.normal(0.0, 1.0, 6) * [1e-9, 1e-3, 0.0, 1.0, 10.0, 1e3]
              ).astype(np.float32) for _ in range(5)]
    ref = FC.adam_of(conf, p0)
    for g in grads:
        x.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(x.detach().numpy(), ref.step(g),
                                   rtol=0, atol=1e-6)
    gap, p_ref = FC.param_gap(conf, p0, grads, x.detach().numpy())
    assert gap < 1e-5 and np.abs(p_ref - p0).max() > 0.05
    assert FC.param_gap(conf, p0, grads, p0)[0] == pytest.approx(1.0)


def test_both_sides_make_the_same_slots_and_forward():
    """The program's slots and the reference's, made from the same numbers
    by each package, agree value for value, and so do the program's fused
    forward (the kernel's plain version here) and the frozen engine on the
    same threefry key."""
    from benchmark.reference import fit_check as FC
    from benchmark.sources import flash_string as FS
    from benchmark.world import PROGRAM, program_world
    from clsim_tpu_torch.convert import steps_from_numpy
    conf = toy_config()
    ref = FC.Reference(conf, SEED, "cpu", N_SLOTS)
    w = program_world(conf, "cpu")
    slots = FS.slots(PROGRAM, w, conf, N_SLOTS, FC.slot_rng(SEED))
    for f in slots._fields:
        assert np.array_equal(np.asarray(getattr(slots, f)),
                              getattr(ref.steps, f).numpy()), f
    from benchmark.drivers.fit import make_fit
    fit = make_fit(w, conf)
    with torch.no_grad():
        h = fit.one_forward(w.medium, steps_from_numpy(slots._asdict(),
                                                       "cpu"),
                            fit.step_key(FC.fit_key(SEED)))
    assert float(h.sum()) > 0 and torch.equal(h, ref.target)


def _problem(device="cpu"):
    """The toy's program world, slots, key and target, and a start."""
    from benchmark.drivers.fit import make_fit
    from benchmark.reference import fit_check as FC
    from benchmark.sources import flash_string as FS
    from benchmark.world import PROGRAM, program_world
    from clsim_tpu_torch.convert import steps_from_numpy
    conf = toy_config()
    w = program_world(conf, device)
    steps = steps_from_numpy(FS.slots(PROGRAM, w, conf, N_SLOTS,
                                      FC.slot_rng(SEED))._asdict(), device)
    fit = make_fit(w, conf)
    key = FC.fit_key(SEED)
    with torch.no_grad():
        target = fit.one_forward(w.medium, steps, fit.step_key(key))
    p = {"log_s": torch.tensor([0.2, -0.15, 0.1, -0.25], device=device)}
    return (lambda: make_fit(w, conf)), w, steps, key, target, p


def test_last_grads_is_the_gradient_applied():
    make, w, steps, key, target, p = _problem()
    lr, base = 1e-3, make()
    sgd = IceFit(base.cfg, w.geometry, w.spectra, forward="fused",
                 max_iterations=T, learning_rate=lr,
                 param_transform=base.param_transform)
    assert sgd.last_grads is None
    new, _ = sgd.step(p, w.medium, steps, key, target)
    g = sgd.last_grads["log_s"]
    assert float(g.abs().max()) > 0
    torch.testing.assert_close((p["log_s"] - new["log_s"]) / lr, g,
                               rtol=1e-3, atol=1e-3 * float(g.abs().max()))
    # Adam: the gradient kept is autograd's of the loss the step reported
    adam = make()
    _, loss = adam.step(p, w.medium, steps, key, target)
    x = p["log_s"].clone().requires_grad_(True)
    ref_loss = adam.loss_fn({"log_s": x}, w.medium, steps, key, target)
    (ref_g,) = torch.autograd.grad(ref_loss, x)
    assert float(loss) == float(ref_loss.detach())
    assert torch.equal(adam.last_grads["log_s"], ref_g)


def test_a_step_records_its_spans_and_photons():
    make, w, steps, key, target, p = _problem()
    fit = make()
    with P.recording() as rec:
        fit.step(p, w.medium, steps, key, target)
        fit.step(p, w.medium, steps, key, target)
    spans = rec.spans()
    by_id = {s["id"]: s for s in spans}
    names = lambda n: [s for s in spans if s["name"] == n]

    def inside(child, parent):
        return (by_id[child["parent"]]["name"] == parent["name"]
                and parent["start_ns"] <= child["start_ns"]
                <= child["end_ns"] <= parent["end_ns"])

    steps_ = names("fit_step")
    assert [s["batch"] for s in steps_] == [0, 1]
    assert all(s["parent"] is None for s in steps_)
    for parent, child in (("fit_step", "fit_forward"),
                          ("fit_step", "fit_optimizer"),
                          ("fit_forward", "plan"),
                          ("fit_backward", "fit_replay"),
                          ("fit_backward", "fit_vjp")):
        kids = names(child)
        assert len(kids) == 2, child
        assert all(inside(k, by_id[k["parent"]]) and
                   by_id[k["parent"]]["name"] == parent for k in kids)
    assert len(names("fit_backward")) == 2
    assert rec.total("fit_photons") == 2 * N_SLOTS


@pytest.mark.cuda
def test_on_the_card_the_backward_is_a_root_of_autograds_thread():
    """On CUDA tensors autograd runs the backward on its device thread:
    there "fit_backward" is a root span, with the replay and the
    vector-Jacobian product inside it, inside the step's wall."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (autograd's device thread)")
    make, w, steps, key, target, p = _problem("cuda")
    fit = make()
    fit.step(p, w.medium, steps, key, target)
    with P.recording() as rec:
        fit.step(p, w.medium, steps, key, target)
    torch.cuda.synchronize()
    spans = {s["name"]: s for s in rec.spans()}
    step, bwd = spans["fit_step"], spans["fit_backward"]
    assert bwd["parent"] is None and bwd["tid"] != step["tid"]
    assert step["start_ns"] <= bwd["start_ns"] <= bwd["end_ns"] \
        <= step["end_ns"]
    for child in ("fit_replay", "fit_vjp"):
        assert spans[child]["parent"] == bwd["id"]
    assert spans["fit_forward"]["parent"] == step["id"]
    assert rec.total("fit_photons") == N_SLOTS


def test_nothing_is_recorded_with_recording_off():
    make, w, steps, key, target, p = _problem()
    fit = make()
    with P.recording() as rec:
        pass
    assert not P.recording_on()
    assert P.span("fit_step", batch=0) is P.NO_SPAN
    fit.step(p, w.medium, steps, key, target)
    assert rec.spans() == []
    assert [c for c in rec.counters() if c["name"] != "launches"] == []


def _span(name, i, parent, start_ms, end_ms):
    return dict(name=name, id=i, parent=parent, start_ns=int(start_ms * 1e6),
                end_ns=int(end_ms * 1e6), thread="t", tid=1)


SYNTHETIC = [
    _span("fit_step", 0, None, 0.0, 100.0),
    _span("fit_forward", 1, 0, 1.0, 11.0),
    _span("plan", 2, 1, 1.0, 3.0),
    _span("fit_optimizer", 3, 0, 95.0, 96.0),
    _span("fit_backward", 4, None, 12.0, 92.0),
    _span("fit_step", 5, None, 100.0, 200.0),
    _span("fit_forward", 6, 5, 101.0, 115.0),
    _span("plan", 7, 6, 101.0, 105.0),
    _span("fit_optimizer", 8, 5, 195.0, 197.0),
    _span("fit_backward", 9, None, 116.0, 186.0),
]
DATA = dict(driver="fit", busy_s=0.15, window_s=0.2, steps=2,
            launches=5000, k1_s=0.02, k1_ops=67e9, k1_bytes=0.0)
EXPECTED = {
    "forward_ms_per_step.fit": 12.0,
    "backward_ms_per_step.fit": 75.0,
    "plan_ms_per_step.fit": 3.0,
    "launches_per_step.fit": 2500.0,
    "device_idle_share.fit": 25.0,
    "k1_roofline.fit": 5.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_fit_reader_on_a_synthetic_recording(metric, monkeypatch):
    from benchmark import harness, spans
    monkeypatch.setattr(spans, "recorded", lambda: (SYNTHETIC, []))
    reader = harness.load_module("metrics", metric, [harness.HERE])
    assert reader.read(DATA) == pytest.approx(EXPECTED[metric])
    assert reader.read(dict(DATA, driver="stream")) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    if metric.split("_ms_")[0] in ("forward", "backward", "plan"):
        assert reader.read(DATA) is None


def test_the_fit_metrics_are_the_cells_and_read_in_a_traced_run(toy_root):
    _, spec = toy_root
    fit_metrics = sorted(m["name"] for m in spec["per_layer"]
                         if "ic86-icefit.adam" in m.get("workloads", ()))
    assert fit_metrics == sorted(EXPECTED)
    out = run(toy_root, trace=1)
    assert out["correct"] and out["attempted"] == 1
    # on the CPU the trace holds no device time: the span readers read
    assert set(out["metrics"]) == {"forward_ms_per_step.fit",
                                   "backward_ms_per_step.fit",
                                   "plan_ms_per_step.fit",
                                   "launches_per_step.fit"}


def test_k1s_fit_work_counts_the_inputs():
    from benchmark import roofline_fit as RF
    from benchmark.drivers.fit import make_fit
    from benchmark.world import program_world
    conf = toy_config()
    w = program_world(conf, "cpu")
    cfg = make_fit(w, conf).cfg
    seg = RF.segments_lower_bound(conf, w, cfg)
    assert 1.0 < seg < float("inf")
    ops, nbytes = RF.k1_work(conf, w, cfg, 3)
    assert ops == pytest.approx(3 * N_SLOTS * min(T, seg) * 48)
    per = (N_SLOTS * 13 * 4 + conf["ice"]["n_layers"] * 12
           + int(w.geometry.n_doms) * 12 + int(w.spectra.x.numel()) * 12
           + T * 16 + int(w.geometry.n_doms) * 512 * 4 + 22 * 8)
    assert nbytes == 3 * per


def test_the_fit_check_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.fit_check, benchmark.reference.lowp\n"
        "import benchmark.sources.flash_string, benchmark.roofline_fit\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('clsim_tpu_torch', 'clsim_tpu', 'jax')))\n"
        % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
