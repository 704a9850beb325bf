"""The port's native step sampler (clsim_tpu_torch/native, built with g++
into build/clsim_tpu_torch/) against the JAX package's (clsim_tpu/native):
the same source and flags, so the same bytes for the same seed; and the
PPC generator and Simulation.steps_from_particles with use_native=True on
both sides, byte for byte."""

import shutil
import time
import warnings

import numpy as np
import pytest
import torch

from clsim_tpu import native as NJ
from clsim_tpu.util import golden as GJ

from clsim_tpu_torch import native as NT
from clsim_tpu_torch.util import golden as GT

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++: the native sampler cannot "
                                       "be built here")


def jax_native():
    """The JAX package's library, built in place when absent (other test
    processes may be building it at the same moment, so a load that finds
    a half-written library is retried)."""
    for _ in range(5):
        if NJ.load() is not None:
            return NJ
        NJ.build_native()
        time.sleep(1.0)
    pytest.fail("the JAX package's native step sampler did not build")


def assert_batches_equal(bj, bt):
    assert len(bj) == len(bt) > 0
    for a, b in zip(bj, bt):
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, f
            assert x.tobytes() == y.tobytes(), f


def test_library_builds_into_build_dir():
    assert NT.available(), NT.error()
    path = NT.library_path()
    assert path.exists()
    assert path.parent.parts[-2:] == ("build", "clsim_tpu_torch")


@pytest.mark.parametrize("mode", ["gamma", "uniform", "point"])
@pytest.mark.parametrize("seed", [1, 20260818, 2 ** 63 - 5])
def test_cascade_step_arrays_byte_for_byte(mode, seed):
    kw = dict(gamma={"gamma_a": 2.3, "gamma_b": 0.71},
              uniform={"gamma_a": 1.0, "gamma_b": 0.0,
                       "uniform_length": 430.0},
              point={"gamma_a": 1.0, "gamma_b": 0.0})[mode]
    args = (seed, 5000, (12.0, -7.5, 31.0), 4.0, (0.48, -0.6, 0.64))
    out_j = jax_native().cascade_step_arrays(*args, **kw)
    out_t = NT.cascade_step_arrays(*args, **kw)
    assert len(out_j) == len(out_t) == 7
    for a, b in zip(out_j, out_t):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mean", [0.0, 12.5, 4.0e4, 3.0e7])
def test_sample_count_matches(mean):
    lib_j, lib_t = jax_native().load(), NT.load()
    for seed in (3, 99):
        assert lib_t.ppc_sample_count(seed, mean) == \
            lib_j.ppc_sample_count(seed, mean)


@pytest.mark.parametrize("name", ["config1_cascade", "config2_muon_spice"])
def test_generator_and_simulation_byte_for_byte(name):
    """The golden configurations' particles, with use_native=True on both
    sides and the goldens' yield, through PPCStepGenerator.convert and
    Simulation.steps_from_particles."""
    jax_native()
    sim_j, src_j = GJ.CONFIGS[name]()
    sim_t, src_t = GT.CONFIGS[name]("cpu")
    gj, gt = sim_j.step_generator, sim_t.step_generator
    assert gj._native is not None and gt._native is not None
    assert gt.mean_photons_per_meter.tobytes() == \
        gj.mean_photons_per_meter.tobytes()
    assert_batches_equal(gj.convert(src_j[0], 0, np.random.default_rng(8)),
                         gt.convert(src_t[0], 0, np.random.default_rng(8)))
    assert_batches_equal(
        sim_j.steps_from_particles(src_j, np.random.default_rng(GJ.GOLDEN_SEED)),
        sim_t.steps_from_particles(src_t, np.random.default_rng(GT.GOLDEN_SEED)))


def test_failed_build_warns_once(monkeypatch, tmp_path):
    """A library that cannot be built is unavailable with a warning naming
    the compiler's error, once; the generator then uses numpy."""
    from clsim_tpu_torch.medium.properties import make_homogeneous_ice
    from clsim_tpu_torch.ops.spectrum import make_cherenkov_spectrum
    from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu_torch.sources.ppc import PPCStepGenerator
    bad = tmp_path / "step_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(NT, "SOURCE", bad)
    monkeypatch.setattr(NT, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(NT, "_lib", None)
    monkeypatch.setattr(NT, "_error", None)
    spec = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    with pytest.warns(RuntimeWarning, match="step_sampler.cpp"):
        gen = PPCStepGenerator(make_homogeneous_ice(device="cpu"), spec)
    assert gen._native is None and "failed" in NT.error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not NT.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        NT.cascade_step_arrays(1, 4, (0, 0, 0), 0.0, (0, 0, 1), 1.0, 0.0)
