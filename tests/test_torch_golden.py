"""tests/golden/config1_cascade.npz reproduced through the port's engine.

The JAX package's Simulation.run_steps draws slot batch i with
fold_in(PRNGKey(seed), i) (clsim_tpu/api.py:159-172).  The port's engine in
key mode draws the same threefry stream (ops/rng.py), so config1 of
clsim_tpu/util/golden.py, built on the port (medium, geometry, spectra and
configuration from the port's Simulation), reproduces the golden histogram
when each slot batch runs with that key.  The first test feeds it the JAX
Simulation's slot batches.  The contract is compare_to_golden's: exact
n_generated, histogram L1 <= 1e-3 of the total weight.

The port also reproduces config1 from its particles
(clsim_tpu_torch/util/golden.py: its native step sampler, which draws the
golden's step positions and directions, and the goldens' frozen Cherenkov
yield, without which the port's own float32 quadrature draws 183,321
photons for this seed instead of 183,322), and draws the same step batches
as the JAX package's configs 2 and 3.  Config 2's histogram is not compared: its
golden was frozen with spice_lea, which the repository does not hold."""

import os
import time

import numpy as np
import pytest
import torch

from clsim_tpu import native
from clsim_tpu.util.golden import CONFIGS, GOLDEN_SEED, compare_to_golden
from clsim_tpu_torch import convert as C
from clsim_tpu_torch.api import Simulation
from clsim_tpu_torch.geometry import single_string_geometry
from clsim_tpu_torch.medium.properties import make_homogeneous_ice
from clsim_tpu_torch.ops import rng
from clsim_tpu_torch.propagate import engine as E
from clsim_tpu_torch.types import PropagationConfig

torch.set_num_threads(2)


def _native_sampler_loaded() -> bool:
    """Load the JAX package's native step sampler, building it when absent.
    Other test processes may be building it at the same moment, so a load
    that finds a half-written library is retried."""
    for _ in range(5):
        if native.load() is not None:
            return True
        native.build_native()
        time.sleep(1.0)
    return False


def test_config1_cascade_golden_through_port_engine():
    if not _native_sampler_loaded():
        pytest.skip("the golden's steps need the native step sampler "
                    "(clsim_tpu/native), which did not build here")
    sim_j, sources = CONFIGS["config1_cascade"]()
    assert sim_j.step_generator._native is not None
    batches = sim_j.steps_from_particles(
        sources, np.random.default_rng(GOLDEN_SEED))
    sim = Simulation(
        medium=make_homogeneous_ice(b400=0.04, a_dust400=0.006,
                                    device="cpu"),
        geometry=single_string_geometry(n_doms=24, spacing=17.0, x=25.0,
                                        z_top=200.0, oversize=5.0,
                                        device="cpu"),
        config=PropagationConfig(n_slots=4096, hist_t_min=0.0,
                                 hist_t_max=3200.0, hist_n_bins=400))
    key = rng.base_key(GOLDEN_SEED)
    hist, gen, hits, weight = 0.0, 0.0, 0.0, 0.0
    for i, batch in enumerate(batches):
        steps = C.steps_from_numpy(C.numpy_tree(batch), device="cpu")
        res = E.propagate(steps, sim.medium, sim.geometry, sim.spectra, 0,
                          sim.config, key=rng.fold_in(key, i))
        hist = hist + res.hist.double().numpy()
        gen += float(res.n_generated)
        hits += float(res.n_hits)
        weight += float(res.weight_hits)
    golden = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                       "config1_cascade.npz")))
    compare_to_golden(dict(hist=hist, n_generated=np.asarray(gen),
                           n_hits=np.asarray(hits),
                           weight_hits=np.asarray(weight)), golden)
    assert hits == float(golden["n_hits"])


def test_config1_cascade_golden_from_particles():
    """Particles -> steps (native sampler) -> engine on the CPU in the
    golden's threefry stream: n_generated exactly the golden's 183,322 and
    the histogram within L1 1e-3."""
    from clsim_tpu_torch.util import golden as GT
    golden = GT.load_golden("config1_cascade")
    res = GT.run_config("config1_cascade", "cpu")
    assert float(res["n_generated"]) == float(golden["n_generated"]) == 183322
    GT.compare_to_golden(res, golden)


@pytest.mark.parametrize("name", ["config2_muon_spice", "config3_flasher"])
def test_config_step_batches_match_jax(name):
    from clsim_tpu_torch.util import golden as GT
    if not _native_sampler_loaded():
        pytest.skip("the JAX package's native step sampler did not build")
    sim_j, src_j = CONFIGS[name]()
    sim_t, src_t = GT.CONFIGS[name]("cpu")
    bj = sim_j.steps_from_particles(src_j, np.random.default_rng(GOLDEN_SEED))
    bt = sim_t.steps_from_particles(src_t, np.random.default_rng(GOLDEN_SEED))
    assert len(bj) == len(bt) > 0
    for a, b in zip(bj, bt):
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
