"""The port's particle sanitizers (util/sanitize.py) against the JAX
package's, on tests/test_util.py's cases and a seeded particle list; and
the port's profiling helpers (util/profiling.py) on the CPU: a Chrome trace
and profile_device_time's keys, as clsim_tpu.util.profiling returns them."""

import dataclasses

import numpy as np
import pytest

from clsim_tpu.geometry import single_string_geometry as string_j
from clsim_tpu.sources import particles as PJ
from clsim_tpu.util import filter_light_sources as filter_j
from clsim_tpu.util import sanitize_taus as taus_j

from clsim_tpu_torch.geometry import single_string_geometry as string_t
from clsim_tpu_torch.sources import particles as PT
from clsim_tpu_torch.util import filter_light_sources as filter_t
from clsim_tpu_torch.util import sanitize_taus as taus_t


def particles(P, n=60, seed=17):
    """A seeded mix of taus (some without a length), cascades and muons
    near and far from the string."""
    r = np.random.default_rng(seed)
    kinds = [P.ParticleType.TauMinus, P.ParticleType.EMinus,
             P.ParticleType.MuMinus]
    out = []
    for i in range(n):
        kind = kinds[i % 3]
        length = float("nan") if r.random() < 0.3 else float(
            r.uniform(-5.0, 400.0))
        if kind == P.ParticleType.EMinus:
            length = float("nan")
        d = r.standard_normal(3)
        d /= np.linalg.norm(d)
        out.append(P.Particle(ptype=kind, x=float(r.uniform(-900, 900)),
                              y=float(r.uniform(-900, 900)),
                              z=float(r.uniform(-400, 400)), time=0.0,
                              energy=10.0, dir_x=float(d[0]),
                              dir_y=float(d[1]), dir_z=float(d[2]),
                              length=length))
    return out


def keys(ps):
    return [(p.ptype.value, p.x, p.y, p.z, repr(p.length)) for p in ps]


def test_sanitize_taus_drops_invalid():
    for P, fn in ((PJ, taus_j), (PT, taus_t)):
        good = P.Particle(ptype=P.ParticleType.TauMinus, x=0, y=0, z=0,
                          time=0, energy=10, dir_x=1, dir_y=0, dir_z=0,
                          length=50.0)
        bad = dataclasses.replace(good, length=float("nan"))
        em = P.Particle(ptype=P.ParticleType.EMinus, x=0, y=0, z=0, time=0,
                        energy=10, dir_x=1, dir_y=0, dir_z=0)
        out = fn([good, bad, em])
        assert good in out and em in out and bad not in out
    assert keys(taus_t(particles(PT))) == keys(taus_j(particles(PJ)))


@pytest.mark.parametrize("cutoff", [300.0, 120.0])
def test_filter_by_detector_distance(cutoff):
    geo_j = string_j(n_doms=10, x=0.0, z_top=100.0)
    geo_t = string_t(n_doms=10, x=0.0, z_top=100.0, device="cpu")
    near = PT.Particle(ptype=PT.ParticleType.EMinus, x=50, y=0, z=0, time=0,
                       energy=1, dir_x=1, dir_y=0, dir_z=0)
    far = PT.Particle(ptype=PT.ParticleType.EMinus, x=5000, y=0, z=0,
                      time=0, energy=1, dir_x=1, dir_y=0, dir_z=0)
    out = filter_t([near, far], geo_t, closest_dom_distance_cutoff=cutoff)
    assert near in out and far not in out
    kept_t = filter_t(particles(PT), geo_t, closest_dom_distance_cutoff=cutoff)
    kept_j = filter_j(particles(PJ), geo_j, closest_dom_distance_cutoff=cutoff)
    assert 0 < len(kept_t) < 60
    assert keys(kept_t) == keys(kept_j)
    assert len(filter_t(particles(PT), None)) == 60


def test_trace_writes_a_chrome_trace(tmp_path):
    import json
    import torch
    from clsim_tpu_torch.util.profiling import trace
    with trace(str(tmp_path)) as prof:
        x = torch.arange(1000.0)
        (x * 2.0 + 1.0).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mul" in n for n in names)
    assert any(e.name == "aten::mul" for e in prof.events())


def test_profile_device_time_keys_on_the_cpu():
    import torch
    from clsim_tpu.util.profiling import profile_device_time as pdt_j
    from clsim_tpu_torch.util.profiling import profile_device_time as pdt_t
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(64).sum()

    res = pdt_t(fn, reps=3, warmup=2, device="cpu")
    assert len(calls) == 2 + 3
    keys_j = set(pdt_j(lambda: np.ones(4), reps=2, warmup=0))
    assert keys_j <= set(res) and res["clock"] == "wall"
    assert res["device_time_s"] > 0 and res["first_call_s"] > 0
    assert res["queue_saturated"] is True
    one = pdt_t(fn, reps=1, warmup=0, device="cpu")
    assert one["queue_saturated"] is False and one["device_time_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pdt_t(fn)
