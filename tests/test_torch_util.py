"""The port's particle sanitizers (util/sanitize.py) against the JAX
package's, on tests/test_util.py's cases and a seeded particle list."""

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
