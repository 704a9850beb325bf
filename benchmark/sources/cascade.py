"""Events of one point cascade each (the reference benchmark's event):
energy, particle type and the vertex region from the traffic mix; vertex
uniform in a cylinder about the origin, direction isotropic."""

from __future__ import annotations

import numpy as np

from benchmark.world import pkg


def pool(traffic: dict, config: dict) -> list:
    """The mix's fixed set of events (its `pool_seed`): one plain dict
    each, which either side turns into its own particles."""
    rng = np.random.default_rng(traffic["pool_seed"])
    n = traffic["events_per_call"]
    r = traffic["vertex_r_max_m"] * np.sqrt(rng.random(n))
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    z = rng.uniform(-traffic["vertex_z_max_m"], traffic["vertex_z_max_m"], n)
    zen = np.arccos(rng.uniform(-1.0, 1.0, n))
    azi = rng.uniform(0.0, 2.0 * np.pi, n)
    return [dict(pos=[float(r[k] * np.cos(phi[k])),
                      float(r[k] * np.sin(phi[k])), float(z[k])],
                 zenith=float(zen[k]), azimuth=float(azi[k]),
                 energy=float(traffic["energy_gev"]),
                 ptype=traffic["particle"]) for k in range(n)]


def sources(root: str, world, desc: dict) -> list:
    P = pkg(root, "sources.particles")
    return [P.Particle.cascade(getattr(P.ParticleType, desc["ptype"]),
                               tuple(desc["pos"]), 0.0, desc["energy"],
                               desc["zenith"], desc["azimuth"])]


def mean_photons(world, desc: dict, srcs) -> float:
    """The mean photon count of the event under the PPC parameterization
    (the frozen generator's per-metre yield at the vertex layer, the
    density-scaled photons per GeV, the EM scale)."""
    from benchmark.reference.frozen import constants as C
    from benchmark.reference.frozen.sources.shower import shower_parameters
    gen = world.step_generator
    p = srcs[0]
    sp = shower_parameters(p.ptype, p.energy, gen.density)
    nph = C.PPC_NPH_CONST * C.PPC_NPH_REF_DENSITY / gen.density
    return float(sp.em_scale * gen.mean_photons_per_meter[
        gen._layer_for(p.z)] * nph * p.energy)
