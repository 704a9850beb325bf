"""Cascade (shower) longitudinal-profile and EM-scale parameters.

Standalone equivalent of sim-services' I3SimConstants::ShowerParameters used
by the reference converter (I3CLSimLightSourceToStepConverterPPC.cxx:289-297,
:480-538): the longitudinal emission profile of a cascade of energy E is
  longitudinal_pos ~ b * Gamma(a)   [meters]
with  a = alpha + beta * log10(E/GeV),  b fixed per particle species, and
hadronic cascades carry a fluctuating EM-scale factor
  F = 1 - (E/E0)^-m * (1 - f0),   sigma_F = F * rms0 * ln(E)^-gamma.

The parameter values are the standard IceCube cascade parameterization
(Radel & Wiebusch for EM; Kowalski/Gallagher hadronic shower fits), valid for
ice at 0.9216 g/cm^3.
"""

from __future__ import annotations

import dataclasses
import math

from .particles import (EM_TYPES, HADRON_TYPES, Particle, ParticleType)

# species -> (alpha, beta, b[m]) for the Gamma-profile shape a = alpha +
# beta*log10(E), scale b
_EM_PROFILE = {
    ParticleType.EMinus:   (2.01849, 1.45469, 0.63207),
    ParticleType.EPlus:    (2.00035, 1.45501, 0.63008),
    ParticleType.Gamma:    (2.83923, 1.34031, 0.64526),
}
# Brems/DeltaE/PairProd/Pi0 behave like EMinus
for _t in (ParticleType.Brems, ParticleType.DeltaE, ParticleType.PairProd,
           ParticleType.Pi0):
    _EM_PROFILE[_t] = _EM_PROFILE[ParticleType.EMinus]

_HAD_PROFILE = {
    ParticleType.Hadrons:  (1.58357292, 0.41886807, 0.33833116),
    ParticleType.PiPlus:   (1.59264, 0.43438, 0.33342),
    ParticleType.PiMinus:  (1.69176636, 0.40536861, 0.34108075),
    ParticleType.K0_Long:  (1.95948974, 0.34934666, 0.34535151),
    ParticleType.PPlus:    (1.47495778, 0.40450398, 0.35226706),
    ParticleType.Neutron:  (1.57739060, 0.40631102, 0.35269455),
}
_DEFAULT_HAD = _HAD_PROFILE[ParticleType.Hadrons]

# species -> (E0, m, f0, rms0, gamma) hadronic EM-scale fluctuation
_HAD_EMSCALE = {
    ParticleType.Hadrons:  (0.18791678, 0.16267529, 0.30974123, 0.95899551, 1.35589541),
    ParticleType.PiPlus:   (0.18791678, 0.16267529, 0.30974123, 0.95899551, 1.35589541),
    ParticleType.PiMinus:  (0.19826506, 0.16218006, 0.31859323, 0.94033488, 1.35070162),
    ParticleType.K0_Long:  (0.21687243, 0.16861530, 0.27724987, 1.00318874, 1.37528605),
    ParticleType.PPlus:    (0.29579368, 0.19373018, 0.02455403, 1.01619344, 1.45477346),
    ParticleType.Neutron:  (0.66725124, 0.19263595, 0.03646519, 1.01414337, 1.45196864),
}
_DEFAULT_HAD_EMSCALE = _HAD_EMSCALE[ParticleType.Hadrons]


@dataclasses.dataclass
class ShowerParameters:
    a: float            # Gamma shape
    b: float            # Gamma scale [m]  (0 disables cascade extension)
    em_scale: float     # mean EM-equivalent scale factor
    em_scale_sigma: float


def shower_parameters(ptype: ParticleType, energy_gev: float,
                      density: float = 0.9216) -> ShowerParameters:
    logE = max(0.0, math.log10(max(energy_gev, 1e-9)))
    density_scale = 0.9216 / density  # profile stretches in less dense ice
    if ptype in EM_TYPES:
        alpha, beta, b = _EM_PROFILE[ptype]
        return ShowerParameters(a=alpha + beta * logE, b=b * density_scale,
                                em_scale=1.0, em_scale_sigma=0.0)
    # hadrons (unknown types are treated as hadrons, PPC.cxx:273-279)
    alpha, beta, b = _HAD_PROFILE.get(ptype, _DEFAULT_HAD)
    E0, m, f0, rms0, gamma = _HAD_EMSCALE.get(ptype, _DEFAULT_HAD_EMSCALE)
    E = max(energy_gev, E0)
    F = 1.0 - (E / E0) ** (-m) * (1.0 - f0)
    lnE = max(math.log(E), 1.0)
    dF = F * rms0 * lnE ** (-gamma)
    return ShowerParameters(a=alpha + beta * logE, b=b * density_scale,
                            em_scale=F, em_scale_sigma=dF)
