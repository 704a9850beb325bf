"""Particle and light-source descriptions (host-side, plain Python/numpy).

The minimal equivalent of I3Particle + I3CLSimLightSource for a standalone
framework: a particle is a dataclass; classification mirrors the reference's
type switch (private/clsim/I3CLSimLightSourceToStepConverterPPC.cxx:213-273).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class ParticleType(enum.Enum):
    # EM cascades
    EMinus = "EMinus"
    EPlus = "EPlus"
    Brems = "Brems"
    DeltaE = "DeltaE"
    PairProd = "PairProd"
    Gamma = "Gamma"
    Pi0 = "Pi0"
    # hadronic cascades
    Hadrons = "Hadrons"
    Neutron = "Neutron"
    PiPlus = "PiPlus"
    PiMinus = "PiMinus"
    K0_Long = "K0_Long"
    KPlus = "KPlus"
    KMinus = "KMinus"
    PPlus = "PPlus"
    PMinus = "PMinus"
    K0_Short = "K0_Short"
    NuclInt = "NuclInt"
    # tracks
    MuMinus = "MuMinus"
    MuPlus = "MuPlus"
    TauMinus = "TauMinus"
    TauPlus = "TauPlus"


EM_TYPES = {ParticleType.EMinus, ParticleType.EPlus, ParticleType.Brems,
            ParticleType.DeltaE, ParticleType.PairProd, ParticleType.Gamma,
            ParticleType.Pi0}
HADRON_TYPES = {ParticleType.Hadrons, ParticleType.Neutron, ParticleType.PiPlus,
                ParticleType.PiMinus, ParticleType.K0_Long, ParticleType.KPlus,
                ParticleType.KMinus, ParticleType.PPlus, ParticleType.PMinus,
                ParticleType.K0_Short, ParticleType.NuclInt}
MUON_TYPES = {ParticleType.MuMinus, ParticleType.MuPlus}
TAU_TYPES = {ParticleType.TauMinus, ParticleType.TauPlus}


@dataclasses.dataclass
class Particle:
    """A light-emitting particle.

    pos [m], time [ns], energy [GeV], zenith/azimuth or direction via
    (dir_x, dir_y, dir_z); length [m] for tracks / cascade segments (NaN for
    point cascades)."""
    ptype: ParticleType
    x: float
    y: float
    z: float
    time: float
    energy: float
    dir_x: float
    dir_y: float
    dir_z: float
    length: float = float("nan")
    is_cascade_segment: bool = False
    # stochastic losses riding on a track (the I3MCTree parent/daughter
    # relation): consumed by sources/convert.MuonSlicerPropagator
    daughters: tuple = ()
    final_energy: float = 0.0

    @staticmethod
    def cascade(ptype, pos, time, energy, zenith, azimuth):
        """Direction convention matches IceCube: (zenith, azimuth) describe
        where the particle comes FROM; the travel direction is the negative."""
        dx = -math.sin(zenith) * math.cos(azimuth)
        dy = -math.sin(zenith) * math.sin(azimuth)
        dz = -math.cos(zenith)
        return Particle(ptype=ptype, x=pos[0], y=pos[1], z=pos[2], time=time,
                        energy=energy, dir_x=dx, dir_y=dy, dir_z=dz)


@dataclasses.dataclass
class FlasherPulse:
    """An LED flasher pulse (the equivalent of I3CLSimFlasherPulse).

    The pulse emits `num_photons_no_bias` photons (pre-bias) from `pos` in
    direction (dir_x, dir_y, dir_z) with Gaussian angular smearing widths
    [rad] and a time-profile width [ns]; `spectrum_index` selects the entry
    in the spectrum table (>= 1)."""
    x: float
    y: float
    z: float
    time: float
    dir_x: float
    dir_y: float
    dir_z: float
    num_photons_no_bias: float
    angular_smear_polar: float = 0.0
    angular_smear_azimuthal: float = 0.0
    pulse_width: float = 0.0
    spectrum_index: int = 1
    # "smear": LED mode -- Gaussian angular smearing + the measured flasher
    #   time profile (non-polar interpretation,
    #   I3CLSimLightSourceToStepConverterFlasher.cxx:460-478)
    # "cone": Standard Candle mode -- emission rotated EXACTLY
    #   angular_smear_polar away from the axis at an azimuth uniform in
    #   [0, angular_smear_azimuthal), time delay N(2 ns, pulse_width)
    #   (the interpretAngularDistributionsInPolarCoordinates branch,
    #   …Flasher.cxx:479-520; GetFlasherParameterizationList.py:60-66)
    emission_mode: str = "smear"
