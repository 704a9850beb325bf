"""Physical constants and unit conventions.

Unit system (differs from IceTray's I3Units, chosen for fp32 friendliness on TPU):
  * length  : meters
  * time    : nanoseconds
  * energy  : GeV
  * angle   : radians
  * wavelength: **nanometers** (wavelength-dependent property functions take nm
    directly; the reference's formulas are all written in terms of x = lambda/nm
    anyway, cf. reference private/clsim/function/I3CLSimFunctionAbsLenIceCube.cxx).
"""

# speed of light in vacuum [m/ns] (I3Constants::c)
C_LIGHT = 0.299792458

# fine structure constant prefactor used in the Frank-Tamm formula:
# dN/dx dlambda = 2*pi*alpha * (1 - 1/(beta n)^2) / lambda^2
# the reference uses alpha = 1/137 exactly
# (reference private/clsim/I3CLSimLightSourceToStepConverterUtils.cxx:57).
TWO_PI_OVER_137 = 2.0 * 3.141592653589793 / 137.0

PI = 3.141592653589793

# default IceCube DOM radius [m] (13" sphere)
DOM_RADIUS = 0.16510

# nominal IceCube detector center depth [m]
# (reference python/MakeIceCubeMediumProperties.py:50)
DETECTOR_CENTER_DEPTH = 1948.07

# standard South Pole ice density [g/cm^3]
# (reference python/MakeIceCubeMediumProperties.py:170)
ICE_DENSITY = 0.9216

# density scale used in the PPC cascade photon-yield formula:
# nph = 5.21 * (0.924 g/cm^3) / rho  photons per GeV unit-yield scale
# (reference private/clsim/I3CLSimLightSourceToStepConverterPPC.cxx:287)
PPC_NPH_CONST = 5.21
PPC_NPH_REF_DENSITY = 0.924
