from .particles import FlasherPulse, Particle, ParticleType  # noqa: F401
from .ppc import PPCStepGenerator, assign_steps_to_slots  # noqa: F401
from .shower import ShowerParameters, shower_parameters  # noqa: F401
