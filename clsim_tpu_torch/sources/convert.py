"""Light-source conversion layer: propagator plugins + parameterization
matchers + the conversion queue.

TPU-native equivalents of three reference components:

* ``LightSourcePropagator`` -- the plugin protocol of
  ``I3CLSimLightSourcePropagator::Convert(source, id, secondary_cb,
  step_cb)`` (public/clsim/I3CLSimLightSourcePropagator.h:14-48): a
  propagator claims a light source, may emit secondary light sources (which
  re-enter the conversion queue) and/or step batches directly.  This is the
  seam where a Geant4-class detailed propagator or a PROPOSAL bridge plugs
  in; ``MuonSlicerPropagator`` is the first implementation.

* ``Parameterization`` -- the matcher record of
  ``I3CLSimLightSourceParameterization`` (public/clsim/
  I3CLSimLightSourceParameterization.h:52-120): converter + particle-type
  set + [from_energy, to_energy) + flasher mode, with ``is_valid_for``.
  ``default_parameterizations`` mirrors python/
  GetDefaultParameterizationList.py:33-95 (every cascade type and muons to
  the PPC converter over the full energy range).

* ``SourceConverter`` -- the conversion queue of
  ``I3CLSimLightSourceToStepConverterAsync`` (public header :48-200): each
  source goes to the FIRST valid propagator (secondaries re-enqueued) or
  else the FIRST matching parameterization.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, List, Optional, Protocol, Sequence, Set, Tuple

import numpy as np

from ..types import StepBatch
from .particles import (EM_TYPES, HADRON_TYPES, MUON_TYPES, FlasherPulse,
                        Particle, ParticleType)


class LightSourcePropagator(Protocol):
    """Plugin protocol (I3CLSimLightSourcePropagator.h:14-48).

    ``convert`` receives the source, its identifier, and two callbacks:
    ``emit_secondary(source)`` re-enqueues a new light source for the
    remaining converter chain; ``emit_steps(step_batch)`` contributes device
    steps directly.  Returning without emitting anything drops the source.
    """

    def is_valid_for(self, source) -> bool: ...

    def convert(self, source, identifier: int,
                emit_secondary: Callable[[object], None],
                emit_steps: Callable[[StepBatch], None],
                rng: np.random.Generator) -> None: ...


@dataclasses.dataclass
class Parameterization:
    """Matcher record: converter + type/energy/flasher-mode validity
    (I3CLSimLightSourceParameterization.h:52-120)."""
    converter: object                      # .convert(source, ident, rng)
    for_types: Optional[Set[ParticleType]] = None   # None = any particle
    from_energy: float = 0.0               # [GeV], inclusive
    to_energy: float = float("inf")        # exclusive
    flasher_mode: bool = False              # matches FlasherPulse sources

    def is_valid_for(self, source) -> bool:
        if isinstance(source, FlasherPulse):
            return self.flasher_mode
        if self.flasher_mode:
            return False
        if self.for_types is not None and source.ptype not in self.for_types:
            return False
        e = source.energy
        return (e >= self.from_energy) and (e < self.to_energy) \
            and not math.isnan(e)


def default_parameterizations(ppc_converter, flasher_converter=None
                              ) -> List[Parameterization]:
    """The GetDefaultParameterizationList analog: every EM/hadronic cascade
    type and muons (with their track handling) go to the PPC converter over
    the full energy range; flasher pulses to the flasher converter."""
    params = [Parameterization(converter=ppc_converter,
                               for_types=EM_TYPES | HADRON_TYPES | MUON_TYPES)]
    if flasher_converter is not None:
        params.append(Parameterization(converter=flasher_converter,
                                       flasher_mode=True))
    return params


def hybrid_parameterizations(ppc_converter,
                             crossover_energy_em: float = 0.1,
                             crossover_energy_hadron: float = 30.0
                             ) -> List[Parameterization]:
    """The GetHybridParameterizationList analog
    (python/GetHybridParameterizationList.py:33-105): muons always go to the
    PPC parameterization; EM and hadronic cascades only ABOVE their
    crossover energies [GeV] -- below, the matcher finds no record and the
    source falls through to a detailed propagator in the propagator chain
    (the Geant4 role).  Taus are never parameterized.  Passing None for a
    crossover sends that whole family to the detailed propagator."""
    params = [Parameterization(converter=ppc_converter,
                               for_types=set(MUON_TYPES))]
    if crossover_energy_em is not None:
        params.append(Parameterization(converter=ppc_converter,
                                       for_types=set(EM_TYPES),
                                       from_energy=crossover_energy_em))
    if crossover_energy_hadron is not None:
        params.append(Parameterization(converter=ppc_converter,
                                       for_types=set(HADRON_TYPES),
                                       from_energy=crossover_energy_hadron))
    return params


class MuonSlicerPropagator:
    """First LightSourcePropagator implementation: a muon carrying
    stochastic losses (``daughters``) is sliced into track segments with
    interpolated energies (util/muon_slicer.py; I3MuonSlicer.cxx:247-360),
    each re-enqueued as a secondary for the PPC parameterization, followed
    by the losses themselves."""

    def is_valid_for(self, source) -> bool:
        return (isinstance(source, Particle)
                and source.ptype in MUON_TYPES
                and bool(getattr(source, "daughters", ())))

    def convert(self, source, identifier, emit_secondary, emit_steps, rng):
        from ..util.muon_slicer import slice_muon
        daughters = list(source.daughters)
        muon = dataclasses.replace(source, daughters=())
        for s in slice_muon(muon, daughters,
                            final_energy=source.final_energy):
            emit_secondary(s)
        for d in daughters:
            emit_secondary(d)


class SourceConverter:
    """The conversion queue: propagator chain first, then parameterization
    matchers (I3CLSimLightSourceToStepConverterAsync worker semantics)."""

    def __init__(self, parameterizations: Sequence[Parameterization],
                 propagators: Sequence[LightSourcePropagator] = (),
                 max_secondary_depth: int = 64):
        self.parameterizations = list(parameterizations)
        self.propagators = list(propagators)
        self.max_secondary_depth = max_secondary_depth

    def convert(self, sources_with_ids: Sequence[Tuple[object, int]],
                rng: np.random.Generator) -> List[StepBatch]:
        queue = deque((s, i, 0) for s, i in sources_with_ids)
        batches: List[StepBatch] = []
        while queue:
            source, ident, depth = queue.popleft()
            if depth > self.max_secondary_depth:
                raise RuntimeError(
                    "propagator secondary chain exceeded max depth "
                    f"({self.max_secondary_depth}); cyclic emission?")
            prop = next((p for p in self.propagators
                         if p.is_valid_for(source)), None)
            if prop is not None:
                prop.convert(source, ident,
                             lambda s: queue.append((s, ident, depth + 1)),
                             lambda b: batches.append(b), rng)
                continue
            par = next((p for p in self.parameterizations
                        if p.is_valid_for(source)), None)
            if par is None:
                raise ValueError(
                    f"no propagator or parameterization accepts {source!r}")
            batches.extend(par.converter.convert(source, ident, rng))
        return batches
