"""The flashers of one string, drawn into one-photon slots: each standard
DOM of the configuration's flashing string fires the LEDs of its mask at
its brightness and width (sources/flash.py's flash), and a fixed number of
slots is drawn from all their photons.

Either side builds its slots from the same numbers with its own package
(`root`: world.PROGRAM or world.REFERENCE) and the same generator seed, so
both get the same slots, value for value.
"""

from __future__ import annotations

import numpy as np

from benchmark.sources import flash
from benchmark.world import pkg, raw_detector


def flashing_doms(conf: dict) -> list:
    """(string, om) of every DOM of the flashing string that carries 405 nm
    LEDs (the colour DOMs, which need the other LED spectra, are left
    out)."""
    from benchmark.reference.frozen.sources.flasher_extras import COLOR_DOMS
    fl = conf["flashers"]
    sids, oids, _, _, _ = raw_detector(conf["detector"])
    return [(int(s), int(o)) for s, o in zip(sids, oids)
            if s == fl["string"] and (int(s), int(o)) not in COLOR_DOMS]


def pulses(root: str, world, conf: dict, scale: float = 1.0) -> list:
    """Each flasher's pulses (one list a DOM) at `scale` times the
    configuration's photons at full brightness."""
    fx = pkg(root, "sources.flasher_extras")
    fl = conf["flashers"]
    return [fx.flasher_info_to_pulses(
        fx.fake_flasher_info(s, o, mask=fl["mask"],
                             brightness=fl["brightness"], width=fl["width"]),
        world.geometry, {405: 1},
        photons_at_max_brightness=fl["photons_at_max_brightness"] * scale)
        for s, o in flashing_doms(conf)]


def slots(root: str, world, conf: dict, n: int, rng):
    """n one-photon slots of the string's flashes, as `root`'s numpy
    StepBatch: the pulses at a brightness scaled to `draw_factor` x n
    photons in all, converted one photon a step by `root`'s
    FlasherStepGenerator (each flash's photons in proportion to its
    brightness), then n of them drawn without replacement, in the order
    they were made.  Each slot's weight is the flashes' mean photons at
    full brightness over n, so the histogram stands for the whole
    flashes'."""
    T = pkg(root, "types")
    flasher = pkg(root, "sources.flasher")
    full = flash.mean_photons(world, None, [
        p for ps in pulses(root, world, conf) for p in ps])
    factor = conf["flashers"]["draw_factor"] * n / full
    gen = flasher.FlasherStepGenerator(
        world.cherenkov, photons_per_step=1,
        correction_factors=world.flasher_generator.correction_factors)
    batches = [b for i, ps in enumerate(pulses(root, world, conf, factor))
               for p in ps for b in gen.convert(p, i, rng)]
    made = T.StepBatch.concatenate(batches)
    if made.n_steps < n:
        raise ValueError(f"the flashes made {made.n_steps} photons, fewer "
                         f"than the {n} slots")
    pick = np.sort(rng.choice(made.n_steps, n, replace=False))
    fields = {f: np.asarray(a)[pick] for f, a in made._asdict().items()}
    fields["weight"] = (fields["weight"].astype(np.float64) * (full / n)
                        ).astype(np.float32)
    return T.StepBatch(**fields)
