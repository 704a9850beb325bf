"""Events of one flasher-board flash each: a standard DOM of the main
array fires the LEDs of the mix's mask at its brightness and width."""

from __future__ import annotations

import numpy as np

from benchmark.world import pkg, raw_detector


def pool(traffic: dict, config: dict) -> list:
    """The mix's fixed set of flashing DOMs (its `pool_seed`), drawn without
    replacement among the main array's DOMs that carry 405 nm LEDs (the
    colour DOMs, which need the other LED spectra, are left out)."""
    from benchmark.reference.frozen.sources.flasher_extras import COLOR_DOMS
    det = config["detector"]
    sids, oids, _, _, _ = raw_detector(det)
    main = [(int(s), int(o)) for s, o in zip(sids, oids)
            if s < det["strings"] and (int(s), int(o)) not in COLOR_DOMS]
    rng = np.random.default_rng(traffic["pool_seed"])
    pick = rng.choice(len(main), traffic["events_per_call"], replace=False)
    return [dict(dom=list(main[k]), mask=traffic["mask"],
                 brightness=traffic["brightness"], width=traffic["width"],
                 photons_at_max=traffic["photons_at_max_brightness"])
            for k in pick]


def sources(root: str, world, desc: dict) -> list:
    fx = pkg(root, "sources.flasher_extras")
    info = fx.fake_flasher_info(*desc["dom"], mask=desc["mask"],
                                brightness=desc["brightness"],
                                width=desc["width"])
    return fx.flasher_info_to_pulses(
        info, world.geometry, {405: 1},
        photons_at_max_brightness=desc["photons_at_max"])


def mean_photons(world, desc: dict, srcs) -> float:
    """Each pulse's photons times its spectrum's correction factor."""
    gen = world.flasher_generator
    return float(sum(p.num_photons_no_bias * gen.correction_for(p)
                     for p in srcs))
