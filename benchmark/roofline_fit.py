"""The least work of K1's fit forward (the expected estimator on in-kernel
threefry draws, one launch of T iterations a step), counted from the
inputs only, never from the kernel's own counters:

  operations  slots x min(T, a lower bound on a photon's segments to its
              absorption horizon) x OPS_FIT_SEGMENT;
  bytes       each launch's steps, medium tables, DOM positions, stacked
              spectra and key table read once, its histogram and counters
              written once.

The segments' bound: the expected estimator flies each photon to a fixed
horizon of fixed_abs_lens absorption lengths, and a photon scatters at
least l_abs / l_sca times an absorption length in the layer that minimises
that ratio (roofline.scatters_lower_bound, averaged over the LED
spectrum's density, times the smallest anisotropy scale; its STOPPED_SHARE
is taken back out, since the fit's photons pass through DOMs and never
stop).  Every scatter ends a segment, and the horizon ends one more.  The
bound lies far below T = 256 in the configuration's ice, so
min(T, segments) is the segments a slot propagates at the least.
"""

from __future__ import annotations

from benchmark.roofline import (N_COUNTERS, OPS_SEGMENT, STEP_FIELDS,
                                STOPPED_SHARE, scatters_lower_bound)

# float32 operations the expected estimator adds to every segment, whether
# it enters a DOM or not (its deposits, on DOM entries only, are left out):
#   the segment's absorption depth (budget before less after)  1
#   the depth at the segment's start (horizon less budget)     1
OPS_EXPECTED = 2
OPS_FIT_SEGMENT = OPS_SEGMENT + OPS_EXPECTED


def segments_lower_bound(conf: dict, world, cfg) -> float:
    """A lower bound on the segments of one photon to its horizon."""
    sp = world.spectra
    led = [(sp.x[i].cpu().numpy(), sp.beta[i].cpu().numpy())
           for i in range(1, sp.x.shape[0])]
    per_abs_len = scatters_lower_bound(conf, led) / STOPPED_SHARE
    return cfg.fixed_abs_lens * per_abs_len + 1.0


def k1_work(conf: dict, world, cfg, launches: int):
    """(operations, bytes) of `launches` fit forwards of the world."""
    T = int(conf["fit"]["iterations"])
    seg = min(float(T), segments_lower_bound(conf, world, cfg))
    ops = float(launches) * cfg.n_slots * seg * OPS_FIT_SEGMENT
    geo, sp = world.geometry, world.spectra
    per_launch = (cfg.n_slots * STEP_FIELDS * 4                # steps
                  + conf["ice"]["n_layers"] * 3 * 4            # layer tables
                  + int(geo.n_doms) * 3 * 4                    # DOM positions
                  + int(sp.x.numel()) * 3 * 4                  # x, acu, beta
                  + T * 2 * 8                                  # key table
                  + int(geo.n_doms) * cfg.hist_n_bins * 4      # histogram
                  + N_COUNTERS * 8)                            # counters
    return ops, float(launches) * per_launch
