"""The detector, the ice and the spectra of a configuration, built from the
configuration's numbers for either side of the comparison.

`raw_*` make plain numpy data from a configuration file's numbers (and
their own fixed seeds); `make_*` turn that data into the objects of one
package, `root` being PROGRAM (clsim_tpu_torch) or REFERENCE (the frozen
copy under reference/frozen), and `program_world` / `reference_world`
assemble a stream configuration's side.  Both sides are built from the
same numbers by their own constructors; neither takes an object the other
made.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np

PROGRAM = "clsim_tpu_torch"
REFERENCE = "benchmark.reference.frozen"


def pkg(root: str, name: str):
    """The module `name` of the package `root`."""
    return importlib.import_module(f"{root}.{name}")


def raw_detector(det: dict):
    """(string ids, om ids, x, y, z) of the IC86 stand-in: `strings` strings
    on a hexagonal lattice of `string_spacing_m`, perturbed by a seeded
    Gaussian of `string_jitter_m`, `doms_per_string` DOMs from `z_top_m`
    down at `dom_spacing_m`; then `deepcore_strings` strings, the first at
    `deepcore_centre`, the rest on a ring of `deepcore_ring_m`, each with
    `deepcore_doms` DOMs at `deepcore_spacing_m` from `deepcore_z_top_m`
    and `deepcore_upper_doms` DOMs at `deepcore_upper_spacing_m` from
    `deepcore_upper_z_top_m`.  The upper DOMs of a DeepCore string carry a
    string id of their own (after all the others) at the same x, y: the
    port's geometry fits one z grid to each string and refuses a string
    whose DOMs stray more than 30 m from it."""
    rng = np.random.default_rng(det["position_seed"])
    n_str, pitch = det["strings"], det["string_spacing_m"]
    centres = [(0.0, 0.0)]
    ring = 1
    while len(centres) < n_str:
        for k in range(6 * ring):
            side, step = k // ring, k % ring
            a0, a1 = np.pi / 3.0 * side, np.pi / 3.0 * (side + 2)
            centres.append(((ring * np.cos(a0) + step * np.cos(a1)) * pitch,
                            (ring * np.sin(a0) + step * np.sin(a1)) * pitch))
            if len(centres) >= n_str:
                break
        ring += 1
    centres = np.asarray(centres) + rng.normal(
        0.0, det["string_jitter_m"], (n_str, 2))
    sids, oids, xs, ys, zs = [], [], [], [], []

    def string(sid, cx, cy, n, z_top, dz, first_om=0):
        for d in range(n):
            sids.append(sid)
            oids.append(first_om + d)
            xs.append(cx)
            ys.append(cy)
            zs.append(z_top - d * dz)

    for si, (cx, cy) in enumerate(centres):
        string(si, cx, cy, det["doms_per_string"], det["z_top_m"],
               det["dom_spacing_m"])
    n_dc = det["deepcore_strings"]
    n_up = det.get("deepcore_upper_doms", 0)
    for k in range(n_dc):
        a = 2 * np.pi * k / n_dc
        cx, cy = ((det["deepcore_ring_m"] * np.cos(a),
                   det["deepcore_ring_m"] * np.sin(a)) if k
                  else tuple(det["deepcore_centre"]))
        string(n_str + k, cx, cy, det["deepcore_doms"],
               det["deepcore_z_top_m"], det["deepcore_spacing_m"], n_up)
        if n_up:
            string(n_str + n_dc + k, cx, cy, n_up,
                   det["deepcore_upper_z_top_m"],
                   det["deepcore_upper_spacing_m"])
    return (np.asarray(sids), np.asarray(oids), np.asarray(xs),
            np.asarray(ys), np.asarray(zs))


def layer_depths(ice: dict) -> np.ndarray:
    """Each layer's centre as a depth below the surface (z = 0 lies at
    `centre_depth_m`)."""
    z = ice["z_start_m"] + (np.arange(ice["n_layers"]) + 0.5) * \
        ice["layer_height_m"]
    return ice["centre_depth_m"] - z


def raw_ice(ice: dict) -> dict:
    """Per-layer b400, a_dust400 and delta_tau.  Each layer takes the
    depth band (`bands`) its centre lies in, and draws its effective
    scattering be400 and its a_dust400 from the generator of the ice's
    seed, uniform in the band's ranges; b400 is the geometric coefficient
    be400 / (1 - mean_cos), as PPC's icemodel.dat is read.  delta_tau is
    PPC's temperature term: T(depth) - T(`delta_tau_depth_m`) with T the
    quadratic `temperature_K`.  The tilt's z-corrections are drawn next
    from the same generator."""
    r = np.random.default_rng(ice["seed"])
    depth = layer_depths(ice)
    n = ice["n_layers"]
    band = np.full(n, -1)
    for k, b in enumerate(ice["bands"]):
        lo, hi = b["depth_m"]
        band[(depth >= lo) & (depth < hi)] = k
    if (band < 0).any():
        raise ValueError(f"layers at depths {depth[band < 0]} lie in no band")
    out = {}
    for key in ("be400", "a_dust400"):
        lo = np.array([ice["bands"][k][key][0] for k in band])
        hi = np.array([ice["bands"][k][key][1] for k in band])
        out[key] = lo + (hi - lo) * r.random(n)
    out["b400"] = (out.pop("be400") / (1.0 - ice["mean_cos"])
                   ).astype(np.float32)
    out["a_dust400"] = out["a_dust400"].astype(np.float32)
    temp = np.polynomial.polynomial.polyval
    c = ice["temperature_K"]
    out["delta_tau"] = (temp(depth, c) - temp(ice["delta_tau_depth_m"], c)
                        ).astype(np.float32)
    tilt = ice.get("tilt")
    if tilt:
        shape = (len(tilt["distances_m"]), tilt["n_z"])
        out["z_corrections"] = (tilt["sigma_m"] * r.standard_normal(shape)
                                ).astype(np.float32)
    return out


def make_medium(root: str, ice: dict, device):
    """The ice of a configuration as `root`'s MediumProperties."""
    import torch
    props = pkg(root, "medium.properties")
    raw = raw_ice(ice)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    medium = props.make_homogeneous_ice(
        n_layers=ice["n_layers"], z_start=ice["z_start_m"],
        layer_height=ice["layer_height_m"], mean_cos=ice["mean_cos"],
        device=device)
    medium = medium._replace(b400=t(raw["b400"]),
                             a_dust400=t(raw["a_dust400"]),
                             delta_tau=t(raw["delta_tau"]))
    an = ice.get("anisotropy")
    if an:
        medium = medium._replace(anisotropy=pkg(
            root, "medium.anisotropy").AnisotropyParams(
            azimuth=f32(an["azimuth"]), mag_along=f32(an["mag_along"]),
            mag_perp=f32(an["mag_perp"]), enabled=True))
    tl = ice.get("tilt")
    if tl:
        medium = medium._replace(tilt=pkg(root, "medium.tilt").TiltParams(
            distances=f32(tl["distances_m"]), first_z=f32(tl["first_z_m"]),
            z_spacing=f32(tl["z_spacing_m"]),
            z_corrections=t(raw["z_corrections"]),
            azimuth_cos=f32(math.cos(tl["azimuth"])),
            azimuth_sin=f32(math.sin(tl["azimuth"])), enabled=True))
    return medium


def make_geometry(root: str, det: dict, device):
    sids, oids, xs, ys, zs = raw_detector(det)
    return pkg(root, "geometry").build_geometry(
        sids, oids, xs, ys, zs, oversize=det["dom_oversize"], device=device)


def make_config(root: str, prop: dict, **override):
    """`root`'s PropagationConfig from the configuration's `propagation`
    numbers (every field it names; the rest at their defaults)."""
    kw = dict(prop)
    kw.update(override)
    return pkg(root, "types").PropagationConfig(**kw)


def led_spectra(root: str, wlens):
    flasher = pkg(root, "sources.flasher")
    return [flasher.led_spectrum(int(w)) for w in wlens]


@dataclasses.dataclass
class World:
    """One side's objects for a configuration."""
    medium: object
    geometry: object
    config: object
    spectra: object = None          # the stacked SpectrumTable
    cherenkov: object = None        # the biased Cherenkov spectrum
    step_generator: object = None   # particles -> steps
    flasher_generator: object = None  # pulses -> steps
    sim: object = None              # the program's Simulation
    # the reference's sampling: each biased spectrum mixed half and half
    # with its unbiased twin, and (x, biased density, mixed density) a type
    spectra_mix: object = None
    densities: tuple = ()


def program_world(conf: dict, device) -> World:
    """The program's Simulation for a stream configuration: the public
    constructor, which biases the spectra and makes the generators."""
    from clsim_tpu_torch.api import Simulation
    medium = make_medium(PROGRAM, conf["ice"], device)
    geo = make_geometry(PROGRAM, conf["detector"], device)
    cfg = make_config(PROGRAM, conf["propagation"])
    sim = Simulation(medium=medium, geometry=geo, config=cfg,
                     flasher_spectra=led_spectra(
                         PROGRAM, conf.get("flasher_spectra_nm", ())),
                     photons_per_step=conf.get("photons_per_step", 200),
                     device=device)
    return World(medium=medium, geometry=geo, config=sim.config,
                 spectra=sim.spectra, cherenkov=sim.cherenkov,
                 step_generator=sim.step_generator,
                 flasher_generator=sim.flasher_generator, sim=sim)


def exact_segment(geo, cfg) -> float:
    """A segment cap at which the frozen engine's collision test is exact.

    The engine tests only the strings_per_photon strings closest to a
    segment and max_dom_layers DOM rows on each (the kernel's global plans
    test every DOM the segment passes).  A segment shorter than the
    closest two places' distance less two collision radii can reach the
    strings of one place at most, and at the cap returned it spans fewer
    DOM rows than max_dom_layers.  Segments are memoryless cuts of the
    scattering distance, so a shorter cap changes no law, only the
    iterations."""
    xy = np.stack([np.asarray(geo.string_x.cpu(), np.float64),
                   np.asarray(geo.string_y.cpu(), np.float64)], 1)
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    # strings at one x, y (a DeepCore string's two parts) are one place,
    # which the engine's top strings_per_photon strings have to cover
    same = d < 1.0
    if same.sum(1).max() > cfg.strings_per_photon:
        raise ValueError("more strings at one place than the engine tests")
    d[same] = np.inf
    r = float(geo.om_radius) * float(geo.oversize)
    z = np.asarray(geo.dom_z.cpu(), np.float64)
    sid = np.asarray(geo.dom_string_id.cpu())
    dz = min(np.diff(np.sort(z[sid == s])).min() for s in np.unique(sid)
             if (sid == s).sum() > 1)
    rows = (cfg.max_dom_layers - 2) * dz
    return float(min(cfg.max_segment_m, 0.99 * (d.min() - 2.0 * r), rows))


def reference_world(conf: dict, device) -> World:
    """The same configuration from the frozen copy, with the weighted
    spectra and generators made as the program's Simulation documents
    them (the bias is the oversized DOM's acceptance times the DOM
    efficiency, the hole ice's peak and the 1.35 * 1.01 of
    I3CLSimMakePhotons; a pulse's photons scale by its spectrum's
    correction factor)."""
    acc_mod = pkg(REFERENCE, "hits.acceptance")
    spec_mod = pkg(REFERENCE, "ops.spectrum")
    flasher = pkg(REFERENCE, "sources.flasher")
    ppc = pkg(REFERENCE, "sources.ppc")
    medium = make_medium(REFERENCE, conf["ice"], device)
    geo = make_geometry(REFERENCE, conf["detector"], device)
    cfg = make_config(REFERENCE, conf["propagation"])
    if cfg.pancake_factor == 1.0 and geo.oversize != 1.0:
        cfg = dataclasses.replace(cfg, pancake_factor=geo.oversize)
    cfg = dataclasses.replace(cfg, max_segment_m=exact_segment(geo, cfg))
    eff = (float(medium.efficiency) * acc_mod.HOLE_ICE_H2_50CM["peak"]
           * 1.35 * 1.01)
    acc = acc_mod.icecube_dom_acceptance(
        dom_radius=geo.om_radius * geo.oversize, efficiency=eff,
        device="cpu")
    bias_x = float(acc.first_x) + float(acc.dx) * np.arange(
        acc.values.shape[0])
    bias_y = acc.values.numpy()
    cher = spec_mod.make_cherenkov_spectrum(
        medium.ref_index, medium.min_wlen, medium.max_wlen,
        bias_wlen_nm=bias_x, bias_values=bias_y)
    biased = [flasher.bias_flasher_spectrum(s, bias_x, bias_y)
              for s in led_spectra(REFERENCE,
                                   conf.get("flasher_spectra_nm", ()))]
    stacked = [cher, *(s for s, _ in biased)]
    spectra = spec_mod.stack_spectra(stacked, device=device)
    # each biased spectrum mixed half and half with its unbiased twin (its
    # density with the bias divided out at its own grid points): one
    # sampler a source type, so type 0 stays the Cherenkov one
    mixed, dens = [], []
    for s in stacked:
        pb = np.asarray(s.beta, np.float64)
        pu = pb / np.maximum(np.interp(s.x, bias_x, bias_y), 1e-30)
        q = 0.5 * pb + 0.5 * pu / np.trapezoid(pu, s.x)
        mixed.append(spec_mod.make_tabulated_spectrum(s.x, q))
        dens.append((np.asarray(s.x, np.float64), pb,
                     np.asarray(mixed[-1].beta, np.float64)))
    mix = spec_mod.stack_spectra(mixed, device=device)
    mix = mix._replace(bias_x=spectra.bias_x, bias_y=spectra.bias_y)
    return World(
        medium=medium, geometry=geo, config=cfg, spectra=spectra,
        cherenkov=cher, spectra_mix=mix, densities=tuple(dens),
        step_generator=ppc.PPCStepGenerator(
            medium, cher,
            photons_per_step=conf.get("photons_per_step", 200)),
        flasher_generator=flasher.FlasherStepGenerator(
            cher, correction_factors={i + 1: f for i, (_, f)
                                      in enumerate(biased)}))
