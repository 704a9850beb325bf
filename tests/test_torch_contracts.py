"""Contracts between clsim_tpu (JAX reference) and clsim_tpu_torch (port):
config and batch field names and defaults, geometry tables, parameter
carry-over, and the port's independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from clsim_tpu import geometry as GJ
from clsim_tpu import types as TJ
from clsim_tpu.medium.properties import make_homogeneous_ice as ice_j
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX as REF_J
from clsim_tpu.ops.spectrum import (make_cherenkov_spectrum as cher_j,
                                    stack_spectra as stack_j)

from clsim_tpu_torch import convert as C
from clsim_tpu_torch import geometry as GT
from clsim_tpu_torch import types as TT

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_propagation_config_fields_and_defaults_match():
    fj = {f.name: f.default for f in dataclasses.fields(TJ.PropagationConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(TT.PropagationConfig)}
    assert list(fj) == list(ft)
    assert fj == ft
    assert TT.PropagationConfig().hist_dt == TJ.PropagationConfig().hist_dt


def test_step_and_photon_batch_fields_match():
    assert TT.StepBatch._fields == TJ.StepBatch._fields
    assert TT.PhotonBatch._fields == TJ.PhotonBatch._fields
    ej, et = TJ.StepBatch.empty(5), TT.StepBatch.empty(5)
    for f in TJ.StepBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ej, f)),
                                      getattr(et, f))


@pytest.mark.parametrize("n_rings", [1, 4])
def test_geometry_tables_equal(n_rings):
    kw = dict(n_rings=n_rings, string_spacing=125.0, doms_per_string=60,
              dom_spacing=17.0, z_top=500.0, oversize=5.0)
    gj, gt = GJ.hexagonal_geometry(**kw), GT.hexagonal_geometry(device="cpu", **kw)
    assert gt.n_doms == gj.n_doms and gt.n_strings == gj.n_strings
    for f in GJ.DetectorGeometry._fields:
        a, b = getattr(gj, f), getattr(gt, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
        else:
            assert a == b, f
    assert GT.advise_strings_per_photon(gt, 90.0, 2) == \
        GJ.advise_strings_per_photon(gj, 90.0, 2)


def test_import_leaves_jax_out():
    code = ("import sys, clsim_tpu_torch, clsim_tpu_torch.api, "
            "clsim_tpu_torch.convert, clsim_tpu_torch._build, "
            "clsim_tpu_torch.propagate.dispatch, "
            "clsim_tpu_torch.propagate.diff, clsim_tpu_torch.parallel.mesh, "
            "clsim_tpu_torch.parallel.bootstrap, "
            "clsim_tpu_torch.ops.rng, clsim_tpu_torch.hits.mcpe, "
            "clsim_tpu_torch.hits.multi_pmt, clsim_tpu_torch.medium.antares, "
            "clsim_tpu_torch.medium.photonics, clsim_tpu_torch.native, "
            "clsim_tpu_torch.util.golden, clsim_tpu_torch.validate.oracle, "
            "clsim_tpu_torch.medium.ice_parser, "
            "clsim_tpu_torch.sources.detailed, clsim_tpu_torch.util, "
            "clsim_tpu_torch.util.profiling, clsim_tpu_torch.tabulator, "
            "clsim_tpu_torch.tabulator.axes, clsim_tpu_torch.tabulator.fits, "
            "clsim_tpu_torch.tabulator.table, "
            "clsim_tpu_torch.tabulator.kernel, "
            "clsim_tpu_torch.validate.table_referee; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'clsim_tpu' "
            "or m.startswith('clsim_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    medium = ice_j(n_layers=7, z_start=-100.0, layer_height=30.0)
    medium = medium._replace(b400=np.float32(0.02 + 0.03 * rng.random(7)))
    mt = C.medium_from_numpy(C.numpy_tree(medium), device="cpu")
    assert mt.n_layers == 7
    for f in ("b400", "a_dust400", "delta_tau", "alpha", "kappa", "abs_A",
              "abs_B", "abs_D", "abs_E", "layers_z_start", "layer_height"):
        np.testing.assert_array_equal(np.asarray(getattr(medium, f)),
                                      getattr(mt, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(medium.ref_index.n),
                                  mt.ref_index.n.numpy())
    assert mt.tilt.enabled == medium.tilt.enabled
    assert mt.anisotropy.enabled == medium.anisotropy.enabled

    gj = GJ.single_string_geometry(n_doms=10, oversize=3.0)
    gt = C.geometry_from_numpy(C.numpy_tree(gj), device="cpu")
    for f in GJ.DetectorGeometry._fields:
        a, b = getattr(gj, f), getattr(gt, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert a == b

    sj = stack_j([cher_j(REF_J, 265.0, 675.0)])
    st = C.spectra_from_numpy(C.numpy_tree(sj), device="cpu")
    for f in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy())

    steps = TJ.StepBatch.empty(4)._replace(
        x=np.float32([1, 2, 3, 4]), num_photons=np.int32([5, 0, 7, 1]))
    tt = C.steps_from_numpy(C.numpy_tree(steps), device="cpu")
    assert tt.num_photons.dtype == torch.int32 and tt.x.dtype == torch.float32
    back = {f: getattr(tt, f).numpy() for f in TT.StepBatch._fields}
    for f in TJ.StepBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(steps, f)), back[f])


def test_non_icecube_medium_raises():
    """Every medium kind is carried across (tests/test_torch_media.py); a
    water-kind medium without its wavelength tables is refused."""
    m = C.numpy_tree(ice_j())
    m["medium_kind"] = "water"
    with pytest.raises(ValueError, match="without wavelength tables"):
        C.medium_from_numpy(m, device="cpu")


def _default_factories():
    """Every factory and converter of the port, called without a device."""
    from clsim_tpu_torch.hits import acceptance as A
    from clsim_tpu_torch.medium import tilt
    from clsim_tpu_torch.medium.properties import make_homogeneous_ice
    from clsim_tpu_torch.ops.spectrum import (make_cherenkov_spectrum,
                                              stack_spectra)
    from clsim_tpu_torch.medium.functions import DEFAULT_ICE_REF_INDEX
    j = lambda obj: C.numpy_tree(obj)
    return {
        "make_homogeneous_ice": lambda: make_homogeneous_ice(),
        "build_geometry": lambda: GT.build_geometry([1], [1], [0.0], [0.0],
                                                    [0.0]),
        "single_string_geometry": lambda: GT.single_string_geometry(),
        "hexagonal_geometry": lambda: GT.hexagonal_geometry(n_rings=1),
        "stack_spectra": lambda: stack_spectra([make_cherenkov_spectrum(
            DEFAULT_ICE_REF_INDEX, 265.0, 675.0)]),
        "icecube_dom_acceptance": lambda: A.icecube_dom_acceptance(),
        "dom_angular_sensitivity": lambda: A.dom_angular_sensitivity(),
        "disabled_tilt": lambda: tilt.disabled_tilt(),
        "geometry_from_numpy": lambda: C.geometry_from_numpy(
            j(GJ.single_string_geometry(n_doms=3))),
        "spectra_from_numpy": lambda: C.spectra_from_numpy(
            j(stack_j([cher_j(REF_J, 265.0, 675.0)]))),
        "steps_from_numpy": lambda: C.steps_from_numpy(
            j(TJ.StepBatch.empty(4))),
        "medium_from_numpy": lambda: C.medium_from_numpy(j(ice_j())),
    }


@pytest.mark.parametrize("name", sorted(_default_factories()))
def test_entry_points_default_to_cuda(name):
    """The port's factories and converters build on the card unless the
    caller asks for the CPU: without a CUDA device the no-argument call
    raises instead of quietly building CPU tensors."""
    make = _default_factories()[name]
    if torch.cuda.is_available():
        out = make()
        tensors = [out] if isinstance(out, torch.Tensor) else [
            v for v in out._asdict().values() if isinstance(v, torch.Tensor)]
        assert tensors and all(t.is_cuda for t in tensors)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()
