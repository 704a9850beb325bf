"""The port's PPC ice-model parser (medium/ice_parser.py, medium/tilt.py's
load_tilt) against the JAX package's on synthetic PPC directories: the same
medium field by field, the same extras, the same refusals."""

import numpy as np
import pytest

from clsim_tpu.medium.ice_parser import parse_ppc_ice_model as parse_j
from clsim_tpu_torch.convert import numpy_tree
from clsim_tpu_torch.medium.ice_parser import parse_ppc_ice_model as parse_t


def write_ice(d, par_rows=6, aniso=True, tilt=True, n_layers=23):
    r = np.random.default_rng(31)
    depth = 1400.0 + 10.0 * np.arange(n_layers)
    np.savetxt(d / "icemodel.dat", np.column_stack([
        depth, 0.01 + 0.05 * r.random(n_layers),
        0.002 + 0.01 * r.random(n_layers), -5.0 + 10.0 * r.random(n_layers)]))
    par = [0.898608, 1.084106, 6954.09, 6617.75, 71.0, 2.5][:par_rows]
    np.savetxt(d / "icemodel.par", np.column_stack([par, np.full(par_rows,
                                                                 0.01)]))
    cfg = [5.0, 1.0, 0.3, 0.9] + ([130.0, -0.106, 0.053] if aniso else [])
    np.savetxt(d / "cfg.txt", np.asarray(cfg))
    if tilt:
        dist = [-531.2, -454.6, 0.0, 124.97, 296.8, 463.1]
        np.savetxt(d / "tilt.par", np.column_stack([np.arange(6), dist]))
        tdepth = 1350.0 + 25.0 * np.arange(13)
        np.savetxt(d / "tilt.dat", np.column_stack(
            [tdepth, 20.0 * r.standard_normal((13, 6))]))
    return d


def assert_trees_equal(a, b, path="medium"):
    if isinstance(a, dict):
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
        return
    if a is None or isinstance(a, (str, bool, int, float)):
        assert a == b, path
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("par_rows,aniso,tilt", [(6, True, True),
                                                 (4, False, False),
                                                 (6, False, True)])
def test_parsed_medium_matches_jax(tmp_path, par_rows, aniso, tilt):
    d = write_ice(tmp_path, par_rows, aniso, tilt)
    mj, xj = parse_j(str(d))
    mt, xt = parse_t(str(d), device="cpu")
    assert xj == xt
    tj, tt = numpy_tree(mj), numpy_tree(mt)
    assert tt["tilt"]["enabled"] == tilt
    assert tt["anisotropy"]["enabled"] == aniso
    assert mt.b400.device.type == "cpu" and mt.n_layers == 23
    assert_trees_equal({k: v for k, v in tj.items() if k in tt}, tt)


def test_tilt_switch_and_refusals(tmp_path):
    d = write_ice(tmp_path)
    assert not parse_t(str(d), use_tilt_if_available=False,
                       device="cpu")[0].tilt.enabled
    (d / "tilt.dat").unlink()
    for parse, kw in ((parse_j, {}), (parse_t, {"device": "cpu"})):
        with pytest.raises(ValueError, match="only one of tilt"):
            parse(str(d), **kw)
    np.savetxt(d / "icemodel.par", np.ones((5, 2)))
    for parse, kw in ((parse_j, {}), (parse_t, {"device": "cpu"})):
        with pytest.raises(ValueError, match="4 or 6 rows"):
            parse(str(d), **kw)
