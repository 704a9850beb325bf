"""The CUDA propagation kernel against its plain PyTorch version on the card
(same tensors, same uniform stream).  Needs a CUDA GPU and skips elsewhere;
the module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("aniso,tilt", [(False, False), (True, True)])
def test_cuda_kernel_matches_plain_version(aniso, tilt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    import chip_smoke
    from clsim_tpu_torch.propagate import kernel as K
    dev = torch.device("cuda", 0)
    n, T = 8192, 16
    medium, geo, spectra, cfg, steps, u = chip_smoke.small_workload(
        n, T, aniso, tilt, dev)
    spec, cell_tab = K.fused_spec(medium, geo, spectra, cfg, n, T)
    tables = K.build_tables(spec, medium, geo, spectra, cell_tab)
    steps_p = K.pack_steps(steps)
    launches = K.LAUNCHES
    _, h_k, c_k = K.run_fused_iterations(K.init_state(steps), steps_p,
                                         tables, spec, uniforms=u)
    _, h_p, c_p = K.run_fused_iterations_plain(K.init_state(steps), steps_p,
                                               tables, spec, uniforms=u)
    torch.cuda.synchronize()
    assert K.LAUNCHES == launches + 1
    # tests/test_kernel.py::_compare tolerances
    chip_smoke.compare("cuda test", c_k, h_k, c_p, h_p)
