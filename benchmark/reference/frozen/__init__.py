"""A frozen copy of clsim_tpu_torch's plain PyTorch and numpy modules, the
benchmark's reference.

The files below are copied unchanged from clsim_tpu_torch at commit
4c952e44234b9fe6a7c1b2e6542d3ffd3efdec26, with their relative imports, so
that they resolve inside this package and never reach the program:

    constants, geometry, types, convert, medium/{anisotropy, functions,
    properties, tilt}, ops/{rng, rotations, samplers, spectrum},
    propagate/engine, sources/{particles, shower, ppc, flasher,
    flasher_data, flasher_extras}, hits/acceptance

One change: sources/ppc.PPCStepGenerator never loads the native step
sampler (the numpy sampler serves), so the reference builds nothing.

The program may change after this copy; the reference does not, unless a
benchmark PR replaces it.  It imports torch and numpy only.
"""
