"""ctypes bindings for the native step sampler (step_sampler.cpp, the same
source as the JAX package's clsim_tpu/native).

The library is compiled with g++ at first use into build/clsim_tpu_torch/
at the repository root, next to the CUDA kernels; its name carries a hash
of the source, the flags and the host's name, so an edited source is
rebuilt and a checkout copied to another machine does not load code that
-march=native tuned for this one's CPU.  No
-ffast-math: it links crtfastmath.o, which sets flush-to-zero for the whole
process that loads the library.  When the library cannot be built or
loaded, `available()` is false and the first such call warns once with the
compiler's or the loader's error; callers then use the numpy sampler of
sources/ppc.py.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "step_sampler.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "clsim_tpu_torch")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None    # why the library is unavailable


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(platform.node().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstepsampler_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile step_sampler.cpp unless the library for this source exists;
    raises RuntimeError with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, lib)    # atomic: a concurrent loader sees all or nothing
    return lib


def build_native(quiet: bool = True) -> bool:
    """build() under the JAX package's name: True when the library exists,
    False when it could not be built (with `quiet` False the compiler's
    error is also warned)."""
    try:
        return build().exists()
    except RuntimeError as e:
        if not quiet:
            warnings.warn(str(e), RuntimeWarning, stacklevel=2)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None after warning once
    why it is unavailable."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        warnings.warn("native step sampler unavailable, the numpy sampler "
                      f"serves instead: {_error}", RuntimeWarning,
                      stacklevel=2)
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ppc_cascade_steps.argtypes = [ctypes.c_uint64, ctypes.c_int64] \
        + [ctypes.c_double] * 10 + [f32] * 7
    lib.ppc_cascade_steps.restype = None
    lib.ppc_sample_count.argtypes = [ctypes.c_uint64, ctypes.c_double]
    lib.ppc_sample_count.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def error() -> Optional[str]:
    """The build or load error that made the library unavailable."""
    load()
    return _error


def cascade_step_arrays(seed: int, n: int, pos, t0, direction,
                        gamma_a: float, gamma_b: float,
                        uniform_length: float = 0.0
                        ) -> Tuple[np.ndarray, ...]:
    """Sample n cascade-like step records natively; returns
    (x, y, z, t, dx, dy, dz) float32 arrays."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"native step sampler unavailable: {_error}")
    outs = [np.empty(n, np.float32) for _ in range(7)]
    lib.ppc_cascade_steps(
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), n,
        float(pos[0]), float(pos[1]), float(pos[2]), float(t0),
        float(direction[0]), float(direction[1]), float(direction[2]),
        float(gamma_a), float(gamma_b), float(uniform_length), *outs)
    return tuple(outs)

