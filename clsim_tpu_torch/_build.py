"""Build and load the CUDA kernels of csrc/ (nvcc into a shared library with
a plain C interface, loaded with ctypes).

The library is compiled at first use into build/clsim_tpu_torch/ at the
repository root; its name carries a hash of the sources and flags, so an
edited source is rebuilt.  Each translation unit (csrc/*.cu) is compiled by
its own nvcc, all started together, and the objects are linked into one
library.  Only the sources in the repository and the installed CUDA toolkit
are used.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "clsim_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO = {}   # path, seconds and compiler log of the last build/load


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclsim_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per translation unit, run in parallel, then one link."""
    lib = library_path()
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{u.stem}.o" for u in units]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(u)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for u, o in zip(units, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [u.name for u, p in zip(units, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      log="\n".join(logs).strip())
    return lib


def load():
    """The loaded kernel library with argtypes declared (builds on first
    use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    lib.clsim_propagate.argtypes = [ctypes.c_int] + [vp] * 19
    lib.clsim_propagate.restype = ctypes.c_int
    lib.clsim_propagate_records.argtypes = [ctypes.c_int] + [vp] * 21
    lib.clsim_propagate_records.restype = ctypes.c_int
    lib.clsim_error_string.argtypes = [ctypes.c_int]
    lib.clsim_error_string.restype = ctypes.c_char_p
    for fn in ("clsim_params_size", "clsim_record_columns",
               "clsim_record_state_rows"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    lib.clsim_tabulate.argtypes = [ctypes.c_int] + [vp] * 16
    lib.clsim_tabulate.restype = ctypes.c_int
    for fn in ("clsim_tab_params_size", "clsim_tab_counters"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    from .propagate.kernel import NRC, NRSF, _Params
    from .tabulator.kernel import N_TAB_INT, _TabParams
    if (lib.clsim_tab_params_size(), lib.clsim_tab_counters()) != \
            (ctypes.sizeof(_TabParams), N_TAB_INT):
        raise RuntimeError(
            f"tabulator block mismatch: kernel {lib.clsim_tab_params_size()} "
            f"bytes and {lib.clsim_tab_counters()} counters, ctypes "
            f"{ctypes.sizeof(_TabParams)} bytes and {N_TAB_INT}")
    if lib.clsim_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError(
            f"parameter block size mismatch: kernel "
            f"{lib.clsim_params_size()} bytes, ctypes "
            f"{ctypes.sizeof(_Params)} bytes")
    if (lib.clsim_record_columns(), lib.clsim_record_state_rows()) != \
            (NRC, NRSF):
        raise RuntimeError("record layout mismatch between csrc/ and "
                           "propagate/kernel.py")
    _LIB = lib
    return lib
