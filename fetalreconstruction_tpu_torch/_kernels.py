"""Build and load the package's CUDA kernels.

The sources under `csrc/` are compiled at first use with `nvcc` into one
shared library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  The build goes into `_build/<hash>/`
beside this file, keyed by a hash of the sources and flags: a later run
reuses it and a changed source rebuilds.  Any failure raises; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libfrtorch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every entry returns an int: a
# cudaError_t, or for frt_reg_cost_strips a count)
SIGNATURES = {
    "frt_splat2_dense": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "frt_reg_cost_strips": (_I, _I, _I),
    "frt_reg_ncc_cost": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _P, _I, _P, _I, _P, _P, _P),
}

_lib = None
build_seconds = None  # wall time of the build this process ran (None: reused)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the CUDA kernels cannot be built")


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its hash is new."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / build_key()
    so = out_dir / LIB_NAME
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.frt_error_string.argtypes = [ctypes.c_int]
    lib.frt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = _lib.frt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")
