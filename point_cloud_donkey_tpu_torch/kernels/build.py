"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The kernels have a plain C interface (no PyTorch headers), so one nvcc call
builds them all in seconds.  The shared library goes to
``build/torch_kernels/<hash>/`` beside the package, where the hash covers
every source, the flags and the nvcc version: a library built from other
sources or flags is never loaded.  The build happens at the first kernel
launch, never at import, so the package imports on machines without nvcc
or a GPU.

Every C entry point takes raw device pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.

The launch counters are the package's only global state: each wrapper in
``ops/kernels/`` calls :func:`count_launch` right where it launches its
kernel, so a run can show that the main path went through every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

# No -use_fast_math: it changes sqrtf, division and atan2f/acosf, and with
# them the radius gates and the SHOT bin boundaries.  -fmad=false keeps
# a*b+c as two roundings, as the plain PyTorch twins compute it.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"

KERNELS = ("lrf_moments", "sign_votes", "shot_fused", "chisq_topk",
           "lrf_moments_windowed", "sign_votes_windowed", "shot_dense",
           "shot_hist", "histogram", "lrf_moments_v2", "sign_votes_v2",
           "shot_windowed", "chisq_matrix")

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (csrc/*.cu)
_SIGNATURES = {
    "pcd_lrf_moments": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "pcd_sign_votes": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "pcd_shot_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "pcd_chisq_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pcd_chisq_matrix": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pcd_lrf_moments_windowed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _P],
    "pcd_sign_votes_windowed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _I, _P],
    "pcd_shot_dense": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "pcd_cshot_hist": [_P] * 10 + [_I, _I, _I, _F, _P],
    "pcd_short_shot_hist": [_P] * 6 + [_I, _I, _I, _F, _I, _I, _I, _F, _I,
                                          _F, _F, _P],
    "pcd_lrf_moments_v2": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "pcd_sign_votes_v2": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "pcd_shot_windowed": [_P] * 9 + [_I, _I, _I, _I, _F, _P],
}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(NVCC_FALLBACK):
        nvcc = NVCC_FALLBACK
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of point_cloud_donkey_tpu_torch "
            "are compiled from csrc/ at first use and need the CUDA toolkit "
            f"(nvcc on PATH or {NVCC_FALLBACK})")
    return nvcc


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def library_path(nvcc: str) -> str:
    """Path of the library for the current sources, flags and nvcc."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            check=True).stdout)
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libpcd_kernels.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the hashed build directory unless it is
    there already; returns the library path."""
    nvcc = find_nvcc()
    out = library_path(nvcc)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # build to a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cu = [p for p in _sources() if p.endswith(".cu")]
    cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *cu]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pcd_error_string.argtypes = [ctypes.c_int]
        handle.pcd_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        what = lib().pcd_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err} ({what})")
