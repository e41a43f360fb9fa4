"""Build and load the hand-written Hopper kernels.

All CUDA sources in ``videoseal_tpu_torch/csrc/`` compile with nvcc into one
shared library with a plain C interface, loaded with ctypes. The build runs at
first use, into ``videoseal_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, so an unchanged tree reuses its library and a changed one
rebuilds. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "vs_blend_planar": [P, P, P, P, I, P, P, P, P, I] + [I] * 8 + [F, F, P],
    "vs_detect_height": [P, P, P, I, P, I, I, I, P],
    "vs_cnx_block_a_f32": [P] * 9 + [I] * 5 + [P],
    "vs_cnx_block_a_bf16": [P] * 9 + [I] * 5 + [P],
    "vs_cnx_block_b_f32": [P] * 8 + [I] * 5 + [P],
    "vs_cnx_block_b_bf16": [P] * 8 + [I] * 5 + [P],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libvideoseal_kernels.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cu = [s for s in sources() if s.endswith(".cu")]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
