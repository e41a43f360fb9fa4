"""Build and load the hand-written Hopper kernels.

All CUDA sources in ``videoseal_tpu_torch/csrc/`` compile with nvcc, one
process per ``.cu`` file, all started together, and link into one shared
library with a plain C interface, loaded with ctypes. The build runs at first
use, into ``videoseal_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources (headers included) and flags, so an unchanged tree reuses its library
and a changed one rebuilds. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "vs_blend_planar": [P, P, P, P, I, P, P, I, P, P, P, P, I] + [I] * 11 + [F, F, P],
    "vs_detect_height": [P, P, P, I, P, I, I, I, P],
    "vs_blend_planar_attr": [P, P, P, P, I, P, P, I, P] + [I] * 9 + [F, F, I, P],
    "vs_cnx_dwln_f32": [P] * 6 + [I] * 5 + [P],
    "vs_cnx_dwln_bf16": [P] * 6 + [I] * 5 + [P],
    "vs_cnx_pw1": [P] * 5 + [I] * 4 + [P],
    "vs_cnx_grn": [P] * 3 + [I] * 4 + [P],
    "vs_cnx_pw2_f32": [P] * 7 + [I] * 4 + [P],
    "vs_cnx_pw2_bf16": [P] * 7 + [I] * 4 + [P],
    "vs_cnx_group_f32": [P] * 9 + [I] * 6 + [P],
    "vs_cnx_group_bf16": [P] * 9 + [I] * 6 + [P],
    "vs_cnx_group_f32_info": [I] * 5 + [P],
    "vs_cnx_group_bf16_info": [I] * 5 + [P],
    "vs_cnx_probe": [P] * 16 + [I] * 6 + [P],
    "vs_jnd_up": [P, I, P, P, P, I, P, P, I, P, I] + [I] * 6 + [F] * 5 + [P],
    "vs_jnd_delta": [P, I, P, P] + [I] * 7 + [F] * 4 + [P],
    "vs_jnd_delta_info": [I, I, P],
    "vs_jnd_delta_split": [P, I, P, P] + [I] * 7 + [F] * 4 + [I, P],
    "vs_jnd_blend": [P, P, I, I, P] + [I] * 3 + [F] * 5 + [P],
    "vs_jnd_probe": [P, I, P, P] + [I] * 3 + [F] * 4 + [I, I, P],
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


def _build(out_dir: str, so: str) -> None:
    """One nvcc per .cu file, all running at once, then one link; every
    process's output, and its seconds, go to out_dir/build.log."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs, procs = [], {}
    t0 = time.perf_counter()
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        with open(f"{obj}.log", "w") as log:   # the child keeps its own descriptor
            procs[src] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                           stdout=log, stderr=subprocess.STDOUT), log.name)
    secs = {}
    while len(secs) < len(procs):
        for src, (proc, _) in procs.items():
            if src not in secs and proc.poll() is not None:
                secs[src] = time.perf_counter() - t0
        time.sleep(0.05)
    logs, failed = [], []
    for src, (proc, log_path) in procs.items():
        with open(log_path) as f:
            out = f.read()
        os.remove(log_path)
        logs.append(f"== {os.path.basename(src)} built in {secs[src]:.1f} s\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out[-4000:]}")
    tmp = f"{so}.{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(logs))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)


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
        _build(out_dir, so)
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
