"""Build and bind the port's hand-written CUDA kernels.

The ``*.cu`` sources in this directory have a plain C interface.  At first
use :func:`load` compiles each of them with nvcc for ``sm_90a``, all at
once, links them into ``build/ntsm_tpu_torch/libntsm_kernels.so`` (a
few seconds; nothing here includes PyTorch's headers) and binds the entry
points with ctypes.  Each entry point launches on the stream it is given
and returns ``cudaGetLastError()``; the wrappers (``ntsm_tpu_torch.count.hash_kernel``,
``count.kernel``, whose fused v1 count step the v1 engine calls,
``count.kernel_v2``, whose v2 count step (a lookup and an ordering
stage) the v2 engine calls,
``count.kernel_v3``, whose fused count step the v3 engine calls,
``eval.pair_kernel``, ``experiments.gather``, ``experiments.exp_dma_probe``
and ``experiments.exp_count_kernels``) raise on
a non-zero code.
Nothing is compiled when this module is imported, so the CPU tests import
it freely.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(_REPO, "build", "ntsm_tpu_torch")
SO_PATH = os.path.join(BUILD_DIR, "libntsm_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_DIR, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first failure."""
    logs = []
    for cmd, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        logs.append(out)
    return "".join(logs)


def build() -> str:
    """Compile every kernel source into SO_PATH, one nvcc per source, all
    started together, then link; returns nvcc's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # pid-unique names, then an atomic rename: a concurrent process never
    # dlopens a half-written library
    tmp = f"{SO_PATH}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    try:
        log = _run(procs)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        log += _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))])
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, SO_PATH)
    return log


def _stale() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    built = os.path.getmtime(SO_PATH)
    deps = sources() + glob.glob(os.path.join(_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def load():
    """The kernel library, built first if missing or older than a source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(SO_PATH)
        P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
        lib.ntsm_window_hash.restype = I
        lib.ntsm_window_hash.argtypes = [P, L, P, L, I, I, I, P, P, P]
        lib.ntsm_window_hash_codes.restype = I
        lib.ntsm_window_hash_codes.argtypes = [P, L, P, I, I, I, P, P, P]
        lib.ntsm_probe_count.restype = I
        lib.ntsm_probe_count.argtypes = [P, P, L, P, P, P, L, I, P, P, P]
        lib.ntsm_count_step.restype = I
        lib.ntsm_count_step.argtypes = [P, L, P, L, I, I, I, P, P, P, L, I, P, P, P]
        lib.ntsm_count_step_v1.restype = I
        lib.ntsm_count_step_v1.argtypes = [P, L, P, I, I, I, P, P, L, I, P, P, P]
        lib.ntsm_v2_lookup.restype = I
        lib.ntsm_v2_lookup.argtypes = [P, L, P, L, I, I, I, P, L, L, P, L, I, P, L, P, P]
        lib.ntsm_v2_order.restype = I
        lib.ntsm_v2_order.argtypes = [P, L, P, L, P, P, P]
        lib.ntsm_v2_counter_bytes.restype = I
        lib.ntsm_v2_counter_bytes.argtypes = []
        lib.ntsm_v2_bins.restype = I
        lib.ntsm_v2_bins.argtypes = []
        lib.ntsm_l2_window.restype = I
        lib.ntsm_l2_window.argtypes = [P, L, P, P]
        lib.ntsm_pair_stats.restype = I
        lib.ntsm_pair_stats.argtypes = [P, P, P, L, I, L, I, I, L, P, I, I, P, P, L, P]
        lib.ntsm_pair_block_tiles.restype = I
        lib.ntsm_pair_block_tiles.argtypes = [P, P, P, L, L, L, P, P, P, L, P, P, L, P]
        lib.ntsm_pair_block_sparse.restype = I
        lib.ntsm_pair_block_sparse.argtypes = [P, P, P, L, L, L, P, I, P, P, P, L, P, P, L, P]
        lib.ntsm_gather_1d.restype = I
        lib.ntsm_gather_1d.argtypes = [P, P, L, P, P]
        lib.ntsm_take_axis0.restype = I
        lib.ntsm_take_axis0.argtypes = [P, L, I, P, L, P, P]
        lib.ntsm_take_axis1.restype = I
        lib.ntsm_take_axis1.argtypes = [P, I, P, I, I, P, P]
        lib.ntsm_row_gather.restype = I
        lib.ntsm_row_gather.argtypes = [P, I, P, I, P, P]
        lib.ntsm_launch_floor.restype = I
        lib.ntsm_launch_floor.argtypes = [P]
        lib.ntsm_dma_probe.restype = I
        lib.ntsm_dma_probe.argtypes = [P, P, I, I, I, P, P]
        lib.ntsm_rcp_check.restype = I
        lib.ntsm_rcp_check.argtypes = [P, P, P]
        lib.ntsm_cuda_error_string.restype = ctypes.c_char_p
        lib.ntsm_cuda_error_string.argtypes = [I]
        _lib = lib
        return _lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.ntsm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as the launch argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
