"""Kernel 1 of the count path: the window hash
(counterpart of ntsm_tpu/count/pallas_kernel.py).

:func:`window_hashes` is the wrapper the engine calls.  For CPU tensors it
runs the plain PyTorch version (kernel_v2.window_hashes_packed); for CUDA
tensors it launches ``csrc/window_hash.cu`` or raises — it never falls back.
``launches`` counts the kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.count.kernel_v2 import window_hashes_packed

launches = 0


def _check_packed(packed: torch.Tensor, vbits: torch.Tensor, k: int, L: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if L % 8 or L < k:
        raise ValueError(f"segment length {L} must be a multiple of 8 and >= k={k}")
    for name, t, width in (("packed", packed, L // 4), ("vbits", vbits, L // 8)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name} must be [B, {width}], got {tuple(t.shape)}")
        if t.stride(1) != 1:
            raise ValueError(f"{name} rows must be contiguous")
    if packed.shape[0] != vbits.shape[0] or packed.device != vbits.device:
        raise ValueError("packed and vbits must have the same rows and device")


def window_hashes(packed: torch.Tensor, vbits: torch.Tensor, k: int, L: int):
    """(h [B, W] int64, valid [B, W] bool) for every window of a packed batch.

    packed [B, L/4] and vbits [B, L/8] are uint8 with contiguous rows; they
    may be column slices of one fused [B, 3L/8] upload (the row pitch is
    passed to the kernel)."""
    global launches
    _check_packed(packed, vbits, k, L)
    if packed.device.type == "cpu":
        return window_hashes_packed(packed, vbits, k, L)
    if packed.device.type != "cuda":
        raise ValueError(f"window_hashes: unsupported device {packed.device}")
    lib = csrc.load()
    B, W = packed.shape[0], L - k + 1
    h = torch.empty((B, W), dtype=torch.int64, device=packed.device)
    valid = torch.empty((B, W), dtype=torch.bool, device=packed.device)
    rc = lib.ntsm_window_hash(
        ctypes.c_void_p(packed.data_ptr()), packed.stride(0),
        ctypes.c_void_p(vbits.data_ptr()), vbits.stride(0),
        B, L, k,
        ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        csrc.stream_ptr(packed.device),
    )
    csrc.check(lib, rc, "window_hash")
    launches += 1
    return h, valid
