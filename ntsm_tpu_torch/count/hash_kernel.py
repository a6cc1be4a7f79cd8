"""The window hash of the count path, both entry points of
``csrc/window_hash.cu`` (counterpart of ntsm_tpu/count/pallas_kernel.py):

* K1, :func:`window_hashes`, from a 2-bit packed batch; plain version
  kernel_v2.window_hashes_packed.  Its window stage (csrc/window_stage.cuh)
  is also the first half of the fused count step
  (count/kernel_v3.py:count_step_v3), which the v3 engine
  (count/engine.py:run_count) launches in its place.
* K2, :func:`window_hashes_codes`, from unpacked u8 codes and row lengths;
  plain version kernel_v2.window_hashes_codes_plain.  The same stage, from
  its code decoder, is the first half of the fused v1 count step
  (count/kernel.py:count_step), which the v1 engine
  (count/engine.py:run_count_v1) launches in its place.

For CPU tensors each wrapper runs its plain PyTorch version; for CUDA
tensors it launches its kernel or raises — it never falls back.
``launches`` (K1) and ``launches_codes`` (K2) count the kernel launches, so
a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.count.kernel_v2 import window_hashes_codes_plain, window_hashes_packed

launches = 0
launches_codes = 0


def _check_k(k: int, L: int) -> None:
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if L < k:
        raise ValueError(f"segment length {L} must be >= k={k}")


def check_packed(packed: torch.Tensor, vbits: torch.Tensor, k: int, L: int) -> None:
    """The checks of a packed batch [B, L/4] + [B, L/8] (K1 and the fused
    count step): uint8, contiguous rows, one row count and device, L % 8
    == 0, 1 <= k <= 32 and k <= L."""
    _check_k(k, L)
    if L % 8:
        raise ValueError(f"segment length {L} must be a multiple of 8")
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
    check_packed(packed, vbits, k, L)
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


def check_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int) -> None:
    """The checks of a code batch [B, L] + [B] (K2 and the fused v1 count
    step): uint8 codes with contiguous rows, int32 contiguous lengths, one
    row count and device, 1 <= k <= 32 and k <= L."""
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    if codes.dim() != 2 or codes.stride(1) != 1:
        raise ValueError(f"codes must be [B, L] with contiguous rows, got {tuple(codes.shape)}")
    _check_k(k, codes.shape[1])
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if lengths.shape != (codes.shape[0],) or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous [{codes.shape[0]}]")
    if codes.device != lengths.device:
        raise ValueError("codes and lengths must be on the same device")


def window_hashes_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """(h [B, W] int64, valid [B, W] bool) for every window of a [B, L]
    uint8 code batch with [B] int32 row lengths (K2); a base is bad when its
    code is > 3 or its position is >= its row's length."""
    global launches_codes
    check_codes(codes, lengths, k)
    if codes.device.type == "cpu":
        return window_hashes_codes_plain(codes, lengths, k)
    if codes.device.type != "cuda":
        raise ValueError(f"window_hashes_codes: unsupported device {codes.device}")
    lib = csrc.load()
    (B, L), W = codes.shape, codes.shape[1] - k + 1
    h = torch.empty((B, W), dtype=torch.int64, device=codes.device)
    valid = torch.empty((B, W), dtype=torch.bool, device=codes.device)
    rc = lib.ntsm_window_hash_codes(
        ctypes.c_void_p(codes.data_ptr()), codes.stride(0),
        ctypes.c_void_p(lengths.data_ptr()), B, L, k,
        ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        csrc.stream_ptr(codes.device),
    )
    csrc.check(lib, rc, "window_hash_codes")
    launches_codes += 1
    return h, valid
