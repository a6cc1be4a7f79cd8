"""Packed batch layout and the plain window-hash stage
(counterpart of ntsm_tpu/count/kernel_v2.py).

Reads travel to the device 2-bit packed (4 bases/byte) with one validity
bit per base: 3L/8 bytes per row instead of L.  The plain PyTorch window
hashes here, from packed bases (K1's) and from unpacked codes (K2's), are
the references that the kernels (count/hash_kernel.py, csrc/window_hash.cu)
are held to, and what their wrappers run for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch.core.hash import hash64_torch, unsigned_key


def pack_batch(codes: np.ndarray):
    """Host-side 2-bit packing: [B, L] u8 codes -> ([B, L//4] u8, [B, L//8] u8).

    BLOCK layout, not positional interleave: byte j holds bases
    (j, j+L/4, j+L/2, j+3L/4) in bit pairs (0,2,4,6).  Bit i of validity
    byte j is base j + i*L/8.

    The validity bitmask carries both "real base" (not N) and "inside the
    read" so lengths never need to ride along.
    """
    B, L = codes.shape
    if L % 8:
        raise ValueError(f"segment length {L} is not a multiple of 8")
    base = codes & 3
    q = L // 4
    packed = (
        base[:, 0:q]
        | (base[:, q : 2 * q] << 2)
        | (base[:, 2 * q : 3 * q] << 4)
        | (base[:, 3 * q :] << 6)
    ).astype(np.uint8)
    valid = (codes < 4).astype(np.uint8)
    e = L // 8
    vbits = np.zeros((B, e), dtype=np.uint8)
    for i in range(8):
        vbits |= valid[:, i * e : (i + 1) * e] << i
    return packed, vbits


def pack_batch_fast(codes: np.ndarray):
    """pack_batch via the native C++ packer when available, numpy otherwise
    (identical output)."""
    from ntsm_tpu_torch import native

    lib = native.load()
    B, L = codes.shape
    if lib is None or L % 8:
        return pack_batch(codes)  # raises for L % 8
    codes = np.ascontiguousarray(codes)
    packed = np.empty((B, L // 4), dtype=np.uint8)
    vbits = np.empty((B, L // 8), dtype=np.uint8)
    lib.ntsm_pack_batch(
        codes.ctypes.data_as(ctypes.c_void_p),
        B,
        L,
        packed.ctypes.data_as(ctypes.c_void_p),
        vbits.ctypes.data_as(ctypes.c_void_p),
    )
    return packed, vbits


def unpack_codes(packed: torch.Tensor, vbits: torch.Tensor):
    """[B, L/4] packed + [B, L/8] vbits -> (codes [B, L] u8 in 0..3,
    base_valid [B, L] bool).  A concatenation thanks to the block layout."""
    codes = torch.cat([(packed >> (2 * i)) & 3 for i in range(4)], dim=1)
    valid = torch.cat([(vbits >> i) & 1 for i in range(8)], dim=1).bool()
    return codes, valid


def window_hashes_packed(packed: torch.Tensor, vbits: torch.Tensor, k: int, L: int):
    """Canonical hash + validity for every window, from packed input.

    Plain PyTorch on any device.  Returns (h [B, W] int64 — the uint64
    hash's bits, valid [B, W] bool), W = L - k + 1; h at an invalid window
    is the hash of whatever codes it holds, like the JAX stage's."""
    codes, base_valid = unpack_codes(packed, vbits)
    return hash_windows(codes, base_valid, k)


def hash_windows(codes: torch.Tensor, base_valid: torch.Tensor, k: int):
    """(h, valid) of every window of [B, L] codes in 0..3 with a [B, L]
    bool "base is real and inside the read": the step both plain window
    hashes share (K1's packed one and K2's unpacked one, both here)."""
    B, W = codes.shape[0], codes.shape[1] - k + 1
    c = codes.to(torch.int64)
    comp = 3 ^ c
    fw = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    rv = torch.zeros_like(fw)
    for j in range(k):
        fw = (fw << 2) | c[:, j : j + W]
        rv = rv | (comp[:, j : j + W] << (2 * j))
    canon = torch.where(unsigned_key(fw) < unsigned_key(rv), fw, rv)
    h = hash64_torch(canon, k)
    bad = (~base_valid).to(torch.int32)
    csz = torch.nn.functional.pad(torch.cumsum(bad, dim=1, dtype=torch.int32), (1, 0))
    valid = (csz[:, k:] - csz[:, :-k]) == 0
    return h, valid


def window_hashes_codes_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical hash and validity of every window of a [B, L] code block
    (kernel K2's plain version; ntsm_tpu/count/kernel.py:window_hashes).

    A base is bad when its code is > 3 or its position is >= its row's
    length.  Returns (h [B, W] int64, the uint64 hash's bits; valid [B, W]
    bool), W = L - k + 1; h at an invalid window is the hash of whatever
    codes it holds, like the JAX stage's."""
    L = codes.shape[1]
    inside = torch.arange(L, device=codes.device)[None, :] < lengths[:, None]
    return hash_windows(codes & 3, (codes <= 3) & inside, k)
