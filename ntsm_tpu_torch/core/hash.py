"""The invertible 64-bit k-mer hash (counterpart of ntsm_tpu/core/hash.py).

The minimap2-style Thomas Wang hash the reference applies to the canonical
(min of forward / reverse-complement) 2-bit k-mer encoding (reference:
vendor/KseqHashIterator.hpp:129-139).  Only shifts, adds, xors and masks.

Two implementations with identical results:
  * :func:`hash64_np` — vectorized numpy on uint64 (golden model, tables)
  * :func:`hash64_torch` — torch on int64 bit patterns (device path)

PyTorch on the CPU has no uint64 ``>>``, ``<<``, ``+`` or ``<``, so the torch
side carries every 64-bit value as the int64 with the same bits: adds and
left shifts wrap identically, right shifts are made logical with a mask
(:func:`srl`), and unsigned order is signed order after flipping the top
bit (:func:`unsigned_key`).  k = 32 fills all 64 bits, which is where both
tricks matter.
"""

from __future__ import annotations

import numpy as np
import torch

_U64 = np.uint64


def kmer_mask(k: int) -> np.uint64:
    """2k-bit mask; valid for k <= 32 (src/ntSeqMatchCount.cpp:147-150)."""
    if not 0 < k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if k == 32:
        return _U64(0xFFFFFFFFFFFFFFFF)
    return _U64((1 << (2 * k)) - 1)


def hash64_np(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """hash64 on a uint64 numpy array (vendor/KseqHashIterator.hpp:129-139)."""
    key = np.asarray(key, dtype=_U64)
    key = (~key + (key << _U64(21))) & mask
    key = key ^ (key >> _U64(24))
    key = ((key + (key << _U64(3))) + (key << _U64(8))) & mask
    key = key ^ (key >> _U64(14))
    key = ((key + (key << _U64(2))) + (key << _U64(4))) & mask
    key = key ^ (key >> _U64(28))
    key = (key + (key << _U64(31))) & mask
    return key


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def unsigned_key(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of x's bits."""
    return x ^ (-(2**63))


def hash64_torch(key: torch.Tensor, k: int) -> torch.Tensor:
    """hash64 under the 2k-bit mask on int64 bit patterns."""
    mask = int(np.asarray(kmer_mask(k)).view(np.int64))  # -1 for k = 32
    key = (~key + (key << 21)) & mask
    key = key ^ srl(key, 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ srl(key, 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ srl(key, 28)
    key = (key + (key << 31)) & mask
    return key
