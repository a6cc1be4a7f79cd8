"""Golden (numpy) canonical k-mer hashing over a sequence
(counterpart of ntsm_tpu/core/kmers.py).

Reproduces the reference's rolling iterator semantics exactly
(vendor/KseqHashIterator.hpp:95-112):

* forward 2-bit encoding, reverse-complement encoding, canonical = min
* a window containing any non-ACGT base yields no k-mer (the C++ iterator
  resets its rolling state on such bases, :106-107)
* one hash per valid window position, in left-to-right order

This is the parity oracle for the device kernels and is also used for
site-table construction (site FASTAs are tiny; numpy is plenty).
"""

from __future__ import annotations

import numpy as np

from ntsm_tpu_torch.core.encode import encode_bytes
from ntsm_tpu_torch.core.hash import hash64_np, kmer_mask

_U64 = np.uint64


def window_encodings(codes: np.ndarray, k: int):
    """Forward/reverse 2-bit encodings + validity for every window.

    Returns (fw, rv, valid) arrays of length len(codes)-k+1.  Invalid
    windows (containing a code >= 4) have undefined fw/rv and valid=False.
    """
    n = codes.shape[0]
    if n < k:
        z = np.zeros(0, dtype=_U64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    w = n - k + 1
    c = (codes & np.uint8(3)).astype(_U64)
    comp = (_U64(3) ^ c).astype(_U64)
    fw = np.zeros(w, dtype=_U64)
    rv = np.zeros(w, dtype=_U64)
    for j in range(k):
        fw = (fw << _U64(2)) | c[j : j + w]
        rv |= comp[j : j + w] << _U64(2 * j)
    bad = (codes >= 4).astype(np.int64)
    cs = np.concatenate(([0], np.cumsum(bad)))
    valid = (cs[k:] - cs[:-k]) == 0
    return fw, rv, valid


def flat_window_hashes(codes: np.ndarray, k: int):
    """(hashes, valid) for every window of a flat code stream.

    Uses the native C++ roller when available (the numpy u64 passes below
    take tens of seconds on a human-scale site stream); numpy otherwise —
    identical output, and the numpy path remains the parity oracle."""
    from ntsm_tpu_torch import native

    lib = native.load()
    n = int(codes.shape[0])
    w = n - k + 1
    if lib is not None and w > 0:
        import ctypes

        codes = np.ascontiguousarray(codes)
        hashes = np.empty(w, dtype=np.uint64)
        valid = np.empty(w, dtype=np.uint8)
        lib.ntsm_canonical_hashes(
            codes.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(n),
            ctypes.c_int(k),
            hashes.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p),
        )
        return hashes, valid.astype(bool)
    fw, rv, valid = window_encodings(codes, k)
    return hash64_np(np.minimum(fw, rv), kmer_mask(k)), valid


def canonical_hashes(seq: bytes | str, k: int, with_pos: bool = False):
    """All canonical k-mer hashes of `seq`, in order, skipping N-windows.

    ``with_pos`` additionally returns, per hash, the position the reference
    iterator would report via getPos() — one past the window end
    (vendor/KseqHashIterator.hpp:60-62,97: m_pos is post-incremented).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    codes = encode_bytes(seq)
    fw, rv, valid = window_encodings(codes, k)
    canon = np.minimum(fw, rv)
    h = hash64_np(canon, kmer_mask(k))
    hashes = h[valid]
    if with_pos:
        pos = (np.nonzero(valid)[0] + k).astype(np.uint64)
        return hashes, pos
    return hashes
