"""The v1 counting step: unpacked codes in, counts out
(counterpart of ntsm_tpu/count/kernel.py).

The v1 engine (count/engine.py:run_count_v1) uploads each batch as [B, L]
u8 codes (0..3 a base, >= 4 not one) and [B] int32 segment lengths, one
read segment a row.  :func:`count_step` is the whole step in one
hand-written kernel, ``csrc/hash_bucket_count.cu`` (the window hash of K2,
count/hash_kernel.py:window_hashes_codes, on the window stage it shares,
then the bucket probe and the count, with the hashes kept out of HBM).
Its plain version is :func:`window_hashes_codes_plain` then
:func:`bucket_probe`: one gather of the 8-slot bucket
``keys[h & (n_buckets - 1)]`` a window, the slot match, and a scatter-add
into the count vector, whose last slot absorbs misses.  CPU tensors run
the plain version; CUDA tensors launch the kernel or raise.  ``launches_step``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.count.hash_kernel import check_codes
from ntsm_tpu_torch.count.kernel_v2 import window_hashes_codes_plain

SLOTS = 8  # io/sites.build_lookup's bucket width

launches_step = 0  # the fused v1 count step, count_step


def make_table_arrays(lookup, n_kmers: int, device="cpu"):
    """(keys [n_buckets, slots] int64 hash bits, vals [n_buckets, slots]
    int32 k-mer index, n_kmers where unused) on `device`, from the host
    table of io/sites.build_lookup."""
    keys = torch.from_numpy(np.ascontiguousarray(lookup.keys).view(np.int64)).to(device)
    vals = np.where(lookup.vals < 0, n_kmers, lookup.vals).astype(np.int32)
    return keys, torch.from_numpy(vals).to(device)


def bucket_probe(h, valid, keys, vals, counts, *, n_kmers: int):
    """counts[kmer] += 1 for every valid window whose hash is in the table
    (IN PLACE; counts is int32 [n_kmers + 1], the last slot the miss bin).
    Returns the batch's (n_valid, n_found) as int64 tensors on its device."""
    bucket = h & (keys.shape[0] - 1)
    match = keys[bucket] == h[..., None]  # [B, W, slots]
    slot_val = torch.where(match, vals[bucket], n_kmers).amin(dim=-1)
    found = match.any(dim=-1) & valid
    idx = torch.where(found, slot_val, n_kmers).reshape(-1)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    return valid.sum(), found.sum()


def _check_table(keys, vals, counts, n_kmers: int, device) -> None:
    if keys.dtype != torch.int64 or vals.dtype != torch.int32:
        raise TypeError(f"keys must be int64 and vals int32, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 2 or keys.shape[1] != SLOTS or vals.shape != keys.shape:
        raise ValueError(f"keys and vals must be [n_buckets, {SLOTS}], got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    n_buckets = keys.shape[0]
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    if counts.dtype != torch.int32 or counts.shape != (n_kmers + 1,):
        raise ValueError(f"counts must be int32 [{n_kmers + 1}]")
    if {keys.device, vals.device, counts.device} != {device}:
        raise ValueError("codes, lengths, keys, vals and counts must be on one device")


def count_step(codes, lengths, keys, vals, counts, *, k: int, n_kmers: int):
    """One v1 counting step (ntsm_tpu/count/kernel.py:count_step_impl):
    every window of the batch hashed and counted into `counts` (IN PLACE),
    misses and invalid windows into its last slot.

    codes [B, L] uint8 with contiguous rows, lengths [B] int32, keys/vals
    from :func:`make_table_arrays` (a build_lookup table: in each bucket
    ascending vals, empty slots last), counts int32 [n_kmers + 1], all on
    one device.  Returns the batch's (n_valid, n_found) as device tensors
    (int64 from the plain version, int32 from the kernel)."""
    global launches_step
    check_codes(codes, lengths, k)
    _check_table(keys, vals, counts, n_kmers, codes.device)
    if codes.device.type == "cpu":
        h, valid = window_hashes_codes_plain(codes, lengths, k)
        return bucket_probe(h, valid, keys, vals, counts, n_kmers=n_kmers)
    if codes.device.type != "cuda":
        raise ValueError(f"count_step: unsupported device {codes.device}")
    for name, t in (("keys", keys), ("vals", vals), ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"count_step: {name} must be contiguous")
    if keys.data_ptr() % 16:
        raise ValueError("count_step: keys rows must be 16-byte aligned")
    lib = csrc.load()
    B, L = codes.shape
    diag = torch.zeros(2, dtype=torch.int32, device=codes.device)
    rc = lib.ntsm_count_step_v1(
        ctypes.c_void_p(codes.data_ptr()), codes.stride(0),
        ctypes.c_void_p(lengths.data_ptr()), B, L, k,
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(vals.data_ptr()), keys.shape[0],
        n_kmers, ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(diag.data_ptr()),
        csrc.stream_ptr(codes.device),
    )
    csrc.check(lib, rc, "count_step_v1")
    launches_step += 1
    return diag[0], diag[1]
