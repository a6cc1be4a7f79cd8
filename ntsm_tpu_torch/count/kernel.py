"""The v1 counting step: unpacked codes in, counts out
(counterpart of ntsm_tpu/count/kernel.py).

The v1 engine (count/engine.py:run_count_v1) uploads each batch as [B, L]
u8 codes (0..3 a base, >= 4 not one) and [B] int32 segment lengths, one
read segment a row.  :func:`count_step` runs kernel K2, the window hash from
codes (count/hash_kernel.py:window_hashes_codes, ``csrc/window_hash.cu``),
then :func:`bucket_probe`: one gather of the 8-slot bucket
``keys[h & (n_buckets - 1)]`` a window, the slot match, and a scatter-add
into the count vector, whose last slot absorbs misses.  The probe is plain
PyTorch on the device (in the JAX package it is XLA, outside any Pallas
kernel); a hand kernel for it waits for a measurement that calls for one.
"""

from __future__ import annotations

import numpy as np
import torch

from ntsm_tpu_torch.count.hash_kernel import window_hashes_codes
from ntsm_tpu_torch.count.kernel_v2 import window_hashes_codes_plain  # noqa: F401  (K2's plain version)


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


def count_step(codes, lengths, keys, vals, counts, *, k: int, n_kmers: int):
    """One v1 counting step (ntsm_tpu/count/kernel.py:count_step_impl):
    K2's window hash, then the bucket probe into `counts` (in place).

    codes [B, L] uint8, lengths [B] int32, keys/vals from
    :func:`make_table_arrays`, counts int32 [n_kmers + 1], all on one
    device.  Returns the batch's (n_valid, n_found) as device tensors."""
    h, valid = window_hashes_codes(codes, lengths, k)
    return bucket_probe(h, valid, keys, vals, counts, n_kmers=n_kmers)
