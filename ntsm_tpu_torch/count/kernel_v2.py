"""Packed batch layout, the plain window-hash stage and the v2 count step
(counterpart of ntsm_tpu/count/kernel_v2.py).

Reads travel to the device 2-bit packed (4 bases/byte) with one validity
bit per base: 3L/8 bytes per row instead of L.  The plain PyTorch window
hashes here, from packed bases (K1's) and from unpacked codes (K2's), are
the references that the kernels (count/hash_kernel.py, csrc/window_hash.cu)
are held to, and what their wrappers run for CPU tensors.

The v2 step (:func:`count_step_v2`, the v2 engine's, count/engine.py:
run_count_v2) hashes a packed batch's windows, looks each valid one up in a
bucket of SLOTS_V2 = 16 keys (one 128-byte row) and returns the hit ids
``(bucket << 4 | slot) + 1`` in descending order, zero-padded, with the
batch's hit and valid-window counts; the host turns the ids into counts
through the vals plane (:func:`hits_to_kmer_counts`).  On the card it is
one kernel, ``csrc/hash_bucket_hits.cu``; its plain version is
:func:`count_step_v2_plain`.  One difference from the JAX step, on purpose:
a match on an empty slot (key EMPTY_KEY, val n_kmers) is a miss.  At k = 32
the one canonical 32-mer whose hash is all ones matches every empty slot,
and the JAX step counts it as found, after which its hits_to_kmer_counts
indexes counts[n_kmers] and raises IndexError; here it is counted as
``--engine golden`` counts it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.core.hash import hash64_torch, unsigned_key

TOPK = 65536  # hit ids a v2 step returns at most (ntsm_tpu/count/kernel_v2.py)
SLOTS_V2 = 16  # keys a bucket of the v2 table: one 128-byte row
EMPTY_KEY = -1  # io/sites.EMPTY_KEY (all ones) as int64 bits

launches_step = 0  # the v2 count step, count_step_v2


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


def make_table_v2(lookup, device="cpu"):
    """(keys [n_buckets, SLOTS_V2] int64 hash bits, vals [n_buckets,
    SLOTS_V2] int32 k-mer index, n_kmers where empty) on `device`, from the
    host table of io/sites.build_lookup(hashes, slots=SLOTS_V2).  The JAX
    step takes the keys alone; the vals tell an empty slot from the site
    k-mer whose hash is all ones."""
    keys = torch.from_numpy(np.ascontiguousarray(lookup.keys).view(np.int64)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(lookup.vals, dtype=np.int32)).to(device)
    return keys, vals


def _check_table_v2(keys, vals, n_kmers: int, device) -> None:
    if keys.dtype != torch.int64 or vals.dtype != torch.int32:
        raise TypeError(f"keys must be int64 and vals int32, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 2 or keys.shape[1] != SLOTS_V2 or vals.shape != keys.shape:
        raise ValueError(f"keys and vals must be [n_buckets, {SLOTS_V2}], got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    n_buckets = keys.shape[0]
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    if n_buckets * SLOTS_V2 > 1 << 31:
        raise ValueError(f"{n_buckets} buckets: a hit id (bucket << 4 | slot) + 1 "
                         "would not fit int32")
    if n_kmers < 0:
        raise ValueError(f"n_kmers must be >= 0, got {n_kmers}")
    if keys.device != device or vals.device != device:
        raise ValueError("packed, vbits, keys and vals must be on one device")


def count_step_v2_plain(packed, vbits, keys, vals, *, k: int, L: int, n_kmers: int):
    """The v2 step in plain PyTorch (ntsm_tpu/count/kernel_v2.py:
    count_step_v2): the window hashes, a gather of each window's bucket
    row, the lowest matching slot that is not empty, then torch.topk of the
    [B W] hit ids.  Returns (top [min(TOPK, B W)] int32, n_found int64,
    n_valid int64) on the inputs' device."""
    h, valid = window_hashes_packed(packed, vbits, k, L)
    n_buckets, slots = keys.shape
    sbits = (slots - 1).bit_length()
    bucket = h & (n_buckets - 1)
    empty = (keys == EMPTY_KEY) & (vals == n_kmers)
    match = (keys[bucket] == h[..., None]) & ~empty[bucket]
    iota = torch.arange(slots, dtype=torch.int32, device=h.device)
    slot = torch.where(match, iota, slots).amin(dim=-1)
    found = match.any(dim=-1) & valid
    hit_id = torch.where(found, (bucket.to(torch.int32) << sbits) | slot, -1) + 1
    flat = hit_id.reshape(-1)
    top = torch.topk(flat, min(TOPK, flat.numel())).values
    return top, found.sum(), valid.sum()


def count_step_v2(packed, vbits, keys, vals, *, k: int, L: int, n_kmers: int):
    """One v2 step: (top [min(TOPK, B W)] int32, the hit ids (bucket << 4 |
    slot) + 1 in descending order and zero-padded; n_found, n_valid: int64
    0-d tensors), on the inputs' device.

    packed [B, L/4] and vbits [B, L/8] are uint8 with contiguous rows (they
    may be column slices of one fused upload), keys/vals from
    :func:`make_table_v2`.  CPU tensors run :func:`count_step_v2_plain`;
    CUDA tensors launch ``csrc/hash_bucket_hits.cu`` or raise.  The kernel
    stores the first min(n_found, TOPK) hits it finds, and this wrapper
    sorts them (torch.sort of the TOPK ids, on the card), so that `top`
    equals the plain version's whenever n_found <= TOPK; past that it holds
    TOPK of the hits, not the largest, and the engine recounts the batch on
    the host without reading it, as the JAX engine does."""
    global launches_step
    # count/hash_kernel.py imports this module
    from ntsm_tpu_torch.count.hash_kernel import check_packed

    check_packed(packed, vbits, k, L)
    _check_table_v2(keys, vals, n_kmers, packed.device)
    if packed.device.type == "cpu":
        return count_step_v2_plain(packed, vbits, keys, vals, k=k, L=L, n_kmers=n_kmers)
    if packed.device.type != "cuda":
        raise ValueError(f"count_step_v2: unsupported device {packed.device}")
    for name, t in (("keys", keys), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"count_step_v2: {name} must be contiguous")
    if keys.data_ptr() % 16:
        raise ValueError("count_step_v2: keys rows must be 16-byte aligned")
    lib = csrc.load()
    B = packed.shape[0]
    cap = min(TOPK, B * (L - k + 1))
    ids = torch.zeros(cap, dtype=torch.int32, device=packed.device)
    totals = torch.zeros(2, dtype=torch.int64, device=packed.device)
    rc = lib.ntsm_count_step_v2(
        ctypes.c_void_p(packed.data_ptr()), packed.stride(0),
        ctypes.c_void_p(vbits.data_ptr()), vbits.stride(0), B, L, k,
        ctypes.c_void_p(keys.data_ptr()), ctypes.c_void_p(vals.data_ptr()), keys.shape[0],
        n_kmers, ctypes.c_void_p(ids.data_ptr()), cap, ctypes.c_void_p(totals.data_ptr()),
        csrc.stream_ptr(packed.device),
    )
    csrc.check(lib, rc, "count_step_v2")
    launches_step += 1
    return torch.sort(ids, descending=True).values, totals[0], totals[1]


def hits_to_kmer_counts(hit_ids: np.ndarray, lookup, n_kmers: int, counts: np.ndarray) -> int:
    """Host accumulation (ntsm_tpu/count/kernel_v2.py:hits_to_kmer_counts):
    counts[vals[bucket, slot]] += 1 for every nonzero hit id, IN PLACE;
    returns how many there were."""
    ids = hit_ids[hit_ids > 0] - 1
    if ids.size == 0:
        return 0
    sbits = (lookup.slots - 1).bit_length()
    kidx = lookup.vals[ids >> sbits, ids & (lookup.slots - 1)]
    np.add.at(counts, kidx, 1)
    return ids.size
