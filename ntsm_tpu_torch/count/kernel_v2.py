"""Packed batch layout, the plain window-hash stage and the v2 count step
(counterpart of ntsm_tpu/count/kernel_v2.py).

Reads travel to the device 2-bit packed (4 bases/byte) with one validity
bit per base: 3L/8 bytes per row instead of L.  The plain PyTorch window
hashes here, from packed bases (K1's) and from unpacked codes (K2's), are
the references that the kernels (count/hash_kernel.py, csrc/window_hash.cu)
are held to, and what their wrappers run for CPU tensors.

The v2 step (:func:`count_step_v2`, the v2 engine's, count/engine.py:
run_count_v2) hashes a packed batch's windows, looks each valid one up in a
bucket of SLOTS_V2 = 16 keys and returns the hit ids ``(bucket << 4 | slot)
+ 1`` in descending order, zero-padded, with the batch's hit and
valid-window counts; the host turns the ids into counts through the vals
plane (:func:`hits_to_kmer_counts`).  Its table is a :class:`TableV2`
(:func:`make_table_v2`), which also holds the keys as the kernel reads them
and the step's scratch.  On the card the step is two kernels of
``csrc/hash_bucket_hits.cu``, the lookup and the ordering stage; its plain
version is :func:`count_step_v2_plain`, the ordering stage's
:func:`order_hits_plain`.  One difference from the JAX step, on purpose: a
match on an empty slot (key EMPTY_KEY, val n_kmers) is a miss.  At k = 32
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
SECTOR_SLOTS = 4  # keys a 32-byte sector, the unit the lookup reads
EMPTY_KEY = -1  # io/sites.EMPTY_KEY (all ones) as int64 bits
LAYOUTS = ("planes", "rows")  # TableV2.sectors: the kernel's key layouts

launches_step = 0  # the v2 step's lookup kernel (count_step_v2, lookup_launch)
launches_order = 0  # its ordering stage (count_step_v2, order_launch)


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


class TableV2:
    """The v2 step's table on one device.

    keys     [n_buckets, 16] int64  the uint64 hash bits, EMPTY_KEY where
             empty (io/sites.build_lookup's rows: what the plain version and
             the JAX step read)
    vals     [n_buckets, 16] int32  k-mer index, n_kmers where empty
    sectors  the keys as the lookup kernel reads them, 32-byte sectors of 4
             slots, sector p of bucket b at element b * bucket_stride + p *
             plane_stride: layout "planes" (the default) is [4, n_buckets, 4],
             plane p holding slots 4p .. 4p + 3 of every bucket, so that the
             first plane, which nearly every lookup needs, is a quarter of
             the keys; "rows" is the keys themselves.

    The lookup stops at a bucket's first empty slot, so the table must fill
    each bucket's slots from 0 up, with every key in its own bucket (h &
    (n_buckets - 1)), as build_lookup does; the constructor checks it.  The
    step's scratch (the unsorted hit list and the counters the ordering
    stage sets back to zero) is made at the first step on the card; the
    steps on one table run one after another on a stream, as the engine's
    do."""

    def __init__(self, keys, vals, n_kmers: int, layout: str = "planes"):
        _check_table_v2(keys, vals, n_kmers)
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        n_buckets = keys.shape[0]
        empty = (keys == EMPTY_KEY) & (vals == n_kmers)
        if bool((empty[:, :-1] & ~empty[:, 1:]).any()):
            raise ValueError("a bucket holds a key after an empty slot")
        own = (keys & (n_buckets - 1)) == torch.arange(n_buckets, device=keys.device)[:, None]
        if bool((~empty & ~own).any()):
            raise ValueError("a key lies outside its bucket h & (n_buckets - 1)")
        self.keys, self.vals, self.n_kmers = keys, vals, n_kmers
        self.n_buckets = n_buckets
        if layout == "planes":
            self.sectors = keys.view(n_buckets, SLOTS_V2 // SECTOR_SLOTS, SECTOR_SLOTS) \
                .transpose(0, 1).contiguous()
            self.strides = (SECTOR_SLOTS, SECTOR_SLOTS * n_buckets)
        else:
            self.sectors = keys
            self.strides = (SLOTS_V2, SECTOR_SLOTS)
        if self.sectors.data_ptr() % 16:
            raise ValueError("the key sectors must be 16-byte aligned")
        self._ids = self._counters = None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def scratch(self, n_ids: int, counter_bytes: int):
        """(ids [>= n_ids] int32, counters [counter_bytes] uint8, zero at
        first): the step's scratch on the card."""
        if self._counters is None:
            self._counters = torch.zeros(counter_bytes, dtype=torch.uint8, device=self.device)
        if self._ids is None or self._ids.numel() < n_ids:
            self._ids = torch.empty(max(n_ids, 1), dtype=torch.int32, device=self.device)
        return self._ids, self._counters


def make_table_v2(lookup, n_kmers: int, device="cpu", layout: str = "planes") -> TableV2:
    """The :class:`TableV2` on `device` of the host table of
    io/sites.build_lookup(hashes, slots=SLOTS_V2), n_kmers = hashes.size.
    The JAX step takes the keys alone; the vals tell an empty slot from the
    site k-mer whose hash is all ones."""
    keys = torch.from_numpy(np.ascontiguousarray(lookup.keys).view(np.int64)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(lookup.vals, dtype=np.int32)).to(device)
    return TableV2(keys, vals, n_kmers, layout)


def _check_table_v2(keys, vals, n_kmers: int) -> None:
    if keys.dtype != torch.int64 or vals.dtype != torch.int32:
        raise TypeError(f"keys must be int64 and vals int32, got {keys.dtype}, {vals.dtype}")
    if keys.dim() != 2 or keys.shape[1] != SLOTS_V2 or vals.shape != keys.shape:
        raise ValueError(f"keys and vals must be [n_buckets, {SLOTS_V2}], got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}")
    n_buckets = keys.shape[0]
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    if n_buckets * SLOTS_V2 >= 1 << 31:
        raise ValueError(f"{n_buckets} buckets: a hit id (bucket << 4 | slot) + 1 "
                         "would not fit int32")
    if n_kmers < 0:
        raise ValueError(f"n_kmers must be >= 0, got {n_kmers}")
    if keys.device != vals.device:
        raise ValueError("keys and vals must be on one device")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")


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


def count_step_v2(packed, vbits, table: TableV2, *, k: int, L: int):
    """One v2 step: (top [min(TOPK, B W)] int32, the hit ids (bucket << 4 |
    slot) + 1 in descending order and zero-padded; n_found, n_valid: int64
    0-d tensors), on the inputs' device.

    packed [B, L/4] and vbits [B, L/8] are uint8 with contiguous rows (they
    may be column slices of one fused upload), `table` a :class:`TableV2` on
    their device.  CPU tensors run :func:`count_step_v2_plain`; CUDA tensors
    launch the two kernels of ``csrc/hash_bucket_hits.cu`` or raise: the
    lookup (:func:`lookup_launch`), which stores the first min(n_found,
    TOPK) hits it finds, and the ordering stage (:func:`order_launch`),
    which sorts them, so that `top` equals the plain version's whenever
    n_found <= TOPK; past that it holds TOPK of the hits, not the largest,
    and the engine recounts the batch on the host without reading it, as
    the JAX engine does."""
    # count/hash_kernel.py imports this module
    from ntsm_tpu_torch.count.hash_kernel import check_packed

    check_packed(packed, vbits, k, L)
    if table.device != packed.device:
        raise ValueError("packed, vbits and the table must be on one device")
    if packed.device.type == "cpu":
        return count_step_v2_plain(packed, vbits, table.keys, table.vals, k=k, L=L,
                                   n_kmers=table.n_kmers)
    if packed.device.type != "cuda":
        raise ValueError(f"count_step_v2: unsupported device {packed.device}")
    cap = min(TOPK, packed.shape[0] * (L - k + 1))
    lookup_launch(packed, vbits, table, k=k, L=L, cap=cap)
    return order_launch(table, cap)


def _list_stride(cap: int) -> int:
    """The stride of the bins' hit lists in the ids scratch: cap rounded up
    to 16 bytes (csrc/hash_bucket_hits.cu:list_stride)."""
    return (cap + 3) // 4 * 4


def _card_scratch(table: TableV2, cap: int):
    if table.device.type != "cuda":
        raise ValueError(f"the v2 kernels take CUDA tensors, not {table.device}")
    lib = csrc.load()
    n_ids = lib.ntsm_v2_bins() * _list_stride(cap)
    return (lib, *table.scratch(n_ids, lib.ntsm_v2_counter_bytes()))


def lookup_launch(packed, vbits, table: TableV2, *, k: int, L: int, cap: int) -> None:
    """The step's first kernel (card only; count_step_v2 checks the
    inputs): the ids of the batch's first `cap` hits into the table's
    scratch, each in its bin's list (the ordering stage's bins), with
    n_found, n_valid and the bins' counts; :func:`order_launch` reads them
    and sets the counts back to zero."""
    global launches_step
    lib, ids, counters = _card_scratch(table, cap)
    rc = lib.ntsm_v2_lookup(
        ctypes.c_void_p(packed.data_ptr()), packed.stride(0),
        ctypes.c_void_p(vbits.data_ptr()), vbits.stride(0), packed.shape[0], L, k,
        ctypes.c_void_p(table.sectors.data_ptr()), *table.strides,
        ctypes.c_void_p(table.vals.data_ptr()), table.n_buckets, table.n_kmers,
        ctypes.c_void_p(ids.data_ptr()), cap, ctypes.c_void_p(counters.data_ptr()),
        csrc.stream_ptr(packed.device),
    )
    csrc.check(lib, rc, "count_step_v2 (lookup)")
    launches_step += 1


def order_launch(table: TableV2, cap: int):
    """The step's second kernel (card only), after :func:`lookup_launch`:
    (top [cap] int32, n_found, n_valid), the stored ids sorted descending
    and zero-padded, as :func:`order_hits_plain` orders them."""
    global launches_order
    lib, ids, counters = _card_scratch(table, cap)
    top = torch.empty(cap, dtype=torch.int32, device=table.device)
    out = torch.empty(2, dtype=torch.int64, device=table.device)
    rc = lib.ntsm_v2_order(ctypes.c_void_p(ids.data_ptr()), cap,
                           ctypes.c_void_p(counters.data_ptr()), table.n_buckets,
                           ctypes.c_void_p(top.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                           csrc.stream_ptr(table.device))
    if rc != 0:
        counters.zero_()  # the lookup's counts, which this launch would have cleared
    csrc.check(lib, rc, "count_step_v2 (ordering stage)")
    launches_order += 1
    return top, out[0], out[1]


def stored_hits(table: TableV2, cap: int) -> torch.Tensor:
    """The ids :func:`lookup_launch` stored, its bins' lists one after
    another (card only, between the two launches; it waits for the card).
    The counters are csrc/hash_bucket_hits.cu's: totals [2] u64, then the
    bins' counts [n_bins] u32."""
    lib, ids, counters = _card_scratch(table, cap)
    n_bins, stride = lib.ntsm_v2_bins(), _list_stride(cap)
    counts = counters[16:16 + 4 * n_bins].view(torch.int32).tolist()
    return torch.cat([ids[b * stride: b * stride + c] for b, c in enumerate(counts)])


def order_hits_plain(ids: torch.Tensor, n_found: int, cap: int) -> torch.Tensor:
    """The ordering stage in plain PyTorch: [cap] int32, the first
    min(n_found, cap) of the unsorted hit ids in descending order, then
    zeros."""
    n = min(int(n_found), cap)
    top = torch.zeros(cap, dtype=torch.int32, device=ids.device)
    top[:n] = torch.sort(ids[:n], descending=True).values
    return top


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
