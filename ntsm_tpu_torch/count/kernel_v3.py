"""Site-table probe planes, the probe (K4) and the fused count step of the
count path (counterpart of ntsm_tpu/count/kernel_v3.py).

The table is bucketed open addressing (io/sites.build_lookup's layout):
``n_buckets`` rows of 8 slots, bucket = hash & (n_buckets - 1), with three
planes — a 1-byte fingerprint filter, the exact key and the k-mer index.
:func:`probe_and_count` is the plain PyTorch probe; :func:`probe_count`
launches ``csrc/probe_count.cu`` (K4) for CUDA tensors and runs the plain
probe for CPU tensors.  :func:`count_step_v3`, the step the v3 engine
calls once a batch, hashes a packed batch's windows and probes them in one
kernel, ``csrc/hash_probe_count.cu``; its plain version is the plain
window hash then the plain probe.  All of them verify EVERY fingerprint
candidate against the key plane, so unlike the JAX stage there is no
candidate budget, no overflow flag and no host recount tier.

Reference for the semantics: FingerPrint::insertCount
(src/FingerPrint.hpp:89-103) — one table probe per k-mer window and an
atomic increment on a match.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.core.hash import srl
from ntsm_tpu_torch.count.hash_kernel import check_packed
from ntsm_tpu_torch.count.kernel_v2 import window_hashes_packed
from ntsm_tpu_torch.io.sites import size_buckets

SLOTS = 8
EMPTY_KEY = -1  # io/sites.EMPTY_KEY (all ones) as int64 bits

launches = 0  # K4, probe_count
launches_step = 0  # the fused count step, count_step_v3


def fingerprint(rem: torch.Tensor) -> torch.Tensor:
    """8-bit nonzero fingerprint of the hash remainder h >> bbits: its low
    byte, clamped away from the 0 = empty-slot sentinel."""
    return torch.clamp(rem & 0xFF, min=1).to(torch.uint8)


class TableV3:
    """Device probe planes.

    fp    [n_buckets, 8] u8   fingerprint filter (0 = empty)
    keys  [n_buckets, 8] i64  exact hash bits (EMPTY_KEY = empty)
    vals  [n_buckets, 8] i32  k-mer index (n_kmers = empty)
    """

    def __init__(self, fp, keys, vals, n_buckets: int, bbits: int, n_kmers: int):
        self.fp = fp
        self.keys = keys
        self.vals = vals
        self.n_buckets = n_buckets
        self.slots = SLOTS
        self.bbits = bbits
        self.n_kmers = n_kmers

    @classmethod
    def from_hashes(cls, hashes: np.ndarray, device) -> "TableV3":
        """Build the planes on `device` from the [n] uint64 hash list.

        Port of ntsm_tpu/count/kernel_v3.py:_build_planes_device: a stable
        sort by bucket, slot = rank within the bucket's run, then three
        scatters.  Bucket sizing (the one data-dependent choice) is the
        host's io/sites.size_buckets, shared with build_lookup."""
        device = torch.device(device)
        n = int(hashes.shape[0])
        n_buckets = size_buckets(hashes, SLOTS)
        bbits = n_buckets.bit_length() - 1
        h = torch.from_numpy(np.ascontiguousarray(hashes).view(np.int64)).to(device)
        bucket = h & (n_buckets - 1)
        order = torch.argsort(bucket, stable=True)
        sb = bucket[order]
        idx = torch.arange(n, dtype=torch.int64, device=device)
        run_start = torch.ones(n, dtype=torch.bool, device=device)
        run_start[1:] = sb[1:] != sb[:-1]
        start_idx = torch.where(run_start, idx, 0)
        if n:
            start_idx = torch.cummax(start_idx, dim=0).values
        flat = sb * SLOTS + (idx - start_idx)
        hs = h[order]
        size = n_buckets * SLOTS
        keys = torch.full((size,), EMPTY_KEY, dtype=torch.int64, device=device)
        keys[flat] = hs
        vals = torch.full((size,), n, dtype=torch.int32, device=device)
        vals[flat] = order.to(torch.int32)
        fp = torch.zeros(size, dtype=torch.uint8, device=device)
        fp[flat] = fingerprint(srl(hs, bbits))
        return cls(
            fp.view(n_buckets, SLOTS), keys.view(n_buckets, SLOTS),
            vals.view(n_buckets, SLOTS), n_buckets, bbits, n,
        )

    @classmethod
    def from_numpy(cls, fp, keys, vals, n_buckets: int, bbits: int, device) -> "TableV3":
        """Planes given as arrays (e.g. the JAX package's ``np.asarray(tab.fp)``;
        uint64 keys are viewed as int64)."""
        keys = np.array(keys)  # a writable copy for torch.from_numpy
        if keys.dtype == np.uint64:
            keys = keys.view(np.int64)
        vals = np.array(vals, dtype=np.int32)
        # empty slots hold n_kmers, and size_buckets leaves at least half
        # of the slots empty
        n_kmers = int(vals.max(initial=0))
        return cls(
            torch.from_numpy(np.array(fp, dtype=np.uint8)).to(device),
            torch.from_numpy(keys).to(device),
            torch.from_numpy(vals).to(device),
            n_buckets, bbits, n_kmers,
        )


def probe_and_count(h, valid, fp_t, keys_t, vals_t, counts, *, n_buckets: int, bbits: int):
    """Plain exact probe: counts[kmer] += 1 for every valid window whose
    hash is in the table; returns diag [n_valid, n_cand, n_hits] int32.

    h/valid are [B, W] (int64 hash bits, bool).  counts is int32
    [n_kmers + 1] and is updated IN PLACE (the engine keeps one count
    vector on the device for the whole run); its last entry absorbs hits
    on an empty slot, exactly like the JAX stage's pad target."""
    bucket = h & (n_buckets - 1)
    q = fingerprint(srl(h, bbits))
    rows = fp_t[bucket]  # [B, W, 8] u8
    cand = (rows == q[..., None]).any(dim=-1) & valid
    ch = h[cand]
    cbucket = bucket[cand]
    ematch = keys_t[cbucket] == ch[:, None]  # [n_cand, 8]
    hit = ematch.any(dim=-1)
    slot = ematch.to(torch.int32).argmax(dim=-1)  # first matching slot
    kidx = vals_t[cbucket[hit], slot[hit]]
    counts.index_add_(0, kidx, torch.ones_like(kidx, dtype=counts.dtype))
    return torch.stack([
        valid.sum(), cand.sum(), hit.sum(),
    ]).to(torch.int32)


def _check_table(what: str, table: TableV3, counts: torch.Tensor, *tensors) -> torch.device:
    """The device of a probe's tensors, after the checks both probe
    wrappers share: counts int32 [>= n_kmers + 1], one device; on the card
    contiguous planes and counts, and 8-byte aligned fingerprint rows."""
    if counts.dtype != torch.int32 or counts.dim() != 1 or counts.shape[0] < table.n_kmers + 1:
        raise ValueError(f"counts must be int32 [>= {table.n_kmers + 1}]")
    devices = {t.device for t in (*tensors, counts, table.fp, table.keys, table.vals)}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {devices}")
    device = counts.device
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for name, t in (("counts", counts), ("fp", table.fp), ("keys", table.keys),
                    ("vals", table.vals)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if table.fp.data_ptr() % 8:
        raise ValueError(f"{what}: fp rows must be 8-byte aligned")
    return device


def probe_count(h: torch.Tensor, valid: torch.Tensor, table: TableV3, counts: torch.Tensor):
    """Kernel 2 wrapper: the exact probe of a [B, W] window batch into
    `counts` (in place); returns the batch's diag [3] int32 on its device.

    CPU tensors run :func:`probe_and_count`; CUDA tensors launch
    ``csrc/probe_count.cu`` or raise."""
    global launches
    if h.dtype != torch.int64 or valid.dtype != torch.bool or h.shape != valid.shape:
        raise TypeError("h must be int64 and valid bool, of one shape")
    device = _check_table("probe_count", table, counts, h, valid)
    if device.type == "cpu":
        return probe_and_count(
            h, valid, table.fp, table.keys, table.vals, counts,
            n_buckets=table.n_buckets, bbits=table.bbits,
        )
    for name, t in (("h", h), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"probe_count: {name} must be contiguous")
    lib = csrc.load()
    diag = torch.zeros(3, dtype=torch.int32, device=device)
    rc = lib.ntsm_probe_count(
        ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(valid.data_ptr()), h.numel(),
        ctypes.c_void_p(table.fp.data_ptr()), ctypes.c_void_p(table.keys.data_ptr()),
        ctypes.c_void_p(table.vals.data_ptr()), table.n_buckets, table.bbits,
        ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(diag.data_ptr()),
        csrc.stream_ptr(device),
    )
    csrc.check(lib, rc, "probe_count")
    launches += 1
    return diag


def count_step_v3(packed: torch.Tensor, vbits: torch.Tensor, table: TableV3,
                  counts: torch.Tensor, k: int, L: int) -> torch.Tensor:
    """One counting step of the v3 engine (ntsm_tpu/count/kernel_v3.py:
    count_step_v3): every window of a packed batch hashed and probed, hits
    added into `counts` IN PLACE; returns the batch's diag [n_valid,
    n_cand, n_hits] int32 on its device.

    packed [B, L/4] and vbits [B, L/8] are uint8 with contiguous rows, as
    for hash_kernel.window_hashes (column slices of one fused upload).  CPU
    tensors run the plain window hash then the plain probe; CUDA tensors
    launch ``csrc/hash_probe_count.cu`` or raise."""
    global launches_step
    check_packed(packed, vbits, k, L)
    device = _check_table("count_step_v3", table, counts, packed, vbits)
    if device.type == "cpu":
        h, valid = window_hashes_packed(packed, vbits, k, L)
        return probe_and_count(
            h, valid, table.fp, table.keys, table.vals, counts,
            n_buckets=table.n_buckets, bbits=table.bbits,
        )
    lib = csrc.load()
    diag = torch.zeros(3, dtype=torch.int32, device=device)
    rc = lib.ntsm_count_step(
        ctypes.c_void_p(packed.data_ptr()), packed.stride(0),
        ctypes.c_void_p(vbits.data_ptr()), vbits.stride(0), packed.shape[0], L, k,
        ctypes.c_void_p(table.fp.data_ptr()), ctypes.c_void_p(table.keys.data_ptr()),
        ctypes.c_void_p(table.vals.data_ptr()), table.n_buckets, table.bbits,
        ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(diag.data_ptr()),
        csrc.stream_ptr(device),
    )
    csrc.check(lib, rc, "count_step")
    launches_step += 1
    return diag

