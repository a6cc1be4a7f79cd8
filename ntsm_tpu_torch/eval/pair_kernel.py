"""The pair statistics of ``eval`` all-vs-all and ``eval -p`` (counterpart
of ntsm_tpu/eval/pallas_joint.py and the pair math of
ntsm_tpu/eval/kernels.py).

For every pair (i, j), i < j, of a block of rows [r0, r1) against the whole
cohort, :func:`pair_stats` gives

* ``ints`` [5, P] int32: n, ibs0, sharedHets, hets1, hets2 over the pair's
  valid sites (a site is valid when both samples have an allele count above
  ``mc``);
* ``sums`` [2, P] float64: ``joint`` (sumLogPJoint,
  src/CompareCounts.hpp:1013-1033) and ``ss`` (sumLogPSingle of both
  samples, :968-991) over the same sites;

with P the block's pairs in ``np.triu_indices`` order.  On the TPU these
are K3 (``_joint_frac_kernel``, the fraction jfrac) plus the XLA stages
around it (the integer part jint, the compensated s1 sums, the indicator
tallies); ``joint`` here equals the TPU engine's ``jint - jfrac``.

:func:`pair_stats` is the wrapper: for CPU tensors it runs
:func:`pair_stats_plain`, for CUDA tensors it launches
``csrc/pair_stats.cu`` or raises; it never falls back.  ``launches`` counts
the kernel launches.

:func:`pair_block_stats` gives the same ``(ints, sums)`` for a list of
candidate pairs ``(ii[p], jj[p])`` of ``eval -p``, in the list's order (the
TPU's K5, ``eval/kernels.py:_pair_block_stats_v2``): for CPU tensors it
runs :func:`pair_block_stats_plain`, for CUDA tensors it launches
``csrc/pair_block_stats.cu`` or raises.  ``launches_block`` counts its
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc

launches = 0
launches_block = 0

N_INTS = 5  # n, ibs0, shared_hets, hets1, hets2
# csrc/pair_stats.cu: a block of TILE x TILE threads, each holding RI x RJ
# pairs; index m of MICRO_TILES is the kernel's `micro` argument
TILE = 16
MICRO_TILES = ((1, 1), (2, 2))
# threads an SM a block's launch should give (micro_tile): on the H100 (132
# SMs) 2x2 then runs from 4 * 132 * 1024 = 540,672 pairs a block, and 1x1 was
# the faster at 302,736 pairs, 2x2 at 933,661 (experiments/exp_pair_stats.py)
THREADS_PER_SM = 1024
# elements of a [T, N, C] broadcast chunk in the plain version: bounds its
# temporaries (a few f64 planes of this size) on either device
PLAIN_CHUNK = {"cpu": 1 << 22, "cuda": 1 << 25}


def n_block_pairs(n_samples: int, r0: int, r1: int) -> int:
    """Pairs (i, j > i) with i in [r0, r1) of an n_samples cohort."""
    return (r1 - r0) * (n_samples - 1) - (r1 * (r1 - 1) - r0 * (r0 - 1)) // 2


def s_single_plane(a: torch.Tensor, b: torch.Tensor, mc: int) -> torch.Tensor:
    """[N, L] f64 per-site single-sample terms (computeSumLogPSingle,
    src/CompareCounts.hpp:968-991) on the planes' device, with the
    arithmetic of eval/model.py:CountData.s_single (a*fa + b*fb, each
    step its own rounding).  Zero counts give 0, so pad columns add
    nothing."""
    af = a.double()
    bf = b.double()
    den = torch.clamp(af + bf, min=1.0)
    zero = torch.zeros((), dtype=torch.float64, device=a.device)
    fa = torch.where(a > mc, af / den, zero)
    fb = torch.where(b > mc, bf / den, zero)
    return af * fa + bf * fb


def _site_sums(ai, bi, si, aj, bj, sj, mc: int):
    """The per-site step of csrc/pair_site.cuh on int64 counts and f64
    s_single values that broadcast against each other, summed over the
    last axis: (ints [5, ...] int64, sums [2, ...] float64)."""
    ci = (ai > mc).long() | ((bi > mc).long() << 1)  # 3 het, 1/2 hom, 0 miss
    cj = (aj > mc).long() | ((bj > mc).long() << 1)
    v = (ci != 0) & (cj != 0)
    ints = torch.stack([v.sum(-1), (v & ((ci ^ cj) == 3)).sum(-1), ((ci & cj) == 3).sum(-1),
                        (v & (ci == 3)).sum(-1), (v & (cj == 3)).sum(-1)])
    aa, bb = ai + aj, bi + bj
    aad, bbd = aa.double(), bb.double()
    den = aad + bbd
    dsafe = torch.where(den > 0, den, torch.ones_like(den))
    zero = torch.zeros((), dtype=torch.float64, device=ai.device)
    fa = torch.where(aa > mc, aad / dsafe, zero)
    fb = torch.where(bb > mc, bbd / dsafe, zero)
    joint = torch.where(v, aad * fa + bbd * fb, zero).sum(-1)
    return ints, torch.stack([joint, torch.where(v, si + sj, zero).sum(-1)])


def pair_stats_plain(a, b, s, r0: int, r1: int, mc: int, n_sites: int):
    """The plain PyTorch version, in int64 / f64 over [T, N, C] chunks:
    (ints [5, P] int32, sums [2, P] float64).

    Only the first ``n_sites`` columns count: pad columns beyond them stay
    invalid for any ``mc`` (their zero counts pass ``> mc`` when mc < 0;
    the JAX engine's n_valid mask, eval/kernels.py:94-103)."""
    N = a.shape[0]
    dev = a.device
    a = a[:, :n_sites].long()
    b = b[:, :n_sites].long()
    s = s[:, :n_sites]
    budget = PLAIN_CHUNK.get(dev.type, PLAIN_CHUNK["cpu"])
    T = max(1, min(r1 - r0, budget // max(1, N)))
    ints_out, sums_out = [], []
    cols = torch.arange(N, device=dev)
    for t0 in range(r0, r1, T):
        t1 = min(t0 + T, r1)
        C = max(1, budget // ((t1 - t0) * N))
        acc_i = torch.zeros((N_INTS, t1 - t0, N), dtype=torch.int64, device=dev)
        acc_f = torch.zeros((2, t1 - t0, N), dtype=torch.float64, device=dev)
        for c0 in range(0, n_sites, C):
            sl = slice(c0, min(c0 + C, n_sites))
            ints, sums = _site_sums(a[t0:t1, None, sl], b[t0:t1, None, sl], s[t0:t1, None, sl],
                                    a[None, :, sl], b[None, :, sl], s[None, :, sl], mc)
            acc_i += ints
            acc_f += sums
        upper = cols[None, :] > torch.arange(t0, t1, device=dev)[:, None]
        ints_out.append(acc_i[:, upper].to(torch.int32))
        sums_out.append(acc_f[:, upper])
    if not ints_out:
        return (torch.zeros((N_INTS, 0), dtype=torch.int32, device=dev),
                torch.zeros((2, 0), dtype=torch.float64, device=dev))
    return torch.cat(ints_out, dim=1), torch.cat(sums_out, dim=1)


def _check(a, b, s, r0: int, r1: int, n_sites: int) -> None:
    if a.dim() != 2 or a.shape != b.shape or a.shape != s.shape:
        raise ValueError(f"a, b, s must be [N, L] of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(s.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or s.dtype != torch.float64:
        raise TypeError(f"a, b must be int32 and s float64, got {a.dtype}, {b.dtype}, {s.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and s.is_contiguous()):
        raise ValueError("a, b, s must be contiguous")
    if not (a.device == b.device == s.device):
        raise ValueError("a, b, s must be on one device")
    N, L = a.shape
    if not 0 <= r0 <= r1 <= N:
        raise ValueError(f"row block [{r0}, {r1}) outside [0, {N})")
    if not 0 <= n_sites <= L:
        raise ValueError(f"n_sites {n_sites} outside [0, {L}]")
    if N >= 2**31:
        raise ValueError(f"{N} samples exceed the kernel's int32 indices")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def micro_tile(n_pairs: int, n_sms: int) -> int:
    """The kernel instance for a block of n_pairs pairs on a card of n_sms
    SMs: an index into MICRO_TILES, the largest micro-tile that still gives
    THREADS_PER_SM threads an SM (one a micro-tile), so that a small block
    keeps every SM busy and a large one reuses each staged value most."""
    for m in range(len(MICRO_TILES) - 1, 0, -1):
        ri, rj = MICRO_TILES[m]
        if n_pairs >= n_sms * THREADS_PER_SM * ri * rj:
            return m
    return 0


def live_tiles(n_samples: int, r0: int, r1: int, ti: int, tj: int) -> np.ndarray:
    """[T, 2] int32 (row tile, column tile) of the ti x tj tiles of pairs
    (rows r0 + ti * t.., columns tj * u..) of the row block [r0, r1) that
    hold a pair j > i: the kernel's grid, row tiles in order.  Row tile t
    (first row i0) is live from column tile (i0 + 1) // tj on, the first
    whose last column exceeds i0, if i0 < n_samples - 1."""
    i0 = r0 + ti * np.arange(-(-(r1 - r0) // ti), dtype=np.int64)
    i0 = i0[i0 < n_samples - 1]
    first = (i0 + 1) // tj
    count = -(-n_samples // tj) - first
    rows = np.repeat((i0 - r0) // ti, count)
    starts = np.cumsum(count) - count
    cols = np.repeat(first, count) + np.arange(rows.size) - np.repeat(starts, count)
    return np.stack([rows, cols], axis=1).astype(np.int32)


def pair_stats(a, b, s, r0: int, r1: int, mc: int, n_sites: int):
    """(ints [5, P] int32, sums [2, P] float64) for the pairs of rows
    [r0, r1): a, b are [N, L] int32 allele count planes, s is
    :func:`s_single_plane` of them, and only sites [0, n_sites) count."""
    global launches
    _check(a, b, s, r0, r1, n_sites)
    if a.device.type == "cpu":
        return pair_stats_plain(a, b, s, r0, r1, mc, n_sites)
    if a.device.type != "cuda":
        raise ValueError(f"pair_stats: unsupported device {a.device}")
    lib = csrc.load()
    N, L = a.shape
    P = n_block_pairs(N, r0, r1)
    ints = torch.empty((N_INTS, P), dtype=torch.int32, device=a.device)
    sums = torch.empty((2, P), dtype=torch.float64, device=a.device)
    if P == 0:
        return ints, sums
    m = micro_tile(P, sm_count(a.device))
    ri, rj = MICRO_TILES[m]
    # pinned, then an asynchronous copy: the upload never waits for the card
    tiles = torch.from_numpy(live_tiles(N, r0, r1, TILE * ri, TILE * rj)).pin_memory()
    tiles = tiles.to(a.device, non_blocking=True)
    rc = lib.ntsm_pair_stats(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(s.data_ptr()), L, N, n_sites, r0, r1, int(mc),
        ctypes.c_void_p(tiles.data_ptr()), tiles.shape[0], m,
        ctypes.c_void_p(ints.data_ptr()), ctypes.c_void_p(sums.data_ptr()), P,
        csrc.stream_ptr(a.device),
    )
    csrc.check(lib, rc, "pair_stats")
    launches += 1
    return ints, sums


def pair_block_stats_plain(a, b, s, ii, jj, mc: int, n_sites: int):
    """The plain PyTorch version of :func:`pair_block_stats`, in int64 /
    f64 over chunks of pairs: (ints [5, P] int32, sums [2, P] float64).
    Only the first ``n_sites`` columns count, as in :func:`pair_stats_plain`."""
    dev = a.device
    P = ii.shape[0]
    a = a[:, :n_sites]
    b = b[:, :n_sites]
    s = s[:, :n_sites]
    ints = torch.zeros((N_INTS, P), dtype=torch.int64, device=dev)
    sums = torch.zeros((2, P), dtype=torch.float64, device=dev)
    budget = PLAIN_CHUNK.get(dev.type, PLAIN_CHUNK["cpu"])
    T = max(1, budget // max(1, n_sites))
    for p0 in range(0, P, T):
        sl = slice(p0, min(p0 + T, P))
        i, j = ii[sl].long(), jj[sl].long()
        ints[:, sl], sums[:, sl] = _site_sums(a[i].long(), b[i].long(), s[i],
                                              a[j].long(), b[j].long(), s[j], mc)
    return ints.to(torch.int32), sums


def _check_pairs(a, ii, jj) -> None:
    if ii.dim() != 1 or ii.shape != jj.shape:
        raise ValueError(f"ii, jj must be [P] of one length, got "
                         f"{tuple(ii.shape)}, {tuple(jj.shape)}")
    if ii.dtype != torch.int32 or jj.dtype != torch.int32:
        raise TypeError(f"ii, jj must be int32, got {ii.dtype}, {jj.dtype}")
    if not (ii.is_contiguous() and jj.is_contiguous()):
        raise ValueError("ii, jj must be contiguous")
    if not (ii.device == jj.device == a.device):
        raise ValueError("ii, jj must be on the planes' device")
    if ii.numel() == 0:
        return
    N = a.shape[0]
    lo = int(torch.minimum(ii.min(), jj.min()))
    hi = int(torch.maximum(ii.max(), jj.max()))
    if lo < 0 or hi >= N:
        raise ValueError(f"pair indices outside [0, {N}): [{lo}, {hi}]")
    if bool((ii == jj).any()):
        raise ValueError("a pair (i, i) is no candidate: ii == jj")


def pair_block_stats(a, b, s, ii, jj, mc: int, n_sites: int):
    """(ints [5, P] int32, sums [2, P] float64) for the candidate pairs
    (ii[p], jj[p]), in that order: a, b are [N, L] int32 allele count
    planes, s is :func:`s_single_plane` of them, ii and jj are [P] int32
    sample indices in [0, N) with ii != jj, and only sites [0, n_sites)
    count."""
    global launches_block
    N = a.shape[0]
    _check(a, b, s, 0, N, n_sites)
    _check_pairs(a, ii, jj)
    if a.device.type == "cpu":
        return pair_block_stats_plain(a, b, s, ii, jj, mc, n_sites)
    if a.device.type != "cuda":
        raise ValueError(f"pair_block_stats: unsupported device {a.device}")
    lib = csrc.load()
    P = ii.shape[0]
    ints = torch.empty((N_INTS, P), dtype=torch.int32, device=a.device)
    sums = torch.empty((2, P), dtype=torch.float64, device=a.device)
    if P == 0:
        return ints, sums
    rc = lib.ntsm_pair_block_stats(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(s.data_ptr()), a.shape[1], n_sites,
        ctypes.c_void_p(ii.data_ptr()), ctypes.c_void_p(jj.data_ptr()), P, int(mc),
        ctypes.c_void_p(ints.data_ptr()), ctypes.c_void_p(sums.data_ptr()),
        csrc.stream_ptr(a.device),
    )
    csrc.check(lib, rc, "pair_block_stats")
    launches_block += 1
    return ints, sums
