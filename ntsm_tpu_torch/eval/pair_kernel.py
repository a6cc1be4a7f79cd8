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
runs :func:`pair_block_stats_plain`, for CUDA tensors it plans the list on
the host (:func:`plan_pair_blocks`) and launches the instances of
``csrc/pair_block_stats.cu`` the plan uses, or raises.
``launches_block`` counts the tile instance's launches,
``launches_block_sparse`` the sparse instance's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ntsm_tpu_torch import csrc

launches = 0
launches_block = 0
launches_block_sparse = 0

N_INTS = 5  # n, ibs0, shared_hets, hets1, hets2
# csrc/pair_stats.cu: a block of TILE x TILE threads, each holding RI x RJ
# pairs; index m of MICRO_TILES is the kernel's `micro` argument
TILE = 16
MICRO_TILES = ((1, 1), (2, 2))
# threads an SM a block's launch should give (micro_tile): on the H100 (132
# SMs) 2x2 then runs from 4 * 132 * 1024 = 540,672 pairs a block, and 1x1 was
# the faster at 302,736 pairs, 2x2 at 933,661 (experiments/exp_pair_stats.py)
THREADS_PER_SM = 1024
# csrc/pair_block_stats.cu: the sparse instance's pairs a block
SPARSE_PAIRS = 128
# a TILE x TILE tile of the -p plan whose distinct listed pairs fill at
# least this share of its slots goes to the tile instance, the pairs of a
# thinner one to the sparse instance (plan_pair_blocks): the density at
# which the two cost the same on the H100, 208 ns a tile slot against 748
# ns a sparse pair at 96,287 sites (experiments/exp_pair_block_stats.py)
DENSITY_MIN = 0.28
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


def _check_pair_values(ii: np.ndarray, jj: np.ndarray, n_samples: int) -> None:
    """Host arrays: every index in [0, n_samples), no pair (i, i)."""
    if ii.size == 0:
        return
    lo = int(min(ii.min(), jj.min()))
    hi = int(max(ii.max(), jj.max()))
    if lo < 0 or hi >= n_samples:
        raise ValueError(f"pair indices outside [0, {n_samples}): [{lo}, {hi}]")
    if bool((ii == jj).any()):
        raise ValueError("a pair (i, i) is no candidate: ii == jj")


@dataclass
class PairPlan:
    """A candidate list laid out for csrc/pair_block_stats.cu
    (:func:`plan_pair_blocks`).  Tile instance: ``rows``, ``cols`` [T, TILE]
    int32, each tile's row and column samples (-1: none), ``outs`` [T, TILE,
    TILE] int32, the output index of each slot (-1: not listed).  Sparse
    instance, pairs sorted by (i, j): ``irows`` [blocks, W] int32, each
    block's distinct i samples packed first (then -1; W the most a block
    has), and per pair
    ``islot`` (its i's place there), ``jrow`` and ``out`` [Q] int32.
    ``dup`` [2, D] int64: an index p that lists a pair again, and the index
    whose results it copies.  Every distinct pair is in one tile slot or one
    sparse entry, at its first index in the list."""

    n_samples: int
    n_pairs: int
    rows: np.ndarray
    cols: np.ndarray
    outs: np.ndarray
    irows: np.ndarray
    islot: np.ndarray
    jrow: np.ndarray
    out: np.ndarray
    dup: np.ndarray
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def n_tiles(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_sparse(self) -> int:
        return int(self.out.size)

    @property
    def n_tiled(self) -> int:
        """Distinct pairs the tile instance computes."""
        return int((self.outs >= 0).sum())

    def slots(self) -> int:
        """Pair slots the kernels compute: a tile's every slot, a sparse pair."""
        return self.n_tiles * TILE * TILE + self.n_sparse

    def density(self) -> float:
        """Distinct listed pairs over the slots computed (1.0 for none)."""
        n = self.n_tiled + self.n_sparse
        return n / self.slots() if n else 1.0

    def tile_density(self) -> float:
        """The tile instance's listed pairs over its slots (1.0 for none)."""
        return self.n_tiled / (self.n_tiles * TILE * TILE) if self.n_tiles else 1.0

    def device(self, device) -> dict:
        """The plan's arrays on `device`, uploaded once (pinned, then
        asynchronous copies: the upload never waits for the card)."""
        key = str(device)
        if key not in self._dev:
            arrays = dict(rows=self.rows, cols=self.cols, outs=self.outs, irows=self.irows,
                          islot=self.islot, jrow=self.jrow, out=self.out, dup=self.dup)
            self._dev[key] = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                device, non_blocking=True) for k, v in arrays.items()}
        return self._dev[key]


def _components(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """[n] labels of the connected components of the graph on [0, n) with
    edges (u[k], v[k]): hooking of roots to the smaller label, then pointer
    jumping, until every edge joins equal labels."""
    lab = np.arange(n, dtype=np.int64)
    while True:
        m = np.minimum(lab[u], lab[v])
        new = lab.copy()
        np.minimum.at(new, lab[u], m)
        np.minimum.at(new, lab[v], m)
        while True:
            nxt = new[new]
            if np.array_equal(nxt, new):
                break
            new = nxt
        if np.array_equal(new, lab):
            return lab
        lab = new


def _argsort(key: np.ndarray) -> np.ndarray:
    """np.argsort(key, kind="stable") of int64 keys >= 0, as one np.sort of
    each key packed with its index where the two fit in 63 bits (several
    times faster than a stable argsort)."""
    bits = max(1, (key.size - 1).bit_length())
    if key.size == 0 or int(key.max()) >= 1 << (63 - bits):
        return np.argsort(key, kind="stable")
    return np.sort((key << bits) | np.arange(key.size)) & ((1 << bits) - 1)


_HASH_MUL = 0x9E3779B1  # odd: j -> j * _HASH_MUL mod 2^32 is a bijection
_HASH_INV = pow(_HASH_MUL, -1, 1 << 32)


def _row_order(ii: np.ndarray, jj: np.ndarray, n_samples: int):
    """The rows of a pair list grouped by i, ascending, and the order in
    which the tiler groups them: rows whose j sets overlap next to each
    other.  Each row is joined to the j of its pairs with the least hash
    (one min-hash); the components of those edges hold rows that share
    columns (an interleaved cluster stays one component).  Within a
    component, rows by degree descending (a nearly dense row next to its
    like), then index.  Returns (rows, their degrees, the order, each
    row's component label)."""
    start = np.flatnonzero(np.r_[True, ii[1:] != ii[:-1]])
    rows = ii[start]
    deg = np.diff(np.r_[start, ii.size])
    mask = np.uint64(0xFFFFFFFF)
    h = (jj.astype(np.uint64) * np.uint64(_HASH_MUL)) & mask
    jmin = ((np.minimum.reduceat(h, start) * np.uint64(_HASH_INV)) & mask).astype(np.int64)
    label = _components(n_samples, rows, jmin)[rows]
    return rows, deg, np.lexsort((rows, -deg, label)), label


def plan_pair_blocks(ii, jj, n_samples: int, density_min: float = DENSITY_MIN) -> PairPlan:
    """The plan of the candidate list (ii[p], jj[p]) (host int arrays, p in
    print order) over an n_samples cohort, in numpy: O(P log P), no loop
    over pairs.

    Distinct pairs keep the index of their first listing; (i, j) and
    (j, i) are different pairs.  The rows are ordered by :func:`_row_order`
    (a row's degree counts its repeats) and cut into groups of TILE rows; a group's columns
    (the union of its rows' j's) are sorted by how many of its rows list
    them, most first, and cut into TILE-wide tiles.  Groups do not straddle
    two components of the row order: a component's last group may be
    short.  A tile whose listed
    pairs fill at least `density_min` of its TILE x TILE slots goes to the
    tile instance, the pairs of the others to the sparse instance."""
    ii = np.asarray(ii).astype(np.int64).ravel()
    jj = np.asarray(jj).astype(np.int64).ravel()
    if ii.shape != jj.shape:
        raise ValueError(f"ii, jj must be [P] of one length, got {ii.shape}, {jj.shape}")
    if n_samples >= 2**31:
        raise ValueError(f"{n_samples} samples exceed the kernel's int32 indices")
    _check_pair_values(ii, jj, n_samples)
    P, N, T2 = ii.size, n_samples, TILE * TILE
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)  # noqa: E731
    if P == 0:
        z = np.zeros(0, np.int32)
        return PairPlan(N, 0, z.reshape(0, TILE), z.reshape(0, TILE), z.reshape(0, TILE, TILE),
                        z.reshape(0, 1), z, z, z, np.zeros((2, 0), np.int64))

    # the listings grouped by i (eval/pca.py gives them so), each i's in
    # list order; ip: their indices in the list
    ip = None if bool((ii[1:] >= ii[:-1]).all()) else _argsort(ii)
    if ip is not None:
        ii, jj = ii[ip], jj[ip]

    # row groups of TILE rows, each inside one component
    rows, deg, rorder, label = _row_order(ii, jj, N)
    lab = label[rorder]
    cstart = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
    csize = np.diff(np.r_[cstart, lab.size])
    cpos = np.arange(lab.size) - np.repeat(cstart, csize)  # place in its component
    cgroups = -(-csize // TILE)
    grp = np.empty(rows.size, np.int64)  # each distinct row's group and slot there
    slot = np.empty(rows.size, np.int64)
    grp[rorder] = np.repeat(np.cumsum(cgroups) - cgroups, csize) + cpos // TILE
    slot[rorder] = cpos % TILE
    n_groups = int(cgroups.sum())
    group_rows = np.full((n_groups, TILE), -1, np.int64)
    group_rows[grp, slot] = rows
    grp_of, slot_of = np.zeros(N, np.int64), np.zeros(N, np.int64)  # by sample
    grp_of[rows], slot_of[rows] = grp, slot

    # the listings in (group, j, i, list index) order; a repeat of (i, j)
    # follows its first listing
    g = grp_of[ii]
    o2 = _argsort(g * N + jj)
    gs, js, is_ = g[o2], jj[o2], ii[o2]
    op = o2 if ip is None else ip[o2]
    new_col = np.r_[True, (gs[1:] != gs[:-1]) | (js[1:] != js[:-1])]
    first = new_col | np.r_[False, is_[1:] != is_[:-1]]
    dup = np.zeros((2, 0), np.int64)
    if not first.all():
        dup = np.stack([op[~first], op[first][np.cumsum(first)[~first] - 1]])
        gs, js, is_, new_col = gs[first], js[first], is_[first], new_col[first]
        op = op[first]

    # each group's columns, most listed first, cut into tiles
    run_start = np.flatnonzero(new_col)
    run_g, run_j = gs[run_start], js[run_start]
    run_n = np.diff(np.r_[run_start, gs.size])
    o3 = np.lexsort((run_j, -run_n, run_g))
    gstart = np.flatnonzero(np.r_[True, run_g[o3][1:] != run_g[o3][:-1]])
    n_cols = np.diff(np.r_[gstart, o3.size])  # every group has a column
    rank = np.empty(o3.size, np.int64)
    rank[o3] = np.arange(o3.size) - np.repeat(gstart, n_cols)
    chunks = -(-n_cols // TILE)
    run_tile = (np.cumsum(chunks) - chunks)[run_g] + rank // TILE
    run_id = np.repeat(np.arange(run_start.size), run_n)

    # dense tiles to the tile instance: each run's slot base in t_outs
    listed = np.bincount(run_tile, weights=run_n, minlength=int(chunks.sum()))
    dense = listed >= density_min * T2
    new_id = np.cumsum(dense) - 1
    T = int(dense.sum())
    t_rows = group_rows[np.repeat(np.arange(n_groups), chunks)[dense]]
    keep = dense[run_tile]
    t_cols = np.full((T, TILE), -1, np.int64)
    t_cols[new_id[run_tile[keep]], rank[keep] % TILE] = run_j[keep]
    base = np.where(keep, new_id[run_tile] * T2 + rank % TILE, -1)[run_id]
    in_tile = base >= 0
    t_outs = np.full(T * T2 + 1, -1, np.int32)  # + 1: a sink for the sparse pairs
    t_outs[np.where(in_tile, base + slot_of[is_] * TILE, T * T2)] = op
    t_outs = t_outs[:-1]

    # the other pairs, by i, to the sparse instance, blocks of SPARSE_PAIRS
    sp = np.flatnonzero(~in_tile)
    sp = sp[_argsort(is_[sp])]
    qi, qj, qp = is_[sp], js[sp], op[sp]
    Q = qi.size
    q = np.arange(Q)
    new_i = np.r_[True, qi[1:] != qi[:-1]] | (q % SPARSE_PAIRS == 0)
    cs = np.cumsum(new_i) - 1
    islot = cs - cs[(q // SPARSE_PAIRS) * SPARSE_PAIRS]
    irows = np.full((-(-Q // SPARSE_PAIRS), int(islot.max(initial=0)) + 1), -1, np.int64)
    irows[q // SPARSE_PAIRS, islot] = qi
    return PairPlan(N, P, i32(t_rows), i32(t_cols), i32(t_outs.reshape(T, TILE, TILE)),
                    i32(irows), i32(islot),
                    i32(qj), i32(qp), dup)


def pair_block_stats(a, b, s, ii, jj, mc: int, n_sites: int, plan: PairPlan | None = None):
    """(ints [5, P] int32, sums [2, P] float64) for the candidate pairs
    (ii[p], jj[p]), in that order: a, b are [N, L] int32 allele count
    planes, s is :func:`s_single_plane` of them, ii and jj are [P] int32
    sample indices in [0, N) with ii != jj, and only sites [0, n_sites)
    count.

    On a card the list is planned on the host first: `plan`, if given, is
    :func:`plan_pair_blocks` of the same list (its host copy, so nothing
    waits for the card); without one the wrapper fetches ii and jj to make
    it."""
    global launches_block, launches_block_sparse
    N = a.shape[0]
    _check(a, b, s, 0, N, n_sites)
    _check_pairs(a, ii, jj)
    if a.device.type == "cpu":
        _check_pair_values(ii.numpy(), jj.numpy(), N)
        return pair_block_stats_plain(a, b, s, ii, jj, mc, n_sites)
    if a.device.type != "cuda":
        raise ValueError(f"pair_block_stats: unsupported device {a.device}")
    P = ii.shape[0]
    if plan is None:
        plan = plan_pair_blocks(ii.cpu().numpy(), jj.cpu().numpy(), N)
    if plan.n_pairs != P or plan.n_samples != N:
        raise ValueError(f"the plan is of {plan.n_pairs} pairs of {plan.n_samples} samples, "
                         f"not {P} of {N}")
    lib = csrc.load()
    ints = torch.empty((N_INTS, P), dtype=torch.int32, device=a.device)
    sums = torch.empty((2, P), dtype=torch.float64, device=a.device)
    if P == 0:
        return ints, sums
    d = plan.device(a.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    stream = csrc.stream_ptr(a.device)
    if plan.n_tiles:
        rc = lib.ntsm_pair_block_tiles(
            ptr(a), ptr(b), ptr(s), a.shape[1], n_sites, int(mc), ptr(d["rows"]),
            ptr(d["cols"]), ptr(d["outs"]), plan.n_tiles, ptr(ints), ptr(sums), P, stream)
        csrc.check(lib, rc, "pair_block_stats (tiles)")
        launches_block += 1
    if plan.n_sparse:
        rc = lib.ntsm_pair_block_sparse(
            ptr(a), ptr(b), ptr(s), a.shape[1], n_sites, int(mc), ptr(d["irows"]),
            plan.irows.shape[1], ptr(d["islot"]), ptr(d["jrow"]), ptr(d["out"]),
            plan.n_sparse, ptr(ints), ptr(sums), P, stream)
        csrc.check(lib, rc, "pair_block_stats (sparse)")
        launches_block_sparse += 1
    if plan.dup.shape[1]:
        ints[:, d["dup"][0]] = ints[:, d["dup"][1]]
        sums[:, d["dup"][0]] = sums[:, d["dup"][1]]
    return ints, sums
