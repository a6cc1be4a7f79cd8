"""The candidate search of ``eval -p`` on the device engine (the radius
queries of computeScorePCA, src/CompareCounts.hpp:316-390): the list of
eval/pca.py:pca_candidate_arrays, element for element, from the cloud and
the squared radii where they are, in blocks of rows, with memory
O(rows x N) and no [N, N] array.

:func:`candidate_search` runs two stages of the run's stage recorder:

* ``candidates.search.radius``: for each row i of a block whose radius is
  finite, every j != i with d2(i, j) < r_i, strictly, where d2 sums the
  dim terms (c_i - c_j)^2 in numpy's pairwise order (the reduction of
  eval/pca.py:sq_dists_blocked), each operation rounded on its own, so
  that d2 is the host's bit for bit.  :func:`radius_matches` runs
  :func:`radius_matches_plain` for CPU tensors and launches
  ``csrc/pca_radius.cu`` for CUDA tensors (a counting pass, each (row,
  column chunk)'s offset, a writing pass), or raises; it never falls
  back.  A row's matches come in ascending j.  The stage waits for the
  writing pass, so that it holds both passes.
* ``candidates.search.order``: the pruning rules (r_j == r_i keeps j > i,
  r_j < r_i keeps j, the rest go), each row's matches by distance with
  ties in index order (numpy's stable argsort), the rows of the
  exhaustive tier (every j but i and the exhaustive j < i, in index
  order), all rows by i, and one host copy of the list.

``launches_radius`` counts the kernel's launches; eval/pca.py:counters
counts the rows searched, their matches and the pairs listed.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.eval import pca

launches_radius = 0

# rows a block of candidate_search: its matches and counts are O(rows x N)
SEARCH_ROWS = 8192
# csrc/pca_radius.cu: query rows a thread block, most points of a column
# tile; the column chunks are cut so that a launch has about CTAS_PER_SM
# blocks an SM; a staged point fits in its 48 KB of shared memory
KERNEL_ROWS = 128
KERNEL_TILE = 128
CTAS_PER_SM = 8
KERNEL_MAX_DIM = 6144
# elements of the plain version's [rows, N, dim] difference chunk
PLAIN_ELEMS = 1 << 22


def pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of `t` in numpy's pairwise order
    (pairwise_sum of its add reduction): below 8 terms one after the other;
    up to 128 eight accumulators of every eighth term, joined as ((r0 + r1)
    + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the rest one after the
    other; beyond 128 the two halves, split at a multiple of 8, each summed
    so.  Every addition is one elementwise tensor addition, rounded on its
    own."""
    n = t.shape[-1]
    if n < 8:
        res = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for k in range(n):
            res = res + t[..., k]
        return res
    if n <= 128:
        r = t[..., :8]
        i = 8
        while i < n - n % 8:
            r = r + t[..., i:i + 8]
            i += 8
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for k in range(i, n):
            res = res + t[..., k]
        return res
    h = n // 2
    h -= h % 8
    return pairwise_sum(t[..., :h]) + pairwise_sum(t[..., h:])


def radius_matches_plain(cloud: torch.Tensor, radii: torch.Tensor, r0: int, r1: int) -> tuple:
    """(i, j int32, d2 f64) of every j != i with d2(i, j) < r_i for the rows
    i in [r0, r1) whose r_i is finite, by i, then j: the plain PyTorch
    version, over [rows, N, dim] chunks."""
    n, dim = cloud.shape
    dev = cloud.device
    step = max(1, PLAIN_ELEMS // max(1, n * dim))
    cols = torch.arange(n, device=dev)
    parts = []
    for a0 in range(r0, r1, step):
        a1 = min(a0 + step, r1)
        diff = cloud[a0:a1, None, :] - cloud[None, :, :]
        d2 = pairwise_sum(diff * diff)
        rows = torch.arange(a0, a1, device=dev)
        rad = radii[a0:a1, None]
        hit = (d2 < rad) & (rad < pca.DBL_MAX) & (cols[None, :] != rows[:, None])
        r, j = hit.nonzero(as_tuple=True)
        parts.append((rows[r].int(), j.int(), d2[r, j]))
    if not parts:
        return (torch.zeros(0, dtype=torch.int32, device=dev),) * 2 + (
            torch.zeros(0, dtype=torch.float64, device=dev),)
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _check(cloud, radii, r0: int, r1: int) -> None:
    if cloud.dim() != 2 or cloud.dtype != torch.float64 or not cloud.is_contiguous():
        raise ValueError(f"cloud must be a contiguous [N, dim] float64 tensor, got "
                         f"{tuple(cloud.shape)} {cloud.dtype}")
    n = cloud.shape[0]
    if radii.shape != (n,) or radii.dtype != torch.float64 or not radii.is_contiguous():
        raise ValueError(f"radii must be a contiguous [{n}] float64 tensor, got "
                         f"{tuple(radii.shape)} {radii.dtype}")
    if radii.device != cloud.device:
        raise ValueError("cloud and radii must be on one device")
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"row block [{r0}, {r1}) outside [0, {n})")
    if n >= 2**31:
        raise ValueError(f"{n} samples exceed the kernel's int32 indices")
    if cloud.device.type == "cuda" and not 1 <= cloud.shape[1] <= KERNEL_MAX_DIM:
        raise ValueError(f"dim {cloud.shape[1]} outside the radius kernel's [1, "
                         f"{KERNEL_MAX_DIM}]")


def n_chunks(rows: int, n: int, n_sms: int) -> int:
    """Column chunks of a launch over `rows` query rows of an n-point
    cloud: about CTAS_PER_SM thread blocks an SM, and never more chunks
    than tiles of points."""
    row_blocks = -(-rows // KERNEL_ROWS)
    want = -(-CTAS_PER_SM * n_sms // max(1, row_blocks))
    return max(1, min(want, -(-n // KERNEL_TILE)))


def radius_matches(cloud: torch.Tensor, radii: torch.Tensor, r0: int, r1: int) -> tuple:
    """(i, j int32, d2 f64) of the rows [r0, r1), as
    :func:`radius_matches_plain` defines them, on the cloud's device."""
    global launches_radius
    _check(cloud, radii, r0, r1)
    if cloud.device.type == "cpu":
        return radius_matches_plain(cloud, radii, r0, r1)
    if cloud.device.type != "cuda":
        raise ValueError(f"radius_matches: unsupported device {cloud.device}")
    n, dim = cloud.shape
    dev = cloud.device
    lib = csrc.load()
    cloud_t = cloud.t().contiguous()
    chunks = n_chunks(r1 - r0, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    counts = torch.empty((r1 - r0, chunks), dtype=torch.int32, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    stream = csrc.stream_ptr(dev)
    rc = lib.ntsm_pca_radius(ptr(cloud_t), ptr(radii), n, dim, r0, r1, chunks, ptr(counts), None,
                             None, None, None, stream)
    csrc.check(lib, rc, "pca_radius (count)")
    launches_radius += 1
    ends = torch.cumsum(counts.view(-1), 0, dtype=torch.int64)
    total = int(ends[-1]) if ends.numel() else 0
    out_i = torch.empty(total, dtype=torch.int32, device=dev)
    out_j = torch.empty(total, dtype=torch.int32, device=dev)
    out_d = torch.empty(total, dtype=torch.float64, device=dev)
    if total:
        starts = ends - counts.view(-1)
        rc = lib.ntsm_pca_radius(ptr(cloud_t), ptr(radii), n, dim, r0, r1, chunks, ptr(counts),
                                 ptr(starts), ptr(out_i), ptr(out_j), ptr(out_d), stream)
        csrc.check(lib, rc, "pca_radius (write)")
        launches_radius += 1
    return out_i, out_j, out_d


def _order(i, j, d2, radii) -> tuple:
    """The pruning rules and the order of a block's matches (by i, then j):
    (i, j) by i, then distance, then j."""
    ri, rj = radii[i], radii[j]
    keep = torch.where(rj == ri, j > i, rj < ri)
    i, j, d2 = i[keep], j[keep], d2[keep]
    o = torch.sort(d2, stable=True).indices
    i, j = i[o], j[o]
    o = torch.sort(i, stable=True).indices
    return i[o], j[o]


def _exhaustive(rows: torch.Tensor, radii: torch.Tensor) -> tuple:
    """(i, j int32) of the rows `rows` of the exhaustive tier: every j but
    i and the j <= i whose radius is DBL_MAX, by i, then j."""
    n = radii.shape[0]
    cols = torch.arange(n, device=radii.device)
    ex = radii >= pca.DBL_MAX
    mask = (cols[None, :] != rows[:, None]) & ~(ex[None, :] & (cols[None, :] <= rows[:, None]))
    r, j = mask.nonzero(as_tuple=True)
    return rows[r].int(), j.int()


def candidate_search(cloud: torch.Tensor, radii: torch.Tensor, rows: int = SEARCH_ROWS,
                     stage=None) -> tuple:
    """(ii, jj, ii_host, jj_host): the candidate list of
    eval/pca.py:pca_candidate_arrays for the [N, dim] f64 cloud and the
    [N] f64 squared radii (both on one device), as int32 tensors on that
    device and as int64 host arrays, searched `rows` rows at a time.
    `stage(name)` times the stages candidates.search.radius and .order
    (utils/spans.py; none where not given)."""
    stage = stage or (lambda name: contextlib.nullcontext())
    _check(cloud, radii, 0, cloud.shape[0])
    n = cloud.shape[0]
    rows = max(1, rows)
    parts, within = [], 0
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        with stage("candidates.search.radius"):
            i, j, d2 = radius_matches(cloud, radii, r0, r1)
            if cloud.is_cuda:
                torch.cuda.synchronize(cloud.device)
        within += int(i.numel())
        with stage("candidates.search.order"):
            parts.append(_order(i, j, d2, radii))
    with stage("candidates.search.order"):
        listing = torch.nonzero(~(radii < pca.DBL_MAX)).flatten()
        n_ex = 0
        for e0 in range(0, int(listing.numel()), rows):
            part = _exhaustive(listing[e0:e0 + rows], radii)
            n_ex += int(part[0].numel())
            parts.append(part)
        ii = torch.cat([p[0] for p in parts]) if parts else torch.zeros(0, dtype=torch.int32)
        jj = torch.cat([p[1] for p in parts]) if parts else torch.zeros(0, dtype=torch.int32)
        if n_ex and n_ex < ii.numel():  # the two tiers' rows, each grouped, by i
            o = torch.sort(ii, stable=True).indices
            ii, jj = ii[o], jj[o]
        ii_host = ii.cpu().numpy().astype(np.int64)
        jj_host = jj.cpu().numpy().astype(np.int64)
    pca.counters["search_rows"] += n - int(listing.numel())
    pca.counters["within_radius"] += within
    pca.counters["exhaustive"] += n_ex
    pca.counters["candidates"] += int(ii_host.size)
    return ii, jj, ii_host, jj_host
