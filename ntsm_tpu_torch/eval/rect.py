"""The device engine of ``eval`` all-vs-all and ``eval -p`` (counterpart of
ntsm_tpu/eval/rect.py and eval/tpu.py:compute_score_all_tpu,
compute_score_pca_tpu).

The [N, L] int32 allele count planes go to the device once, with the f64
s_single plane computed there.  All-vs-all scores the i<j triangle in row
blocks with the pair-statistics kernel; -p scores the candidate list in
slices with the candidate-pair kernel (both in eval/pair_kernel.py).  Each
block's per-pair (ints, joint, ss) is fetched, finalized on the host in f64
with the exact engine's transform and emitted.  The TPU engine's wire
(u8/u16 planes, the 17 B/pair blob, fetch stacking and grouping, diagonal
gathers) and its load-overlapped streaming (eval/pca_stream.py) are not
ported: the card has f64 and a wide host link, so the plain form comes
first.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ntsm_tpu_torch.eval import pair_kernel
from ntsm_tpu_torch.eval.emit import _emit_prepared, _load_row_formatter, _pair_columns, _sample_strings
from ntsm_tpu_torch.eval.exact import DBL_MAX, HEADER
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.eval.pca import pair_dist_sq, pca_candidate_arrays, search_radii
from ntsm_tpu_torch.options import Options

SITE_ALIGN = 32  # plane rows padded to 128 bytes; pad sites never count
BLOCK_PAIRS = 1 << 21  # pairs per row block or -p slice: bounds the fetched block


def device_planes(data: CountData, device) -> tuple:
    """(a, b, s) on `device`: [N, Lp] int32 count planes, zero-padded to
    SITE_ALIGN sites, and their f64 s_single plane."""
    mc = data.max_counts
    if mc.dtype != np.int32:
        if mc.size and (mc.min() < 0 or mc.max() > np.iinfo(np.int32).max):
            raise ValueError("count outside int32: the device engine cannot hold it")
        mc = mc.astype(np.int32)
    N, L = mc.shape[0], mc.shape[1]
    Lp = L + (-L) % SITE_ALIGN
    both = torch.from_numpy(np.ascontiguousarray(mc)).to(device)  # [N, L, 2]
    a = torch.zeros((N, Lp), dtype=torch.int32, device=device)
    b = torch.zeros((N, Lp), dtype=torch.int32, device=device)
    a[:, :L] = both[:, :, 0]
    b[:, :L] = both[:, :, 1]
    del both
    s = pair_kernel.s_single_plane(a, b, data._min_cov)
    return a, b, s


def row_blocks(n_samples: int, block_pairs: int):
    """[r0, r1) row blocks of the i<j triangle, each with at most
    block_pairs pairs (or one row)."""
    r0 = 0
    while r0 < n_samples - 1:
        r1, pairs = r0, 0
        while r1 < n_samples - 1 and (r1 == r0 or pairs + n_samples - 1 - r1 <= block_pairs):
            pairs += n_samples - 1 - r1
            r1 += 1
        yield r0, r1
        r0 = r1


def block_indices(n_samples: int, r0: int, r1: int):
    """(iu, ju) of the block's pairs in np.triu_indices order."""
    rows = np.arange(r0, r1)
    per_row = n_samples - 1 - rows
    iu = np.repeat(rows, per_row)
    starts = np.cumsum(per_row) - per_row
    ju = iu + 1 + (np.arange(iu.size) - np.repeat(starts, per_row))
    return iu, ju


def finalize(data: CountData, opts: Options, iu, ju, ints: np.ndarray, sums: np.ndarray):
    """(f3, i9) row columns of the _pair_columns contract from a block's
    fetched (ints [5, P], sums [2, P]), with the exact engine's f64
    transform (eval/exact.py:native_pair_stats): loglik = -2(joint - ss),
    skewed by (cov_i cov_j)^skew, over n; DBL_MAX where n == 0."""
    n, ibs0, shet, h1, h2 = (x.astype(np.int64) for x in ints)
    joint, ss = sums
    loglik = -2.0 * (joint - ss)
    cov = data.cov.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = loglik / (cov[iu] * cov[ju]) ** opts.cov_skew
        sc = sc / n.astype(np.float64)
    score = np.where(n > 0, sc, DBL_MAX)
    o1, o2 = n - h1, n - h2
    shom = n - h1 - h2 + shet - ibs0
    return _pair_columns(score, ibs0, shet, shom, h1, h2, o1, o2, n)


def compute_score_all_cuda(data: CountData, opts: Options, out, device) -> dict:
    """All-vs-all output identical in layout to the exact engine's.
    Returns the seconds spent in each stage (upload, score = kernel and
    fetch, finalize, emit) and the number of row blocks."""
    out.write(HEADER)
    out.write("\n")
    N = data.n_samples
    times = dict(upload=0.0, score=0.0, finalize=0.0, emit=0.0, blocks=0)
    if N < 2:
        return times
    t0 = time.monotonic()
    a, b, s = device_planes(data, device)
    if a.is_cuda:
        torch.cuda.synchronize(a.device)
    times["upload"] = time.monotonic() - t0
    lib = _load_row_formatter()
    samp_w = _sample_strings(data) if lib is not None else None
    for r0, r1 in row_blocks(N, BLOCK_PAIRS):
        t0 = time.monotonic()
        ints_d, sums_d = pair_kernel.pair_stats(a, b, s, r0, r1, opts.min_cov, data.n_sites)
        ints, sums = ints_d.cpu().numpy(), sums_d.cpu().numpy()
        t1 = time.monotonic()
        iu, ju = block_indices(N, r0, r1)
        f3, i9 = finalize(data, opts, iu, ju, ints, sums)
        t2 = time.monotonic()
        _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w)
        times["score"] += t1 - t0
        times["finalize"] += t2 - t1
        times["emit"] += time.monotonic() - t2
        times["blocks"] += 1
    return times


def compute_score_pca_cuda(data: CountData, opts: Options, out, cloud: np.ndarray,
                           device) -> dict:
    """PCA-filtered comparison (computeScorePCA, CompareCounts.hpp:285-391)
    on the device engine: the candidate pairs and their order are the exact
    engine's (eval/driver.py:compute_score_pca), scored on `device` in
    slices of at most BLOCK_PAIRS.  Returns the seconds spent in each stage
    (candidates, upload, score = kernel and fetch, finalize, emit) and the
    number of candidate pairs."""
    times = dict(candidates=0.0, upload=0.0, score=0.0, finalize=0.0, emit=0.0, pairs=0)
    t0 = time.monotonic()
    radii = search_radii(data, opts)
    out.write(HEADER)
    out.write("\n")
    ii_all, jj_all = pca_candidate_arrays(cloud, radii, opts.dim)
    P = int(ii_all.shape[0])
    times["candidates"] = time.monotonic() - t0
    times["pairs"] = P
    if not P:
        return times
    t0 = time.monotonic()
    a, b, s = device_planes(data, device)
    ii_d = torch.from_numpy(ii_all.astype(np.int32)).to(device)
    jj_d = torch.from_numpy(jj_all.astype(np.int32)).to(device)
    if a.is_cuda:
        torch.cuda.synchronize(a.device)
    times["upload"] = time.monotonic() - t0
    lib = _load_row_formatter()
    samp_w = _sample_strings(data) if lib is not None else None
    for p0 in range(0, P, BLOCK_PAIRS):
        p1 = min(p0 + BLOCK_PAIRS, P)
        t0 = time.monotonic()
        ints_d, sums_d = pair_kernel.pair_block_stats(
            a, b, s, ii_d[p0:p1], jj_d[p0:p1], opts.min_cov, data.n_sites)
        ints, sums = ints_d.cpu().numpy(), sums_d.cpu().numpy()
        t1 = time.monotonic()
        iu, ju = ii_all[p0:p1], jj_all[p0:p1]
        f3, i9 = finalize(data, opts, iu, ju, ints, sums)
        dist = pair_dist_sq(cloud, iu, ju, opts.dim)
        t2 = time.monotonic()
        _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w, dist=dist)
        times["score"] += t1 - t0
        times["finalize"] += t2 - t1
        times["emit"] += time.monotonic() - t2
    return times
