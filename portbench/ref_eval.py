"""The plain reference of ``eval``: per-sample columns, pair statistics
and scores, the -p projection and candidate search, in plain PyTorch on
counts that the benchmark made.  It imports nothing of the program.

It restates ntsmEval's arithmetic (CompareCounts.hpp: computeScore,
calcRelatedness, calcHomHetMiss, computeErrorRate, projectPCs and
computeScorePCA's radius tiers and pruning) as tensor operations over
blocks of pairs.  `dtype` is the floating type of every step: float64 is
the reference, float32 the control (the nearest precision below the
configuration's).
"""

from __future__ import annotations

import numpy as np
import torch

DBL_MAX = float(np.finfo(np.float64).max)


def classes(a: torch.Tensor, b: torch.Tensor, mc: int) -> torch.Tensor:
    """Genotype class a site: 3 het, 1 hom A/T, 2 hom C/G, 0 missing."""
    return (a > mc).to(torch.uint8) | ((b > mc).to(torch.uint8) << 1)


def sample_columns(mx: np.ndarray, sum_counts_total: np.ndarray, raw_total_kmers: np.ndarray,
                   ks: np.ndarray, distinct_total: float, genome_size: float, mc: int) -> dict:
    """Per-sample cov, errorRate, miss, allHom and allHet of a cohort's
    [N, L, 2] max counts (all sites)."""
    a = torch.from_numpy(mx[:, :, 0])
    b = torch.from_numpy(mx[:, :, 1])
    pa, pb = a > mc, b > mc
    L = mx.shape[1]
    hets = (pa & pb).sum(1).numpy()
    homs = (pa ^ pb).sum(1).numpy()
    miss = (~(pa | pb)).sum(1).numpy()
    cov = mx.sum(axis=(1, 2), dtype=np.int64).astype(np.float64) / float(L)
    err = np.full(mx.shape[0], -1.0)
    ok = (raw_total_kmers > 0) & (ks > 0)
    expected = raw_total_kmers.astype(np.float64) * distinct_total / genome_size
    err[ok] = 1.0 - (sum_counts_total[ok].astype(np.float64) / expected[ok]) ** (
        1.0 / ks[ok].astype(np.float64))
    return dict(cov=cov, error_rate=err, miss=miss, homs=homs, hets=hets)


def _single(a: torch.Tensor, b: torch.Tensor, mc: int, dtype) -> torch.Tensor:
    af, bf = a.to(dtype), b.to(dtype)
    den = torch.clamp(af + bf, min=1.0)
    zero = torch.zeros((), dtype=dtype, device=a.device)
    return af * torch.where(a > mc, af / den, zero) + bf * torch.where(b > mc, bf / den, zero)


def pair_stats(mx_dev: torch.Tensor, ii: np.ndarray, jj: np.ndarray, cov: np.ndarray, mc: int,
               skew: float, dtype=torch.float64, block: int = 1024) -> dict:
    """Per pair (ii[p], jj[p]) of the [N, L, 2] int32 counts on a device:
    score, relate, homConcord (as float64 arrays, computed in `dtype`) and
    the tallies n, ibs0, ibs2, hets1, hets2, sharedHet, homs1, homs2,
    sharedHom (int64 arrays)."""
    dev = mx_dev.device
    P = int(ii.size)
    keys = ("n", "ibs0", "shet", "shom", "h1", "h2")
    ints = {k: np.zeros(P, np.int64) for k in keys}
    joint = np.zeros(P, np.float64)
    ss = np.zeros(P, np.float64)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for p0 in range(0, P, block):
        p1 = min(p0 + block, P)
        i = torch.from_numpy(ii[p0:p1]).to(dev)
        j = torch.from_numpy(jj[p0:p1]).to(dev)
        ai, bi = mx_dev[i, :, 0], mx_dev[i, :, 1]
        aj, bj = mx_dev[j, :, 0], mx_dev[j, :, 1]
        ci, cj = classes(ai, bi, mc), classes(aj, bj, mc)
        v = (ci != 0) & (cj != 0)
        got = dict(n=v.sum(1), ibs0=(v & ((ci ^ cj) == 3)).sum(1),
                   shet=((ci & cj) == 3).sum(1), shom=(v & (ci == cj) & (ci != 3)).sum(1),
                   h1=(v & (ci == 3)).sum(1), h2=(v & (cj == 3)).sum(1))
        for k in keys:
            ints[k][p0:p1] = got[k].cpu().numpy()
        A, B = (ai + aj), (bi + bj)
        Af, Bf = A.to(dtype), B.to(dtype)
        den = Af + Bf
        dsafe = torch.where(den > 0, den, torch.ones_like(den))
        term = Af * torch.where(A > mc, Af / dsafe, zero) + Bf * torch.where(B > mc, Bf / dsafe, zero)
        joint[p0:p1] = torch.where(v, term, zero).sum(1).double().cpu().numpy()
        single = _single(ai, bi, mc, dtype) + _single(aj, bj, mc, dtype)
        ss[p0:p1] = torch.where(v, single, zero).sum(1).double().cpu().numpy()
    n = ints["n"]
    if dtype == torch.float64:
        loglik = -2.0 * (joint - ss)
        with np.errstate(divide="ignore", invalid="ignore"):
            sc = loglik / (cov[ii] * cov[jj]) ** skew / n.astype(np.float64)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.float32(-2.0) * (joint.astype(np.float32) - ss.astype(np.float32))
            cv = (cov[ii].astype(np.float32) * cov[jj].astype(np.float32)) ** np.float32(skew)
            sc = (t / cv / n.astype(np.float32)).astype(np.float64)
    score = np.where(n > 0, sc, DBL_MAX)
    h1, h2, ibs0, shet, shom = ints["h1"], ints["h2"], ints["ibs0"], ints["shet"], ints["shom"]
    o1, o2 = n - h1, n - h2
    with np.errstate(divide="ignore", invalid="ignore"):
        relate = (shet - 2.0 * ibs0) / np.minimum(h1, h2).astype(np.float64)
        homc = (shom - 2.0 * ibs0) / np.minimum(o1, o2).astype(np.float64)
    return dict(score=score, relate=relate, homc=homc, n=n, ibs0=ibs0, ibs2=shet + shom,
                hets1=h1, hets2=h2, shet=shet, homs1=o1, homs2=o2, shom=shom)


def project(mx_dev: torch.Tensor, centers: np.ndarray, rot: np.ndarray, mc: int, dim: int,
            dtype=torch.float64, block: int = 256) -> np.ndarray:
    """[N, dim] cloud: per site AT/(AT+CG) of the counts above mc,
    quantized to {0, 0.5, 1} at 0.25 / 0.75, less the site's center, 0
    where both counts are at most mc; rotated by rot[:, :dim]."""
    dev = mx_dev.device
    N = mx_dev.shape[0]
    cen = torch.from_numpy(centers).to(dev, dtype)
    R = torch.from_numpy(np.ascontiguousarray(rot[:, :dim])).to(dev, dtype)
    out = np.empty((N, dim), np.float64)
    for r0 in range(0, N, block):
        r1 = min(r0 + block, N)
        a, b = mx_dev[r0:r1, :, 0], mx_dev[r0:r1, :, 1]
        ca = torch.where(a > mc, a, torch.zeros_like(a)).to(dtype)
        cb = torch.where(b > mc, b, torch.zeros_like(b)).to(dtype)
        den = ca + cb
        g = ca / torch.clamp(den, min=1.0)
        q = torch.where(g - 0.25 < 0, 0.0, torch.where(g - 0.75 < 0, 0.5, 1.0)).to(dtype)
        vals = torch.where(den == 0, torch.zeros((), dtype=dtype, device=dev), q - cen)
        out[r0:r1] = (vals @ R).double().cpu().numpy()
    return out


def radii(error_rate: np.ndarray, miss: np.ndarray, n_sites: int, err_thresh: float,
          miss1: float, miss2: float, r1: float, r2: float) -> np.ndarray:
    """Squared search radius a sample: r1^2 for clean samples, r2^2 for
    those missing fewer than miss2 of the sites, else exhaustive."""
    prop = miss.astype(np.float64) / float(n_sites)
    out = np.full(miss.shape[0], DBL_MAX)
    t1 = (error_rate < err_thresh) & (prop < miss1)
    t2 = ~t1 & (prop < miss2)
    out[t1] = r1 ** 2
    out[t2] = r2 ** 2
    return out


def candidates(cloud: np.ndarray, rad: np.ndarray):
    """(ii, jj) of computeScorePCA's candidate pairs in its order: for each
    sample i, a finite-radius search lists the samples strictly inside its
    radius, nearest first (ties by index), keeping k > i among equal radii
    and every k of a smaller radius; an exhaustive sample lists every
    finite-radius sample and the exhaustive ones after it, by index."""
    c = torch.from_numpy(cloud)
    sq = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1).numpy()
    n = cloud.shape[0]
    idx = np.arange(n)
    ex = rad >= DBL_MAX
    out_i, out_j = [], []
    for i in range(n):
        if rad[i] < DBL_MAX:
            m = np.flatnonzero(sq[i] < rad[i])
            m = m[np.argsort(sq[i][m], kind="stable")]
            rk = rad[m]
            ks = m[np.where(rk == rad[i], m > i, rk < rad[i])]
        else:
            ks = idx[(idx != i) & ~(ex & (idx <= i))]
        out_i.append(np.full(ks.size, i, np.int64))
        out_j.append(ks.astype(np.int64))
    return np.concatenate(out_i), np.concatenate(out_j)


def dist_sq(cloud: np.ndarray, ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    d = cloud[ii] - cloud[jj]
    return (d * d).sum(axis=1)
