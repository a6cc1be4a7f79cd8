"""Exact (float64, host) pairwise scoring engine
(counterpart of ntsm_tpu/eval/exact.py).

Replicates CompareCounts' arithmetic byte-for-byte:

* log-likelihood score: -2*(sumLogPJoint - sumLogPSingle1 - sumLogPSingle2)
  over the pair's valid sites, coverage-skewed and normalized
  (computeScore, src/CompareCounts.hpp:591-624, 1013-1099)
* relatedness / IBS tallies (calcRelatedness, :1144-1196)
* result row layout (resultsStr, :844-921; header :726-730)

The device engine (eval/rect.py) computes the same quantities with the
same per-site arithmetic in a CUDA kernel; this engine is the parity oracle
(``--engine exact``) and the default for small N.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ntsm_tpu_torch.eval.model import HET, HOM_AT, HOM_CG, UNKNOWN, CountData
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils.formats import cpp_div, cpp_to_string

DBL_MAX = np.finfo(np.float64).max

HEADER = (
    "sample1\tsample2\tscore\tsame\tdist\trelate\tibs0\tibs2\thomConcord"
    "\thet1\thet2\tsharedHet\thom1\thom2\tsharedHom\tn"
    "\tcov1\tcov2\terrorRate1\terrorRate2\tmiss1\tmiss2"
    "\tallHom1\tallHom2\tallHet1\tallHet2"
)


@dataclass
class Relate:
    relatedness: float = 0.0
    ibs0: int = 0
    ibs2: int = 0
    hom_concord: float = 0.0
    shared_homs: int = 0
    shared_hets: int = 0
    hets1: int = 0
    homs1: int = 0
    hets2: int = 0
    homs2: int = 0


@dataclass
class PairResult:
    i: int
    j: int
    score: float
    n: int
    relate: Relate


def joint_sum(data: CountData, i: int, j: int, valid: np.ndarray, min_cov: int) -> float:
    """sumLogPJoint over valid sites (CompareCounts.hpp:1013-1033)."""
    a = (data.max_counts[i, :, 0] + data.max_counts[j, :, 0]).astype(np.float64)
    b = (data.max_counts[i, :, 1] + data.max_counts[j, :, 1]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        den = a + b
        fa = np.where(a > min_cov, a / den, 0.0)
        fb = np.where(b > min_cov, b / den, 0.0)
    term = a * fa + b * fb
    return float(np.sum(term[valid]))


def pair_score(data: CountData, i: int, j: int, opts: Options):
    """(score, n_valid, Relate) for one pair."""
    valid = (data.cls[i] != UNKNOWN) & (data.cls[j] != UNKNOWN)
    n = int(valid.sum())
    if n > 0:
        j_sum = joint_sum(data, i, j, valid, opts.min_cov)
        s1 = float(np.sum(data.s_single[i][valid]))
        s2 = float(np.sum(data.s_single[j][valid]))
        loglik = -2.0 * (j_sum - (s1 + s2))
        # skew (CompareCounts.hpp:1081-1083) then per-site normalization
        score = loglik / float(data.cov[i] * data.cov[j]) ** opts.cov_skew
        score /= float(n)
    else:
        score = DBL_MAX
    return score, n, calc_relatedness(data, i, j, valid)


def calc_relatedness(data: CountData, i: int, j: int, valid: np.ndarray) -> Relate:
    c1 = data.cls[i]
    c2 = data.cls[j]
    v = valid
    r = Relate()
    r.hets1 = int(((c1 == HET) & v).sum())
    r.homs1 = int((((c1 == HOM_AT) | (c1 == HOM_CG)) & v).sum())
    r.hets2 = int(((c2 == HET) & v).sum())
    r.homs2 = int((((c2 == HOM_AT) | (c2 == HOM_CG)) & v).sum())
    r.shared_hets = int(((c1 == HET) & (c2 == HET) & v).sum())
    r.shared_homs = int(
        ((((c1 == HOM_AT) & (c2 == HOM_AT)) | ((c1 == HOM_CG) & (c2 == HOM_CG))) & v).sum()
    )
    r.ibs2 = r.shared_hets + r.shared_homs
    r.ibs0 = int(
        ((((c1 == HOM_AT) & (c2 == HOM_CG)) | ((c1 == HOM_CG) & (c2 == HOM_AT))) & v).sum()
    )
    r.hom_concord = cpp_div(
        float(r.shared_homs) - 2.0 * float(r.ibs0), float(min(r.homs1, r.homs2))
    )
    r.relatedness = cpp_div(
        float(r.shared_hets) - 2.0 * float(r.ibs0), float(min(r.hets1, r.hets2))
    )
    return r


def results_row(
    data: CountData,
    res: PairResult,
    dist: str,
    opts: Options,
) -> str:
    """One output row (resultsStr, CompareCounts.hpp:844-921)."""
    i, j, r = res.i, res.j, res.relate
    f = cpp_to_string
    if opts.all:
        same = "1" if res.score < opts.score_thresh else "0"
    else:
        # without -a only passing pairs are printed, hard-coded "1"
        # (CompareCounts.hpp:853-861)
        same = "1"
    cols = [
        data.filenames[i],
        data.filenames[j],
        f(res.score),
        same,
        dist,
        f(r.relatedness),
        str(r.ibs0),
        str(r.ibs2),
        f(r.hom_concord),
        str(r.hets1),
        str(r.hets2),
        str(r.shared_hets),
        str(r.homs1),
        str(r.homs2),
        str(r.shared_homs),
        str(res.n),
        f(data.cov[i]),
        f(data.cov[j]),
        f(data.error_rate[i]),
        f(data.error_rate[j]),
        str(int(data.miss[i])),
        str(int(data.miss[j])),
        str(int(data.homs[i])),
        str(int(data.homs[j])),
        str(int(data.hets[i])),
        str(int(data.hets[j])),
    ]
    return "\t".join(cols)


def native_pair_stats(data: CountData, opts: Options, ii, jj):
    """Vectorized pair statistics via the native kernel, or None.

    Computes score + the eight tallies for an arbitrary pair list with the
    exact engine's per-site f64 arithmetic in C
    (ntsm_tpu/native/exact_pairs.cpp:ntsm_exact_pairs), far faster than
    the Python loop.  Only the final summation order differs from
    pair_score (sequential vs numpy pairwise), a <=1 ulp effect absorbed by
    the fixed 6-decimal output formatting.
    Returns (score[P] f64, tallies dict of [P] int64) or None when the
    native library is unavailable.
    """
    import ctypes

    from ntsm_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None

    N, L = data.n_samples, data.n_sites
    # loop-invariant planes cached on the CountData: compute_score_all
    # calls this per 2^18-pair block, and rebuilding the f64 A/B copies
    # (~2.5 GB each at N=3202) per block costs minutes of host first-touch
    planes = getattr(data, "_exact_native_planes", None)
    if planes is None:
        planes = (
            np.ascontiguousarray(data.max_counts[:, :, 0].astype(np.float64)),
            np.ascontiguousarray(data.max_counts[:, :, 1].astype(np.float64)),
            np.ascontiguousarray(data.cls),
            np.ascontiguousarray(data.s_single),
        )
        data._exact_native_planes = planes
    A, B, CLS, S = planes
    ii = np.ascontiguousarray(ii, dtype=np.int32)
    jj = np.ascontiguousarray(jj, dtype=np.int32)
    P = int(ii.shape[0])
    joint = np.empty(P, np.float64)
    ss = np.empty(P, np.float64)
    tal = np.empty((P, 8), np.int64)
    vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.ntsm_exact_pairs(
        vp(A), vp(B), vp(CLS), vp(S), N, L, float(opts.min_cov),
        vp(ii), vp(jj), P, vp(joint), vp(ss), vp(tal),
    )
    nvec = tal[:, 0]
    loglik = -2.0 * (joint - ss)
    cov = data.cov.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = loglik / (cov[ii] * cov[jj]) ** opts.cov_skew
        sc = sc / nvec.astype(np.float64)
    score = np.where(nvec > 0, sc, DBL_MAX)
    tallies = dict(
        n=nvec,
        ibs0=tal[:, 1],
        shared_hets=tal[:, 2],
        shared_homs=tal[:, 3],
        hets1=tal[:, 4],
        hets2=tal[:, 5],
        homs1=tal[:, 6],
        homs2=tal[:, 7],
    )
    return score, tallies


def _emit_pairs(data, opts, out, ii, jj, score, tallies, samp_w=None) -> None:
    """Emit result rows for a scored pair list through the shared emission
    path (eval/emit.py:_emit_prepared: filtering, the `same` column, the
    native C formatter with the Python fallback).  Pass samp_w (the
    _sample_strings cache) when calling per block: None makes the native
    emitter rebuild it on every call."""
    from ntsm_tpu_torch.eval.emit import (
        PAIR_COL_KEYS,
        _emit_prepared,
        _load_row_formatter,
        _pair_columns,
    )

    f3, i9 = _pair_columns(score, *(tallies[k] for k in PAIR_COL_KEYS))
    _emit_prepared(data, opts, out, np.asarray(ii), np.asarray(jj), f3, i9,
                   _load_row_formatter(), samp_w)


def compute_score_all(data: CountData, opts: Options, out) -> None:
    """All-vs-all comparison (computeScore, CompareCounts.hpp:591-624)."""
    out.write(HEADER)
    out.write("\n")
    n = data.n_samples
    iu, ju = np.triu_indices(n, 1)
    # pair blocks bound the native kernel's working set and let large
    # cohorts stream output instead of buffering every row's inputs
    BLK = 1 << 18
    samp_w = None
    for b0 in range(0, iu.shape[0], BLK):
        ii, jj = iu[b0 : b0 + BLK], ju[b0 : b0 + BLK]
        got = native_pair_stats(data, opts, ii, jj)
        if got is not None:
            score, tallies = got
            if samp_w is None:
                from ntsm_tpu_torch.eval.emit import _sample_strings

                samp_w = _sample_strings(data)
            _emit_pairs(data, opts, out, ii, jj, score, tallies,
                        samp_w=samp_w)
            continue
        for i, j in zip(ii, jj):
            score, nv, rel = pair_score(data, int(i), int(j), opts)
            if opts.all or score < opts.score_thresh:
                res = PairResult(
                    i=int(i), j=int(j), score=score, n=nv, relate=rel
                )
                out.write(results_row(data, res, "-1", opts))
                out.write("\n")


def compute_score_single(data: CountData, opts: Options, out) -> None:
    """Single-file QC output (computeScoreSingle, CompareCounts.hpp:541-585).

    NB the reference writes QC rows with no trailing newline (the rows are
    joined bare); replicated faithfully.
    """
    out.write("sample\tcov\terrorRate\tmiss\thom\thet\n")
    f = cpp_to_string
    for i in range(data.n_samples):
        cols = [
            data.filenames[i],
            f(data.cov[i]),
            f(data.error_rate[i]),
            str(int(data.miss[i])),
            str(int(data.homs[i])),
            str(int(data.hets[i])),
        ]
        out.write("\t".join(cols))
