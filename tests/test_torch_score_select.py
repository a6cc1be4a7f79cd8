"""The score selection of eval without -a (eval/pair_kernel.py:
score_select_plain, the plain version of csrc/score_select.cu, and its use
in eval/rect.py:compute_score_all_cuda and compute_score_pca_cuda).

* The kept set holds every pair whose host score (eval/rect.py:finalize's
  f64 expression) is under -s, at the edges: n == 0 (DBL_MAX), cov 0
  (+-inf and NaN scores), negative scores, -s infinite or NaN, and scores
  one and two ulps either side of -s; a pair well above -s is dropped, and
  each kept record is the block's values at its index.
* The default table of compute_score_all_cuda is byte-identical to the one
  a full fetch of every block prints, over seeds, thresholds (one keeping
  every pair, one none) and row-block sizes; -a fetches every pair.
* The candidate-list source (-p): the same records as the triangle source
  on the same pairs, in the same p order; the kept set holds every pair
  whose host finalize score is under -s, -s 0.5, 0, negative, inf and NaN,
  with pairs at n == 0 and one a hair under -s; the wrapper refuses lists
  of the wrong length, type or range.
"""

import io
import types

import numpy as np
import pytest
import torch

from ntsm_tpu_torch.eval import pair_kernel, rect
from ntsm_tpu_torch.eval.emit import _emit_prepared, _load_row_formatter, _sample_strings
from ntsm_tpu_torch.eval.exact import DBL_MAX, HEADER
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options

torch.set_num_threads(1)


def host_scores(ints, sums, cov, iu, ju, skew: float) -> np.ndarray:
    """finalize's score of each pair, in numpy f64."""
    n = ints[0].astype(np.int64)
    loglik = -2.0 * (sums[0] - sums[1])
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        sc = loglik / (cov[iu] * cov[ju]) ** skew
        sc = sc / n.astype(np.float64)
    return np.where(n > 0, sc, DBL_MAX)


def block(rng, N: int, r0: int, r1: int):
    """Random (ints [5, P] int32, sums [2, P] f64, cov [N] f64, iu, ju) of
    the row block [r0, r1) of an N-sample cohort, scores around 0."""
    iu, ju = rect.block_indices(N, r0, r1)
    P = iu.size
    ints = rng.integers(1, 5000, size=(5, P)).astype(np.int32)
    ss = rng.uniform(-5e4, -1e3, P)
    joint = ss + rng.normal(0, 300, P)
    cov = rng.uniform(5, 40, N)
    return ints, np.stack([joint, ss]), cov, iu, ju


def select(ints, sums, cov, r0: int, N: int, skew: float, thresh: float):
    """score_select's records as numpy, and the kept p as a set."""
    ki, kf, cnt = pair_kernel.score_select(
        torch.from_numpy(np.ascontiguousarray(ints)), torch.from_numpy(np.ascontiguousarray(sums)),
        torch.from_numpy(cov), r0, N, skew, pair_kernel.select_threshold(thresh))
    k = int(cnt[0])
    ki, kf = ki[:k].numpy(), kf[:k].numpy()
    return ki, kf, set(ki[:, 0].tolist())


def place_scores(ints, sums, cov, iu, ju, skew: float, targets: np.ndarray) -> None:
    """Set joint (ss = 0) so that each pair's host score is near its
    target: exactly it where skew == 0 and n == 1."""
    n = ints[0].astype(np.float64)
    with np.errstate(over="ignore"):
        sums[1] = 0.0
        sums[0] = -0.5 * (targets * n * (cov[iu] * cov[ju]) ** skew)


EDGE_CASES = ["n0", "cov0", "negative", "thresh_inf", "thresh_neg_inf", "thresh_nan",
              "ulps", "ulps_skewed", "thresh_zero", "thresh_large"]


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("r0", [0, 7])
def test_plain_keeps_every_pair_under_the_threshold(case, r0):
    rng = np.random.default_rng(EDGE_CASES.index(case) * 100 + r0)
    N = 41
    r1 = min(N - 1, r0 + 9)
    ints, sums, cov, iu, ju = block(rng, N, r0, r1)
    P = iu.size
    skew, thresh = 0.2, 0.5
    if case == "n0":
        ints[0, ::3] = 0
        place_scores(ints, sums, cov, iu, ju, skew, rng.uniform(-1, 1, P))
        thresh = float("inf") if r0 else 0.5  # DBL_MAX prints under an infinite -s
    elif case == "cov0":
        cov[rng.integers(0, N, 6)] = 0.0
        cov[iu[0]] = cov[ju[0]] = 0.0
        sums[0, :P // 3] = sums[1, :P // 3]  # loglik 0: 0 / 0 is NaN
    elif case == "negative":
        place_scores(ints, sums, cov, iu, ju, skew, -rng.uniform(0, 1e3, P))
        thresh = -7.5
    elif case.startswith("thresh_"):
        place_scores(ints, sums, cov, iu, ju, skew, rng.normal(0, 1e3, P))
        ints[0, ::5] = 0
        thresh = dict(thresh_inf=np.inf, thresh_neg_inf=-np.inf, thresh_nan=np.nan,
                      thresh_zero=0.0, thresh_large=1e300)[case]
    elif case in ("ulps", "ulps_skewed"):
        thresh = float(rng.choice([0.5, -3.25, 1e-300, 123456.789]))
        steps = np.arange(P) % 5 - 2  # -2..2 ulps
        targets = np.array([thresh] * P)
        for k in range(P):
            for _ in range(abs(steps[k])):
                targets[k] = np.nextafter(targets[k], np.sign(steps[k]) * np.inf)
        if case == "ulps":
            skew = 0.0
            ints[0] = 1
        place_scores(ints, sums, cov, iu, ju, skew, targets)
    score = host_scores(ints, sums, cov, iu, ju, skew)
    if case == "ulps":
        assert (score < thresh).sum() == (steps < 0).sum()  # the scores are exactly placed
    ki, kf, kept = select(ints, sums, cov, r0, N, skew, thresh)
    prints = set(np.flatnonzero(score < thresh).tolist())
    assert prints <= kept
    nan = set(np.flatnonzero(np.isnan(score)).tolist())
    assert nan <= kept and (nan if case == "cov0" else True)
    if np.isfinite(thresh):
        margin = 1e-9 * max(1.0, abs(thresh))
        far = set(np.flatnonzero(score >= thresh + margin).tolist())
        assert not far & kept
    assert len(kept) == ki.shape[0]
    p = ki[:, 0]
    assert np.array_equal(p, np.sort(p))  # the plain version keeps them in order
    np.testing.assert_array_equal(ki[:, 1:].T, ints[:, p])
    np.testing.assert_array_equal(kf.T, sums[:, p])


@pytest.mark.parametrize("thresh", [0.5, float("inf"), float("nan"), float("-inf"), 1e308])
def test_select_threshold(thresh):
    hi = pair_kernel.select_threshold(thresh)
    if np.isnan(thresh):
        assert np.isnan(hi)
    elif np.isinf(thresh):
        assert hi == thresh
    else:
        assert thresh < hi <= thresh + 2e-12 * max(1.0, abs(thresh))


def test_score_select_rejects_bad_inputs():
    ints = torch.zeros((5, 10), dtype=torch.int32)
    sums = torch.zeros((2, 10), dtype=torch.float64)
    cov = torch.ones(5, dtype=torch.float64)
    pair_kernel.score_select(ints, sums, cov, 0, 5, 0.2, 0.5)  # the whole triangle
    with pytest.raises(ValueError):
        pair_kernel.score_select(ints, sums, cov, 1, 5, 0.2, 0.5)  # more pairs than from row 1
    with pytest.raises(ValueError):
        pair_kernel.score_select(ints, sums, cov, 4, 5, 0.2, 0.5)  # the last row has none
    with pytest.raises(ValueError):
        pair_kernel.score_select(ints, sums[:, :9], cov, 0, 5, 0.2, 0.5)
    with pytest.raises(TypeError):
        pair_kernel.score_select(ints.long(), sums, cov, 0, 5, 0.2, 0.5)
    with pytest.raises(TypeError):
        pair_kernel.score_select(ints, sums, cov.float(), 0, 5, 0.2, 0.5)
    with pytest.raises(ValueError):
        pair_kernel.score_select(ints, sums, cov[:4], 0, 5, 0.2, 0.5)
    with pytest.raises(ValueError):
        pair_kernel.score_select(ints.to("meta"), sums.to("meta"), cov.to("meta"), 0, 5, 0.2, 0.5)
    before = pair_kernel.launches_select
    pair_kernel.score_select(ints, sums, cov, 0, 5, 0.2, 0.5)
    assert pair_kernel.launches_select == before  # the CPU runs the plain version


@pytest.mark.parametrize("N", [2, 3, 17, 130])
def test_pair_indices_are_block_indices(N):
    rng = np.random.default_rng(N)
    for r0, r1 in list(rect.row_blocks(N, 1 << 21)) + list(rect.row_blocks(N, 40)):
        iu, ju = rect.block_indices(N, r0, r1)
        p = np.sort(rng.choice(iu.size, size=min(iu.size, 25), replace=False))
        gi, gj = rect.pair_indices(N, r0, r1, p)
        np.testing.assert_array_equal(gi, iu[p])
        np.testing.assert_array_equal(gj, ju[p])


def make_data(seed: int, N: int, L: int, opts: Options) -> CountData:
    """A prepared cohort: Poisson genotypes at random depths, dropout,
    duplicates of 0 by 1 and 5 by 9 (scores near 0), an all-zero row (n ==
    0 with every other sample) and a near duplicate 12 of 11."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(N, L))
    lam = rng.uniform(2, 30, size=(N, 1))
    mx = np.stack([rng.poisson(lam * (2 - geno)), rng.poisson(lam * geno)], axis=2)
    mx[rng.random((N, L)) < 0.15] = 0
    mx[1] = mx[0]
    mx[9] = mx[5]
    mx[12] = mx[11]
    mx[12, : L // 10] = rng.poisson(9, size=(L // 10, 2))
    mx[2] = 0
    mx = mx.astype(np.int32)
    return CountData(
        filenames=[f"s{i}_counts.txt" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 13, dtype=np.int64), max_counts=mx, sum_counts=mx * 13,
        raw_total_kmers=np.full(N, 10**9, dtype=np.int64), ks=np.full(N, 19, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)).astype(np.int64)).prepare(opts)


def full_fetch_table(data: CountData, opts: Options) -> str:
    """The default table as a fetch of every pair of every block prints it
    (compute_score_all_cuda before the selection)."""
    out = io.StringIO()
    out.write(HEADER + "\n")
    a, b, s = rect.device_planes(data, "cpu")
    lib = _load_row_formatter()
    samp_w = _sample_strings(data) if lib is not None else None
    for r0, r1 in rect.row_blocks(data.n_samples, rect.BLOCK_PAIRS):
        ints, sums = pair_kernel.pair_stats(a, b, s, r0, r1, opts.min_cov, data.n_sites)
        iu, ju = rect.block_indices(data.n_samples, r0, r1)
        f3, i9 = rect.finalize(data, opts, iu, ju, ints.numpy(), sums.numpy())
        _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w)
    return out.getvalue()


# thresholds: the default, one between scores, every pair, none
THRESHOLDS = [0.5, 2.75, float("inf"), -1e300]


@pytest.mark.parametrize("block_pairs", [1 << 21, 37])
@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_default_table_is_the_full_fetch_table(seed, thresh, block_pairs, monkeypatch):
    monkeypatch.setattr(rect, "BLOCK_PAIRS", block_pairs)
    N = 14 + 9 * seed
    opts = Options(score_thresh=thresh, min_cov=seed - 1, cov_skew=(0.2, 0.5, 0.0)[seed - 1])
    data = make_data(seed, N, 150 + 50 * seed, opts)
    out = io.StringIO()
    times = rect.compute_score_all_cuda(data, opts, out, "cpu")
    got = out.getvalue()
    assert got == full_fetch_table(data, opts)
    rows = got.count("\n") - 1
    pairs = N * (N - 1) // 2
    assert rows <= times["kept"] <= pairs
    if thresh == float("inf"):
        assert times["kept"] == pairs  # DBL_MAX and every score under inf
        assert rows == pairs
    if thresh == -1e300:
        assert rows == times["kept"] == 0
    if thresh == 0.5:
        assert 0 < rows and times["kept"] < pairs // 4  # the selection engages


@pytest.mark.parametrize("thresh", [0.5, -1e300])
def test_all_fetches_every_pair(thresh):
    N = 23
    opts = Options(score_thresh=thresh, all=True)
    data = make_data(7, N, 200, opts)
    out = io.StringIO()
    before = pair_kernel.launches_select
    times = rect.compute_score_all_cuda(data, opts, out, "cpu")
    assert times["kept"] == N * (N - 1) // 2
    assert out.getvalue().count("\n") == N * (N - 1) // 2 + 1  # every row prints under -a
    assert pair_kernel.launches_select == before
    default = io.StringIO()
    dopts = Options(score_thresh=thresh)
    rect.compute_score_all_cuda(data, dopts, default, "cpu")
    same = [r for r in out.getvalue().splitlines()[1:] if r.split("\t")[3] == "1"]
    assert default.getvalue().splitlines()[1:] == same


def select_pairs(ints, sums, cov, ii, jj, N: int, skew: float, thresh: float):
    """score_select's records for the candidate lists (ii, jj), as numpy,
    and the kept p as a set."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    ki, kf, cnt = pair_kernel.score_select(
        t(ints), t(sums), t(cov), None, N, skew, pair_kernel.select_threshold(thresh),
        pairs=(t(ii.astype(np.int32)), t(jj.astype(np.int32))))
    k = int(cnt[0])
    ki, kf = ki[:k].numpy(), kf[:k].numpy()
    return ki, kf, set(ki[:, 0].tolist())


@pytest.mark.parametrize("thresh", [0.5, 2.0, float("inf"), float("nan"), -1e300])
@pytest.mark.parametrize("N,r0,r1", [(41, 0, 40), (41, 7, 9), (130, 60, 129)])
def test_list_source_is_the_triangle_source(N, r0, r1, thresh):
    """The list source on a block's own (iu, ju) gives the triangle
    source's records, count and p order, bit for bit."""
    rng = np.random.default_rng(N * 1000 + r0)
    ints, sums, cov, iu, ju = block(rng, N, r0, r1)
    ints[0, ::9] = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    hi = pair_kernel.select_threshold(thresh)
    tri = pair_kernel.score_select_plain(t(ints), t(sums), t(cov), r0, N, 0.2, hi)
    lst = pair_kernel.score_select_plain(t(ints), t(sums), t(cov), None, N, 0.2, hi,
                                         pairs=(t(iu.astype(np.int32)), t(ju.astype(np.int32))))
    for x, y in zip(tri, lst):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    ki, kf, kept = select_pairs(ints, sums, cov, iu, ju, N, 0.2, thresh)
    np.testing.assert_array_equal(ki, tri[0].numpy())
    np.testing.assert_array_equal(kf, tri[1].numpy())


def candidate_block(rng, N: int, P: int):
    """Random candidate lists of an N-sample cohort in no order (both
    orders of a pair, repeats) and their statistics, scores around 0."""
    ii = rng.integers(0, N, P)
    jj = (ii + rng.integers(1, N, P)) % N
    ints = rng.integers(1, 5000, size=(5, P)).astype(np.int32)
    ss = rng.uniform(-5e4, -1e3, P)
    sums = np.stack([ss + rng.normal(0, 300, P), ss])
    return ints, sums, rng.uniform(5, 40, N), ii, jj


@pytest.mark.parametrize("skew", [0.2, 0.0])
@pytest.mark.parametrize("thresh", [0.5, 0.0, -3.25, float("inf"), float("nan")])
def test_list_keeps_every_candidate_under_the_threshold(thresh, skew):
    """Of a candidate list, the kept set holds every pair whose host
    finalize score is under -s (n == 0 pairs at DBL_MAX, one pair a hair
    under -s, one a hair over), drops those well over it, and each record
    is the list's values at its index, in ascending p."""
    rng = np.random.default_rng(int(skew * 10) + 7)
    N, P = 37, 600
    ints, sums, cov, ii, jj = candidate_block(rng, N, P)
    target = rng.normal(0, 2, P)
    if np.isfinite(thresh):
        # an ulp either side; at 0 a power of two (-0.5 times a subnormal ulp rounds to 0)
        hair = 2.0**-1000 if thresh == 0 else 0.0
        target[:3] = (thresh, np.nextafter(thresh, -np.inf) - hair,
                      np.nextafter(thresh, np.inf) + hair)
    ints[0, :3] = 1  # with skew 0 the first three scores are exactly their targets
    place_scores(ints, sums, cov, ii, jj, skew, target)
    ints[0, 3::11] = 0  # n == 0: DBL_MAX
    opts = Options(score_thresh=thresh, cov_skew=skew)
    f3, _ = rect.finalize(types.SimpleNamespace(cov=cov), opts, ii, jj, ints, sums)
    score = f3[:, 0]
    assert (score == DBL_MAX).sum() == len(range(3, P, 11))
    ki, kf, kept = select_pairs(ints, sums, cov, ii, jj, N, skew, thresh)
    prints = set(np.flatnonzero(score < thresh).tolist())
    assert prints <= kept
    if thresh == float("inf"):
        assert kept == set(range(P))  # DBL_MAX prints under an infinite -s
    elif thresh != thresh:
        assert kept == set(range(P)) and not prints  # -s NaN: nothing prints, nothing fails
    else:
        assert 0 < len(prints) and len(kept) < P
        far = set(np.flatnonzero(score >= thresh + 1e-9 * max(1.0, abs(thresh))).tolist())
        assert not far & kept
        if skew == 0.0:  # at -s, a hair under it, a hair over it (within the margin)
            assert 0 not in prints and 1 in prints and 2 not in prints
            assert {0, 1, 2} <= kept
    p = ki[:, 0]
    assert np.array_equal(p, np.sort(p)) and len(kept) == p.size
    np.testing.assert_array_equal(ki[:, 1:].T, ints[:, p])
    np.testing.assert_array_equal(kf.T, sums[:, p])


def test_score_select_rejects_bad_pairs():
    ints = torch.zeros((5, 10), dtype=torch.int32)
    sums = torch.zeros((2, 10), dtype=torch.float64)
    cov = torch.ones(5, dtype=torch.float64)
    ii = torch.arange(10, dtype=torch.int32) % 5
    jj = (ii + 1) % 5
    pair_kernel.score_select(ints, sums, cov, None, 5, 0.2, 0.5, pairs=(ii, jj))
    bad = [
        (ValueError, (ii[:9], jj[:9])),  # shorter than the statistics
        (ValueError, (ii, jj[:9])),
        (ValueError, (torch.cat([ii, ii[:1]]), torch.cat([jj, jj[:1]]))),  # longer
        (ValueError, (ii.view(2, 5), jj.view(2, 5))),
        (ValueError, (ii, torch.where(jj == 3, 5, jj))),  # past the cohort
        (ValueError, (torch.where(ii == 2, -1, ii), jj)),  # negative
        (TypeError, (ii.long(), jj)),
        (ValueError, (ii[::1].repeat(2)[::2], jj)),  # not contiguous
    ]
    for err, pairs in bad:
        with pytest.raises(err):
            pair_kernel.score_select(ints, sums, cov, None, 5, 0.2, 0.5, pairs=pairs)
    with pytest.raises(ValueError):  # a first row and pairs
        pair_kernel.score_select(ints, sums, cov, 0, 5, 0.2, 0.5, pairs=(ii, jj))
    with pytest.raises(ValueError):  # neither
        pair_kernel.score_select(ints, sums, cov, None, 5, 0.2, 0.5)
    empty = torch.zeros(0, dtype=torch.int32)
    _, _, cnt = pair_kernel.score_select(ints[:, :0].contiguous(), sums[:, :0].contiguous(), cov,
                                         None, 5, 0.2, 0.5, pairs=(empty, empty))
    assert int(cnt[0]) == 0
