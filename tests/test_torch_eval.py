"""The port's eval engine (ntsm_tpu_torch.eval) against the JAX package on
the same random cohorts, made from a numpy seed.

* The plain pair statistics (eval/pair_kernel.py) against the TPU engine's
  device functions: tallies exactly equal to compute_pair_stats_tpu, and
  joint within 1e-6 relative of jint - jfrac, with jfrac from the Pallas
  kernel K3 itself in interpret mode (the JAX side is f32 with two-sums:
  the tolerance of tests/test_pallas_joint.py).
* joint and ss against the exact engine's f64 sums within 1e-12 relative
  (only the summation order differs), scores within 1e-9 max(1, |score|)
  (the loglik is a difference of two large sums).
* The port's device engine on the CPU against the JAX exact engine: integer
  columns identical, scores within 1e-9 relative.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ntsm_tpu.eval import exact as jexact
from ntsm_tpu.eval.kernels import CHUNK, _joint_int_matmuls
from ntsm_tpu.eval.model import CountData as JCountData
from ntsm_tpu.eval.pallas_joint import CK, joint_frac_full
from ntsm_tpu.eval.tpu import compute_pair_stats_tpu
from ntsm_tpu.options import Options as JOptions
from ntsm_tpu_torch.eval import exact, pair_kernel, rect
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options

torch.set_num_threads(1)

# (min_cov, N, L): one cohort per -c value
COHORTS = [(-1, 40, 301), (0, 64, 517), (1, 130, 1100), (2, 50, 700), (5, 45, 333)]


def make_counts(seed: int, N: int, L: int) -> np.ndarray:
    """[N, L, 2] int32 counts: Poisson genotypes at random depths, dropout
    sites, a duplicate pair (rows 0 and 1), an all-zero row (2) and one
    count above 65535."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(N, L))
    lam = rng.uniform(2, 30, size=(N, 1))
    mx = np.stack([rng.poisson(lam * (2 - geno)), rng.poisson(lam * geno)], axis=2)
    mx[rng.random((N, L)) < 0.15] = 0
    mx[1] = mx[0]
    mx[2] = 0
    mx[3, 5, 0] = 70_000
    return mx.astype(np.int32)


def cohorts(mx: np.ndarray, opts_kw: dict):
    """The same cohort as a JAX CountData and a port CountData, prepared."""
    N, L, _ = mx.shape
    kw = dict(
        filenames=[f"s{i}_counts.txt" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 13, dtype=np.int64),
        max_counts=mx,
        sum_counts=mx * 13,
        raw_total_kmers=np.full(N, 10**9, dtype=np.int64),
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)).astype(np.int64),
    )
    jd = JCountData(**kw).prepare(JOptions(**opts_kw))
    pd = CountData(**kw).prepare(Options(**opts_kw))
    return jd, pd


def port_stats(pd: CountData, mc: int):
    """(ints [5, P], sums [2, P]) of the plain version over the whole
    triangle, from the engine's own padded planes (pad sites in play)."""
    a, b, s = rect.device_planes(pd, "cpu")
    assert a.shape[1] > pd.n_sites or pd.n_sites % rect.SITE_ALIGN == 0
    ints, sums = pair_kernel.pair_stats(a, b, s, 0, pd.n_samples, mc, pd.n_sites)
    return ints.numpy().astype(np.int64), sums.numpy()


@pytest.mark.parametrize("mc,N,L", COHORTS)
def test_plain_pair_stats_match_tpu_engine(mc, N, L):
    mx = make_counts(1000 + N, N, L)
    jd, pd = cohorts(mx, dict(min_cov=mc))
    ints, sums = port_stats(pd, mc)
    iu, ju = np.triu_indices(N, 1)

    # tallies: exactly the TPU engine's
    st = compute_pair_stats_tpu(jd, JOptions(min_cov=mc))
    n, ibs0, shet, h1, h2 = ints
    np.testing.assert_array_equal(n, st["n"][iu, ju])
    np.testing.assert_array_equal(ibs0, st["ibs0"][iu, ju])
    np.testing.assert_array_equal(shet, st["shared_hets"][iu, ju])
    np.testing.assert_array_equal(h1, st["hets1"][iu, ju])
    np.testing.assert_array_equal(h2, st["hets1"][ju, iu])
    np.testing.assert_array_equal(n - h1, st["homs1"][iu, ju])
    np.testing.assert_array_equal(n - h2, st["homs1"][ju, iu])
    np.testing.assert_array_equal(n - h1 - h2 + shet - ibs0, st["shared_homs"][iu, ju])
    if mc >= 0:
        assert (n[(iu == 2) | (ju == 2)] == 0).all()  # the all-zero row

    # joint: the TPU engine's jint (K6) minus jfrac from K3 in interpret mode
    Lp = L + (-L) % CK
    a = np.zeros((N, Lp), np.float32)
    b = np.zeros((N, Lp), np.float32)
    a[:, :L] = mx[:, :, 0]
    b[:, :L] = mx[:, :, 1]
    v = ((a > mc) | (b > mc)).astype(np.float32)
    v[:, L:] = 0.0  # the n_valid rule: pad sites never count
    ja, jb, jv = jnp.asarray(a), jnp.asarray(b), jnp.asarray(v)
    ih, il = _joint_int_matmuls(ja, jb, jv, ja, jb, jv, float(mc), CHUNK)
    fh, fl = joint_frac_full(ja, jb, jv, float(mc), interpret=True)
    f64 = lambda x: np.asarray(x).astype(np.float64)  # noqa: E731
    want = ((f64(ih) + f64(il)) - (f64(fh) + f64(fl)))[iu, ju]
    err = np.abs(sums[0] - want) / np.maximum(1.0, np.abs(want))
    assert err.max() < 1e-6, err.max()


def exact_sums(jd, i: int, j: int, valid, mc: int):
    """The exact engine's (joint, ss) of one pair, per site as
    ntsm_tpu/native/exact_pairs.cpp:sums_pair computes them: the
    denominator is guarded to 1 where both counts are 0, which only a
    negative -c lets through (eval/exact.py:joint_sum gives nan there)."""
    mx = jd.max_counts.astype(np.float64)
    aa = mx[i, :, 0] + mx[j, :, 0]
    bb = mx[i, :, 1] + mx[j, :, 1]
    den = np.maximum(aa + bb, 1.0)
    fa = np.where(aa > mc, aa / den, 0.0)
    fb = np.where(bb > mc, bb / den, 0.0)
    joint = float(np.sum((aa * fa + bb * fb)[valid]))
    ss = float(np.sum((jd.s_single[i] + jd.s_single[j])[valid]))
    return joint, ss


@pytest.mark.parametrize("mc,N,L", COHORTS)
def test_plain_pair_stats_match_exact_engine(mc, N, L):
    mx = make_counts(2000 + N, N, L)
    opts_kw = dict(min_cov=mc, all=True)
    jd, pd = cohorts(mx, opts_kw)
    ints, sums = port_stats(pd, mc)
    iu, ju = np.triu_indices(N, 1)

    # joint and ss against the exact engine's per-pair f64 sums
    pick = np.random.default_rng(N).choice(iu.size, size=min(iu.size, 60), replace=False)
    pick = np.union1d(pick, [0, 1, N])  # (0,1) is the duplicate pair, (0,2)/(1,2) the zero row
    for p in pick:
        i, j = int(iu[p]), int(ju[p])
        valid = (jd.cls[i] != 0) & (jd.cls[j] != 0)
        assert int(ints[0, p]) == int(valid.sum())
        if not valid.any():
            assert sums[0, p] == 0.0 and sums[1, p] == 0.0
            continue
        joint, ss = exact_sums(jd, i, j, valid, mc)
        if mc >= 0:  # the Python loop's 0/0 gives nan below that
            assert joint == pytest.approx(jexact.joint_sum(jd, i, j, valid, mc), rel=1e-15)
        assert abs(sums[0, p] - joint) <= 1e-12 * max(1.0, abs(joint))
        assert abs(sums[1, p] - ss) <= 1e-12 * max(1.0, abs(ss))

    # scores and every tally against the exact engine's vectorized path
    score, tallies = jexact.native_pair_stats(jd, JOptions(**opts_kw), iu, ju)
    f3, i9 = rect.finalize(pd, Options(**opts_kw), iu, ju, ints, sums)
    for col, key in enumerate(("ibs0", None, "hets1", "hets2", "shared_hets",
                               "homs1", "homs2", "shared_homs", "n")):
        if key is not None:
            np.testing.assert_array_equal(i9[:, col], tallies[key])
    got = f3[:, 0]
    # -c -1 against a zero-coverage sample: loglik is 0 up to rounding and
    # the skew divides by cov = 0, so both engines print inf or nan there
    degenerate = ~np.isfinite(got) & ~np.isfinite(score)
    close = np.abs(got - score) <= 1e-9 * np.maximum(1.0, np.abs(score))
    assert np.all(close | degenerate)
    assert degenerate.sum() <= N - 1
    zero = tallies["n"] == 0
    if mc >= 0:
        assert zero.any()  # the all-zero row
    assert np.all(got[zero] == jexact.DBL_MAX)


def test_s_single_plane_is_the_exact_engines():
    mx = make_counts(7, 20, 300)
    for mc in (-1, 0, 1, 3):
        jd, pd = cohorts(mx, dict(min_cov=mc))
        a = torch.from_numpy(np.ascontiguousarray(mx[:, :, 0]))
        b = torch.from_numpy(np.ascontiguousarray(mx[:, :, 1]))
        got = pair_kernel.s_single_plane(a, b, mc).numpy()
        np.testing.assert_array_equal(got, jd.s_single)
        np.testing.assert_array_equal(got, pd.s_single)


def test_pad_sites_stay_invalid_for_negative_min_cov():
    """-c -1 makes zero counts pass `> minCov`; the planes' pad sites must
    not (tests/test_eval_tpu.py:test_negative_min_cov_pads_stay_invalid)."""
    mx = make_counts(11, 6, 20)
    for mc in (-1, 0):
        _, pd = cohorts(mx, dict(min_cov=mc))
        a, b, s = rect.device_planes(pd, "cpu")
        assert a.shape[1] == 32  # 12 pad sites
        ints, _ = pair_kernel.pair_stats(a, b, s, 0, 6, mc, pd.n_sites)
        want = ((pd.cls[:, None, :] != 0) & (pd.cls[None, :, :] != 0)).sum(-1)
        iu, ju = np.triu_indices(6, 1)
        np.testing.assert_array_equal(ints[0].numpy(), want[iu, ju])


def test_row_blocks_cover_the_triangle():
    for N in (2, 3, 17, 130):
        for block in (1, 7, 100, 1 << 21):
            blocks = list(rect.row_blocks(N, block))
            assert blocks[0][0] == 0 and blocks[-1][1] == N - 1
            assert all(x[1] == y[0] for x, y in zip(blocks, blocks[1:]))
            iu = np.concatenate([rect.block_indices(N, r0, r1)[0] for r0, r1 in blocks])
            ju = np.concatenate([rect.block_indices(N, r0, r1)[1] for r0, r1 in blocks])
            wi, wj = np.triu_indices(N, 1)
            np.testing.assert_array_equal(iu, wi)
            np.testing.assert_array_equal(ju, wj)
            for r0, r1 in blocks:
                assert pair_kernel.n_block_pairs(N, r0, r1) == rect.block_indices(N, r0, r1)[0].size


def test_row_blocks_give_the_same_output(monkeypatch):
    """Several row blocks and one block print the same table."""
    mx = make_counts(5, 23, 150)
    _, pd = cohorts(mx, dict(all=True))
    outs, blocks = [], []
    for block in (1 << 21, 30):
        monkeypatch.setattr(rect, "BLOCK_PAIRS", block)
        out = io.StringIO()
        blocks.append(rect.compute_score_all_cuda(pd, Options(all=True), out, "cpu")["blocks"])
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert blocks[0] == 1 and blocks[1] > 1


def test_wrapper_rejects_bad_inputs():
    a = torch.zeros((4, 8), dtype=torch.int32)
    s = torch.zeros((4, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        pair_kernel.pair_stats(a.long(), a.long(), s, 0, 4, 1, 8)
    with pytest.raises(ValueError):
        pair_kernel.pair_stats(a, a, s, 0, 5, 1, 8)
    with pytest.raises(ValueError):
        pair_kernel.pair_stats(a, a, s, 0, 4, 1, 9)
    with pytest.raises(ValueError):
        pair_kernel.pair_stats(a.t(), a.t(), s.t(), 0, 4, 1, 2)
    with pytest.raises(ValueError):
        pair_kernel.pair_stats(a.to("meta"), a.to("meta"), s.to("meta"), 0, 4, 1, 8)
    before = pair_kernel.launches
    pair_kernel.pair_stats(a, a, s, 0, 4, 1, 8)
    assert pair_kernel.launches == before  # the CPU runs the plain version


INT_COLS = {
    "ibs0", "ibs2", "het1", "het2", "sharedHet", "hom1", "hom2",
    "sharedHom", "n", "miss1", "miss2", "allHom1", "allHom2",
    "allHet1", "allHet2", "same",
}


def test_eval_fuzz_device_engine_vs_exact(rng):
    """tests/test_eval_fuzz.py:test_eval_fuzz_tpu_vs_exact in the port: the
    device engine (plain version on the CPU) against the JAX exact engine."""
    cols = jexact.HEADER.split("\t")
    for trial in range(8):
        trng = np.random.default_rng(rng.integers(0, 2**62) + trial)
        N = int(trng.integers(2, 10))
        L = int(trng.integers(5, 300))
        mx = trng.poisson(trng.uniform(0.5, 30), size=(N, L, 2)).astype(np.int32)
        mx[trng.random(mx.shape[:2]) < trng.uniform(0, 0.4)] = 0
        if trng.integers(0, 2):
            mx[1] = mx[0]  # duplicate pair
        opts_kw = dict(
            all=bool(trng.integers(0, 2)) or trial == 0,
            min_cov=int(trng.choice([-1, 0, 1, 2, 5])),
            cov_skew=float(trng.choice([0.2, 0.0, 0.5])),
            genome_size=float(trng.choice([6.2e9, 1e6])),
        )
        jd, pd = cohorts(mx, opts_kw)
        b1, b2 = io.StringIO(), io.StringIO()
        rect.compute_score_all_cuda(pd, Options(**opts_kw), b1, "cpu")
        jexact.compute_score_all(jd, JOptions(**opts_kw), b2)
        r1 = b1.getvalue().splitlines()
        r2 = b2.getvalue().splitlines()
        assert len(r1) == len(r2), trial
        assert r1[0] == r2[0]
        for l1, l2 in zip(r1[1:], r2[1:]):
            f1, f2 = l1.split("\t"), l2.split("\t")
            assert len(f1) == len(f2)
            for c, (x1, x2) in enumerate(zip(f1, f2)):
                if x1 == x2:
                    continue
                assert cols[c] not in INT_COLS, (trial, cols[c], x1, x2)
                v1, v2 = float(x1), float(x2)
                assert abs(v1 - v2) <= 1e-9 * max(1.0, abs(v2)), (trial, cols[c], x1, x2)


def test_exact_engine_matches_jax_exact_engine(rng):
    """The port's exact engine (native scorer) prints the JAX exact
    engine's table, and its Python loop does too."""
    from ntsm_tpu_torch import native

    mx = make_counts(9, 12, 200)
    jd, pd = cohorts(mx, dict(all=True))
    want = io.StringIO()
    jexact.compute_score_all(jd, JOptions(all=True), want)
    got = io.StringIO()
    exact.compute_score_all(pd, Options(all=True), got)
    assert got.getvalue() == want.getvalue()
    assert native.load() is not None
    lib, native._lib = native._lib, None
    native._tried = True
    try:
        loop = io.StringIO()
        exact.compute_score_all(pd, Options(all=True), loop)
    finally:
        native._lib = lib
    assert loop.getvalue() == want.getvalue()
