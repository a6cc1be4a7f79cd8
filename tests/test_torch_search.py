"""The device engine's -p candidate search (eval/search_kernel.py) and its
row-chunked count planes (eval/rect.py:device_planes), on the CPU.

* The search's plain version is eval/pca.py:pca_candidate_arrays, and the
  JAX package's, element for element: seeded clouds of up to 300 samples in 1, 4, 20 and 23
  dimensions, all three radius tiers, duplicate points, distances exactly
  at a radius, ties in distance, cohorts with every row exhaustive and
  with none, at blocks of 1, 7 and N rows.
* Its distance is numpy's pairwise sum, pinned on terms whose f64 sum
  changes with the order of the additions.
* The planes filled in row blocks are the whole-array planes bit for bit
  at blocks of 1, 3 and N rows, from int32 and int64 counts.
* run_eval -p carries the new stages, and the counters count.
* The benchmark's blocked reference list (portbench/ref_eval_blocked.py)
  is portbench/ref_eval.py's.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from ntsm_tpu.eval import pca as jpca
from ntsm_tpu_torch.eval import pair_kernel, pca, rect, search_kernel
from ntsm_tpu_torch.eval.driver import run_eval
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options
from portbench import ref_eval, ref_eval_blocked

torch.set_num_threads(1)

DBL_MAX = pca.DBL_MAX
R1, R2 = 4.0, 225.0  # squared radii of the two finite tiers (2 and 15)


def tiers(rng, n: int, kind: str) -> np.ndarray:
    """Squared radii: 'mixed' draws all three tiers, 'exhaustive' every row
    DBL_MAX, 'finite' none."""
    if kind == "exhaustive":
        return np.full(n, DBL_MAX)
    u = rng.random(n)
    rad = np.where(u < 0.6, R1, R2)
    if kind == "mixed":
        rad[u > 0.9] = DBL_MAX
    return rad


def cloud_for(rng, n: int, dim: int) -> np.ndarray:
    """Clustered points at a scale that puts many pairs near the radii,
    with a few rows repeated (distance 0)."""
    centers = rng.normal(0, 3, size=(5, dim))
    c = centers[rng.integers(0, 5, n)] + rng.normal(0, 1.2, size=(n, dim))
    dup = rng.integers(0, n, (max(1, n // 20), 2))
    c[dup[:, 1]] = c[dup[:, 0]]
    return c


def search(cloud: np.ndarray, rad: np.ndarray, rows: int):
    ii, jj, hi, hj = search_kernel.candidate_search(torch.from_numpy(cloud),
                                                    torch.from_numpy(rad), rows=rows)
    np.testing.assert_array_equal(ii.numpy(), hi)
    np.testing.assert_array_equal(jj.numpy(), hj)
    assert ii.dtype == jj.dtype == torch.int32 and hi.dtype == hj.dtype == np.int64
    return hi, hj


def assert_same_list(cloud, rad, dim, rows):
    """The search's list is the port's host list and the JAX package's."""
    want = pca.pca_candidate_arrays(cloud, rad, dim)
    got = search(cloud[:, :dim].copy(), rad, rows)
    jax_list = jpca.pca_candidate_arrays(cloud, rad, dim)
    for k in (0, 1):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], jax_list[k])
    return want


@pytest.mark.parametrize("rows", [1, 7, None])
@pytest.mark.parametrize("kind", ["mixed", "finite", "exhaustive"])
@pytest.mark.parametrize("dim", [1, 4, 20, 23])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_is_the_host_list(seed, dim, kind, rows):
    rng = np.random.default_rng([seed, dim])
    n = int(rng.integers(2, 120)) if seed == 0 else 300
    cloud = cloud_for(rng, n, dim)
    rad = tiers(rng, n, kind)
    ii, _ = assert_same_list(cloud, rad, dim, rows or n)
    if kind == "finite" and n > 20:
        assert ii.size > n  # the rows find one another


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_search_at_the_radius_and_ties(rows):
    """Points on an integer grid: squared distances are exact integers, so
    many lie exactly at r = 4 (kept out: the test is strict) and many tie
    (kept in index order); r = 5 and the tiers' pruning between them."""
    g = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0), np.arange(3.0)), -1).reshape(-1, 3)
    g = np.concatenate([g, g[:5]])  # repeated points
    rng = np.random.default_rng(9)
    rad = rng.choice([4.0, 5.0, DBL_MAX], size=g.shape[0], p=[0.5, 0.4, 0.1])
    sq = ((g[:, None] - g[None]) ** 2).sum(-1)
    assert (sq == 4.0).sum() > 50 and (sq == 1.0).sum() > 50
    ii, jj = assert_same_list(g, rad, 3, rows)
    finite = rad[ii] < DBL_MAX
    assert not np.any(sq[ii[finite], jj[finite]] >= rad[ii[finite]])


def test_search_when_one_sample_or_no_match():
    assert_same_list(np.zeros((1, 3)), np.array([R1]), 3, 1)
    far = np.arange(10.0)[:, None] * 100.0
    ii, _ = assert_same_list(far, np.full(10, R1), 1, 3)
    assert ii.size == 0


def test_pairwise_sum_pins_numpy_order():
    """Terms 1, then 2^-53 several times: added one after the other every
    2^-53 is lost against 1, while the pairwise order first adds them to
    one another.  pairwise_sum gives numpy's sum at every length, and at
    the lengths where the orders differ not the sequential one."""
    tiny = 2.0 ** -53
    differs = 0
    for n in (3, 8, 9, 16, 20, 23, 130, 300):
        t = np.full(n, tiny)
        t[0] = 1.0
        t[n // 2] = 3.0
        got = float(search_kernel.pairwise_sum(torch.from_numpy(t[None, :]))[0])
        want = float(np.array(t)[None, :].sum(axis=1)[0])
        assert got == want, n
        seq = 0.0
        for x in t:
            seq += x
        differs += got != seq
    assert differs >= 4


@pytest.mark.parametrize("dim", [4, 20, 23, 130])
def test_distances_are_sq_dists_blocked(dim):
    rng = np.random.default_rng(dim)
    c = rng.normal(size=(40, dim)) * np.exp(rng.uniform(-20, 20, size=(40, dim)))
    want = pca.sq_dists_blocked(c)
    x = torch.from_numpy(c)
    d = x[:, None, :] - x[None, :, :]
    got = search_kernel.pairwise_sum(d * d).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_radius_matches_plain_rows_and_order():
    rng = np.random.default_rng(4)
    c = cloud_for(rng, 60, 5)
    rad = tiers(rng, 60, "mixed")
    i, j, d = search_kernel.radius_matches(torch.from_numpy(c), torch.from_numpy(rad), 10, 50)
    i, j, d = i.numpy(), j.numpy(), d.numpy()
    sq = pca.sq_dists_blocked(c)
    want = [(a, b) for a in range(10, 50) if rad[a] < DBL_MAX
            for b in range(60) if b != a and sq[a, b] < rad[a]]
    assert list(zip(i.tolist(), j.tolist())) == want
    np.testing.assert_array_equal(d, sq[i, j])


def test_search_counters_and_no_launch_on_the_cpu():
    rng = np.random.default_rng(12)
    c = cloud_for(rng, 80, 4)
    rad = tiers(rng, 80, "mixed")
    before = dict(pca.counters)
    launched = search_kernel.launches_radius
    ii, _ = search(c, rad, 16)
    dev = {k: pca.counters[k] - before[k] for k in before}
    before = dict(pca.counters)
    pca.pca_candidate_arrays(c, rad, 4)
    host = {k: pca.counters[k] - before[k] for k in before}
    assert dev == host and search_kernel.launches_radius == launched
    sq = pca.sq_dists_blocked(c)
    fin = rad < DBL_MAX
    assert dev["search_rows"] == fin.sum() and dev["candidates"] == ii.size
    assert dev["within_radius"] == int(((sq < rad[:, None]) & fin[:, None]).sum() - fin.sum())
    ex = ~fin
    assert dev["exhaustive"] == sum(80 - 1 - int(ex[:i].sum()) for i in np.flatnonzero(ex))


def test_search_checks_its_inputs():
    c = torch.zeros((5, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        search_kernel.candidate_search(c.float(), torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        search_kernel.candidate_search(c, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        search_kernel.radius_matches(c, torch.zeros(5, dtype=torch.float64), 3, 6)


def test_n_chunks():
    assert search_kernel.n_chunks(32768, 32768, 132) == 5
    assert search_kernel.n_chunks(3202, 3202, 132) == 26
    assert search_kernel.n_chunks(10, 100, 132) == 1
    assert search_kernel.n_chunks(1, 10**6, 132) == 1056


# ---------------------------------------------------------------- planes


def cohort_data(rng, n: int, L: int, dtype=np.int32, mc: int = 1) -> CountData:
    mx = rng.poisson(9, size=(n, L, 2)).astype(dtype)
    mx[::4, : L // 3] = 0
    mx[1, 0] = (0, 0)
    tot = mx.sum(axis=(1, 2), dtype=np.int64)
    opts = Options(engine="cuda", min_cov=mc)
    return CountData(filenames=[f"s{i}" for i in range(n)],
                     locus_ids=[f"rs{i}" for i in range(L)],
                     distinct=np.full((L, 2), 13, np.int64), max_counts=mx,
                     sum_counts=mx.astype(np.int64) * 13, raw_total_kmers=tot * 37_000,
                     ks=np.full(n, 19, np.int64), total_counts=tot).prepare(opts)


def whole_planes(data: CountData) -> tuple:
    """The planes as one upload of the whole [N, L, 2] array makes them."""
    mc = np.ascontiguousarray(data.max_counts, dtype=np.int32)
    N, L = mc.shape[:2]
    Lp = L + (-L) % rect.SITE_ALIGN
    both = torch.from_numpy(mc)
    a = torch.zeros((N, Lp), dtype=torch.int32)
    b = torch.zeros((N, Lp), dtype=torch.int32)
    a[:, :L] = both[:, :, 0]
    b[:, :L] = both[:, :, 1]
    return a, b, pair_kernel.s_single_plane(a, b, data._min_cov)


@pytest.mark.parametrize("mc", [-1, 1, 3])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("rows", [1, 3, None])
def test_planes_in_row_blocks_are_the_whole_arrays(rows, dtype, mc):
    rng = np.random.default_rng([int(rows or 0), mc + 1])
    data = cohort_data(rng, 13, 70, dtype, mc)
    before = dict(rect.counters)
    got = rect.device_planes(data, "cpu", rows=rows or 13)
    for x, y in zip(got, whole_planes(data)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.int32 else x.view(torch.int64),
                           y.view(torch.int32) if y.dtype == torch.int32 else y.view(torch.int64))
    assert rect.counters["upload_chunks"] - before["upload_chunks"] == -(-13 // (rows or 13))
    assert rect.counters["upload_bytes"] - before["upload_bytes"] == 13 * 70 * 2 * 4
    # the s plane is the exact engine's over the real sites, 0 on the pad
    np.testing.assert_array_equal(got[2][:, :70].numpy(), data.s_single)
    assert not got[2][:, 70:].any()


# (N, rows, slot_bytes, dtype, layout) of the staging ring's cases; a row
# is L * 2 = 140 counts (560 bytes)
RING_CASES = {
    "slot_under_a_row": (13, 5, 100, np.int32, "c"),
    "slot_divides_nothing": (13, 3, 37 * 4, np.int32, "c"),
    "more_pieces_than_slots": (13, 4, 60 * 4, np.int32, "c"),
    "n_under_one_slot": (3, None, rect.SLOT_BYTES, np.int32, "c"),
    "int64_source": (13, 3, 37 * 4, np.int64, "c"),
    "non_contiguous_source": (13, 4, 50 * 4, np.int64, "strided"),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_planes_through_the_staging_ring_are_the_whole_arrays(case):
    N, rows, slot_bytes, dtype, layout = RING_CASES[case]
    data = cohort_data(np.random.default_rng(len(case)), N, 70, dtype, 1)
    if layout == "strided":
        wide = np.zeros((N, 140, 2), dtype)
        wide[:, ::2] = data.max_counts
        data.max_counts = wide[:, ::2]
        assert not data.max_counts.flags.c_contiguous
    per = slot_bytes // 4
    assert case != "slot_under_a_row" or per < 140
    assert case != "slot_divides_nothing" or (140 % per and 3 * 140 % per)
    assert case != "more_pieces_than_slots" or 4 * 140 // per > rect.RING_SLOTS
    assert case != "n_under_one_slot" or N * 140 < per
    before = dict(rect.counters)
    got = rect.device_planes(data, "cpu", rows=rows or rect.UPLOAD_ROWS, slot_bytes=slot_bytes)
    for x, y in zip(got, whole_planes(data)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) if x.dtype == torch.int32 else torch.equal(
            x.view(torch.int64), y.view(torch.int64))
    grew = {k: rect.counters[k] - before[k] for k in before}
    assert grew == {"upload_bytes": N * 70 * 2 * 4,
                    "upload_chunks": -(-N // (rows or rect.UPLOAD_ROWS)),
                    "upload_staged_bytes": 0}  # no slot is pinned off the card


def test_planes_refuse_counts_past_int32():
    data = cohort_data(np.random.default_rng(2), 4, 40, np.int64)
    data.max_counts[2, 5, 1] = 2**31
    with pytest.raises(ValueError, match="int32"):
        rect.device_planes(data, "cpu")


# ---------------------------------------------------------------- run_eval


def pca_world(tmp_path, n: int = 40, L: int = 300, dim: int = 4):
    rng = np.random.default_rng(31)
    freq = rng.uniform(0.05, 0.95, (3, L))
    geno = (rng.random((n, L)) < freq[np.arange(n) % 3]).astype(np.int64)
    geno += rng.random((n, L)) < freq[np.arange(n) % 3]
    mx = np.stack([rng.poisson(12 * (2 - geno)), rng.poisson(12 * geno)], 2).astype(np.int32)
    mx[::9, : L // 2] = 0  # exhaustive rows
    rot_p, norm_p = tmp_path / "rot.tsv", tmp_path / "norm.txt"
    rot = rng.normal(0, 2.0 / np.sqrt(L), (L, dim + 1))
    norm_p.write_text("".join(f"{v!r}\n" for v in rng.uniform(0, 1, L).tolist()))
    rot_p.write_text("AlleleID\t" + "\t".join(map(str, range(dim + 1))) + "\n" + "".join(
        f"rs{i}\t" + "\t".join(repr(x) for x in rot[i].tolist()) + "\n" for i in range(L)))
    opts = Options(engine="cuda", all=True, min_cov=1, dim=dim, pca=str(rot_p), norm=str(norm_p))
    tot = mx.sum(axis=(1, 2), dtype=np.int64)
    data = CountData(filenames=[f"s{i}" for i in range(n)], locus_ids=[f"rs{i}" for i in range(L)],
                     distinct=np.full((L, 2), 13, np.int64), max_counts=mx, sum_counts=mx * 13,
                     raw_total_kmers=tot * 37_000, ks=np.full(n, 19, np.int64),
                     total_counts=tot).prepare(opts)
    return data, opts


def test_run_eval_pca_carries_the_new_stages_and_counts(tmp_path):
    data, opts = pca_world(tmp_path)
    before, up = dict(pca.counters), dict(rect.counters)
    sink = io.StringIO()
    times = run_eval(data, opts, sink, device="cpu")
    for k in ("candidates.search.radius", "candidates.search.order", "upload.copy"):
        assert k in times and times[k] > 0, k
    assert times["candidates.search"] >= (times["candidates.search.radius"]
                                          + times["candidates.search.order"])
    assert times["upload"] >= times["upload.copy"]
    got = {k: pca.counters[k] - before[k] for k in before}
    assert got["candidates"] == times["pairs"] == sink.getvalue().count("\n") - 1
    assert got["search_rows"] == int((pca.search_radii(data, opts) < DBL_MAX).sum())
    assert got["exhaustive"] > 0 and got["within_radius"] > 0
    assert rect.counters["upload_chunks"] - up["upload_chunks"] == 1
    assert rect.counters["upload_bytes"] - up["upload_bytes"] == data.max_counts.nbytes
    # the table is the exact engine's
    exact = io.StringIO()
    run_eval(data, dataclasses.replace(opts, engine="exact"), exact, device="cpu")
    assert [r.split("\t")[:2] for r in sink.getvalue().splitlines()] == [
        r.split("\t")[:2] for r in exact.getvalue().splitlines()]


def test_run_eval_all_vs_all_times_the_copies():
    data = cohort_data(np.random.default_rng(5), 9, 50)
    opts = Options(engine="cuda", all=True, min_cov=1)
    times = run_eval(data, opts, io.StringIO(), device="cpu")
    assert "upload.copy" in times and times["upload"] >= times["upload.copy"] > 0


# ---------------------------------------------------------------- the benchmark's reference


@pytest.mark.parametrize("block", [1, 7, None])
@pytest.mark.parametrize("kind", ["mixed", "finite", "exhaustive"])
def test_blocked_reference_is_ref_eval(kind, block):
    rng = np.random.default_rng(len(kind))
    c = cloud_for(rng, 90, 20)
    rad = tiers(rng, 90, kind)
    want = ref_eval.candidates(c, rad)
    ii, jj, within = ref_eval_blocked.search(c, rad, block=block or 90)
    np.testing.assert_array_equal(ii, want[0])
    np.testing.assert_array_equal(jj, want[1])
    got = ref_eval_blocked.candidates(c, rad, block=block or 90)
    np.testing.assert_array_equal(got[0], want[0])
    sq = ((c[:, None] - c[None]) ** 2).sum(-1)
    fin = rad < DBL_MAX
    assert within == int(((sq < rad[:, None]) & fin[:, None]).sum() - fin.sum())
