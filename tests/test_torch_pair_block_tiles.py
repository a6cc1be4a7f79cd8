"""The host plan of the -p candidate-pair kernel (csrc/pair_block_stats.cu):
eval/pair_kernel.py:plan_pair_blocks lays a candidate list out in tiles for
the tile instance and blocks for the sparse instance.  Pure numpy, on the
CPU: every listed pair is covered once, at its output index, on list shapes
the kernel meets, and the density threshold picks the instance."""

import numpy as np
import pytest
import torch

from ntsm_tpu_torch.eval import pair_kernel
from ntsm_tpu_torch.experiments.exp_pair_block_stats import (
    cluster_pairs, exhaustive_pairs, grouped_pairs, merged)

torch.set_num_threads(1)
TILE = pair_kernel.TILE


def _slots(plan):
    """Every pair slot the plan computes: (i, j, output index) of the tile
    slots that hold a pair, then of the sparse entries."""
    t, r, c = np.nonzero(plan.outs >= 0)
    tiled = (plan.rows[t, r], plan.cols[t, c], plan.outs[t, r, c])
    q = np.arange(plan.n_sparse)
    sparse = (plan.irows[q // pair_kernel.SPARSE_PAIRS, plan.islot], plan.jrow, plan.out)
    return tuple(np.concatenate([x, y]).astype(np.int64) for x, y in zip(tiled, sparse))


def check_plan(ii, jj, n, plan):
    """The plan's arrays are well formed, and every index p of the list is
    computed once at p (a first listing) or copied once from the first
    listing of the same (i, j)."""
    ii, jj = np.asarray(ii, np.int64), np.asarray(jj, np.int64)
    P = ii.size
    assert plan.n_pairs == P and plan.n_samples == n
    for x in (plan.rows, plan.cols, plan.outs, plan.irows, plan.islot, plan.jrow, plan.out):
        assert x.dtype == np.int32 and x.flags.c_contiguous
    T = plan.n_tiles
    assert plan.rows.shape == (T, TILE) and plan.cols.shape == (T, TILE)
    assert plan.outs.shape == (T, TILE, TILE)
    assert plan.irows.shape == (-(-plan.n_sparse // pair_kernel.SPARSE_PAIRS),
                                plan.irows.shape[1])
    assert 1 <= plan.irows.shape[1] <= pair_kernel.SPARSE_PAIRS
    # a tile's samples are distinct, -1 only past them; a slot's pair lies in
    # the tile's row and column
    for a in (plan.rows, plan.cols):
        assert ((a >= -1) & (a < n)).all()
        for row in a:
            live = row[row >= 0]
            assert np.unique(live).size == live.size and (row[live.size:] == -1).all()
    t, r, c = np.nonzero(plan.outs >= 0)
    assert (plan.rows[t, r] >= 0).all() and (plan.cols[t, c] >= 0).all()
    # each sparse block's distinct i's packed first
    for blk in plan.irows:
        live = blk[blk >= 0]
        assert np.unique(live).size == live.size and (blk[live.size:] == -1).all()
    gi, gj, gp = _slots(plan)
    assert (gi == ii[gp]).all() and (gj == jj[gp]).all()
    d, rep = plan.dup
    assert (ii[d] == ii[rep]).all() and (jj[d] == jj[rep]).all()
    seen = np.bincount(np.concatenate([gp, d]), minlength=P)
    assert (seen == 1).all()
    # the computed index is the first listing of its pair
    key = ii * n + jj
    first = np.unique(key, return_index=True)[1]
    assert np.array_equal(np.sort(gp), np.sort(first))
    assert np.isin(rep, first).all()


def _lists():
    rng = np.random.default_rng(5)
    g9 = grouped_pairs(np.random.default_rng(9), 1024, 50_037)
    ex = exhaustive_pairs(3202, np.arange(49, 3202, 50))
    both = (np.array([3, 7, 7, 3, 3, 9], np.int32), np.array([7, 3, 9, 7, 9, 3], np.int32))
    ragged_n = 37
    return {
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int32), 5),
        "single": (np.array([4], np.int32), np.array([1], np.int32), 6),
        "duplicates and both orders": (*both, 10),
        "ragged last tile": (*np.triu_indices(ragged_n, 1), ragged_n),
        "64 exhaustive rows": (*ex, 3202),
        "interleaved s % 16 clusters": (*cluster_pairs(rng, 700), 700),
        "clusters and exhaustive rows": (*merged(cluster_pairs(rng, 500),
                                                 exhaustive_pairs(500, [9, 250, 499])), 500),
        "phase 9 grouped": (*g9, 1024),
        "random with repeats": (rng.integers(0, 40, 3000), (rng.integers(1, 40, 3000)), 80),
    }


LISTS = _lists()


@pytest.mark.parametrize("name", list(LISTS))
@pytest.mark.parametrize("density_min", [0.0, pair_kernel.DENSITY_MIN, 2.0])
def test_plan_covers_every_pair_once(name, density_min):
    ii, jj, n = LISTS[name]
    if name == "random with repeats":
        jj = (ii + jj) % n
    plan = pair_kernel.plan_pair_blocks(ii, jj, n, density_min)
    check_plan(ii, jj, n, plan)
    if density_min == 0.0:
        assert plan.n_sparse == 0
    if density_min > 1.0:
        assert plan.n_tiles == 0 and plan.n_sparse == np.unique(
            np.asarray(ii, np.int64) * n + jj).size


def test_empty_plan_launches_nothing():
    plan = pair_kernel.plan_pair_blocks(np.zeros(0), np.zeros(0), 3)
    assert plan.n_tiles == plan.n_sparse == plan.dup.shape[1] == 0
    assert plan.density() == 1.0 and plan.slots() == 0


def test_duplicates_and_both_orders():
    """A pair listed three times is computed once, at its first index, and
    copied to the others; (i, j) and (j, i) are two pairs."""
    ii, jj, n = LISTS["duplicates and both orders"]
    plan = pair_kernel.plan_pair_blocks(ii, jj, n, 0.0)
    gi, gj, gp = _slots(plan)
    assert sorted(zip(gi.tolist(), gj.tolist(), gp.tolist())) == [
        (3, 7, 0), (3, 9, 4), (7, 3, 1), (7, 9, 2), (9, 3, 5)]
    assert plan.dup.tolist() == [[3], [0]]


@pytest.mark.parametrize("name", ["64 exhaustive rows", "interleaved s % 16 clusters",
                                  "clusters and exhaustive rows", "phase 9 grouped"])
def test_density_threshold_picks_the_instance(name):
    """The grouping does not depend on the threshold: the tiles of a plan
    at DENSITY_MIN are the tiles of the all-tiles plan whose distinct
    listed pairs fill at least DENSITY_MIN of the TILE x TILE slots, and
    the pairs of the others go to the sparse instance."""
    ii, jj, n = LISTS[name]
    every = pair_kernel.plan_pair_blocks(ii, jj, n, 0.0)
    listed = (every.outs >= 0).sum(axis=(1, 2))
    dense = listed >= pair_kernel.DENSITY_MIN * TILE * TILE
    plan = pair_kernel.plan_pair_blocks(ii, jj, n)
    assert np.array_equal(plan.rows, every.rows[dense])
    assert np.array_equal(plan.cols, every.cols[dense])
    assert np.array_equal(plan.outs, every.outs[dense])
    assert plan.n_sparse == listed[~dense].sum()
    assert plan.tile_density() >= pair_kernel.DENSITY_MIN


def test_dense_rows_go_to_tiles_and_thin_rows_to_the_sparse_instance():
    """64 exhaustive rows fill whole tiles (the tile instance); phase 9's
    rows of 1-5 pairs, with random j's, fill no tile of their own: their
    pairs go to the sparse instance but for the few that share a tile with
    long rows, which mostly tile."""
    ii, jj, n = LISTS["64 exhaustive rows"]
    plan = pair_kernel.plan_pair_blocks(ii, jj, n)
    assert plan.n_sparse < 0.01 * ii.size and plan.tile_density() > 0.95
    ii, jj, n = LISTS["phase 9 grouped"]
    plan = pair_kernel.plan_pair_blocks(ii, jj, n)
    deg = np.bincount(ii, minlength=n)
    short = (deg > 0) & (deg <= 5)
    q = np.arange(plan.n_sparse)
    sparse_i = plan.irows[q // pair_kernel.SPARSE_PAIRS, plan.islot]
    assert short[sparse_i].sum() > 0.95 * short[ii].sum()
    assert plan.n_tiled > 2 * plan.n_sparse


def test_interleaved_clusters_tile_densely():
    """Sample s in cluster s % 16: tiles of rows in index order would be
    about 1/16 dense; the plan's groups hold one cluster each."""
    ii, jj, n = LISTS["interleaved s % 16 clusters"]
    plan = pair_kernel.plan_pair_blocks(ii, jj, n)
    assert plan.density() > 0.4
    per_tile = [np.unique(plan.rows[k][plan.rows[k] >= 0] % 16).size for k in range(plan.n_tiles)]
    assert np.mean(np.array(per_tile) == 1) > 0.8


def _emulate(a, b, s, plan, mc, n_sites):
    """The plan run as the kernels run it, each slot by the plain version:
    tiles, sparse blocks, then the copies of repeated pairs."""
    P = plan.n_pairs
    ints = torch.full((5, P), -7, dtype=torch.int32)
    sums = torch.full((2, P), np.nan, dtype=torch.float64)
    gi, gj, gp = _slots(plan)
    if gp.size:
        i32 = lambda x: torch.from_numpy(x.astype(np.int32))  # noqa: E731
        vi, vf = pair_kernel.pair_block_stats_plain(a, b, s, i32(gi), i32(gj), mc, n_sites)
        ints[:, gp], sums[:, gp] = vi, vf
    d, rep = (torch.from_numpy(x) for x in plan.dup)
    ints[:, d], sums[:, d] = ints[:, rep], sums[:, rep]
    return ints, sums


@pytest.mark.parametrize("name", ["duplicates and both orders", "ragged last tile",
                                  "clusters and exhaustive rows", "random with repeats"])
@pytest.mark.parametrize("mc", [-1, 1])
def test_plan_run_equals_the_list_run(name, mc):
    """Computing the plan's slots and copying the repeats gives the plain
    version's result on the list itself, index for index."""
    ii, jj, n = LISTS[name]
    if name == "random with repeats":
        jj = (ii + jj) % n
    rng = np.random.default_rng(n)
    L = 70
    a = torch.from_numpy(rng.poisson(6, (n, L)).astype(np.int32))
    b = torch.from_numpy(rng.poisson(6, (n, L)).astype(np.int32))
    s = pair_kernel.s_single_plane(a, b, mc)
    it = torch.from_numpy(np.asarray(ii, np.int32))
    jt = torch.from_numpy(np.asarray(jj, np.int32))
    want = pair_kernel.pair_block_stats(a, b, s, it, jt, mc, L - 3)
    for density_min in (0.0, pair_kernel.DENSITY_MIN, 2.0):
        plan = pair_kernel.plan_pair_blocks(ii, jj, n, density_min)
        got = _emulate(a, b, s, plan, mc, L - 3)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("ii,jj,n,err", [
    ([0, 1], [1, 4], 4, ValueError),  # j outside [0, N)
    ([-1], [2], 4, ValueError),  # i negative
    ([2], [2], 4, ValueError),  # a pair (i, i)
    ([0, 1], [1], 4, ValueError),  # lengths differ
])
def test_plan_rejects_bad_lists(ii, jj, n, err):
    with pytest.raises(err):
        pair_kernel.plan_pair_blocks(np.array(ii), np.array(jj), n)


def test_components():
    """Labels equal exactly within each connected component."""
    u = np.array([0, 2, 5, 6, 6])
    v = np.array([1, 3, 4, 5, 7])
    lab = pair_kernel._components(9, u, v)
    groups = {}
    for x, g in enumerate(lab.tolist()):
        groups.setdefault(g, []).append(x)
    assert sorted(groups.values()) == [[0, 1], [2, 3], [4, 5, 6, 7], [8]]
