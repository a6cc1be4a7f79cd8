"""The host side of the all-vs-all pair-statistics kernel (csrc/pair_stats.cu):
the wrapper's list of live tiles, its choice of micro-tile, and the
reciprocal-and-correction division of csrc/pair_site.cuh:ntsm_quot, emulated
exactly on the CPU."""

from fractions import Fraction

import numpy as np
import pytest

from ntsm_tpu_torch.eval import pair_kernel
from ntsm_tpu_torch.eval.rect import BLOCK_PAIRS, row_blocks

H100_SMS = 132  # the H100 SXM's streaming multiprocessors


def _covered(n, r0, r1, ti, tj, tiles):
    """Every pair (i, j > i) the tiles hold, with multiplicity."""
    got = []
    for t, u in tiles.tolist():
        rows = range(r0 + t * ti, min(r0 + (t + 1) * ti, r1))
        cols = range(u * tj, min((u + 1) * tj, n))
        pairs = [(i, j) for i in rows for j in cols if j > i]
        assert pairs, f"tile ({t}, {u}) of block [{r0}, {r1}) holds no pair j > i"
        got += pairs
    return got


@pytest.mark.parametrize("n,r0,r1", [
    (2, 0, 2), (2, 0, 1), (37, 0, 37), (37, 12, 36), (37, 36, 37), (130, 43, 129),
    (130, 129, 130), (300, 0, 1), (300, 17, 18), (300, 250, 300), (301, 5, 299),
])
@pytest.mark.parametrize("m", range(len(pair_kernel.MICRO_TILES)))
def test_live_tiles_cover_every_pair_once(n, r0, r1, m):
    """Ragged N, r0 and r1, the N = 2 cohort and one-row blocks: the tiles
    hold every pair of the block exactly once, and only live tiles."""
    ri, rj = pair_kernel.MICRO_TILES[m]
    ti, tj = pair_kernel.TILE * ri, pair_kernel.TILE * rj
    tiles = pair_kernel.live_tiles(n, r0, r1, ti, tj)
    assert tiles.dtype == np.int32 and tiles.ndim == 2 and tiles.shape[1] == 2
    got = _covered(n, r0, r1, ti, tj, tiles)
    want = [(i, j) for i in range(r0, r1) for j in range(i + 1, n)]
    assert len(got) == len(want) == pair_kernel.n_block_pairs(n, r0, r1)
    assert sorted(got) == want


@pytest.mark.parametrize("what,n_pairs,want", [
    ("phase 5 proxy rows [700, 956) of 1,024", pair_kernel.n_block_pairs(1024, 700, 956), 0),
    ("phase 5 tail rows [956, 1024) of 1,024", pair_kernel.n_block_pairs(1024, 956, 1024), 0),
    ("phase 6 N = 320, one block", 320 * 319 // 2, 0),
    ("a quarter of BLOCK_PAIRS", BLOCK_PAIRS // 4, 0),
    ("half of BLOCK_PAIRS", BLOCK_PAIRS // 2, 1),
    ("BLOCK_PAIRS", BLOCK_PAIRS, 1),
])
def test_micro_tile_choice(what, n_pairs, want):
    """On the H100 SXM's 132 SMs."""
    assert pair_kernel.micro_tile(n_pairs, H100_SMS) == want, what


@pytest.mark.parametrize("n_sms", [H100_SMS, 114])
def test_micro_tile_choice_at_n_3202(n_sms):
    """Phase 7 (and phase 5's full-size block, its first): N = 3202 runs
    every block, its ragged last one (933,661 pairs) too, on the 2x2
    micro-tile, each with at least THREADS_PER_SM threads an SM, on 132 SMs
    and on an H100 PCIe's 114."""
    blocks = list(row_blocks(3202, BLOCK_PAIRS))
    got = [pair_kernel.micro_tile(pair_kernel.n_block_pairs(3202, r0, r1), n_sms)
           for r0, r1 in blocks]
    assert got == [1, 1, 1]
    for (r0, r1), m in zip(blocks, got):
        ri, rj = pair_kernel.MICRO_TILES[m]
        need = n_sms * pair_kernel.THREADS_PER_SM * ri * rj
        assert pair_kernel.n_block_pairs(3202, r0, r1) >= need


def test_micro_tile_threshold_follows_the_sm_count():
    """The 2x2 threshold is 4 * 1024 threads an SM: a block between 114
    and 132 SMs' thresholds is 2x2 on the smaller card only."""
    n_pairs = 4 * 1024 * 120
    assert pair_kernel.micro_tile(n_pairs, 114) == 1
    assert pair_kernel.micro_tile(n_pairs, H100_SMS) == 0
    assert pair_kernel.micro_tile(4 * 1024 * H100_SMS, H100_SMS) == 1


def _fma(x: float, y: float, z: float) -> float:
    """RN(x y + z) with one rounding: Fraction is exact, float() rounds to
    nearest even."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _quot(x: float, d: float) -> float:
    """csrc/pair_site.cuh:ntsm_quot: r = RN(1/d) (__drcp_rn; CPython's 1.0 / d
    is IEEE), q0 = RN(x r), e = RN(x - q0 d) (one FMA), RN(q0 + e r)."""
    r = 1.0 / d
    q0 = x * r
    e = _fma(-q0, d, x)
    return _fma(e, r, q0)


def test_reciprocal_division_is_ieee_division_small():
    """Every 0 <= a <= d <= 512."""
    bad = [(a, d) for d in range(1, 513) for a in range(d + 1)
           if _quot(float(a), float(d)) != a / d]
    assert bad == []


def test_reciprocal_division_is_ieee_division_random():
    """20,000 seeded random pairs 0 <= a <= d < 2^33, d >= 1 (the domain:
    den is a sum of four int32 counts, below 2^33), half of them with d
    past 2^32, and the largest a for d near 2^32 and 2^33."""
    rng = np.random.default_rng(6)
    d = np.concatenate([rng.integers(1, 2**32, 10_000), rng.integers(2**32, 2**33, 10_000)])
    a = np.minimum((rng.random(d.size) * (d + 1)).astype(np.int64), d)
    top = [2**33 - 1, 2**33 - 3, 2**32 + 1, 2**32 - 1]
    a = [*a.tolist(), *(x - k for x in top for k in (0, 1, 2)), *([1] * len(top))]
    d = [*d.tolist(), *(x for x in top for _ in range(3)), *top]
    bad = [(x, y) for x, y in zip(a, d)
           if _quot(float(x), float(y)) != float(x) / float(y)]
    assert bad == []
