"""The roofline functions against hand counts on tiny shapes."""

from __future__ import annotations

import math

import pytest

from portbench import roofline as rf


def test_least_s_is_the_larger_bound():
    assert rf.least_s(3.35e12, 0, 1) == pytest.approx(1.0)
    assert rf.least_s(0, 68e12, 34e12) == pytest.approx(2.0)


def test_pair_stats_counts_eight_f64_ops_a_valid_pair_site():
    # 4 samples, 10 sites, every sample valid: 6 pairs x 10 sites = 60 pair-sites
    ops_s = 60 * 8 / 34e12
    bytes_s = 4 * 10 * 16 / 3.35e12
    assert rf.pair_stats_least_s(60, 4, 10) == pytest.approx(max(ops_s, bytes_s))


def test_pair_block_counts_touched_rows_list_and_results():
    # 3 pairs over 4 touched rows of 100 sites, 250 valid pair-sites
    want = max((4 * 100 * 16 + 3 * 44) / 3.35e12, 250 * 8 / 34e12)
    assert rf.pair_block_least_s(250, 4, 100, 3) == pytest.approx(want)


def test_count_step_bytes_by_hand():
    # 2 launches, 16 buckets, 32 valid windows: 16 each, 16 (1 - e^-1) buckets a launch
    buckets = 2 * 16 * (1 - math.exp(-1))
    n_bytes = 1000 + buckets * 8 + 3 * (8 * 12 + 8)
    ops = (40 * 25 + 32 * 10) * 2
    want = max(n_bytes / 3.35e12, ops / 67e12)
    assert rf.count_step_least_s(1000, 40, 32, 3, 16, 2) == pytest.approx(want)
    assert rf.count_step_least_s(1000, 40, 32, 3, 16, 0) == 0.0
