"""The generators repeat exactly for one seed and change with another."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import gen

SEEDS = (2**31 + 5, 2**31 + 6)


def sites(seed):
    return gen.site_windows(gen.rng_for(seed, 1), 50, 31, 19)


def reads(seed):
    at, cg = sites(seed)
    return gen.make_reads(gen.rng_for(seed, 2), at, cg, 400, 150, 0.3, 0.0035, 0.001, 0.5)


def fastq(seed, tmp_path):
    path = tmp_path / f"r{seed}.fq"
    gen.write_fastq(str(path), gen.rng_for(seed, 3), reads(seed), 1, 2, 40)
    return path.read_bytes()


def cohort(seed):
    rot, _ = gen.rotation(seed, 200, 4, 0.003)
    return gen.make_cohort("cpu", seed, 20, 200, 25, 35, 0.02, 0.1, rotation=rot, clusters=4,
                           cluster_step=0.04, dirty_every=5, dirty_share=0.4)


def rotation(seed):
    return gen.rotation(seed, 200, 4, 0.003)


@pytest.mark.parametrize("make", [sites, reads, cohort, rotation])
def test_same_seed_same_inputs_other_seed_other(make):
    a, b, c = make(SEEDS[0]), make(SEEDS[0]), make(SEEDS[1])
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y)
        assert x.shape != z.shape or not np.array_equal(x, z)


def test_fastq_repeats_and_parses(tmp_path):
    a, b, c = fastq(SEEDS[0], tmp_path), fastq(SEEDS[0], tmp_path), fastq(SEEDS[1], tmp_path)
    assert a == b and a != c
    lines = a.split(b"\n")
    assert lines[0].startswith(b"@A00217:77:HFLWKDSXX:") and len(lines[0]) == 54
    assert lines[2] == b"+" and len(lines[1]) == len(lines[3]) == 150
    assert min(lines[3]) >= 33 + 2 and max(lines[3]) <= 33 + 40


def test_reads_carry_sites_at_the_asked_share():
    at, cg = sites(SEEDS[0])
    r = gen.make_reads(gen.rng_for(SEEDS[0], 2), at, cg, 20000, 150, 0.004, 0.0, 0.0, 0.0)
    text = gen.LETTERS[r]
    wins = {bytes(gen.LETTERS[w]) for w in np.concatenate([at, cg])}
    hit = sum(any(w in row.tobytes() for w in wins) for row in text)
    assert 40 <= hit <= 130  # 80 expected


def test_cohort_plants_the_swap_and_duplicates():
    mx, pairs = gen.make_cohort("cpu", SEEDS[0], 30, 500, 25, 35, 0.02, 0.1)
    assert pairs[0].tolist() == [0, 1] and len(pairs) == 4
    assert mx.shape == (30, 500, 2) and mx.dtype == np.int32 and mx.min() >= 0
    cov = mx.sum(axis=(1, 2)) / 500
    assert 20 < cov.min() and cov.max() < 40


def test_pca_artifacts_hold_what_they_return(tmp_path):
    rot, cen = rotation(SEEDS[0])
    rp, np_, rv, cv = gen.write_pca_artifacts(str(tmp_path), rot, cen)
    rows = open(rp).read().splitlines()
    assert rows[0].split("\t") == ["AlleleID"] + [f"PC{i}" for i in range(4)]
    assert [float(x) for x in rows[1].split("\t")[1:]] == rv[0].tolist()
    assert [float(x) for x in open(np_).read().split()] == cv.tolist()
