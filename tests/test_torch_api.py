"""The port's Python API (ntsm_tpu_torch/api.py): tests/test_api.py's
round trip on device="cpu", and the port against the JAX package's api on
the same seeded files: counts equal, evaluate's rows equal (scores within
1e-9 max(1, |score|)), merged bytes equal; the card is the default device
and its absence raises."""

import numpy as np
import pytest
import torch

import ntsm_tpu.api as jax_api
import ntsm_tpu_torch.api as api
from tests.synth import make_reads_fastq, make_site_fasta

torch.set_num_threads(1)


def test_api_round_trip(rng, tmp_path):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=16, path=sites_path)
    fq_a = str(tmp_path / "a.fq")
    fq_b = str(tmp_path / "b.fq")
    make_reads_fastq(rng, sites, coverage=8, genotype="het", path=fq_a)
    make_reads_fastq(rng, sites, coverage=8, genotype="hom_ref", path=fq_b)

    table = api.load_sites(sites_path)
    res_a = api.count(table, [fq_a], device="cpu")
    res_g = api.count(table, [fq_a], engine="golden")
    np.testing.assert_array_equal(res_a.counts, res_g.counts)

    ca = str(tmp_path / "a_counts.txt")
    cb = str(tmp_path / "b_counts.txt")
    api.write_counts(ca, table, res_a)
    api.write_counts(cb, table, api.count(table, [fq_b], device="cpu"))

    rows = api.evaluate([ca, cb], device="cpu")
    assert len(rows) == 1
    row = rows[0]
    assert row["sample1"].endswith("a_counts.txt")
    assert isinstance(row["score"], float)
    assert row["n"] > 0

    # exact engine agrees on classification
    rows_exact = api.evaluate([ca, cb], engine="exact")
    assert rows_exact[0]["same"] == row["same"]

    merged = str(tmp_path / "merged.txt")
    api.merge_counts([ca, cb], merged)
    res_m = api.evaluate([merged, ca], device="cpu")
    assert len(res_m) == 1


def test_api_conveniences(rng, tmp_path):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=8, path=sites_path)
    fq = str(tmp_path / "a.fq")
    make_reads_fastq(rng, sites, coverage=6, genotype="het", path=fq)
    table = api.load_sites(sites_path)
    res = api.count(table, [fq], engine="golden")
    cov = res.coverage(table)
    assert cov > 0
    err = res.error_rate(table, genome_size=1e5)
    assert -1.0 <= err < 1.0
    # kwargs apply on top of an explicit opts object
    res2 = api.count(
        table, [fq], max_cov=1.0, engine="golden", opts=api.Options()
    )
    assert res2.early_term
    assert api.__all__ == jax_api.__all__


def _world(seed: int, tmp_path, n_samples: int = 5):
    rng = np.random.default_rng(seed)
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=24, path=sites_path)
    fqs = []
    for s in range(n_samples):
        fq = str(tmp_path / f"s{s}.fq")
        make_reads_fastq(rng, sites, coverage=int(rng.integers(3, 12)),
                         genotype=["het", "hom_ref", "hom_alt"][s % 3], path=fq)
        fqs.append(fq)
    return sites_path, fqs


def _close_rows(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key == "score":
                assert abs(g[key] - w[key]) <= 1e-9 * max(1.0, abs(w[key])), (g, w)
            else:  # nan (relate with no shared site) equals nan
                assert type(g[key]) is type(w[key]), (key, g, w)
                assert g[key] == w[key] or (g[key] != g[key] and w[key] != w[key]), (key, g, w)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_api_matches_jax(seed, tmp_path):
    """count (golden and the device engines), write_counts, evaluate (auto,
    the device engine and exact) and merge_counts against the JAX api."""
    sites_path, fqs = _world(seed, tmp_path)
    table, jtable = api.load_sites(sites_path), jax_api.load_sites(sites_path)
    np.testing.assert_array_equal(table.kmer_hashes, jtable.kmer_hashes)
    paths = []
    for s, fq in enumerate(fqs):
        gold = api.count(table, [fq], engine="golden")
        dev = api.count(table, [fq], device="cpu")
        jgold = jax_api.count(jtable, [fq], engine="golden")
        jdev = jax_api.count(jtable, [fq])
        for got in (gold, dev):
            np.testing.assert_array_equal(got.counts, jgold.counts)
            assert got.total_kmers == jgold.total_kmers == jdev.total_kmers
        np.testing.assert_array_equal(jdev.counts, jgold.counts)
        assert dev.coverage(table) == jgold.coverage(jtable)
        assert dev.error_rate(table) == jgold.error_rate(jtable)
        path, jpath = tmp_path / f"s{s}_counts.txt", tmp_path / f"j{s}_counts.txt"
        api.write_counts(str(path), table, dev)
        jax_api.write_counts(str(jpath), jtable, jgold)
        assert path.read_bytes() == jpath.read_bytes()
        paths.append(str(path))

    # every port engine against the JAX exact engine, to which the JAX
    # device engine (compensated f32 pairs, scores off by ~1e-6) is itself
    # held in its own tests
    want = jax_api.evaluate(paths, engine="exact")
    assert len(want) == len(paths) * (len(paths) - 1) // 2
    _close_rows(api.evaluate(paths, device="cpu"), want)
    _close_rows(api.evaluate(paths, engine="cuda", device="cpu"), want)
    _close_rows(api.evaluate(paths, engine="exact"), want)
    jdev = jax_api.evaluate(paths)
    assert [(r["sample1"], r["sample2"], r["same"], r["n"]) for r in jdev] == [
        (r["sample1"], r["sample2"], r["same"], r["n"]) for r in want]
    _close_rows(api.evaluate(paths, all_pairs=False, device="cpu"),
                jax_api.evaluate(paths, all_pairs=False, engine="exact"))

    api.merge_counts(paths[:3], str(tmp_path / "merged.txt"))
    jax_api.merge_counts(paths[:3], str(tmp_path / "jmerged.txt"))
    assert (tmp_path / "merged.txt").read_bytes() == (tmp_path / "jmerged.txt").read_bytes()


def test_api_default_device_is_the_card(tmp_path):
    """Without a card the device engines raise with the CLIs' text; they
    never move to the CPU.  The JAX engine name is refused."""
    sites_path, fqs = _world(7, tmp_path, n_samples=2)
    table = api.load_sites(sites_path)
    for bad in ({"engine": "tpu"}, {"device": "tpu"}):
        with pytest.raises(ValueError, match="engine must be one of cuda, golden"):
            api.count(table, fqs[:1], **bad)
    paths = []
    for s, fq in enumerate(fqs):
        paths.append(str(tmp_path / f"s{s}_counts.txt"))
        api.write_counts(paths[-1], table, api.count(table, [fq], engine="golden"))
    with pytest.raises(ValueError, match="engine must be one of auto, exact, cuda"):
        api.evaluate(paths, engine="tpu")
    (qc,) = api.evaluate(paths[:1])  # one file: QC on the host, on no device
    assert qc["sample1"] == paths[0]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device and none is available"):
        api.count(table, fqs[:1])
    for engine in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="needs a CUDA device and none is available"):
            api.evaluate(paths, engine=engine)
