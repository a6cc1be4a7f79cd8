"""The port's count engine (run_count on the CPU, i.e. the kernels' plain
versions) against the JAX engine run_count_v3 and the reference fixtures:
all 7 fixture samples under the default and a small batch geometry, -m,
checkpoint/resume, segmented long reads, k = 32 and the summary text."""

import math
import pathlib

import numpy as np
import pytest
import torch

from ntsm_tpu.count.engine import EngineConfig as JaxConfig
from ntsm_tpu.count.engine import run_count_v3
from ntsm_tpu.io.sites import load_site_table as jax_load_site_table
from ntsm_tpu.options import Options as JaxOptions
from ntsm_tpu_torch.count.engine import EngineConfig, format_info_summary, run_count
from ntsm_tpu_torch.count.golden import count_files
from ntsm_tpu_torch.io.countfile import format_counts
from ntsm_tpu_torch.io.sites import load_site_table
from ntsm_tpu_torch.options import Options
from tests.synth import make_reads_fastq, make_site_fasta

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
SAMPLES = ["sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow",
           "sampleA_junk", "sampleA_badqual"]
CONFIGS = {
    "default": {},
    "small": dict(batch_reads=64, segment_len=128),
}


@pytest.fixture(scope="module")
def tables():
    sites = str(FIX / "sites.fa")
    return (load_site_table(sites, k=19, allow_dupes=False),
            jax_load_site_table(sites, k=19, allow_dupes=False))


def _text(table, res, k=19):
    mx, sm = res.site_max_sum(table)
    return format_counts(table.site_ids, mx, sm, table.distinct, res.total_kmers, k)


def _totals(res):
    return (res.total_kmers, res.total_hits, res.total_bases, res.total_reads,
            res.early_term)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("sample", SAMPLES)
def test_fixture_counts_match_jax_engine(tables, sample, config):
    table, jtable = tables
    fq = [str(FIX / f"{sample}.fq")]
    mine = run_count(table, fq, Options(), EngineConfig(**CONFIGS[config]), device="cpu")
    ref = run_count_v3(jtable, fq, JaxOptions(), JaxConfig(**CONFIGS[config]))
    np.testing.assert_array_equal(mine.counts, ref.counts)
    assert _totals(mine) == _totals(ref)
    assert _text(table, mine) == (FIX / f"{sample}_counts.txt").read_text()


def test_early_termination_matches_device_fixture(tables):
    """-m 2 stops on the same batch as the JAX engine (same drain cadence):
    device_m2_counts.txt and device_m2_meta.txt."""
    table, _ = tables
    cfg = EngineConfig(batch_reads=64, segment_len=128, early_term_check_every=2)
    res = run_count(table, [str(FIX / "sampleA.fq")], Options(cov_thresh=2.0), cfg,
                    device="cpu")
    assert _text(table, res) == (FIX / "device_m2_counts.txt").read_text()
    meta = dict(line.split("=") for line in
                (FIX / "device_m2_meta.txt").read_text().splitlines())
    assert res.early_term == (meta["early_term"] == "True")
    assert (res.total_kmers, res.total_hits, res.total_bases, res.total_reads) == tuple(
        int(meta[f"total_{x}"]) for x in ("kmers", "hits", "bases", "reads"))
    assert int(res.counts.sum()) == res.total_hits


def test_summary_text_matches_reference(tables):
    table, _ = tables
    res = run_count(table, [str(FIX / "sampleA.fq")], Options(), device="cpu")
    summary, warning = format_info_summary(table, res, Options())
    assert summary in (FIX / "sampleA_count_stderr.txt").read_text()
    assert warning is None


def _world(rng, tmp_path, n_sites=16, coverage=12, k=19, window=31, **reads):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=n_sites, window=window, k=k, path=sites_path)
    fq = str(tmp_path / "reads.fq")
    make_reads_fastq(rng, sites, coverage=coverage, genotype="het", path=fq, **reads)
    return load_site_table(sites_path, k=k, allow_dupes=False), fq


def _assert_golden(res, golden):
    np.testing.assert_array_equal(res.counts, golden.counts)
    assert _totals(res) == _totals(golden)


def test_checkpoint_crash_and_resume(rng, tmp_path):
    table, fq = _world(rng, tmp_path)
    golden = count_files(table, [fq])
    ckpt = str(tmp_path / "run.ckpt")
    crash = EngineConfig(batch_reads=32, segment_len=128, checkpoint_path=ckpt,
                         checkpoint_every=2, fail_after_batches=5)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_count(table, [fq], Options(), crash, device="cpu")
    assert pathlib.Path(ckpt).exists()
    resume = EngineConfig(batch_reads=32, segment_len=128, checkpoint_path=ckpt,
                          checkpoint_every=2)
    _assert_golden(run_count(table, [fq], Options(), resume, device="cpu"), golden)
    # a different batch geometry changes the cursor: the snapshot is refused
    other = EngineConfig(batch_reads=64, segment_len=128, checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="different inputs"):
        run_count(table, [fq], Options(), other, device="cpu")


def test_segmented_long_reads(rng, tmp_path):
    table, fq = _world(rng, tmp_path, n_sites=8, coverage=3, read_len=1500)
    cfg = EngineConfig(batch_reads=32, segment_len=128)
    _assert_golden(run_count(table, [fq], Options(), cfg, device="cpu"),
                   count_files(table, [fq]))


def test_k32_matches_golden(rng, tmp_path):
    table, fq = _world(rng, tmp_path, n_sites=12, coverage=6, k=32, window=41)
    assert table.k == 32 and table.n_kmers > 0
    res = run_count(table, [fq], Options(k=32), EngineConfig(batch_reads=64),
                    device="cpu")
    golden = count_files(table, [fq])
    assert golden.total_hits > 0
    _assert_golden(res, golden)


def test_threads_over_files_match_golden(rng, tmp_path):
    """-t fans file groups out to reader threads; counts are order-free."""
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=12, path=sites_path)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"r{i}.fq.gz")
        make_reads_fastq(rng, sites[i::4], coverage=4, path=p, gz=True)
        paths.append(p)
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    res = run_count(table, paths, Options(threads=3),
                    EngineConfig(batch_reads=32, segment_len=96), device="cpu")
    _assert_golden(res, count_files(table, paths))


def test_config_from_options_and_early_term_threshold(rng, tmp_path):
    """Without a config the engine takes Options' batch geometry; a -m that
    is never reached leaves early_term False."""
    table, fq = _world(rng, tmp_path, coverage=4)
    opts = Options(batch_reads=16, segment_len=64, cov_thresh=1e9)
    res = run_count(table, [fq], opts, device="cpu")
    golden = count_files(table, [fq], cov_thresh=1e9)
    assert not res.early_term and not math.isinf(opts.cov_thresh)
    _assert_golden(res, golden)


def test_cuda_without_a_card_raises(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    table, _ = tables
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_count(table, [str(FIX / "sampleLow.fq")], Options(), device="cuda")
