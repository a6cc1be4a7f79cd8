"""The port's v1 count path (unpacked codes) against the JAX package: K2's
plain version against the XLA stage and the Pallas K2 (interpret mode), the
v1 step (count/kernel.py:count_step, the fused kernel's plain version on
the CPU) against count_step_impl on the same lookup table and batch, the
k = 32 k-mer whose hash is the empty-slot key included, the step's input
checks, and run_count(version=1) on the CPU against the JAX v1 engine, the
golden engine and the reference fixtures (-m included).  Integer data
throughout: every comparison is exact (tolerance 0)."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.core.hash import kmer_mask
from ntsm_tpu.count import kernel as jax_kernel
from ntsm_tpu.count.engine import EngineConfig as JaxConfig
from ntsm_tpu.count.engine import run_count as jax_run_count
from ntsm_tpu.count.pallas_kernel import pallas_window_hashes
from ntsm_tpu.io.sites import load_site_table as jax_load_site_table
from ntsm_tpu.options import Options as JaxOptions
from ntsm_tpu_torch.count import hash_kernel, kernel_v3
from ntsm_tpu_torch.count import kernel as torch_kernel
from ntsm_tpu_torch.count.engine import EngineConfig, run_count
from ntsm_tpu_torch.count.golden import count_files
from ntsm_tpu_torch.io.countfile import format_counts
from ntsm_tpu_torch.io.fastx import BatchReader
from ntsm_tpu_torch.io.sites import build_lookup, load_site_table
from ntsm_tpu_torch.options import Options
from tests.synth import make_reads_fastq, make_site_fasta
from tests.test_torch_cuda import all_ones_world

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
SAMPLES = ["sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow",
           "sampleA_junk", "sampleA_badqual"]
SMALL = dict(batch_reads=64, segment_len=128)  # small batches: small [B, W, 8] probes


@pytest.mark.parametrize("k", [5, 16, 19, 31, 32])
def test_k2_plain_matches_xla_and_pallas(rng, k):
    """tests/test_pallas_kernel.py:24-38's inputs, plus two pad rows of
    length 0 (a short last batch's): valid equal everywhere, h at the
    valid windows."""
    B, L = 64, 128
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4  # Ns
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[-2:] = 0

    h_x, v_x = jax_kernel.window_hashes(jnp.asarray(codes), jnp.asarray(lengths), k, kmer_mask(k))
    h_p, v_p = pallas_window_hashes(jnp.asarray(codes), jnp.asarray(lengths), k)
    v_x, v_p = np.asarray(v_x), np.asarray(v_p)
    h_x, h_p = np.asarray(h_x).view(np.int64), np.asarray(h_p).view(np.int64)

    before = hash_kernel.launches_codes
    for h_t, v_t in (
        torch_kernel.window_hashes_codes_plain(torch.from_numpy(codes), torch.from_numpy(lengths), k),
        hash_kernel.window_hashes_codes(torch.from_numpy(codes), torch.from_numpy(lengths), k),
    ):
        v, h = v_t.numpy(), h_t.numpy()
        np.testing.assert_array_equal(v, v_x)
        np.testing.assert_array_equal(v, v_p)
        np.testing.assert_array_equal(h[v], h_x[v_x])
        np.testing.assert_array_equal(h[v], h_p[v_p])
    assert hash_kernel.launches_codes == before  # CPU tensors: the plain version
    assert not v[-2:].any()


@pytest.mark.parametrize("case", ["codes_dtype", "codes_rank", "k", "short_row",
                                  "lengths_dtype", "lengths_shape"])
def test_window_hashes_codes_checks(case):
    codes = torch.zeros((4, 32), dtype=torch.uint8)
    lengths = torch.full((4,), 32, dtype=torch.int32)
    k = 19
    err = ValueError
    if case == "codes_dtype":
        codes, err = codes.to(torch.int32), TypeError
    elif case == "codes_rank":
        codes = codes.reshape(-1)
    elif case == "k":
        k = 33
    elif case == "short_row":
        codes = codes[:, :10]
    elif case == "lengths_dtype":
        lengths, err = lengths.long(), TypeError
    else:
        lengths = lengths[:3]
    with pytest.raises(err):
        hash_kernel.window_hashes_codes(codes, lengths, k)


def _world(rng, tmp_path, n_sites=24, coverage=8, k=19, window=31):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=n_sites, window=window, k=k, path=sites_path)
    fq = str(tmp_path / "reads.fq")
    make_reads_fastq(rng, sites, coverage=coverage, genotype="het", path=fq)
    return sites_path, fq


@pytest.mark.parametrize("k,window,seglen", [(19, 31, 128), (32, 41, 128), (19, 31, 150)])
def test_count_step_matches_jax(rng, tmp_path, k, window, seglen):
    """The same build_lookup table (keys and vals equal) and the same batch
    give bit-equal counts (the miss slot included), total_kmers and
    total_hits; on the CPU the step runs its plain version (no launch)."""
    sites_path, fq = _world(rng, tmp_path, k=k, window=window)
    table = load_site_table(sites_path, k=k, allow_dupes=False)
    jtable = jax_load_site_table(sites_path, k=k, allow_dupes=False)
    lookup = build_lookup(table.kmer_hashes)
    np.testing.assert_array_equal(lookup.keys, jtable.lookup.keys)
    np.testing.assert_array_equal(lookup.vals, jtable.lookup.vals)
    n = table.n_kmers
    keys, vals = torch_kernel.make_table_arrays(lookup, n)
    jkeys, jvals = jax_kernel.make_table_arrays(jtable.lookup, n)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).view(np.int64))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))

    batch = next(iter(BatchReader([fq], k=k, seglen=seglen, batch=256)))
    counts = torch.zeros(n + 1, dtype=torch.int32)
    before = torch_kernel.launches_step
    n_valid, n_found = torch_kernel.count_step(
        torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths), keys, vals, counts,
        k=k, n_kmers=n)
    assert torch_kernel.launches_step == before
    jc, jk, jh = jax_kernel.count_step_impl(
        jnp.asarray(batch.codes), jnp.asarray(batch.lengths), jkeys, jvals,
        jnp.zeros(n + 1, dtype=jnp.int32), jnp.int64(0), jnp.int64(0), k=k, n_kmers=n)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert (int(n_valid), int(n_found)) == (int(jk), int(jh))
    assert int(n_found) > 0 and int(counts[:n].sum()) == int(n_found)
    W = seglen - k + 1
    assert int(counts[n]) == batch.codes.shape[0] * W - int(n_found)


@pytest.mark.parametrize("case", ["empty", "full", "site"])
def test_count_step_all_ones_kmer_matches_jax(case):
    """k = 32: the one canonical 32-mer whose hash is all ones (EMPTY_KEY)
    matches every empty slot of its bucket.  With an empty slot there, both
    the port and JAX count it as found, into the miss slot; in a full
    bucket as a miss; as a site k-mer into its own count.  Whole counts
    vector and totals equal."""
    k = 32
    codes, lengths, hashes, planted = all_ones_world(case)
    n = hashes.size
    lookup = build_lookup(hashes)
    last = lookup.keys[-1]  # the bucket of the all-ones hash
    assert (last == np.uint64((1 << 64) - 1)).sum() == {"empty": 8, "full": 0, "site": 8}[case]
    keys, vals = torch_kernel.make_table_arrays(lookup, n)
    jkeys, jvals = jax_kernel.make_table_arrays(lookup, n)
    counts = torch.zeros(n + 1, dtype=torch.int32)
    n_valid, n_found = torch_kernel.count_step(
        torch.from_numpy(codes), torch.from_numpy(lengths), keys, vals, counts, k=k, n_kmers=n)
    jc, jk, jh = jax_kernel.count_step_impl(
        jnp.asarray(codes), jnp.asarray(lengths), jkeys, jvals,
        jnp.zeros(n + 1, dtype=jnp.int32), jnp.int64(0), jnp.int64(0), k=k, n_kmers=n)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert (int(n_valid), int(n_found)) == (int(jk), int(jh))
    windows = codes.shape[0] * (codes.shape[1] - k + 1)
    found = 0 if case == "full" else planted
    assert int(n_found) == found
    if case == "site":
        assert int(counts[int(np.flatnonzero(hashes == hashes.max())[0])]) == planted
        assert int(counts[n]) == windows - planted
    else:  # found or not, the planted windows end in the miss slot
        assert int(counts[:n].sum()) == 0 and int(counts[n]) == windows


@pytest.mark.parametrize("case", ["codes_dtype", "k", "lengths", "keys_dtype", "vals_shape",
                                  "slots", "n_buckets", "counts", "device", "unsupported"])
def test_count_step_checks(case):
    """The step's input checks raise before any launch."""
    n, B, L, k = 30, 4, 64, 19
    lookup = build_lookup(np.arange(1, n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    keys, vals = torch_kernel.make_table_arrays(lookup, n)
    codes = torch.zeros((B, L), dtype=torch.uint8)
    lengths = torch.full((B,), L, dtype=torch.int32)
    counts = torch.zeros(n + 1, dtype=torch.int32)
    err = ValueError
    if case == "codes_dtype":
        codes, err = codes.to(torch.int16), TypeError
    elif case == "k":
        k = 33
    elif case == "lengths":
        lengths = lengths[:-1]
    elif case == "keys_dtype":
        keys, err = keys.to(torch.int32), TypeError
    elif case == "vals_shape":
        vals = vals[:-1]
    elif case == "slots":
        keys, vals = keys[:, :4], vals[:, :4]
    elif case == "n_buckets":
        keys, vals = keys[:-1], vals[:-1]
    elif case == "counts":
        counts = counts[:-1]
    elif case == "device":
        counts = counts.to("meta")
    else:
        codes, lengths, keys, vals, counts = (
            t.to("meta") for t in (codes, lengths, keys, vals, counts))
    before = torch_kernel.launches_step
    with pytest.raises(err):
        torch_kernel.count_step(codes, lengths, keys, vals, counts, k=k, n_kmers=n)
    assert torch_kernel.launches_step == before


def _totals(res):
    return (res.total_kmers, res.total_hits, res.total_bases, res.total_reads,
            res.early_term)


@pytest.mark.parametrize("geometry", [dict(batch_reads=64, segment_len=128),
                                      dict(batch_reads=16, segment_len=64)])
def test_v1_engine_matches_jax_v1_and_golden(rng, tmp_path, geometry):
    sites_path, fq = _world(rng, tmp_path)
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    jtable = jax_load_site_table(sites_path, k=19, allow_dupes=False)
    counters = (hash_kernel.launches, hash_kernel.launches_codes, kernel_v3.launches,
                torch_kernel.launches_step)
    mine = run_count(table, [fq], Options(), EngineConfig(**geometry), device="cpu", version=1)
    assert (hash_kernel.launches, hash_kernel.launches_codes, kernel_v3.launches,
            torch_kernel.launches_step) == counters
    ref = jax_run_count(jtable, [fq], JaxOptions(), JaxConfig(**geometry), version=1)
    golden = count_files(table, [fq])
    for other in (ref, golden):
        np.testing.assert_array_equal(mine.counts, other.counts)
        assert _totals(mine) == _totals(other)
    assert mine.total_hits > 0


@pytest.fixture(scope="module")
def tables():
    sites = str(FIX / "sites.fa")
    return (load_site_table(sites, k=19, allow_dupes=False),
            jax_load_site_table(sites, k=19, allow_dupes=False))


@pytest.mark.parametrize("sample", SAMPLES)
def test_v1_fixture_counts(tables, sample):
    """counts.txt byte-identical to the fixture; counts and totals equal the
    JAX v1 engine's on the same geometry."""
    table, jtable = tables
    fq = [str(FIX / f"{sample}.fq")]
    mine = run_count(table, fq, Options(), EngineConfig(**SMALL), device="cpu", version=1)
    mx, sm = mine.site_max_sum(table)
    text = format_counts(table.site_ids, mx, sm, table.distinct, mine.total_kmers, 19)
    assert text == (FIX / f"{sample}_counts.txt").read_text()
    ref = jax_run_count(jtable, fq, JaxOptions(), JaxConfig(**SMALL), version=1)
    np.testing.assert_array_equal(mine.counts, ref.counts)
    assert _totals(mine) == _totals(ref)


@pytest.mark.parametrize("cov_thresh,every", [(1.0, 2), (1.0, 3), (2.0, 8)])
def test_v1_early_termination_matches_jax_v1(rng, tmp_path, cov_thresh, every):
    """-m stops on the same batch as the JAX v1 engine, with the same counts
    and totals."""
    sites_path, fq = _world(rng, tmp_path, coverage=40)
    table = load_site_table(sites_path, k=19, allow_dupes=False)
    jtable = jax_load_site_table(sites_path, k=19, allow_dupes=False)
    geometry = dict(SMALL, early_term_check_every=every)
    mine = run_count(table, [fq], Options(cov_thresh=cov_thresh), EngineConfig(**geometry),
                     device="cpu", version=1)
    ref = jax_run_count(jtable, [fq], JaxOptions(cov_thresh=cov_thresh), JaxConfig(**geometry),
                        version=1)
    assert mine.early_term
    np.testing.assert_array_equal(mine.counts, ref.counts)
    assert _totals(mine) == _totals(ref)
    assert int(mine.counts.sum()) == mine.total_hits


def test_v1_cuda_without_a_card_raises(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    table, _ = tables
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_count(table, [str(FIX / "sampleLow.fq")], Options(), device="cuda", version=1)
