"""The port's v2 count path against the JAX package: the v2 step
(count/kernel_v2.py:count_step_v2, its plain version on the CPU) bit-exact
to ntsm_tpu.count.kernel_v2.count_step_v2 on the same packed batch and
16-slot table, the k = 32 k-mer whose hash is the empty-slot key against
the golden count (where the JAX step is at fault), the step's input checks,
and run_count(version=2) on the CPU against the JAX v2 engine and the
golden engine (fixtures, -m, the host recount of a batch with more hits
than the id list holds).  Integer data throughout: every comparison is
exact (tolerance 0)."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.count import kernel_v2 as jax_v2
from ntsm_tpu.count.engine import EngineConfig as JaxConfig
from ntsm_tpu.count.engine import run_count as jax_run_count
from ntsm_tpu.io.sites import build_lookup as jax_build_lookup
from ntsm_tpu.io.sites import load_site_table as jax_load_site_table
from ntsm_tpu.options import Options as JaxOptions
from ntsm_tpu_torch.count import kernel_v2
from ntsm_tpu_torch.count.engine import EngineConfig, run_count
from ntsm_tpu_torch.count.golden import count_codes_batch, count_files
from ntsm_tpu_torch.io.sites import build_lookup, load_site_table
from ntsm_tpu_torch.options import Options
from tests.test_torch_cuda import all_ones_world

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
SAMPLES = ["sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow",
           "sampleA_junk", "sampleA_badqual"]
SMALL = dict(batch_reads=64, segment_len=128)  # small batches: small [B, W, 16] gathers


def _batch(rng, k: int, B: int, L: int) -> np.ndarray:
    """[B, L] codes: random bases, 2% Ns, ragged read ends (some rows
    shorter than k) and two empty pad rows, as a short last batch has."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    ends = rng.integers(0, L + 1, size=B)
    ends[-2:] = 0
    codes[np.arange(L)[None, :] >= ends[:, None]] = 4
    return codes


def _table(rng, codes: np.ndarray, k: int, n_real: int, n_other: int) -> np.ndarray:
    """uint64 site hashes: n_real of the batch's own k-mers and n_other
    random ones."""
    packed, vbits = kernel_v2.pack_batch(codes)
    h, v = kernel_v2.window_hashes_packed(torch.from_numpy(packed), torch.from_numpy(vbits),
                                          k, codes.shape[1])
    own = h[v].numpy().view(np.uint64)
    other = rng.integers(0, 1 << 62, size=n_other, dtype=np.uint64)
    return np.unique(np.concatenate([rng.choice(own, n_real), other]))


def _port_step(codes, hashes, k):
    packed, vbits = kernel_v2.pack_batch(codes)
    table = kernel_v2.make_table_v2(build_lookup(hashes, slots=kernel_v2.SLOTS_V2), hashes.size)
    return kernel_v2.count_step_v2(torch.from_numpy(packed), torch.from_numpy(vbits), table,
                                   k=k, L=codes.shape[1])


def _jax_step(codes, hashes, k):
    packed, vbits = jax_v2.pack_batch(codes)
    keys = jax_v2.make_table_v2(jax_build_lookup(hashes, slots=jax_v2.SLOTS_V2))
    top, n_found, n_valid = jax_v2.count_step_v2(jnp.asarray(packed), jnp.asarray(vbits), keys,
                                                 k=k, L=codes.shape[1])
    return np.asarray(top), int(n_found), int(n_valid)


@pytest.mark.parametrize("k,L,B", [(19, 128, 64), (19, 264, 40), (31, 128, 64), (32, 128, 64),
                                   (32, 64, 700)])
def test_count_step_v2_matches_jax(k, L, B):
    """The triple (top, n_found, n_valid) bit-exact to the JAX step on
    ragged rows with Ns, on a table of the batch's k-mers and random ones;
    the last case has more windows than TOPK."""
    rng = np.random.default_rng(100 * k + L)
    codes = _batch(rng, k, B, L)
    hashes = _table(rng, codes, k, n_real=400, n_other=3000)
    before = kernel_v2.launches_step
    top, n_found, n_valid = _port_step(codes, hashes, k)
    assert kernel_v2.launches_step == before  # CPU tensors: the plain version
    j_top, j_found, j_valid = _jax_step(codes, hashes, k)
    assert top.dtype == torch.int32 and top.shape == (min(kernel_v2.TOPK, B * (L - k + 1)),)
    assert n_found.dtype == n_valid.dtype == torch.int64
    np.testing.assert_array_equal(top.numpy(), j_top)
    assert (int(n_found), int(n_valid)) == (j_found, j_valid)
    assert 0 < int(n_found) <= kernel_v2.TOPK


def test_hits_to_kmer_counts_matches_jax():
    rng = np.random.default_rng(7)
    codes = _batch(rng, 19, 64, 128)
    hashes = _table(rng, codes, 19, n_real=500, n_other=500)
    top, n_found, _ = _port_step(codes, hashes, 19)
    lookup = build_lookup(hashes, slots=kernel_v2.SLOTS_V2)
    mine = np.zeros(hashes.size, dtype=np.int64)
    ref = np.zeros(hashes.size, dtype=np.int64)
    assert kernel_v2.hits_to_kmer_counts(top.numpy(), lookup, hashes.size, mine) == int(n_found)
    jax_v2.hits_to_kmer_counts(top.numpy(), jax_build_lookup(hashes, slots=16), hashes.size, ref)
    np.testing.assert_array_equal(mine, ref)
    sorted_h, order = np.sort(hashes), np.argsort(hashes, kind="stable")
    hit_idx, _ = count_codes_batch(codes, 19, sorted_h, order)
    np.testing.assert_array_equal(mine, np.bincount(hit_idx, minlength=hashes.size))


def _all_ones_codes(case: str):
    """all_ones_world's reads as one packed batch (the bases past a row's
    length are Ns), and its table."""
    codes, lengths, hashes, planted = all_ones_world(case)
    codes = codes.copy()
    codes[np.arange(codes.shape[1])[None, :] >= lengths[:, None]] = 4
    return codes, hashes, planted


@pytest.mark.parametrize("case", ["empty", "full", "site"])
def test_all_ones_kmer_counts_as_golden(case):
    """k = 32: the one canonical 32-mer whose hash is all ones (EMPTY_KEY)
    matches every empty slot of its bucket.  The port counts what the
    golden engine counts: 0 hits where the table does not hold it ("empty",
    "full"), 8 where it does ("site").  The JAX step reports the 8 found
    in all three cases, and its hits_to_kmer_counts then indexes
    counts[n_kmers] and raises IndexError: the reference defect the port
    does not inherit.  In the "site" case the JAX step is right and the
    port's triple equals it."""
    k = 32
    codes, hashes, planted = _all_ones_codes(case)
    n = hashes.size
    top, n_found, n_valid = _port_step(codes, hashes, k)
    lookup = build_lookup(hashes, slots=kernel_v2.SLOTS_V2)
    counts = np.zeros(n, dtype=np.int64)
    kernel_v2.hits_to_kmer_counts(top.numpy(), lookup, n, counts)
    hit_idx, golden_valid = count_codes_batch(codes, k, np.sort(hashes),
                                              np.argsort(hashes, kind="stable"))
    np.testing.assert_array_equal(counts, np.bincount(hit_idx, minlength=n))
    assert int(n_found) == hit_idx.size == {"empty": 0, "full": 0, "site": planted}[case]
    assert int(n_valid) == golden_valid

    j_top, j_found, j_valid = _jax_step(codes, hashes, k)
    assert j_valid == int(n_valid)
    if case == "site":
        np.testing.assert_array_equal(top.numpy(), j_top)
        assert j_found == int(n_found)
    else:
        assert j_found == planted  # the JAX step's empty-slot matches
        with pytest.raises(IndexError):
            jax_v2.hits_to_kmer_counts(j_top[:j_found], jax_build_lookup(hashes, slots=16), n,
                                       np.zeros(n, dtype=np.int64))


@pytest.mark.parametrize("case", ["packed_dtype", "k", "keys_dtype", "vals_shape", "slots",
                                  "n_buckets", "device", "table_device"])
def test_count_step_v2_checks(case):
    """The step's input checks (the table's in TableV2) raise before any
    launch."""
    L, k = 64, 19
    packed = torch.zeros((4, L // 4), dtype=torch.uint8)
    vbits = torch.zeros((4, L // 8), dtype=torch.uint8)
    keys = torch.full((8, 16), -1, dtype=torch.int64)
    vals = torch.full((8, 16), 5, dtype=torch.int32)
    kw = dict(k=k, L=L, n_kmers=5)
    err = ValueError
    if case == "packed_dtype":
        packed, err = packed.to(torch.int32), TypeError
    elif case == "k":
        kw["k"] = 33
    elif case == "keys_dtype":
        keys, err = keys.to(torch.int32), TypeError
    elif case == "vals_shape":
        vals = vals[:4]
    elif case == "slots":
        keys, vals = keys[:, :8], vals[:, :8]
    elif case == "n_buckets":
        keys, vals = keys[:6], vals[:6]
    elif case == "device":
        keys = keys.to("meta")
    elif case == "table_device":
        packed, vbits = packed.to("meta"), vbits.to("meta")
    with pytest.raises(err):
        kernel_v2.count_step_v2(packed, vbits, kernel_v2.TableV2(keys, vals, kw.pop("n_kmers")),
                                **kw)


def _totals(r):
    return (r.total_kmers, r.total_hits, r.total_bases, r.total_reads, r.early_term)


@pytest.fixture(scope="module")
def tables():
    path = str(FIX / "sites.fa")
    return load_site_table(path, 19, allow_dupes=False), jax_load_site_table(path, 19, False)


@pytest.mark.parametrize("sample", SAMPLES)
def test_v2_engine_matches_jax_v2_and_golden(tables, sample):
    table, jtable = tables
    fq = [str(FIX / f"{sample}.fq")]
    mine = run_count(table, fq, Options(), EngineConfig(**SMALL), device="cpu", version=2)
    ref = jax_run_count(jtable, fq, JaxOptions(), JaxConfig(**SMALL), version=2)
    gold = count_files(table, fq)
    np.testing.assert_array_equal(mine.counts, ref.counts)
    np.testing.assert_array_equal(mine.counts, gold.counts)
    assert _totals(mine) == _totals(ref) == _totals(gold)


@pytest.mark.parametrize("cov_thresh", [0.5, 2.0])
def test_v2_engine_m_matches_jax_v2(tables, cov_thresh):
    """-m: the same batch at which both engines stop (one batch in flight,
    the check after each drain), the same counts and totals."""
    table, jtable = tables
    fq = [str(FIX / "sampleA.fq")]
    geometry = dict(batch_reads=16, segment_len=128)
    mine = run_count(table, fq, Options(cov_thresh=cov_thresh), EngineConfig(**geometry),
                     device="cpu", version=2)
    ref = jax_run_count(jtable, fq, JaxOptions(cov_thresh=cov_thresh), JaxConfig(**geometry),
                        version=2)
    assert mine.early_term
    np.testing.assert_array_equal(mine.counts, ref.counts)
    assert _totals(mine) == _totals(ref)
    assert mine.total_reads < count_files(table, fq).total_reads


def test_v2_engine_recounts_a_batch_past_topk(tmp_path, monkeypatch):
    """A batch with more hits than TOPK: the step stores TOPK of them, the
    engine recounts the batch on the host (count_codes_batch), and the
    counts equal the JAX v2 engine's and the golden engine's.  The sites
    are the reads themselves, so every window of a read hits."""
    rng = np.random.default_rng(99)
    n_reads, read_len = 600, 150
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    var = rng.integers(0, 4, size=(n_reads, 31), dtype=np.uint8)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    sites, fq = tmp_path / "sites.fa", tmp_path / "reads.fq"
    sites.write_bytes(b"".join(b">s%d ref\n%s\n>s%d var\n%s\n" % (
        i, letters[reads[i]].tobytes(), i, letters[var[i]].tobytes()) for i in range(n_reads)))
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, letters[reads[i]].tobytes(),
                                                      b"I" * read_len) for i in range(n_reads)))
    table = load_site_table(str(sites), 19, allow_dupes=False)
    jtable = jax_load_site_table(str(sites), 19, False)
    geometry = dict(batch_reads=512, segment_len=256)  # 512 x 238 windows > TOPK

    calls = []
    real = kernel_v2.count_step_v2

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((int(out[1]), out[0].shape[0]))
        return out

    monkeypatch.setattr("ntsm_tpu_torch.count.engine.count_step_v2", spy)
    mine = run_count(table, [str(fq)], Options(), EngineConfig(**geometry), device="cpu",
                     version=2)
    assert calls[0][0] > calls[0][1] == kernel_v2.TOPK  # the first batch overflowed
    ref = jax_run_count(jtable, [str(fq)], JaxOptions(), JaxConfig(**geometry), version=2)
    gold = count_files(table, [str(fq)])
    np.testing.assert_array_equal(mine.counts, ref.counts)
    np.testing.assert_array_equal(mine.counts, gold.counts)
    assert _totals(mine) == _totals(ref) == _totals(gold)


def test_unknown_version_raises(tables):
    table, _ = tables
    with pytest.raises(ValueError, match="version 4"):
        run_count(table, [str(FIX / "sampleLow.fq")], Options(), device="cpu", version=4)


def test_v2_cuda_without_a_card_raises(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    table, _ = tables
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_count(table, [str(FIX / "sampleLow.fq")], Options(), device="cuda", version=2)
