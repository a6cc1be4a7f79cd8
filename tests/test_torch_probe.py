"""The port's probe planes and plain probe (kernel 2's reference) against
the JAX package: planes against kernel_v3._build_planes_device and
io/sites.build_lookup, counts and all three diagnostics against
kernel_v3.probe_and_count.  All comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.core.hash import hash64_np, kmer_mask
from ntsm_tpu.count import kernel_v2 as jax_v2
from ntsm_tpu.count import kernel_v3 as jax_v3
from ntsm_tpu.io.sites import build_lookup
from ntsm_tpu_torch.count import kernel_v2 as torch_v2
from ntsm_tpu_torch.count import kernel_v3 as torch_v3
from ntsm_tpu_torch.count.golden import count_codes_batch
from ntsm_tpu_torch.io.sites import build_lookup as torch_build_lookup

torch.set_num_threads(1)


def _hashes(rng, n, bits):
    hi = (1 << bits) - 1
    return np.unique(rng.integers(0, hi, size=n, dtype=np.uint64, endpoint=True))


def _planes(tab):
    return (tab.fp.numpy(), tab.keys.numpy().view(np.uint64), tab.vals.numpy())


@pytest.mark.parametrize("n,bits", [(0, 38), (5, 38), (20000, 38), (20000, 64)])
def test_planes_match_jax(rng, n, bits):
    hashes = _hashes(rng, n, bits)
    mine = torch_v3.TableV3.from_hashes(hashes, "cpu")
    dev = jax_v3.TableV3.from_hashes_device(hashes)  # host path below 16
    assert (mine.n_buckets, mine.slots, mine.bbits) == (dev.n_buckets, dev.slots, dev.bbits)
    assert mine.n_kmers == hashes.size
    fp, keys, vals = _planes(mine)
    np.testing.assert_array_equal(fp, np.asarray(dev.fp))
    np.testing.assert_array_equal(keys, np.asarray(dev.keys))
    np.testing.assert_array_equal(vals, np.asarray(dev.vals))
    for host in (build_lookup(hashes, slots=8), torch_build_lookup(hashes, slots=8)):
        np.testing.assert_array_equal(keys, host.keys)
        np.testing.assert_array_equal(vals, host.vals)
    # the JAX planes fed through from_numpy are the same table
    fed = torch_v3.TableV3.from_numpy(
        np.asarray(dev.fp), np.asarray(dev.keys), np.asarray(dev.vals),
        dev.n_buckets, dev.bbits, "cpu",
    )
    assert fed.n_kmers == mine.n_kmers
    for a, b in zip(_planes(fed), _planes(mine)):
        np.testing.assert_array_equal(a, b)


def _planted_world(rng, k, B=64, L=128, n_table=4000):
    """A batch and a ~4k-k-mer table, part of it k-mers of the batch."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    for b in range(B):
        codes[b, rng.integers(k, L + 1):] = 4
    # repeat some rows so that planted k-mers are counted more than once
    codes[B // 2 : B // 2 + 8] = codes[:8]
    from ntsm_tpu_torch.core.kmers import window_encodings

    fw, rv, valid = window_encodings(codes[:32].ravel(), k)
    seen = np.unique(hash64_np(np.minimum(fw, rv), kmer_mask(k))[valid])
    planted = rng.choice(seen, size=min(n_table // 5, seen.size // 2), replace=False)
    hashes = np.unique(np.concatenate([planted, _hashes(rng, n_table, 2 * k)]))
    return codes, rng.permutation(hashes)


@pytest.mark.parametrize("k", [19, 32])
def test_probe_matches_jax_and_golden(rng, k):
    L = 128
    codes, hashes = _planted_world(rng, k, L=L)
    packed, vbits = jax_v2.pack_batch(codes)
    jtab = jax_v3.build_table_v3(hashes)
    h, valid = jax_v2.window_hashes_packed(jnp.asarray(packed), jnp.asarray(vbits), k, L)
    jc, jd = jax_v3.probe_and_count(
        h, valid, jtab.fp, jtab.keys, jtab.vals,
        jnp.zeros(hashes.size + 1, dtype=jnp.int32),
        n_buckets=jtab.n_buckets, slots=jtab.slots, bbits=jtab.bbits,
    )
    jd = np.asarray(jd)
    assert jd[1] <= jax_v3.CAND_K  # the JAX stage did not overflow

    tab = torch_v3.TableV3.from_hashes(hashes, "cpu")
    th, tv = torch_v2.window_hashes_packed(
        torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    counts = torch.zeros(hashes.size + 1, dtype=torch.int32)
    diag = torch_v3.probe_and_count(
        th, tv, tab.fp, tab.keys, tab.vals, counts,
        n_buckets=tab.n_buckets, bbits=tab.bbits,
    )
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(diag.numpy(), jd)
    assert diag[2] > 0 and diag[1] >= diag[2]

    # the kernel-2 wrapper on CPU is the same plain probe and launches nothing
    before = torch_v3.launches
    c2 = torch.zeros_like(counts)
    d2 = torch_v3.probe_count(th, tv, tab, c2)
    assert torch_v3.launches == before
    assert torch.equal(c2, counts) and torch.equal(d2, diag)

    # and the golden per-batch recount agrees on every k-mer
    order = np.argsort(hashes, kind="stable")
    hit_idx, n_valid = count_codes_batch(codes, k, np.sort(hashes), order)
    assert n_valid == int(diag[0])
    np.testing.assert_array_equal(
        counts.numpy()[:-1], np.bincount(hit_idx, minlength=hashes.size)
    )


def test_probe_count_rejects_mismatched_input(rng):
    hashes = _hashes(rng, 100, 38)
    tab = torch_v3.TableV3.from_hashes(hashes, "cpu")
    h = torch.zeros((2, 10), dtype=torch.int64)
    valid = torch.ones((2, 10), dtype=torch.bool)
    with pytest.raises(ValueError):  # counts too short for the table
        torch_v3.probe_count(h, valid, tab, torch.zeros(10, dtype=torch.int32))
    with pytest.raises(TypeError):
        torch_v3.probe_count(h.int(), valid, tab, torch.zeros(101, dtype=torch.int32))
    with pytest.raises(ValueError):  # several devices
        torch_v3.probe_count(h.to("meta"), valid.to("meta"), tab,
                             torch.zeros(101, dtype=torch.int32, device="meta"))
