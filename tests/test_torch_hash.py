"""The port's hash stage against the JAX package: hash64 on int64 bit
patterns, the 2-bit pack, and the plain window hash (kernel 1's reference)
against both the Pallas kernel (interpret mode) and the XLA stage.  All
comparisons are exact (integer data, tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.core.hash import hash64_np, kmer_mask
from ntsm_tpu.count import kernel_v2 as jax_v2
from ntsm_tpu.count.pallas_kernel import pallas_window_hashes_packed
from ntsm_tpu_torch.core.hash import hash64_torch, srl, unsigned_key
from ntsm_tpu_torch.count import hash_kernel
from ntsm_tpu_torch.count import kernel_v2 as torch_v2

torch.set_num_threads(1)

KS = [5, 19, 31, 32]


def _batch(rng, k, B=48, L=128):
    """Random codes with 2% Ns and ragged read tails."""
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    for b in range(B):
        codes[b, rng.integers(k, L + 1):] = 4
    return codes


@pytest.mark.parametrize("k", KS)
def test_hash64_torch_matches_numpy(rng, k):
    keys = rng.integers(0, 2**64 - 1, size=4096, dtype=np.uint64, endpoint=True)
    keys[:4] = [0, 1, 2**63, 2**64 - 1]
    mask = kmer_mask(k)
    for key in (keys, keys & mask):
        want = hash64_np(key, mask)
        got = hash64_torch(torch.from_numpy(key.view(np.int64)), k)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_int64_bit_helpers(rng):
    x = rng.integers(0, 2**64 - 1, size=1000, dtype=np.uint64, endpoint=True)
    y = rng.integers(0, 2**64 - 1, size=1000, dtype=np.uint64, endpoint=True)
    tx, ty = (torch.from_numpy(a.view(np.int64)) for a in (x, y))
    for s in (1, 8, 24, 63):
        np.testing.assert_array_equal(srl(tx, s).numpy().view(np.uint64), x >> np.uint64(s))
    np.testing.assert_array_equal(
        (unsigned_key(tx) < unsigned_key(ty)).numpy(), x < y
    )


def test_pack_matches_jax(rng):
    codes = rng.integers(0, 5, size=(64, 256), dtype=np.uint8)
    want_p, want_v = jax_v2.pack_batch(codes)
    for got_p, got_v in (torch_v2.pack_batch(codes), torch_v2.pack_batch_fast(codes)):
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("k", KS)
def test_window_hashes_match_jax(rng, k):
    L = 128
    packed, vbits = jax_v2.pack_batch(_batch(rng, k, L=L))
    h_x, v_x = (np.asarray(a) for a in jax_v2.window_hashes_packed(
        jnp.asarray(packed), jnp.asarray(vbits), k, L))
    h_p, v_p = (np.asarray(a) for a in pallas_window_hashes_packed(
        jnp.asarray(packed), jnp.asarray(vbits), k, L))
    h_t, v_t = torch_v2.window_hashes_packed(
        torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    h_t = h_t.numpy().view(np.uint64)
    v_t = v_t.numpy()
    assert v_t.any() and not v_t.all()
    np.testing.assert_array_equal(v_t, v_x)
    np.testing.assert_array_equal(v_t, v_p)
    np.testing.assert_array_equal(h_t[v_t], h_x[v_x])
    np.testing.assert_array_equal(h_t[v_t], h_p[v_p])


@pytest.mark.parametrize("k", [19, 32])
def test_window_hashes_match_host_oracle(rng, k):
    """Row by row against core/kmers.py (the golden rolling hash)."""
    from ntsm_tpu_torch.core.kmers import flat_window_hashes

    L = 128
    codes = _batch(rng, k, B=16, L=L)
    packed, vbits = torch_v2.pack_batch(codes)
    h, v = torch_v2.window_hashes_packed(
        torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    for r in range(codes.shape[0]):
        hg, vg = flat_window_hashes(codes[r], k)
        np.testing.assert_array_equal(v[r].numpy(), vg)
        np.testing.assert_array_equal(h[r].numpy()[vg].view(np.uint64), hg[vg])


def test_wrapper_on_cpu_runs_plain_and_takes_fused_slices(rng):
    """The kernel-1 wrapper on CPU tensors is the plain version, launches
    nothing, and accepts column slices of one fused [B, 3L/8] buffer."""
    k, L = 19, 128
    packed, vbits = torch_v2.pack_batch(_batch(rng, k, L=L))
    fused = torch.from_numpy(np.concatenate([packed, vbits], axis=1))
    before = hash_kernel.launches
    h_w, v_w = hash_kernel.window_hashes(fused[:, : L // 4], fused[:, L // 4 :], k, L)
    h_p, v_p = torch_v2.window_hashes_packed(
        torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    assert hash_kernel.launches == before
    assert torch.equal(h_w, h_p) and torch.equal(v_w, v_p)


@pytest.mark.parametrize(
    "case",
    ["meta_device", "wrong_dtype", "wrong_width", "strided_rows", "bad_k"],
)
def test_wrapper_rejects_bad_input(case):
    k, L, B = 19, 128, 4
    packed = torch.zeros((B, L // 4), dtype=torch.uint8)
    vbits = torch.zeros((B, L // 8), dtype=torch.uint8)
    err = ValueError
    if case == "meta_device":
        packed, vbits = packed.to("meta"), vbits.to("meta")
    elif case == "wrong_dtype":
        packed, err = packed.to(torch.int32), TypeError
    elif case == "wrong_width":
        vbits = torch.zeros((B, L // 4), dtype=torch.uint8)
    elif case == "strided_rows":
        packed = torch.zeros((B, L // 2), dtype=torch.uint8)[:, ::2]
    elif case == "bad_k":
        k = 33
    with pytest.raises(err):
        hash_kernel.window_hashes(packed, vbits, k, L)
