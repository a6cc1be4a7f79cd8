"""The experiment programs' plain versions (the P1/P2 gather forms and P3's
XOR probe) against the scripts' own numpy oracles and, for the gathers,
against the Pallas kernel bodies run through pl.pallas_call in interpret
mode.  The scripts call pallas_call without interpret and run at import, so
the bodies are restated here (scripts/exp_pallas_gather.py:10-13,39-41;
scripts/exp_pallas_gather2.py:31-32,41-42,51-52,61-62).  P3's DMA body
cannot run on the CPU.  Integer data: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ntsm_tpu_torch.experiments import (
    exp_count_kernels, exp_dma_probe, exp_pair_block_stats, exp_pair_stats, exp_pallas_gather)
from ntsm_tpu_torch.experiments import exp_pallas_gather2
from ntsm_tpu_torch.experiments import gather

torch.set_num_threads(1)


def _kernel_1d(tbl_ref, idx_ref, out_ref):
    out_ref[:] = tbl_ref[:][idx_ref[:]]


def _kernel_axis0(t, i, o):
    o[:] = jnp.take_along_axis(t[:], i[:], axis=0)


def _kernel_axis1(t, i, o):
    o[:] = jnp.take_along_axis(t[:], i[:], axis=1)


def _kernel_rows(t, i, o):
    o[:] = t[:][i[:]]


# case -> (form, Pallas body, table shape, index shape, index range, u32 table)
CASES = {
    "P1a_1d": ("gather_1d", _kernel_1d, (4096,), (64, 128), 4096, True),
    "P1b_axis0": ("take_along_axis0", _kernel_axis0, (512, 128), (64, 128), 512, True),
    "P2A_axis0": ("take_along_axis0", _kernel_axis0, (256, 128), (256, 128), 256, False),
    "P2B_axis0_fewer_rows": ("take_along_axis0", _kernel_axis0, (256, 128), (32, 128), 256, False),
    "P2C_axis1": ("take_along_axis1", _kernel_axis1, (256, 128), (256, 128), 128, False),
    "P2D_rows": ("row_gather", _kernel_rows, (256, 128), (32,), 256, False),
    # the kernels' ragged and widest shapes: n % 4 != 0, C and M off the
    # 16-B path, rows no multiple of a block's 8, the widest axis-1 row
    "P1a_1d_ragged": ("gather_1d", _kernel_1d, (4096,), (4099,), 4096, True),
    "P1a_1d_one": ("gather_1d", _kernel_1d, (16,), (1,), 16, True),
    "P1b_axis0_C5": ("take_along_axis0", _kernel_axis0, (64, 5), (33, 5), 64, True),
    "P1b_axis0_C7": ("take_along_axis0", _kernel_axis0, (64, 7), (9, 7), 64, True),
    "P2A_axis0_rows_1027": ("take_along_axis0", _kernel_axis0, (256, 128), (1027, 128), 256,
                            False),
    "P2C_axis1_M9_C5": ("take_along_axis1", _kernel_axis1, (37, 5), (37, 9), 5, False),
    "P2C_axis1_rows_1027": ("take_along_axis1", _kernel_axis1, (1027, 128), (1027, 128), 128, False),
    "P2C_axis1_widest": ("take_along_axis1", _kernel_axis1, (16, 1536), (16, 128), 1536, False),
    "P2D_rows_ragged": ("row_gather", _kernel_rows, (256, 128), (37,), 256, False),
}


def _oracle(form: str, tbl: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The scripts' numpy checks (D has none there: numpy's row gather)."""
    if form == "take_along_axis0":
        return np.take_along_axis(tbl, idx, axis=0)
    if form == "take_along_axis1":
        return np.take_along_axis(tbl, idx, axis=1)
    return tbl[idx]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_form_matches_oracle_and_pallas(case):
    form, body, tshape, ishape, hi, u32 = CASES[case]
    rng = np.random.default_rng(len(case))
    if u32:
        tbl = rng.integers(0, 2**32, size=tshape, dtype=np.uint32)
    else:
        tbl = rng.integers(0, 2**31, size=tshape, dtype=np.int32)
    idx = rng.integers(0, hi, size=ishape, dtype=np.int32)
    want = _oracle(form, tbl, idx)
    out_shape = jax.ShapeDtypeStruct(want.shape, jnp.asarray(tbl).dtype)
    pallas = np.asarray(pl.pallas_call(body, out_shape=out_shape, interpret=True)(
        jnp.asarray(tbl), jnp.asarray(idx)))
    np.testing.assert_array_equal(pallas, want)

    wrapper, plain, _ = gather.FORMS[form]
    t, i = gather.to_tensor(tbl, "cpu"), gather.to_tensor(idx, "cpu")
    before = dict(gather.launches)
    # the plain version on an int64 index is the form's one PyTorch call
    for got in (plain(t, i), wrapper(t, i), plain(t, i.long())):
        np.testing.assert_array_equal(got.numpy().view(tbl.dtype), want)
    assert gather.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("form,tbl_shape,idx_shape", [
    ("gather_1d", (16,), (0,)),
    ("take_along_axis0", (16, 128), (0, 128)),
    ("take_along_axis0", (16, 0), (5, 0)),
    ("take_along_axis1", (0, 128), (0, 9)),
    ("take_along_axis1", (5, 128), (5, 0)),
    ("row_gather", (16, 128), (0,)),
])
def test_gather_form_on_empty_index(form, tbl_shape, idx_shape):
    """An empty index (which the Pallas bodies cannot take in interpret
    mode): the wrapper gives the numpy oracle's empty result, on the CPU."""
    tbl = np.arange(int(np.prod(tbl_shape)), dtype=np.int32).reshape(tbl_shape)
    idx = np.zeros(idx_shape, dtype=np.int32)
    want = _oracle(form, tbl, idx)
    got = gather.FORMS[form][0](torch.from_numpy(tbl), torch.from_numpy(idx))
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32


def test_chained_timing_index_arithmetic():
    """The chain the P1 program times (scripts/exp_pallas_gather.py:61-76
    chain_time): 3 steps of the port's gather_1d, each fed the last output
    masked with & (TBL - 1), end in the same bits as the script's chain in
    jax.numpy on the same inputs (a u32 table, so outputs carry the sign
    bit that the mask must clear)."""
    size = 256
    rng = np.random.default_rng(61)
    tbl = rng.integers(0, 2**32, size=size, dtype=np.uint32)
    idx = rng.integers(0, size, size=(16, 128), dtype=np.int32)
    t, o = jnp.asarray(tbl), jnp.asarray(idx)
    for _ in range(3):
        o = t[(o & jnp.uint32(size - 1)).astype(jnp.int32)]
    want = np.asarray(o)
    assert (want >= 2**31).any()
    tt, it = gather.to_tensor(tbl, "cpu"), gather.to_tensor(idx, "cpu")
    for fn in (gather.gather_1d_plain, gather.gather_1d):
        got = exp_pallas_gather.chain(tt, it, 3, gather=fn)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not np.array_equal(exp_pallas_gather.chain(tt, it, 2).numpy().view(np.uint32), want)


def test_launch_floor_needs_a_card():
    """The empty kernel has no plain version: on the CPU it raises."""
    before = gather.launches["launch_floor"]
    with pytest.raises(ValueError, match="CUDA"):
        gather.launch_floor("cpu")
    assert gather.launches["launch_floor"] == before


@pytest.mark.parametrize("form,tbl_shape,idx_shape,err", [
    ("gather_1d", (8, 2), (4,), ValueError),
    ("take_along_axis0", (8, 4), (3, 5), ValueError),
    ("take_along_axis1", (8, 4), (7, 4), ValueError),
    ("row_gather", (8, 4), (2, 2), ValueError),
    ("row_gather", (8, 4), None, TypeError),
])
def test_gather_wrapper_checks(form, tbl_shape, idx_shape, err):
    tbl = torch.zeros(tbl_shape, dtype=torch.int32)
    idx = (torch.zeros(idx_shape, dtype=torch.int32) if idx_shape
           else torch.zeros(3, dtype=torch.int64))
    with pytest.raises(err):
        gather.FORMS[form][0](tbl, idx)


def _script_oracle(fp: np.ndarray, idx_s: np.ndarray) -> np.ndarray:
    """scripts/exp_dma_probe.py:125-128."""
    exp = np.zeros(fp.shape[1], dtype=np.uint32)
    for s in range(idx_s.shape[0]):
        exp ^= np.bitwise_xor.reduce(fp[idx_s[s]], axis=0)
    return exp


@pytest.mark.parametrize("depth,rows,n_launch,n_idx", [
    (4, 1024, 3, 4096), (16, 64, 5, 100), (64, 8, 1, 7), (1, 16, 2, 1), (16, 300, 7, 33),
])
def test_xor_probe_plain_matches_script_oracle(depth, rows, n_launch, n_idx):
    rng = np.random.default_rng(depth * 1000 + rows)
    fp = rng.integers(0, 2**32, size=(rows, 128), dtype=np.uint32)
    idx_s = rng.integers(0, rows, size=(n_launch, n_idx), dtype=np.int32)
    want = _script_oracle(fp, idx_s)
    fp_t, idx_t = torch.from_numpy(fp.view(np.int32)), torch.from_numpy(idx_s)
    before = exp_dma_probe.launches
    for got in (exp_dma_probe.xor_probe_plain(fp_t, idx_t),
                exp_dma_probe.xor_probe(fp_t, idx_t, depth)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert exp_dma_probe.launches == before


@pytest.mark.parametrize("case", ["fp_width", "fp_dtype", "depth_0", "depth_65"])
def test_xor_probe_checks(case):
    fp = torch.zeros((16, 128), dtype=torch.int32)
    idx = torch.zeros((2, 4), dtype=torch.int32)
    depth = 4
    if case == "fp_width":
        fp = fp[:, :64].contiguous()
    elif case == "fp_dtype":
        fp = fp.long()
    else:
        depth = int(case.split("_")[1])
    with pytest.raises(ValueError):
        exp_dma_probe.xor_probe(fp, idx, depth)


def test_script_shapes_and_draws():
    """The programs draw the scripts' inputs: same shapes, seed 0, order."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 2**32, size=1 << 20, dtype=np.uint32)
    (_, form, t, i), (_, form2, t2, _) = exp_pallas_gather.cases("cpu")
    assert (form, form2) == ("gather_1d", "take_along_axis0")
    np.testing.assert_array_equal(t.numpy().view(np.uint32), tbl)
    assert tuple(i.shape) == (4096, 128) and tuple(t2.shape) == (8192, 128)
    forms = [c[1] for c in exp_pallas_gather2.cases("cpu")]
    assert forms == ["take_along_axis0", "take_along_axis0", "take_along_axis1", "row_gather"]
    fp, idx_s = exp_dma_probe.inputs("cpu", n_launch=2)
    assert tuple(fp.shape) == (65536, 128) and tuple(idx_s.shape) == (2, 4096)


@pytest.mark.parametrize("module", [exp_pallas_gather, exp_pallas_gather2, exp_dma_probe])
def test_programs_run_on_cpu(module, monkeypatch, capsys):
    """Each program's body on the CPU (plain versions, untimed): the gather
    forms at the scripts' shapes, P3 on 2 launches of the script's 512."""
    cpu = torch.device("cpu")
    if module is exp_dma_probe:
        monkeypatch.setattr(exp_dma_probe, "SCAN", 2)
        rows = exp_dma_probe.run(cpu)["depths"]
    else:
        rows = gather.run_forms(module.cases(cpu))
    out = capsys.readouterr().out
    assert "correct" in out and "False" not in out
    assert rows and all(r["correct"] for r in rows)
    assert "ms" not in rows[0]  # no device time on the CPU


def test_programs_without_a_card_exit_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for module in (exp_pallas_gather, exp_pallas_gather2, exp_dma_probe):
        assert module.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_pair_stats_program_cohort_and_no_card(capsys):
    """exp_pair_stats' cohort on the CPU at a small size: int32 counts
    around the generator's coverage; the program itself needs a card."""
    a, b = exp_pair_stats.cohort(torch.device("cpu"), n=6, n_sites=500)
    assert a.shape == b.shape == (6, 500) and a.dtype == b.dtype == torch.int32
    assert int(a.min()) >= 0 and int(b.min()) >= 0
    assert 20 < float((a + b).double().mean()) < 40
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert exp_pair_stats.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_pair_block_stats_program_lists_and_no_card(capsys):
    """exp_pair_block_stats' lists on the CPU: phase 9's shape, its j32
    twin (the same i's, every j in [0, 32) and off i) and the sweep lists,
    whose hand-made plans put every pair on the tile instance at the
    stated density; the program itself needs a card."""
    ii, jj = exp_pair_block_stats.grouped_pairs(np.random.default_rng(9), 1024, 50_037)
    assert ii.size == 50_037 and (np.diff(ii) >= 0).all() and (ii != jj).all()
    j = exp_pair_block_stats.j32(ii, jj)
    assert j.max() < 32 and (j != ii).all()
    rng = np.random.default_rng(11)
    for d in (1 / 16, 0.5, 1.0):
        li, lj, plan = exp_pair_block_stats.sweep_list(rng, 256, d)
        assert plan.n_sparse == 0 and plan.tile_density() == d
        t, r, c = np.nonzero(plan.outs >= 0)
        p = plan.outs[t, r, c]
        assert np.array_equal(np.sort(p), np.arange(li.size))
        assert (plan.rows[t, r] == li[p]).all() and (plan.cols[t, c] == lj[p]).all()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert exp_pair_block_stats.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_count_kernels_program_no_card(capsys):
    """exp_count_kernels' inputs on the CPU at a small size: a fused upload
    of ragged reads and a table holding real k-mers of the batch (so the
    fused step finds hits, equal to the plain probe's), and the v1 path's
    code batch and lookup table (so the v1 step finds hits); the program
    itself needs a card."""
    from ntsm_tpu_torch.count import kernel as kernel_v1
    from ntsm_tpu_torch.count import kernel_v3
    from ntsm_tpu_torch.count.kernel_v2 import window_hashes_codes_plain, window_hashes_packed
    from ntsm_tpu_torch.io.sites import build_lookup

    rng = np.random.default_rng(3)
    k, rows, seglen = 19, 64, 128
    fused = exp_count_kernels.fused_batch(torch.device("cpu"), rng, k, rows=rows, seglen=seglen)
    assert fused.dtype == torch.uint8 and tuple(fused.shape) == (rows, 3 * seglen // 8)
    packed, vbits = exp_count_kernels.split(fused, seglen)
    h, valid = window_hashes_packed(packed, vbits, k, seglen)
    assert 0 < int(valid.sum()) < valid.numel()  # Ns and ragged ends
    hashes = exp_count_kernels.real_table(h, valid, rng, n_real=300, n_table=5000)
    assert hashes.dtype == np.uint64 and hashes.size == np.unique(hashes).size
    assert 4900 < hashes.size <= 5000
    assert np.isin(h[valid].numpy().view(np.uint64), hashes).sum() >= 300
    tab = kernel_v3.TableV3.from_hashes(hashes, "cpu")
    counts = torch.zeros(tab.n_kmers + 1, dtype=torch.int32)
    diag = kernel_v3.count_step_v3(packed, vbits, tab, counts, k, seglen)
    assert int(diag[2]) >= 300 and int(counts.sum()) == int(diag[2])
    # the v1 path's batch: one read a row, code 4 past its length
    codes, lengths = exp_count_kernels.codes_batch(torch.device("cpu"), rng, k, rows=rows,
                                                   seglen=seglen)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (rows, seglen)
    assert lengths.dtype == torch.int32 and int(lengths.min()) >= k
    assert bool((codes[torch.arange(seglen)[None, :] >= lengths[:, None]] == 4).all())
    h, valid = window_hashes_codes_plain(codes, lengths, k)
    hashes = exp_count_kernels.real_table(h, valid, rng, n_real=300, n_table=5000)
    keys, vals = kernel_v1.make_table_arrays(build_lookup(hashes), hashes.size)
    counts = torch.zeros(hashes.size + 1, dtype=torch.int32)
    n_valid, n_found = kernel_v1.count_step(codes, lengths, keys, vals, counts, k=k,
                                            n_kmers=hashes.size)
    assert int(n_found) >= 300 and int(counts[:-1].sum()) == int(n_found)
    assert int(n_valid) == int(valid.sum())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert exp_count_kernels.main([]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
