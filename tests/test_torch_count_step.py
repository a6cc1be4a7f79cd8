"""The fused count step (count/kernel_v3.py:count_step_v3) against the JAX
package's count_step_v3, and a numpy model of the window stage the card
runs (csrc/window_stage.cuh) against the plain window hash.

(a) On the same packed batch and table planes, the port's step on the CPU
    (its plain version: the plain window hash, then the plain probe) and
    the JAX step, with its XLA window hash and with the Pallas kernel in
    interpret mode, give bit-identical counts and diag.
(b) ``stage_pieces``, ``stage_piece`` and ``stage_windows`` below restate
    the stage's cut of a row into pieces, its word layout and window
    extraction step by step (the 8-base chunk decode with its reciprocal
    division, its 8-byte fast path and its byte path, the
    reverse-complement chunks, the three-word funnel shifts of the bases
    and the funnel shift of the good bits); they must equal
    kernel_v2.window_hashes_packed at every window, at shift edges (k = 32,
    w % 16 = 0, the last word), at L % 32 != 0 and at piece edges.
(c) The wrapper's checks, and no launch on the CPU.
(d) ``code_stage_piece`` and ``code_stage_clip`` restate the stage's code
    decoder (csrc/window_stage.cuh: CodeBatch, which K2 and the fused v1
    step stage): the byte decode with its length cut, the 8-byte fast
    path's conditions, the rounding of a piece to 8 bases at L % 8 != 0,
    and the v1 step's clip of each piece to its read; through the same
    window extraction they must equal kernel_v2.window_hashes_codes_plain
    (K2: every window, h included; the v1 step: every valid window, and
    no valid window is left out).
All comparisons are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.count import kernel_v3 as jax_v3
from ntsm_tpu_torch.core.hash import hash64_np, kmer_mask
from ntsm_tpu_torch.count import kernel_v3 as torch_v3
from ntsm_tpu_torch.count.kernel_v2 import (
    pack_batch, window_hashes_codes_plain, window_hashes_packed)
from tests.test_torch_probe import _planted_world

torch.set_num_threads(1)
U64 = (1 << 64) - 1


@pytest.mark.parametrize("pallas_hash", [False, True])
@pytest.mark.parametrize("L", [128, 264])
@pytest.mark.parametrize("k", [5, 19, 31, 32])
def test_count_step_matches_jax(rng, k, L, pallas_hash):
    codes, hashes = _planted_world(rng, k, L=L)
    packed, vbits = pack_batch(codes)
    jtab = jax_v3.build_table_v3(hashes)
    jc, jd = jax_v3.count_step_v3(
        jnp.asarray(packed), jnp.asarray(vbits), jtab.fp, jtab.keys, jtab.vals,
        jnp.zeros(hashes.size + 1, dtype=jnp.int32),
        k=k, L=L, n_buckets=jtab.n_buckets, slots=jtab.slots, bbits=jtab.bbits,
        pallas_hash=pallas_hash,
    )
    jd = np.asarray(jd)
    assert jd[1] <= jax_v3.CAND_K  # the JAX step did not overflow

    tab = torch_v3.TableV3.from_numpy(
        np.asarray(jtab.fp), np.asarray(jtab.keys), np.asarray(jtab.vals),
        jtab.n_buckets, jtab.bbits, "cpu",
    )
    fused = torch.from_numpy(np.concatenate([packed, vbits], axis=1))
    counts = torch.zeros(hashes.size + 1, dtype=torch.int32)
    before = torch_v3.launches_step
    diag = torch_v3.count_step_v3(fused[:, : L // 4], fused[:, L // 4 :], tab, counts, k, L)
    assert torch_v3.launches_step == before  # the plain version: no launch
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(diag.numpy(), jd)
    assert diag[2] > 0 and diag[1] >= diag[2]

    # the step is the plain window hash then the plain probe
    h, valid = window_hashes_packed(torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    c2 = torch.zeros_like(counts)
    d2 = torch_v3.probe_count(h, valid, tab, c2)
    assert torch.equal(c2, counts) and torch.equal(d2, diag)


# ---- (b) the window stage, restated ----

PIECE_WINDOWS = 2048  # csrc/window_stage.cuh:kPieceWindows


def stage_words(n: int) -> int:
    return (n + 31) // 32 + 1


def stage_pieces(L: int, k: int, piece: int = PIECE_WINDOWS):
    """[(s, n, w_end)]: the pieces of a row as ntsm_stage_rows cuts it
    (ntsm_stage_pieces): bases [s, s + n) staged, windows [s, w_end) read."""
    count = 1 if L <= piece + 32 else (L - 32 + piece - 1) // piece
    W = L - k + 1
    out = []
    for t in range(count):
        s = t * piece
        last = t == count - 1
        out.append((s, L - s if last else piece + 32, W if last else s + piece))
    return out


def stage_piece(raw: np.ndarray, L: int, s: int, n: int, runs: bool):
    """(fw [2 NW] u32, rc [2 NW] u32, good [NW] u32) of bases [s, s + n) of
    one row, as WindowStage::load builds them from the row's Q + E uploaded
    bytes (`runs`: the two 8-byte loads a chunk, else byte by byte)."""
    Q, E, nc = L // 4, L // 8, n // 8
    e_magic = (U64 // E + 1) & U64  # ntsm_packed_batch's ceil(2^64 / E)
    slots = 4 * stage_words(n)
    fw16 = np.zeros(slots, dtype="<u2")
    rc16 = np.zeros(slots, dtype="<u2")
    good8 = np.zeros(slots, dtype=np.uint8)
    rawb = raw.tobytes()
    for c in range(nc):
        m = s + 8 * c
        i = (m * e_magic) >> 64  # __umul64hi
        assert i == m // E
        j = m - i * E
        f = r = g = 0
        if runs:  # one 8-byte run, i fixed
            a = j + (i & 1) * E
            P = int.from_bytes(rawb[a : a + 8], "little") >> (2 * (i >> 1))
            G = int.from_bytes(rawb[Q + j : Q + j + 8], "little") >> i
            for t in range(8):
                code = (P >> (8 * t)) & 3
                f = (f << 2) | code
                r |= (3 ^ code) << (2 * t)
            g = (((G & 0x0101010101010101) * 0x0102040810204080) & U64) >> 56
        else:
            for t in range(8):
                code = (rawb[j + (i & 1) * E] >> (2 * (i >> 1))) & 3
                f = (f << 2) | code
                r |= (3 ^ code) << (2 * t)
                g |= ((rawb[Q + j] >> i) & 1) << t
                j += 1
                if j == E:
                    j, i = 0, i + 1
        fw16[c ^ 1] = f
        rc16[(nc - 1 - c) ^ 1] = r
        good8[c] = g
    return fw16.view("<u4"), rc16.view("<u4"), good8.view("<u4")


def funnel_l(lo: np.ndarray, hi: np.ndarray, t: np.ndarray) -> np.ndarray:
    """__funnelshift_l: the high word of (hi:lo) << (t & 31)."""
    x = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((x << (t & 31).astype(np.uint64)) >> np.uint64(32)) & np.uint64(0xFFFFFFFF)


def take_2k(words: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """ntsm_take_2k: the 2k bits from 2-bit position pos on."""
    a, t = pos >> 4, 2 * (pos & 15)
    w0, w1, w2 = words[a], words[a + 1], words[a + 2]
    x = (funnel_l(w1, w0, t) << np.uint64(32)) | funnel_l(w2, w1, t)
    return x >> np.uint64(64 - 2 * k)


def stage_windows(fw, rc, good, s: int, n: int, w_end: int, k: int):
    """(h, valid) of windows [s, w_end) of a staged piece, as
    WindowStage::hash and ::valid compute them."""
    x = np.arange(w_end - s)
    f = take_2k(fw, x, k)
    r = take_2k(rc, n - x - k, k)
    h = hash64_np(np.minimum(f, r), kmer_mask(k))
    j = x >> 5
    g = ((good[j + 1].astype(np.uint64) << np.uint64(32)) | good[j]) >> (x & 31).astype(np.uint64)
    kmask = np.uint64((1 << k) - 1)
    return h, (g & kmask) == kmask


def _stage_model_rows(k: int, L: int, piece: int):
    """Every row of a batch (random bases, Ns, a ragged read, a pad row, a
    run of T) through the model's pieces, against window_hashes_packed, by
    both decode paths where the 8-byte one applies; returns the pieces."""
    rng = np.random.default_rng(1000 * k + L)
    B = 6
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[1, rng.integers(0, L + 1) :] = 4  # a ragged read
    codes[2] = 4  # a pad row: no valid window
    codes[3, : min(L, 40)] = 3  # a run of T (and its A reverse complement)
    packed, vbits = pack_batch(codes)
    h_p, v_p = window_hashes_packed(torch.from_numpy(packed), torch.from_numpy(vbits), k, L)
    h_p = h_p.numpy().view(np.uint64)
    v_p = v_p.numpy()
    raw = np.concatenate([packed, vbits], axis=1)
    pieces = stage_pieces(L, k, piece)
    assert pieces[0][0] == 0 and pieces[-1][2] == L - k + 1
    for runs in {False, (L // 8) % 8 == 0}:
        for b in range(B):
            hs, vs = [], []
            for s, n, w_end in pieces:
                assert n % 8 == 0 and n >= w_end - s + k - 1 and s + n <= L
                fw, rc, good = stage_piece(raw[b], L, s, n, runs)
                assert fw.size == rc.size == 2 * good.size == 2 * stage_words(n)
                h, valid = stage_windows(fw, rc, good, s, n, w_end, k)
                hs.append(h)
                vs.append(valid)
            np.testing.assert_array_equal(np.concatenate(vs), v_p[b], err_msg=f"row {b}")
            np.testing.assert_array_equal(np.concatenate(hs), h_p[b], err_msg=f"row {b}")
    assert not v_p[2].any()
    return pieces


@pytest.mark.parametrize("k,L", [(k, L) for k in (1, 2, 19, 31, 32)
                                 for L in (8, 16, 128, 256, 264, 1000, 2088, 4104)
                                 if k <= L])
def test_stage_model_matches_plain_window_hash(k, L):
    """The card's pieces of 2,048 windows: one piece up to 2,080 bases,
    two at 2,088 (the last of 40 bases) and 4,104."""
    pieces = _stage_model_rows(k, L, PIECE_WINDOWS)
    assert len(pieces) == (1 if L <= 2080 else 2)


@pytest.mark.parametrize("k,L", [(19, 264), (32, 1000), (31, 96), (5, 128)])
def test_stage_model_pieces(k, L):
    """The same cut with pieces of 64 windows: many pieces a row, the last
    one ragged, so every piece edge (its first window, its last, the 32
    bases of overlap) is a window of the check."""
    pieces = _stage_model_rows(k, L, 64)
    assert len(pieces) == max(1, -(-(L - 32) // 64))


def test_stage_model_layout():
    """The words of a known row: base p = p % 4, all good; the reverse
    complement of ACGT... is ...ACGT, and the pad tail is zero."""
    L = 40
    codes = (np.arange(L) % 4).astype(np.uint8)[None, :]
    packed, vbits = pack_batch(codes)
    fw, rc, good = stage_piece(np.concatenate([packed, vbits], axis=1)[0], L, 0, L, False)
    acgt = int("0123" * 4, 4)  # 16 bases ACGT... most significant first
    assert int(fw[0]) == int(fw[1]) == int(rc[0]) == int(rc[1]) == acgt
    assert int(fw[2]) == int("01230123", 4) << 16  # 8 bases, then zero
    assert int(good[0]) == 0xFFFFFFFF and int(good[1]) == 0xFF
    assert int(fw[3]) == int(rc[3]) == int(good[2]) == 0
    assert not fw[4:].any() and not rc[3:].any()


# ---- (d) the window stage from codes, restated ----


def code_stage_clip(length: int, s: int, k: int, n: int, w_end: int):
    """CodeBatch::clip with clip_reads (the fused v1 step): the piece at s
    staging n bases and serving windows [s, w_end) cut to its read; None
    when it serves no window."""
    n = min(n, length - s)
    w_end = min(w_end, length - k + 1)
    return (n, w_end) if w_end > s else None


def code_stage_piece(row: bytes, length: int, s: int, n: int, runs: bool):
    """(fw [2 NW] u32, rc [2 NW] u32, good [NW] u32, n8) of bases [s, s +
    n) of one code row, as WindowStage::load builds them through
    CodeBatch::Row::chunk: n rounded up to n8, a multiple of 8; the bases
    before s + n read, the others zero; `runs` (base pointer and pitch
    8-byte aligned): a chunk wholly before s + n is one 8-byte load; a base
    is good when its code is <= 3 and it lies before min(length, s + n)."""
    n8 = (n + 7) // 8 * 8
    nc, end = n8 // 8, s + n
    slots = 4 * stage_words(n8)
    fw16 = np.zeros(slots, dtype="<u2")
    rc16 = np.zeros(slots, dtype="<u2")
    good8 = np.zeros(slots, dtype=np.uint8)
    for c in range(nc):
        m = s + 8 * c
        left = min(length, end) - m  # bases inside the read from m on
        if runs and m + 8 <= end:
            x = int.from_bytes(row[m : m + 8], "little")
        else:
            x = sum(row[m + t] << (8 * t) for t in range(8) if m + t < end)
        f = r = g = 0
        for t in range(8):
            v = (x >> (8 * t)) & 0xFF
            code = v & 3
            f = (f << 2) | code
            r |= (3 ^ code) << (2 * t)
            g |= int(v <= 3) << t
        g &= 0xFF if left >= 8 else 0 if left <= 0 else (1 << left) - 1
        fw16[c ^ 1] = f
        rc16[(nc - 1 - c) ^ 1] = r
        good8[c] = g
    return fw16.view("<u4"), rc16.view("<u4"), good8.view("<u4"), n8


def _code_rows(k: int, L: int, offset: int):
    """A batch of code rows as views of a wider buffer at `offset` (so the
    rows' alignment and pitch vary): random bases, 2% Ns and codes 4-255,
    and lengths 0, k - 1, mid-row, L - 1, L and L + 5 (past the row)."""
    rng = np.random.default_rng(100 * k + L + offset)
    lengths = np.array([0, k - 1, (L + k) // 2, L - 1, L, L + 5, L, L], dtype=np.int32)
    B = lengths.size
    wide = rng.integers(0, 4, size=(B, L + 16), dtype=np.uint8)
    bad = rng.random(wide.shape) < 0.02
    wide[bad] = rng.integers(4, 256, size=int(bad.sum()), dtype=np.uint8)
    wide[6, : min(L, 40) + offset] = 3  # a run of T (its reverse complement A)
    codes = torch.from_numpy(wide)[:, offset : offset + L]
    return codes, torch.from_numpy(lengths)


def _code_stage_model_rows(k: int, L: int, piece: int, offset: int = 0):
    """Every row through the model's pieces, as K2 stages them (whole) and
    as the v1 step does (clipped to the read), against
    window_hashes_codes_plain, by the byte path and, where the rows allow
    it, the 8-byte path; returns the pieces."""
    codes, lengths = _code_rows(k, L, offset)
    h_p, v_p = window_hashes_codes_plain(codes, lengths, k)
    h_p, v_p = h_p.numpy().view(np.uint64), v_p.numpy()
    aligned = (codes.data_ptr() | codes.stride(0)) % 8 == 0
    pieces = stage_pieces(L, k, piece)
    assert pieces[0][0] == 0 and pieces[-1][2] == L - k + 1
    W = L - k + 1
    for runs in {False, aligned}:
        for b in range(codes.shape[0]):
            row = codes[b].numpy().tobytes()
            length = int(lengths[b])
            hs, vs = [], []
            served_v = np.zeros(W, dtype=bool)
            for s, n, w_end in pieces:
                assert n >= w_end - s + k - 1 and s + n <= L
                fw, rc, good, n8 = code_stage_piece(row, length, s, n, runs)
                h, valid = stage_windows(fw, rc, good, s, n8, w_end, k)
                hs.append(h)
                vs.append(valid)
                cut = code_stage_clip(length, s, k, n, w_end)
                if cut is None:
                    continue
                n_c, w_end_c = cut
                assert s + n_c <= min(length, L) and w_end_c <= w_end
                fw, rc, good, n8 = code_stage_piece(row, length, s, n_c, runs)
                h, valid = stage_windows(fw, rc, good, s, n8, w_end_c, k)
                np.testing.assert_array_equal(valid, v_p[b, s:w_end_c], err_msg=f"row {b}")
                np.testing.assert_array_equal(h[valid], h_p[b, s:w_end_c][valid])
                served_v[s:w_end_c] = valid
            # K2: every window, h included (the hash of the codes & 3 at an
            # invalid one); the v1 step: every valid window, none left out
            np.testing.assert_array_equal(np.concatenate(vs), v_p[b], err_msg=f"row {b}")
            np.testing.assert_array_equal(np.concatenate(hs), h_p[b], err_msg=f"row {b}")
            np.testing.assert_array_equal(served_v, v_p[b], err_msg=f"row {b}")
    assert not v_p[:2].any() and v_p[4:].any()
    return pieces


@pytest.mark.parametrize("k,L", [(k, L) for k in (5, 19, 31, 32)
                                 for L in (64, 128, 150, 264, 4200)])
def test_code_stage_model_matches_plain_window_hash(k, L):
    """The card's pieces of 2,048 windows: one piece up to 2,080 bases,
    three at 4,200 (the last 104 bases); L = 150 is off the 8-base chunk."""
    pieces = _code_stage_model_rows(k, L, PIECE_WINDOWS)
    assert len(pieces) == (1 if L <= 2080 else 3)


@pytest.mark.parametrize("k,L,offset", [(19, 150, 8), (19, 256, 3), (32, 264, 8),
                                        (31, 129, 1), (5, 100, 0)])
def test_code_stage_model_pieces(k, L, offset):
    """The same with pieces of 64 windows (every piece edge a window of the
    check, the clip cutting pieces short and skipping whole ones) and rows
    that are views at an offset: 8-byte aligned at offset 8 with the
    pitch L + 16 when L % 8 == 0, else byte by byte."""
    codes, _ = _code_rows(k, L, offset)
    assert ((codes.data_ptr() | codes.stride(0)) % 8 == 0) == (offset % 8 == 0 and L % 8 == 0)
    pieces = _code_stage_model_rows(k, L, 64, offset)
    assert len(pieces) == max(1, -(-(L - 32) // 64))


def test_code_stage_model_layout():
    """The words of a known row: base p = p % 4, all good up to its length
    13 of 20 bases; the tail past the bases read is zero and bad."""
    row = bytes(np.arange(20, dtype=np.uint8) % 4)
    fw, rc, good, n8 = code_stage_piece(row, 13, 0, 20, True)
    assert n8 == 24
    acgt = int("0123" * 4, 4)
    assert int(fw[0]) == acgt and int(fw[1]) == int("0123" + "0" * 12, 4)
    assert int(good[0]) == (1 << 13) - 1 and not good[1:].any()
    # rc: position q holds 3 - base (n8 - 1 - q): four zero-base pad
    # positions (3, T) first, then the reverse complement of ...0123
    assert int(rc[0]) == int("3333" + "0123" * 3, 4)


# ---- (c) the wrapper's checks ----


def _tab(rng):
    hashes = np.unique(rng.integers(0, (1 << 38) - 1, size=100, dtype=np.uint64))
    return torch_v3.TableV3.from_hashes(hashes, "cpu")


@pytest.mark.parametrize("case", ["dtype", "width", "rows", "k", "seglen", "counts", "device",
                                  "strided"])
def test_count_step_rejects_bad_input(rng, case):
    tab = _tab(rng)
    k, L, B = 19, 128, 4
    packed = torch.zeros((B, L // 4), dtype=torch.uint8)
    vbits = torch.zeros((B, L // 8), dtype=torch.uint8)
    counts = torch.zeros(tab.n_kmers + 1, dtype=torch.int32)
    before = torch_v3.launches_step
    err = ValueError
    if case == "dtype":
        packed, err = packed.to(torch.int16), TypeError
    elif case == "width":
        vbits = torch.zeros((B, L // 4), dtype=torch.uint8)
    elif case == "rows":
        vbits = vbits[:-1]
    elif case == "k":
        k = 33
    elif case == "seglen":
        L = 132
        packed = torch.zeros((B, 33), dtype=torch.uint8)
    elif case == "counts":
        counts = counts[:-1]
    elif case == "device":
        packed, vbits, counts = packed.to("meta"), vbits.to("meta"), counts.to("meta")
    elif case == "strided":
        packed = torch.zeros((B, L // 2), dtype=torch.uint8)[:, ::2]
    with pytest.raises(err):
        torch_v3.count_step_v3(packed, vbits, tab, counts, k, L)
    assert torch_v3.launches_step == before


def test_l2_window_is_nothing_on_the_cpu(rng):
    """exp_count_kernels.fingerprints_in_l2 (the L2 window over the fp
    plane the experiment times the step under) does nothing for a table on
    the CPU: no stream, no launch, 0 bytes."""
    from ntsm_tpu_torch.experiments.exp_count_kernels import fingerprints_in_l2

    tab = _tab(rng)
    before = torch_v3.launches_step
    with fingerprints_in_l2(tab) as set_aside:
        assert set_aside == 0
    assert torch_v3.launches_step == before
