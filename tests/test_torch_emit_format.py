"""The native row formatter's float fields (``ntsm_format_f6``'s routine in
ntsm_tpu_torch/native/fastx_reader.cpp): an exact fixed-point ``%f`` for
finite values under 2^40, snprintf for the rest.  Each case holds the
field routine to utils/formats.py:cpp_to_string (Python's correctly
rounded ``.6f`` with glibc's nan and inf spellings) and to glibc's own
snprintf("%f"), byte for byte, on 10^5 doubles or more; then whole tables
of ``_emit_rows_native`` against the per-row Python fallback of
``_emit_prepared``.  CPU only: it needs g++, no card."""

from __future__ import annotations

import ctypes
import ctypes.util
import io
import math

import numpy as np
import pytest

from ntsm_tpu_torch import native
from ntsm_tpu_torch.eval import emit
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils.formats import cpp_to_string

N_VALUES = 100_000
EDGE = 2.0**40  # the fast path's bound: |x| < 2^40
DBL_MAX = np.finfo(np.float64).max


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "the native host library did not build"
    return lib


def _from_bits(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint64).view(np.float64)


def _signed(rng, x: np.ndarray) -> np.ndarray:
    return np.where(rng.random(x.shape) < 0.5, -x, x)


def _specials(rng) -> np.ndarray:
    """Signed zeros, subnormals, DBL_MAX, +-inf, nan and -nan (any
    payload), the smallest normals, then random subnormals and huge
    values."""
    fixed = np.array([0.0, -0.0, 5e-324, -5e-324, DBL_MAX, -DBL_MAX, np.inf, -np.inf,
                      np.nan, -np.nan, np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny,
                      np.nextafter(np.finfo(np.float64).tiny, 0.0)])
    n = (N_VALUES - fixed.size) // 4 + 1
    sub = _from_bits(rng.integers(1, 1 << 52, n, dtype=np.uint64))
    huge = _from_bits(rng.integers(1063 << 52, 0x7FF << 52, n, dtype=np.uint64))
    nans = _from_bits(rng.integers((0x7FF << 52) + 1, 0x800 << 52, n, dtype=np.uint64))
    zeros = np.zeros(n)
    return np.concatenate([fixed, _signed(rng, sub), _signed(rng, huge), _signed(rng, nans),
                           _signed(rng, zeros)])


def _ties(rng) -> np.ndarray:
    """Exact dyadic values k / 2^j; the odd multiples of 1/128 are the
    exact ties of the sixth decimal, (q + 0.5) 10^-6."""
    n = N_VALUES // 2
    odd = (2 * rng.integers(0, 1 << 46, n, dtype=np.int64) + 1).astype(np.float64) / 128.0
    j = rng.integers(0, 61, n)
    k = rng.integers(0, 1 << 53, n, dtype=np.int64).astype(np.float64)
    dyadic = np.ldexp(k, -j)  # 2^-60 to 2^53: some past the edge
    small = np.arange(1, 4096, 2) / 128.0  # every tie under 32
    return _signed(rng, np.concatenate([odd, dyadic, small]))


def _near_ties(rng) -> np.ndarray:
    """The nearest doubles to (q + 0.5) 10^-6 and their neighbours on
    either side, q across the whole fast range."""
    n = N_VALUES // 3 + 1
    q = np.floor(np.ldexp(rng.random(n), rng.integers(0, 60, n)))
    mid = (q + 0.5) * 1e-6
    x = np.concatenate([mid, np.nextafter(mid, np.inf), np.nextafter(mid, -np.inf)])
    return _signed(rng, x)


def _edge(rng) -> np.ndarray:
    """Every double within 5*10^4 ulps of 2^40 on both sides, both signs:
    the fallback's edge."""
    base = np.float64(EDGE).view(np.uint64)
    x = _from_bits(base + np.arange(-N_VALUES // 4, N_VALUES // 4, dtype=np.int64).astype(np.uint64))
    return np.concatenate([x, -x])


def _random_exponents(rng) -> np.ndarray:
    """Random significands at exponents 2^-60 to 2^45."""
    x = np.ldexp(1.0 + rng.random(N_VALUES), rng.integers(-60, 46, N_VALUES))
    return _signed(rng, x)


CASES = {
    "specials": _specials,
    "ties": _ties,
    "near_ties": _near_ties,
    "edge_2_40": _edge,
    "random_exponents": _random_exponents,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_field_is_glibc_percent_f(lib, case):
    rng = np.random.default_rng(sorted(CASES).index(case) + 2201)
    xs = CASES[case](rng)
    assert xs.size >= N_VALUES
    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    libc.snprintf.restype = ctypes.c_int
    out = ctypes.create_string_buffer(400)
    ref = ctypes.create_string_buffer(400)
    bad, slow_off, n_slow = [], 0, 0
    for x in xs.tolist():
        n = lib.ntsm_format_f6(x, out)
        got = out.raw[:abs(n)].decode()
        m = libc.snprintf(ref, 400, b"%f", ctypes.c_double(x))
        want = cpp_to_string(x)
        if got != want or ref.raw[:m].decode() != want:
            bad.append((x.hex(), got, want))
        slow = not math.isfinite(x) or abs(x) >= EDGE
        slow_off += (n < 0) != slow
        n_slow += n < 0
    assert not bad, f"{len(bad)} of {xs.size} differ, e.g. {bad[:5]}"
    assert slow_off == 0
    if case == "random_exponents":  # the fast path carries the common values
        assert n_slow < xs.size // 10


def _block(seed: int, N: int = 12, L: int = 40):
    """A prepared cohort and one block of its pairs whose float columns
    hold the formatter's hard values: an n = 0 pair's DBL_MAX score, a 0/0
    relatedness, -0.0, ties, values at 2^40 and ordinary ones."""
    rng = np.random.default_rng(seed)
    opts = Options(all=False)
    mx = rng.integers(0, 30, size=(N, L, 2)).astype(np.int32)
    data = CountData(
        filenames=[f"s{i}_counts.txt" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=np.full((L, 2), 13, dtype=np.int64), max_counts=mx, sum_counts=mx * 13,
        raw_total_kmers=np.full(N, 10**9, dtype=np.int64), ks=np.full(N, 19, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)).astype(np.int64)).prepare(opts)
    iu, ju = np.triu_indices(N, 1)
    P = iu.size
    hard = np.array([DBL_MAX, np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 1 / 128, 3 / 128,
                     -5 / 128, 0.5, 2.5000005, EDGE, np.nextafter(EDGE, 0.0), -EDGE, 5e-324,
                     0.4999995, 1e30])
    f3 = rng.uniform(-2, 3, size=(P, 3))
    f3[:, 0] = rng.uniform(0, 1, P)
    for c in range(3):
        at = rng.choice(P, hard.size, replace=False)
        f3[at, c] = hard
    f3[0, 0] = DBL_MAX  # an n = 0 pair
    f3[1, 1] = np.nan  # 0/0 relatedness
    f3[2, 2] = -0.0
    i9 = rng.integers(0, 1000, size=(P, 9)).astype(np.int64)
    i9[0, 8] = 0
    dist = rng.uniform(0, 50, P)
    dist[rng.choice(P, hard.size, replace=False)] = hard
    return data, iu, ju, f3, i9, dist


def _n_slow(*cols) -> int:
    return int(sum((~np.isfinite(c) | (np.abs(c) >= EDGE)).sum() for c in cols))


@pytest.mark.parametrize("with_dist", [False, True], ids=["minus1", "dist"])
@pytest.mark.parametrize("all_rows", [True, False], ids=["a", "default"])
def test_native_rows_are_the_python_rows(lib, all_rows, with_dist):
    data, iu, ju, f3, i9, dist = _block(7 + 2 * all_rows + with_dist)
    opts = Options(all=all_rows, score_thresh=0.5)
    d = dist if with_dist else None
    samp_w = emit._sample_strings(data)
    before = dict(emit.counters)
    native_out, python_out = io.StringIO(), io.StringIO()
    emit._emit_prepared(data, opts, native_out, iu, ju, f3, i9, lib, samp_w, dist=d)
    fields = emit.counters["float_fields"] - before["float_fields"]
    slow = emit.counters["float_slow"] - before["float_slow"]
    emit._emit_prepared(data, opts, python_out, iu, ju, f3, i9, None, None, dist=d)
    got = native_out.getvalue()
    assert got == python_out.getvalue()
    keep = np.ones(iu.size, bool) if all_rows else f3[:, 0] < opts.score_thresh
    rows = int(keep.sum())
    assert got.count("\n") == rows and rows > 0
    assert fields == rows * (4 if with_dist else 3)
    cols = [f3[keep, c] for c in range(3)] + ([dist[keep]] if with_dist else [])
    assert slow == _n_slow(*cols) > 0
