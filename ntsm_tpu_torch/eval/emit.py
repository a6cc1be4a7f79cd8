"""Row emission for the eval engines (counterpart of
ntsm_tpu/eval/emit.py): the native C formatter binding, the shared
-a/-p emission path, and per-sample string caches."""

from __future__ import annotations

import numpy as np

from ntsm_tpu_torch.eval.exact import PairResult, Relate, results_row
from ntsm_tpu_torch.utils.formats import cpp_to_string

# the tallies in _pair_columns' argument order, after the score
PAIR_COL_KEYS = (
    "ibs0", "shared_hets", "shared_homs",
    "hets1", "hets2", "homs1", "homs2", "n",
)


# the native row formatter's float fields (score, relatedness, homConcord,
# and the distance under -p) and those of them snprintf printed: nan, inf
# and |x| >= 2^40 (float_slow / float_fields is the share off the fast path)
counters = {"float_fields": 0, "float_slow": 0}


def _load_row_formatter():
    """The native row-formatter lib, or None (Python per-row fallback)."""
    from ntsm_tpu_torch import native

    return native.load()


def _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w, dist=None):
    """Emit rows from prebuilt (f3 [P,3] f64, i9 [P,9] i64) column arrays
    (the _pair_columns contract) — both engines put each block of pairs
    into exactly these.  dist is the -p path's per-pair f64 column, or
    None for the "-1" of all-vs-all.

    Applies the -a / score-threshold filtering and the quirky `same`
    column semantics (CompareCounts.hpp:853-861), then formats through the
    native C formatter (far faster than the per-row Python path, which
    takes minutes for an N=3202 cohort) or the per-row Python fallback.
    Byte-identical both ways: float columns are glibc "%f"
    (utils/formats.py:cpp_to_string)."""
    sc = f3[:, 0]
    if opts.all:
        same = np.where(
            sc < opts.score_thresh, ord("1"), ord("0")
        ).astype(np.uint8)
    else:
        keep = sc < opts.score_thresh
        iu, ju, f3, i9 = iu[keep], ju[keep], f3[keep], i9[keep]
        sc = f3[:, 0]
        if dist is not None:
            dist = dist[keep]
        # without -a only passing pairs print, hard-coded "1"
        same = np.full(iu.shape[0], ord("1"), dtype=np.uint8)
    P = int(iu.shape[0])
    if P == 0:
        return

    if lib is not None:
        ii = np.ascontiguousarray(iu.astype(np.int32))
        jj = np.ascontiguousarray(ju.astype(np.int32))
        dd = None if dist is None else np.ascontiguousarray(dist, dtype=np.float64)
        _emit_rows_native(lib, data, out, ii, jj, f3, i9, same, dd, samp_w)
        return

    for p in range(P):
        r = Relate(
            ibs0=int(i9[p, 0]),
            ibs2=int(i9[p, 1]),
            shared_homs=int(i9[p, 7]),
            shared_hets=int(i9[p, 4]),
            hets1=int(i9[p, 2]),
            homs1=int(i9[p, 5]),
            hets2=int(i9[p, 3]),
            homs2=int(i9[p, 6]),
        )
        # same IEEE divisions as cpp_div on these operands
        r.hom_concord = float(f3[p, 2])
        r.relatedness = float(f3[p, 1])
        res = PairResult(
            i=int(iu[p]), j=int(ju[p]), score=float(sc[p]),
            n=int(i9[p, 8]), relate=r,
        )
        d = "-1" if dist is None else cpp_to_string(float(dist[p]))
        out.write(results_row(data, res, d, opts))
        out.write("\n")


def _sample_strings(data):
    """[N, 6] fixed-width per-sample byte columns (formatted once):
    fname, cov, errorRate, miss, homs, hets."""
    N = data.n_samples
    rows = [
        [
            str(data.filenames[s]).encode("utf-8"),
            cpp_to_string(float(data.cov[s])).encode(),
            cpp_to_string(float(data.error_rate[s])).encode(),
            str(int(data.miss[s])).encode(),
            str(int(data.homs[s])).encode(),
            str(int(data.hets[s])).encode(),
        ]
        for s in range(N)
    ]
    # width in BYTES (filenames may be non-ASCII UTF-8)
    w = max(len(x) for r in rows for x in r) + 1
    samp = np.zeros((N, 6), dtype=f"S{w}")
    for s, r in enumerate(rows):
        for c, x in enumerate(r):
            samp[s, c] = x
    return np.ascontiguousarray(samp), w


def _pair_columns(score, ibs0, shet, shom, h1, h2, o1, o2, n):
    """The (f3, i9) column-order contract of ntsm_format_eval_rows,
    assembled from per-pair vectors (relate/homConcord are the same IEEE
    f64 divisions as the per-row cpp_div)."""
    P = score.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        relate = (shet - 2.0 * ibs0) / np.minimum(h1, h2).astype(np.float64)
        homc = (shom - 2.0 * ibs0) / np.minimum(o1, o2).astype(np.float64)
    f3 = np.empty((P, 3), np.float64)
    f3[:, 0] = score
    f3[:, 1] = relate
    f3[:, 2] = homc
    i9 = np.empty((P, 9), np.int64)
    i9[:, 0] = ibs0
    i9[:, 1] = shet + shom  # ibs2
    i9[:, 2] = h1
    i9[:, 3] = h2
    i9[:, 4] = shet
    i9[:, 5] = o1
    i9[:, 6] = o2
    i9[:, 7] = shom
    i9[:, 8] = n
    return f3, i9


def _emit_rows_native(lib, data, out, ii, jj, f3, i9, same, dist, samp_w=None):
    """Chunked native emission of prepared per-pair arrays; dist is an f64
    array for -p or None for the "-1" column of all-vs-all."""
    import ctypes

    samp, w = samp_w if samp_w is not None else _sample_strings(data)
    N = data.n_samples
    P = int(ii.shape[0])
    CHROWS = 131072
    cap = min(P, CHROWS) * 384 + 8192
    buf = np.empty(cap, dtype=np.uint8)
    # write the formatted bytes straight to the binary layer when the
    # sink has one: the TSV at N=3202 is ~900 MB, and routing it through
    # the text layer costs a utf-8 decode + re-encode + extra copy
    # (StringIO and text sinks without .buffer keep the decode path)
    raw = getattr(out, "buffer", None)
    if raw is not None:
        out.flush()  # anything buffered in the text layer goes first
    vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    slow = ctypes.c_long(0)
    for c0 in range(0, P, CHROWS):
        c1 = min(c0 + CHROWS, P)
        blk = c1 - c0
        f3b = np.ascontiguousarray(f3[c0:c1])
        i9b = np.ascontiguousarray(i9[c0:c1])
        db = None if dist is None else dist[c0:c1]
        while True:
            nb = lib.ntsm_format_eval_rows(
                blk, vp(ii[c0:c1]), vp(jj[c0:c1]), vp(f3b), vp(i9b),
                vp(same[c0:c1]), None if db is None else vp(db),
                vp(samp), w, N, vp(buf), buf.shape[0], ctypes.byref(slow),
            )
            if nb >= 0:
                break
            # pathological rows (e.g. DBL_MAX scores print 316 chars/field)
            buf = np.empty(buf.shape[0] * 4, dtype=np.uint8)
        counters["float_fields"] += blk * (3 if dist is None else 4)
        counters["float_slow"] += slow.value
        if raw is not None:
            raw.write(memoryview(buf[:nb]))
        else:
            out.write(buf[:nb].tobytes().decode("utf-8"))
