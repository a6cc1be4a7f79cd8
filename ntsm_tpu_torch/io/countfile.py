"""counts.txt codec, byte-compatible with the reference
(counterpart of ntsm_tpu/io/countfile.py).

Writer replicates FingerPrint::printOptionalHeader/printCountsMax
(src/FingerPrint.hpp:261-311), MultiCount::printCountsMax
(src/MultiCount.hpp:93-138, which omits the #@ header lines) and
CompareCounts::mergeCounts (src/CompareCounts.hpp:626-674).

Reader replicates the CompareCounts constructor (src/CompareCounts.hpp:30-114):
the first file fixes the locus order and the distinct columns; every file's
rows are matched by locusID; a file's coverage total is the sum of its
max-count columns.  One loader, :func:`load_count_planes`, reads each file
once: the native parser (ntsm_tpu_torch.native) reads a file whose loci
are the first file's, in their order; the id-mapped Python parse takes any
other.  Each file's read and parse are the stages ``load.read`` and
``load.parse`` of the current stage recorder (utils/spans.py), and
:data:`counters` counts the loader's work.
The JAX package's wire loader (u8/u16 upload planes) is a TPU upload
format and is not ported: the eval engine here uploads the int32 planes.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

from ntsm_tpu_torch.utils import spans

# The loader's work in this process (read by tests and the benchmark, like
# the kernels' launch counters): files read, their bytes, and the files
# that the id-mapped fill parsed.
counters = {"files": 0, "bytes": 0, "exact_files": 0}


def format_counts(
    site_ids,
    max_counts: np.ndarray,  # [n_sites, 2]
    sum_counts: np.ndarray,  # [n_sites, 2]
    distinct: np.ndarray,  # [n_sites, 2]
    total_kmers: int | None,
    k: int | None,
) -> str:
    """Render a counts file. total_kmers/k None => no #@ header (ntsmVCF)."""
    parts: list[str] = []
    if total_kmers is not None:
        parts.append(f"#@TK\t{int(total_kmers)}\n#@KS\t{int(k)}")
    parts.append("\n#locusID\tcountAT\tcountCG\tsumAT\tsumCG\tdistinctAT\tdistinctCG\n")
    mc = np.asarray(max_counts)
    sc = np.asarray(sum_counts)
    dc = np.asarray(distinct)
    for i, sid in enumerate(site_ids):
        parts.append(
            f"{sid}\t{int(mc[i,0])}\t{int(mc[i,1])}\t{int(sc[i,0])}\t{int(sc[i,1])}"
            f"\t{int(dc[i,0])}\t{int(dc[i,1])}\n"
        )
    return "".join(parts)


def format_merged_counts(site_ids, max_counts, sum_counts, distinct, total_kmers, k) -> str:
    """mergeCounts layout: #@ header then table, no leading blank line
    (src/CompareCounts.hpp:639-644)."""
    body = format_counts(site_ids, max_counts, sum_counts, distinct, None, None)
    return f"#@TK\t{int(total_kmers)}\n#@KS\t{int(k)}{body}"


_scratch: dict = {}  # the native parse's locus-id buffer, reused across files


def _read(path: str) -> bytes:
    """A count file's bytes (stage load.read), counted."""
    with spans.stage("load.read"):
        with open(path, "rb") as fh:
            buf = fh.read()
    counters["files"] += 1
    counters["bytes"] += len(buf)
    return buf


def _parse_into(lib, buf: bytes, mc_row, sc_row, dist=None):
    """Native parse (ntsm_parse_counts2, stage load.parse) of a file's bytes
    straight into int32 [cap, 2] rows, and its distinct columns into the
    int64 [cap, 2] `dist` where given: (rows, locus-id blob, #@TK, #@KS),
    or None without the library, for a malformed file or a value past
    int32.  The id buffer is reused across files (first-touch page faults
    on fresh multi-MB allocations dominated the per-file cost otherwise)."""
    if lib is None:
        return None
    with spans.stage("load.parse"):
        cap = mc_row.shape[0]
        ids = _scratch.get("ids")
        if ids is None or ids.shape[0] < len(buf) + 16:
            ids = _scratch["ids"] = np.empty(len(buf) + 16 + cap, dtype=np.uint8)
        ids_len = ctypes.c_long(0)
        tk = ctypes.c_long(0)
        ks = ctypes.c_long(0)
        rows = lib.ntsm_parse_counts2(
            buf,
            len(buf),
            mc_row.ctypes.data_as(ctypes.c_void_p),
            sc_row.ctypes.data_as(ctypes.c_void_p),
            None if dist is None else dist.ctypes.data_as(ctypes.c_void_p),
            cap,
            ids.ctypes.data_as(ctypes.c_void_p),
            ids.shape[0],
            ctypes.byref(ids_len),
            ctypes.byref(tk),
            ctypes.byref(ks),
        )
        if rows < 0:
            return None
        return rows, ids[: ids_len.value].tobytes(), tk.value, ks.value


def _parse_rows(path: str, buf: bytes):
    """(#@TK, #@KS, rows of 7 fields) of a count file's bytes, parsed line
    by line as text; locus IDs decode as latin-1, raw bytes as the native
    parse reads them."""
    tk = 0
    ks = 0
    rows = []
    with spans.stage("load.parse"):
        for lineno, line in enumerate(io.TextIOWrapper(io.BytesIO(buf), "latin-1"), 1):
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            if line[0] == "#":
                if fields[0] == "#@TK":
                    tk = int(fields[1])
                elif fields[0] == "#@KS":
                    ks = int(fields[1])
                continue
            if len(fields) != 7:
                raise SystemExit(
                    f"ntsm eval: {path}:{lineno}: malformed count file row "
                    f"({len(fields)} fields, expected 7: locusID + 6 counts)"
                )
            rows.append(fields)
    return tk, ks, rows


def _fill(mc, sc, s: int, rows, index_of: dict):
    """The id-mapped fill: file s's text rows into plane row s, each at its
    locus's place, as the reference's .at() lookups (CompareCounts.hpp:
    87-99): an unknown locus raises, a locus the file lacks keeps 0.  A
    value past int32 widens both planes to int64; returns the planes."""
    counters["exact_files"] += 1
    with spans.stage("load.parse"):
        at = np.array([index_of[r[0]] for r in rows], dtype=np.intp)
        vals = np.array([[int(v) for v in r[1:5]] for r in rows], dtype=np.int64).reshape(-1, 4)
        i32 = np.iinfo(np.int32)
        if mc.dtype != np.int64 and vals.size and (vals.max() > i32.max or vals.min() < i32.min):
            mc, sc = mc.astype(np.int64), sc.astype(np.int64)
        mc[s] = 0
        sc[s] = 0
        mc[s, at] = vals[:, 0:2]
        sc[s, at] = vals[:, 2:4]
    return mc, sc


def load_count_planes(paths):
    """Load a cohort's count files the way CompareCounts does, each file
    read once, into [N, L, 2] planes allocated once.

    Returns (locus_ids, distinct [L, 2] i64, mc [N, L, 2], sc [N, L, 2],
    tks [N] i64, kss [N] i64).  The planes are int32, which halves the
    memory traffic of everything downstream (counts are bounded by per-site
    read depth), until a value passes int32: that widens both to int64
    once.  The first file fixes the locus order, L and the distinct
    columns.  A file whose locus column is byte-identical to the first
    file's is parsed natively straight into its plane rows; any other file
    (loci in another order, a row the native parse refuses, a value past
    int32, no native library) takes the id-mapped fill."""
    from ntsm_tpu_torch import native

    lib = native.load()
    n_files = len(paths)
    tks = np.zeros(n_files, dtype=np.int64)
    kss = np.zeros(n_files, dtype=np.int64)

    buf = _read(paths[0])
    cap = buf.count(b"\n") + 1  # bounds the rows
    head_mc, head_sc = np.empty((2, cap, 2), dtype=np.int32)
    dist = np.empty((cap, 2), dtype=np.int64)
    first = _parse_into(lib, buf, head_mc, head_sc, dist)
    if first is None:
        tks[0], kss[0], rows = _parse_rows(paths[0], buf)
        locus_ids = [r[0] for r in rows]
        distinct = np.array([[int(r[5]), int(r[6])] for r in rows], dtype=np.int64).reshape(-1, 2)
        blob0 = "".join(f"{lid}\n" for lid in locus_ids).encode("latin-1")
    else:
        n, blob0, tks[0], kss[0] = first
        locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
        distinct = dist[:n].copy()
    L = len(locus_ids)
    index_of = None
    mc = np.empty((n_files, L, 2), dtype=np.int32)
    sc = np.empty_like(mc)
    if first is None:
        index_of = {lid: i for i, lid in enumerate(locus_ids)}
        mc, sc = _fill(mc, sc, 0, rows, index_of)
    else:
        mc[0], sc[0] = head_mc[:L], head_sc[:L]
    del buf
    for s in range(1, n_files):
        buf = _read(paths[s])
        # int64 planes take the parse through the first file's scratch rows
        wide = mc.dtype == np.int64
        row_mc, row_sc = (head_mc[:L], head_sc[:L]) if wide else (mc[s], sc[s])
        got = _parse_into(lib, buf, row_mc, row_sc)
        if got is not None and got[0] == L and got[1] == blob0:
            tks[s], kss[s] = got[2:]
            if wide:
                mc[s], sc[s] = row_mc, row_sc
        else:
            if index_of is None:
                index_of = {lid: i for i, lid in enumerate(locus_ids)}
            tks[s], kss[s], rows = _parse_rows(paths[s], buf)
            mc, sc = _fill(mc, sc, s, rows, index_of)
        del buf  # freed before the next file's read reuses its pages
    return locus_ids, distinct, mc, sc, tks, kss
