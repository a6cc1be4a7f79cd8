"""counts.txt codec, byte-compatible with the reference
(counterpart of ntsm_tpu/io/countfile.py).

Writer replicates FingerPrint::printOptionalHeader/printCountsMax
(src/FingerPrint.hpp:261-311), MultiCount::printCountsMax
(src/MultiCount.hpp:93-138, which omits the #@ header lines) and
CompareCounts::mergeCounts (src/CompareCounts.hpp:626-674).

Reader replicates the CompareCounts constructor (src/CompareCounts.hpp:30-114):
the first file fixes the locus order and the distinct columns; every file's
rows are matched by locusID; a file's coverage total is the sum of its
max-count columns.  The native parsers (ntsm_tpu_torch.native) read the
numeric columns; the Python parse is the fallback.  The JAX package's
wire loader (u8/u16 upload planes) is a TPU upload format and is not
ported: the eval engine here uploads the int32 planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


@dataclass
class CountFile:
    path: str
    max_counts: np.ndarray  # [n_sites, 2] int64 (countAT, countCG)
    sum_counts: np.ndarray  # [n_sites, 2] int64 (sumAT, sumCG)
    raw_total_kmers: int  # #@TK, 0 if absent
    k: int  # #@KS, 0 if absent
    total_counts: int  # sum of max_counts (src/CompareCounts.hpp:104-106)


_scratch: dict = {}


def _parse_native(path: str):
    """Native counts.txt parse: (tk, ks, ids_blob, ints[n,6]) or None.

    Scratch buffers are reused across files (first-touch page faults on
    fresh multi-MB allocations dominated the per-file cost otherwise)."""
    from ntsm_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None
    import ctypes

    with open(path, "rb") as fh:
        buf = fh.read()
    cap = buf.count(b"\n") + 2
    ints = _scratch.get("ints")
    if ints is None or ints.shape[0] < cap:
        ints = _scratch["ints"] = np.empty((cap, 6), dtype=np.int64)
    idcap = len(buf) + cap + 16
    ids = _scratch.get("ids")
    if ids is None or ids.shape[0] < idcap:
        ids = _scratch["ids"] = np.empty(idcap, dtype=np.uint8)
    ids_len = ctypes.c_long(0)
    tk = ctypes.c_long(0)
    ks = ctypes.c_long(0)
    n = lib.ntsm_parse_counts(
        buf,
        ctypes.c_long(len(buf)),
        ints.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(ints.shape[0]),
        ids.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(ids.shape[0]),
        ctypes.byref(ids_len),
        ctypes.byref(tk),
        ctypes.byref(ks),
    )
    if n < 0:
        return None
    blob = ids[: ids_len.value].tobytes()
    return tk.value, ks.value, blob, ints[:n]


def load_count_arrays(paths):
    """Bulk loader for the eval engines: fills preallocated
    [N, L, 2] planes directly, with no per-file arrays to stack.

    Returns (locus_ids, distinct, mc [N,L,2] i32, sc [N,L,2] i32,
    tks [N] i64, ks [N] i64) — int32 planes (counts are bounded by per-site
    read depth); a file with values outside int32 falls back to the exact
    int64 path via load_count_files."""
    from ntsm_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None  # caller falls back to load_count_files
    import ctypes

    def parse_into(path, mc_row, sc_row):
        """Native parse straight into the final [n, 2] i32 slices.
        Returns (rows, ids_blob, tk, ks) or None (malformed / overflow)."""
        with open(path, "rb") as fh:
            buf = fh.read()
        cap = mc_row.shape[0]
        idcap = len(buf) + 16
        ids = _scratch.get("ids")
        if ids is None or ids.shape[0] < idcap:
            ids = _scratch["ids"] = np.empty(idcap + cap, dtype=np.uint8)
        ids_len = ctypes.c_long(0)
        tk = ctypes.c_long(0)
        ks = ctypes.c_long(0)
        rows = lib.ntsm_parse_counts2(
            buf,
            ctypes.c_long(len(buf)),
            mc_row.ctypes.data_as(ctypes.c_void_p),
            sc_row.ctypes.data_as(ctypes.c_void_p),
            None,  # the distinct columns come from the first file
            ctypes.c_long(cap),
            ids.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(ids.shape[0]),
            ctypes.byref(ids_len),
            ctypes.byref(tk),
            ctypes.byref(ks),
        )
        if rows < 0:
            return None
        return rows, ids[: ids_len.value].tobytes(), tk.value, ks.value

    # first file fixes locus order, row count and the distinct columns
    nat0 = _parse_native(paths[0])
    if nat0 is None:
        return None
    tk0, ks0, blob0, ints0 = nat0
    locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
    distinct = ints0[:, 4:6].copy()
    n = len(locus_ids)
    N = len(paths)
    # int32: halves the memory traffic of everything downstream; counts
    # are bounded by per-site read depth (<< 2^31)
    mc = np.empty((N, n, 2), dtype=np.int32)
    sc = np.empty((N, n, 2), dtype=np.int32)
    tks = np.zeros(N, dtype=np.int64)
    kss = np.zeros(N, dtype=np.int64)
    tks[0] = tk0
    kss[0] = ks0
    if ints0[:, 0:4].max(initial=0) > np.iinfo(np.int32).max:
        return None
    mc[0] = ints0[:, 0:2]
    sc[0] = ints0[:, 2:4]
    index_of = None
    for s in range(1, N):
        got = parse_into(paths[s], mc[s], sc[s])
        if got is not None and got[0] == n and got[1] == blob0:
            _, _, tks[s], kss[s] = got
        else:
            # locus order differs / malformed / i32 overflow: exact
            # id-mapped parse for this file
            if index_of is None:
                index_of = {lid: i for i, lid in enumerate(locus_ids)}
            tk, ks, rows = _parse_rows(paths[s])
            mc[s] = 0
            sc[s] = 0
            try:
                for r in rows:
                    i = index_of[r[0]]
                    mc[s, i, 0] = int(r[1])
                    mc[s, i, 1] = int(r[2])
                    sc[s, i, 0] = int(r[3])
                    sc[s, i, 1] = int(r[4])
            except OverflowError:
                # count > 2^31-1 in a locus-reordered file: the int32 fast
                # planes can't hold it; signal the caller to use the exact
                # int64 load_count_files path instead
                return None
            tks[s] = tk
            kss[s] = ks
    return locus_ids, distinct, mc, sc, tks, kss


def _parse_rows(path: str):
    tk = 0
    ks = 0
    rows = []
    with open(path, "r") as fh:
        for lineno, line in enumerate(fh, 1):
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


def load_count_files(paths) -> tuple[list, np.ndarray, list[CountFile]]:
    """Load count files the way CompareCounts does.

    Returns (locus_ids, distinct[n_sites,2], [CountFile...]).

    Fast path: the native parser (ntsm_tpu_torch.native) reads the numeric
    columns; when a file's locus column is byte-identical to the first
    file's (the overwhelmingly common case — same site set, same order)
    the arrays are used directly, otherwise rows are re-mapped by id
    exactly like the reference's .at() lookups (CompareCounts.hpp:87-99).
    """
    nat0 = _parse_native(paths[0])
    index_of = None
    if nat0 is not None:
        tk0, ks0, blob0, ints0 = nat0
        locus_ids = blob0.decode("latin-1").splitlines()  # raw-byte ids, as the reference
        distinct = ints0[:, 4:6].copy()
        n = len(locus_ids)
    else:
        tk0, ks0, rows0 = _parse_rows(paths[0])
        locus_ids = [r[0] for r in rows0]
        distinct = np.array(
            [[int(r[5]), int(r[6])] for r in rows0], dtype=np.int64
        )
        n = len(locus_ids)
        blob0 = None

    out = []
    for idx, path in enumerate(paths):
        if nat0 is None:
            nat = None
        else:
            nat = nat0 if idx == 0 else _parse_native(path)
        if nat is not None and nat[2] == blob0:
            tk, ks, _, ints = nat
            mc = ints[:, 0:2].copy()
            sc = ints[:, 2:4].copy()
        else:
            if index_of is None:
                index_of = {lid: i for i, lid in enumerate(locus_ids)}
            tk, ks, rows = _parse_rows(path)
            mc = np.zeros((n, 2), dtype=np.int64)
            sc = np.zeros((n, 2), dtype=np.int64)
            for r in rows:
                i = index_of[r[0]]  # unknown locus raises, like .at() would
                mc[i, 0] = int(r[1])
                mc[i, 1] = int(r[2])
                sc[i, 0] = int(r[3])
                sc[i, 1] = int(r[4])
        out.append(
            CountFile(
                path=path,
                max_counts=mc,
                sum_counts=sc,
                raw_total_kmers=tk,
                k=ks,
                total_counts=int(mc.sum()),
            )
        )
    return locus_ids, distinct, out
