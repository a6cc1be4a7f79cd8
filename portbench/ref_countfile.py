"""The plain reference of the count-file load: a cohort's count files
(`counts.txt`, as ntsmCount writes them) read back into arrays the way
ntsmEval's CompareCounts constructor reads them (CompareCounts.hpp:30-114).
It imports nothing of the program.

- The first file fixes the locus order and the two distinct columns.
- Every file's rows are matched to the first file's loci by locus ID (an ID
  the first file lacks raises, as the constructor's .at() would; a locus a
  later file lacks keeps zero counts).
- The header lines `#@TK <n>` (k-mers seen) and `#@KS <k>` (the k-mer size)
  are read, and are 0 where absent (ntsmVCF's files have none); the other
  lines that start with '#' (the column names) are skipped.
- A file's coverage total is the sum of its max-count columns.

Departures from the reference, none of which changes what a file that
ntsmCount, ntsmVCF or ntsmEval --merge writes reads as:

- a file is read whole and its rows cut with numpy: '#' lines and blank
  lines are read only before the first row, and every row has to be seven
  tab-separated fields ending in a newline (the last may lack it), each
  count a whole decimal number of at most 18 digits; anything else (a
  blank line, a carriage return, a '#' line among the rows) raises
  ValueError, where the constructor's stream parse would read something;
- the files are read on a pool of threads, as the constructor reads them
  on OpenMP threads: the order of the work, not its result;
- the numbers are held in int64, where the constructor's counts are
  unsigned 32-bit.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

MAX_DIGITS = 18  # every such number fits int64


@dataclass
class Cohort:
    locus_ids: list  # [L] bytes, the first file's order
    distinct: np.ndarray  # [L, 2] distinctAT, distinctCG of the first file
    max_counts: np.ndarray  # [N, L, 2] countAT, countCG
    sum_counts: np.ndarray  # [N, L, 2] sumAT, sumCG
    total_kmers: np.ndarray  # [N] #@TK, 0 where absent
    ks: np.ndarray  # [N] #@KS, 0 where absent
    totals: np.ndarray  # [N] the sum of each file's max-count columns


def read_file(path: str) -> tuple:
    """(locus IDs [L] as a numpy bytes array, [L, 6] int64 numbers in the
    file's column order, #@TK, #@KS) of one count file."""
    with open(path, "rb") as fh:
        raw = fh.read()
    tk = ks = 0
    pos = 0
    while raw.startswith((b"#", b"\n"), pos):  # the header lines, and blank lines among them
        end = raw.find(b"\n", pos)
        end = len(raw) if end < 0 else end
        fields = raw[pos:end].split(b"\t")
        if fields[0] == b"#@TK":
            tk = int(fields[1])
        elif fields[0] == b"#@KS":
            ks = int(fields[1])
        pos = end + 1
    body = raw[pos:]
    if body and not body.endswith(b"\n"):
        body += b"\n"
    a = np.frombuffer(body, np.uint8)
    ends = np.flatnonzero(a == ord("\n"))  # each row's newline
    if not ends.size:
        return np.array([], "S1"), np.zeros((0, 6), np.int64), tk, ks
    tabs = np.flatnonzero(a == ord("\t"))
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
    if tabs.size != 6 * ends.size:
        raise ValueError(f"{path}: rows are not of seven fields")
    tabs = tabs.reshape(-1, 6)
    if ((tabs[:, 0] <= starts) | (tabs[:, 5] >= ends)).any():
        raise ValueError(f"{path}: rows are not of seven fields")
    # the six numbers: between one tab and the next (the last: the newline),
    # their digits right-aligned in a [L, 6, W] block
    lo = tabs + 1
    hi = np.concatenate([tabs[:, 1:], ends[:, None]], axis=1)
    width = hi - lo
    if width.min() < 1 or width.max() > MAX_DIGITS:
        raise ValueError(f"{path}: a count is not a whole number")
    w = int(width.max())
    at = hi[..., None] - w + np.arange(w)
    inside = at >= lo[..., None]
    digits = np.where(inside, a[np.where(inside, at, 0)], ord("0")).astype(np.int64) - ord("0")
    if ((digits < 0) | (digits > 9)).any():
        raise ValueError(f"{path}: a count is not a whole number")
    nums = digits @ 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
    # the locus IDs: from the row's start to its first tab
    wid = int((tabs[:, 0] - starts).max())
    at = starts[:, None] + np.arange(wid)
    ids = np.where(at < tabs[:, :1], a[np.minimum(at, a.size - 1)], 0).astype(np.uint8)
    return ids.view(f"S{wid}").reshape(-1), nums, tk, ks


def read_cohort(paths) -> Cohort:
    """The cohort of count files `paths`, sample s from paths[s]."""
    N = len(paths)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        files = pool.map(read_file, paths)  # in the order of paths
        first = next(files)
        ids0, nums0 = first[0], first[1]
        L = ids0.size
        mx = np.zeros((N, L, 2), np.int64)
        sm = np.zeros((N, L, 2), np.int64)
        tks = np.zeros(N, np.int64)
        kss = np.zeros(N, np.int64)
        index = None
        for s, (ids, nums, tk, ks) in enumerate(itertools.chain([first], files)):
            tks[s], kss[s] = tk, ks
            if np.array_equal(ids, ids0):
                rows = slice(None)
            else:
                if index is None:
                    index = {lid: i for i, lid in enumerate(ids0.tolist())}
                rows = np.array([index[lid] for lid in ids.tolist()], np.int64)
            mx[s, rows] = nums[:, 0:2]
            sm[s, rows] = nums[:, 2:4]
    return Cohort(locus_ids=ids0.tolist(), distinct=nums0[:, 4:6].copy(), max_counts=mx,
                  sum_counts=sm, total_kmers=tks, ks=kss, totals=mx.sum(axis=(1, 2)))
