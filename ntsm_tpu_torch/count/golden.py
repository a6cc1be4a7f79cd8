"""Golden (pure numpy, sequential) counting engine
(counterpart of ntsm_tpu/count/golden.py).

Mirrors FingerPrint's semantics read-by-read (src/FingerPrint.hpp:46-103,
473-488), including the per-read early-termination check, so it serves as
the parity oracle for the device pipeline.  Used by tests and available via
``ntsm count --engine golden``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ntsm_tpu_torch.core.kmers import canonical_hashes
from ntsm_tpu_torch.io.fastx import read_fastx
from ntsm_tpu_torch.io.sites import SiteTable


@dataclass
class CountResult:
    counts: np.ndarray  # [n_kmers] per-k-mer counts (site-table order)
    total_kmers: int  # every valid k-mer seen (hit or not)
    total_hits: int  # k-mers found in the site table ("recorded")
    total_bases: int  # all read bases, including non-ACGT
    total_reads: int
    early_term: bool

    def site_max_sum(self, table: SiteTable):
        """Per-site, per-allele max and sum (FingerPrint.hpp:270-311)."""
        n = table.n_sites
        mx = np.zeros((n, 2), dtype=np.int64)
        sm = np.zeros((n, 2), dtype=np.int64)
        if table.n_kmers:
            idx = (table.kmer_site, table.kmer_allele.astype(np.int64))
            np.maximum.at(mx, idx, self.counts)
            np.add.at(sm, idx, self.counts)
        return mx, sm

    def coverage(self, table) -> float:
        """Fold coverage = sum of per-site max counts / n_sites, the
        quantity ntsmEval derives from a count file
        (CompareCounts.hpp:104-106,296-298)."""
        mx, _ = self.site_max_sum(table)
        return float(mx.sum()) / float(table.n_sites)

    def error_rate(self, table, genome_size: float = 6.2e9) -> float:
        """Sequencing error estimate (computeErrorRate,
        CompareCounts.hpp:1198-1217); -1 when inputs are missing."""
        if self.total_kmers <= 0 or table.k <= 0:
            return -1.0
        mx, sm = self.site_max_sum(table)
        expected = (
            float(self.total_kmers) * float(table.distinct.sum()) / genome_size
        )
        if expected <= 0:
            return -1.0
        return 1.0 - (float(sm.sum()) / expected) ** (1.0 / float(table.k))


def max_counts_threshold(n_kmers: int, cov_thresh: float) -> float:
    """m_maxCounts = size * covThresh / 2; 0 disables (FingerPrint.hpp:41-43)."""
    if cov_thresh == 0:
        return 0.0
    if math.isinf(cov_thresh):
        return math.inf
    return (n_kmers * cov_thresh) / 2.0


def count_codes_batch(
    codes: np.ndarray, k: int, sorted_hashes: np.ndarray, order: np.ndarray
):
    """Exact host count of one [B, L] code batch (rows padded with 4s).

    The per-batch oracle the device kernels are held to in tests.
    Returns (hit_kmer_indices, n_valid_kmers).
    """
    from ntsm_tpu_torch.core.kmers import flat_window_hashes

    B, L = codes.shape
    arr = np.full((B, L + 1), 4, dtype=np.uint8)
    arr[:, :L] = codes
    flat = arr.ravel()
    hs, valid = flat_window_hashes(flat, k)
    h = hs[valid]
    n = sorted_hashes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64), int(h.shape[0])
    pos = np.minimum(np.searchsorted(sorted_hashes, h), n - 1)
    hit = sorted_hashes[pos] == h
    return order[pos[hit]], int(h.shape[0])


def count_files(table: SiteTable, filenames, cov_thresh: float = math.inf) -> CountResult:
    sorted_hashes = np.sort(table.kmer_hashes)
    order = np.argsort(table.kmer_hashes, kind="stable")
    counts = np.zeros(table.n_kmers, dtype=np.int64)
    total_kmers = 0
    total_hits = 0
    total_bases = 0
    total_reads = 0
    max_counts = max_counts_threshold(table.n_kmers, cov_thresh)
    early = False

    for path in filenames:
        if early:
            break
        for rec in read_fastx(path):
            h = canonical_hashes(rec.seq, table.k)
            total_kmers += h.shape[0]
            total_bases += len(rec.seq)
            total_reads += 1
            if h.shape[0]:
                pos = np.searchsorted(sorted_hashes, h)
                pos = np.minimum(pos, max(table.n_kmers - 1, 0))
                hit = (
                    sorted_hashes[pos] == h if table.n_kmers else np.zeros(0, bool)
                )
                hit_idx = order[pos[hit]]
                np.add.at(counts, hit_idx, 1)
                total_hits += int(hit.sum())
            # early termination is checked after every read
            # (FingerPrint.hpp:476-487)
            if max_counts != 0 and total_hits > max_counts:
                early = True
                break

    return CountResult(
        counts=counts,
        total_kmers=total_kmers,
        total_hits=total_hits,
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
    )
