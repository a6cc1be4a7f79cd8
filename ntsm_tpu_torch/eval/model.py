"""In-memory model of a set of count files (counterpart of
ntsm_tpu/eval/model.py, plane mode).

Dense-array replacement for CompareCounts' per-file vectors-of-pairs
(src/CompareCounts.hpp:30-114): counts live in [n_samples, n_sites, 2]
arrays; genotype classes and per-site single-sample likelihood terms are
derived vectorized.  The JAX package's wire mode (u8/u16 TPU upload planes
plus accumulators) is not ported: the device engine uploads these int32
planes as they are.
"""

from __future__ import annotations

import numpy as np

from ntsm_tpu_torch.io.countfile import load_count_planes
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans

# genotype classes (order matters for the relatedness logic)
UNKNOWN, HET, HOM_AT, HOM_CG = 0, 1, 2, 3


class CountData:
    """A count-file cohort: max_counts / sum_counts are [N, L, 2] int arrays
    (the reference's m_counts / m_sum)."""

    def __init__(
        self,
        filenames: list,
        locus_ids: list,
        distinct: np.ndarray,  # [L, 2]
        max_counts: np.ndarray,  # [N, L, 2] (m_counts)
        sum_counts: np.ndarray,  # [N, L, 2] (m_sum)
        raw_total_kmers: np.ndarray,  # [N] #@TK per file
        ks: np.ndarray,  # [N] #@KS per file
        total_counts: np.ndarray,  # [N] sum of max-counts per file
    ):
        self.filenames = filenames
        self.locus_ids = locus_ids
        self.distinct = distinct
        self.max_counts = max_counts
        self.sum_counts = sum_counts
        self.raw_total_kmers = raw_total_kmers
        self.ks = ks
        self.total_counts = total_counts
        # derived (filled by prepare())
        self._cls = None
        self._s_single = None
        self._min_cov = 1
        self.hets = None  # [N] over all sites
        self.homs = None
        self.miss = None
        self.error_rate = None  # [N]
        self.cov = None  # [N]

    def counts_ab(self) -> tuple[np.ndarray, np.ndarray]:
        """The two [N, L] allele count planes (views)."""
        return self.max_counts[:, :, 0], self.max_counts[:, :, 1]

    @property
    def n_samples(self) -> int:
        return self.max_counts.shape[0]

    @property
    def n_sites(self) -> int:
        return len(self.locus_ids)

    @property
    def s_single(self) -> np.ndarray:
        """[N, L] f64 per-site single-sample likelihood terms
        (computeSumLogPSingle, CompareCounts.hpp:968-991).  Lazy: only the
        exact engine reads it; the device engine computes the same plane on
        the card (eval/pair_kernel.py:s_single_plane).  max(den, 1) is
        exact: a zero denominator implies both masks are false (any
        min_cov >= 0)."""
        if self._s_single is None:
            a, b = self.counts_ab()
            mc = self._min_cov
            af = a.astype(np.float64)
            bf = b.astype(np.float64)
            den = np.maximum(af + bf, 1.0)
            freq_at = np.where(a > mc, af / den, 0.0)
            freq_cg = np.where(b > mc, bf / den, 0.0)
            self._s_single = af * freq_at + bf * freq_cg
        return self._s_single

    @property
    def cls(self) -> np.ndarray:
        """[N, L] u8 genotype class (calcHomHetMiss,
        CompareCounts.hpp:742-768).  Lazy: only the exact engine reads it."""
        if self._cls is None:
            a, b = self.counts_ab()
            pa = a > self._min_cov
            pb = b > self._min_cov
            self._cls = np.where(
                pa, np.where(pb, HET, HOM_AT), np.where(pb, HOM_CG, UNKNOWN)
            ).astype(np.uint8)
        return self._cls

    def prepare(self, opts: Options) -> "CountData":
        """The per-sample columns (stage `prepare` of the current stage
        recorder, utils/spans.py)."""
        with spans.stage("prepare"):
            a, b = self.counts_ab()
            mc = opts.min_cov
            pa = a > mc
            pb = b > mc
            self._cls = None
            self.hets = (pa & pb).sum(axis=1)
            self.homs = (pa ^ pb).sum(axis=1)
            self.miss = (~(pa | pb)).sum(axis=1)

            self._min_cov = opts.min_cov
            self._s_single = None

            # error rate (computeErrorRate, CompareCounts.hpp:1198-1217)
            n = self.n_samples
            err = np.full(n, -1.0)
            distinct_kmers = float(self.distinct.sum())
            sums = self.sum_counts.sum(axis=(1, 2)).astype(np.float64)
            for i in range(n):
                if self.raw_total_kmers[i] > 0 and self.ks[i] > 0:
                    expected = (
                        float(self.raw_total_kmers[i]) * distinct_kmers / float(opts.genome_size)
                    )
                    err[i] = 1.0 - (sums[i] / expected) ** (1.0 / float(self.ks[i]))
            self.error_rate = err
            self.cov = self.total_counts.astype(np.float64) / float(self.n_sites)
        return self


def load_count_data(paths, opts: Options) -> CountData:
    """Load and prepare a cohort (io/countfile.py:load_count_planes).  The
    load is the stage `load` of the current stage recorder
    (utils/spans.py), the prepare its sibling `prepare`."""
    with spans.stage("load"):
        data = _load(paths)
    return data.prepare(opts)


def _load(paths) -> CountData:
    locus_ids, distinct, mc, sc, tks, kss = load_count_planes(paths)
    return CountData(
        filenames=list(paths),
        locus_ids=locus_ids,
        distinct=distinct,
        max_counts=mc,
        sum_counts=sc,
        raw_total_kmers=tks,
        ks=kss,
        total_counts=mc.sum(axis=(1, 2)),
    )
