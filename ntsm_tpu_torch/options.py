"""Run configuration (counterpart of ntsm_tpu/options.py).

One explicit dataclass replaces the reference's mutable globals
(reference: src/Options.h:21-62, src/Options.cpp).  Field names and defaults
are the JAX package's, which keeps the reference's because several of them
(minCov, covSkew, scoreThresh, genomeSize, the PCA radius tiers) leak
directly into numeric output.
"""

from __future__ import annotations

import dataclasses
import math

UNSIGNED_MAX = 2**32 - 1


@dataclasses.dataclass
class Options:
    """Knobs of ``count``, ``eval`` and ``vcf``, defaults per src/Options.h:21-62."""

    # PCA dimensionality (src/Options.h:22)
    dim: int = 20

    verbose: int = 0
    threads: int = 1
    k: int = 19

    # site (SNP) fasta path (src/Options.h:29)
    snp: str = ""
    # summary output file for `count` (src/Options.h:30)
    summary: str = ""
    # warn when fewer than this fraction of sites are covered (src/Options.h:31)
    site_cov_threshold: float = 0.75
    # early-termination coverage threshold, -m (src/Options.h:32);
    # inf means "never terminate early"
    cov_thresh: float = math.inf

    # PCA candidate-search criteria (src/Options.h:35-39)
    pc_search_radius1: float = 2.0
    pc_search_radius2: float = 15.0
    pc_error_thresh: float = 0.01
    pc_miss_site1: float = 0.01
    pc_miss_site2: float = 0.3

    # rotation-matrix / centering file paths (src/Options.h:41-42)
    pca: str = ""
    norm: str = ""

    # merged-count output path & only-merge mode (src/Options.h:45-46)
    merge: str = ""
    only_merge: bool = False

    score_thresh: float = 0.5
    cov_skew: float = 0.2
    all: bool = False
    max_cov: int = UNSIGNED_MAX
    min_cov: int = 1
    # keep k-mers shared between sites (-d)
    dupes: bool = False
    genome_size: int = 6_200_000_000

    # vcf-conversion params (src/Options.h:57-59)
    ref: str = ""
    window: int = 31
    multi: int = 20

    # debug ground-truth pair file for eval -b (src/Options.h:61)
    debug: str = ""

    # ---- extensions (not in the reference) ----
    # eval engine: "auto" runs the device engine wherever pairs are scored
    # (-a, the default all-vs-all, -p) at any cohort size, and the exact host
    # engine for single-sample QC, --only_merge and -p with -b; "exact" forces the
    # float64 host engine; "cuda" forces the device engine (eval/rect.py)
    engine: str = "auto"
    # read batch geometry for the device counting pipeline
    batch_reads: int = 32768
    segment_len: int = 256
    checkpoint: str | None = None  # restartable count snapshots
    checkpoint_every: int = 64  # batches between snapshots

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)
