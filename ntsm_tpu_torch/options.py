"""Run configuration (counterpart of ntsm_tpu/options.py).

One explicit dataclass replaces the reference's mutable globals
(reference: src/Options.h:21-62, src/Options.cpp).  Field names and defaults
are the JAX package's, which keeps the reference's because some of them
leak directly into numeric output.  Only the fields of the ported commands
(so far ``count``) are here; the eval and vcf fields come with their slices.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Options:
    """Knobs of ``count``, defaults per src/Options.h:21-62."""

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
    # keep k-mers shared between sites (-d)
    dupes: bool = False

    # ---- extensions (not in the reference) ----
    # read batch geometry for the device counting pipeline
    batch_reads: int = 32768
    segment_len: int = 256
    checkpoint: str | None = None  # restartable count snapshots
    checkpoint_every: int = 64  # batches between snapshots

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)
