"""The yardstick's peaks and the operations and bytes each kernel needs,
from the shapes and counts of a run's inputs (the bound arithmetic of the
repository's card smoke test, copied).

Peaks are NVIDIA's data sheet for one H100 SXM at its full power limit of
700 W.  A roofline share is the least time the card could take, the larger
of bytes over bandwidth and operations over the operation rate, over the
kernel's device time.  Each count is of what these inputs need, never of
the most they could, so that a share cannot pass 100% by a count too high.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12  # outside the tensor cores
OPS32_PER_S = 67e12  # 32-bit operations outside the tensor cores
PAIR_SITE_F64_OPS = 8  # a valid pair-site: 2 divisions, 2 products, 4 sums
SLOTS = 8  # a probe bucket's slots


def least_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time of a kernel that moves n_bytes and does n_ops."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def count_step_least_s(upload_bytes: float, windows: float, valid: float, hits: float,
                       n_buckets: int, launches: int) -> float:
    """The fused count step over `launches` launches that share a pass's
    batches evenly: the uploaded rows read once, in each launch one 8-byte
    fingerprint row of each bucket its valid windows reach (the expected
    number of distinct buckets under a uniform hash), the key and value
    rows of a hit's bucket and a count read-modify-write a hit;
    operations: the canonical min and hash of every window (~25 64-bit
    integer ones, two 32-bit ones each) and the probe of each valid window
    (~10)."""
    if launches <= 0:
        return 0.0
    per = valid / launches
    buckets = launches * n_buckets * (1.0 - math.exp(-per / n_buckets)) if n_buckets else 0.0
    n_bytes = upload_bytes + buckets * SLOTS + hits * (SLOTS * (8 + 4) + 8)
    return least_s(n_bytes, (windows * 25 + valid * 10) * 2, OPS32_PER_S)


def pair_stats_least_s(valid_pair_sites: float, n_samples: int, n_sites: int) -> float:
    """The all-pairs kernel over a pass: 8 f64 operations a valid
    pair-site; the count planes and s_single read once (16 bytes a
    sample-site)."""
    return least_s(n_samples * n_sites * 16.0, valid_pair_sites * PAIR_SITE_F64_OPS, F64_OPS_PER_S)


def pair_block_least_s(valid_pair_sites: float, touched_rows: int, n_sites: int,
                       n_pairs: int) -> float:
    """The candidate-pair kernel over a pass: 8 f64 operations a valid
    pair-site; each touched row of the planes and s_single read once, the
    pair list (8 bytes a pair) and 36 bytes of results a pair."""
    return least_s(touched_rows * n_sites * 16.0 + n_pairs * (8 + 36),
                   valid_pair_sites * PAIR_SITE_F64_OPS, F64_OPS_PER_S)
