"""The least work of the -p candidate search's radius pass
(csrc/pca_radius.cu), for its roofline share: what any search, brute force
or indexed, has to do on these inputs.  It reads the cloud and the radii
once; for each pair (i, j != i) inside a finite radius r_i it computes the
pair's squared distance (3 dim f64 operations: a difference, a product
and a sum a dimension) and writes the match (a 4-byte index and an 8-byte
distance).  Pairs it need not look at, it need not count: so no search can
read above 100%.
"""

from __future__ import annotations

from portbench.roofline import F64_OPS_PER_S, least_s

MATCH_BYTES = 12  # an int32 index and an f64 distance


def search_least_s(n_samples: int, dim: int, within: int) -> float:
    """The least time of a pass's radius search over an [n_samples, dim]
    f64 cloud with `within` pairs inside a finite radius."""
    n_bytes = n_samples * (dim + 1) * 8.0 + within * MATCH_BYTES
    return least_s(n_bytes, within * 3.0 * dim, F64_OPS_PER_S)
