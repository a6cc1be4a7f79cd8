"""counts.txt rendering (counterpart of ntsm_tpu/io/countfile.py).

Only the writer is ported so far; the eval-side loaders come with the eval
slice.
"""

from __future__ import annotations

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
