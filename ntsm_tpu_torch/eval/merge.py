"""Count-file merging (mergeCounts, src/CompareCounts.hpp:626-674;
counterpart of ntsm_tpu/eval/merge.py).

Count files double as checkpoints: a large sample can be counted in shards
and merged.  Counts and sums add; distinct columns come from the first
file; #@TK adds; all #@KS must agree.
"""

from __future__ import annotations

from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.io.countfile import format_merged_counts


def merge_counts(data: CountData, out_path: str) -> None:
    import numpy as np

    ks = np.asarray(data.ks)
    if ks.size and (ks != ks[0]).any():
        j = int(np.argmax(ks != ks[0]))
        raise AssertionError(
            f"k-mer size mismatch between {data.filenames[0]} and "
            f"{data.filenames[j]} (CompareCounts.hpp:631-635)"
        )
    tk = int(data.raw_total_kmers.sum())
    mc = data.max_counts.sum(axis=0)
    sc = data.sum_counts.sum(axis=0)
    text = format_merged_counts(data.locus_ids, mc, sc, data.distinct, tk, int(ks[0]))
    with open(out_path, "w") as fh:
        fh.write(text)
