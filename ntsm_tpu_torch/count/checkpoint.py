"""Count-run snapshots: restartable counting
(counterpart of ntsm_tpu/count/checkpoint.py).

The reference has no in-process checkpointing; its count *files* are the
de-facto checkpoint (shard + `ntsmEval --merge`, CompareCounts.hpp:626-674),
which this framework also supports.  This module adds the finer-grained
version SURVEY §5 calls for: periodic on-disk snapshots of
(count vector, totals, input cursor) so a multi-hour WGS count survives
preemption.

The input cursor is a batch index: the reader is deterministic for a given
(files, k, seglen, batch_reads), so resuming = skipping the first
`n_batches` batches (parse-only, ~600 Mbase/s with the native reader) and
restoring the accumulated counts into the host-side plane.  A parameter
signature guards against resuming with different inputs.

Snapshots are written atomically (tmp + rename).
"""

from __future__ import annotations

import os

import numpy as np

SNAP_VERSION = 1


def params_sig(
    filenames,
    k: int,
    seglen: int,
    batch_reads: int,
    n_kmers: int,
    dense: bool = True,
):
    parts = [
        f"v{SNAP_VERSION}",
        f"k{k}",
        f"L{seglen}",
        f"B{batch_reads}",
        f"n{n_kmers}",
        f"d{int(dense)}",  # dense vs classic packing changes the cursor
    ]
    for f in filenames:
        try:
            st = os.stat(f)
            size, mtime = st.st_size, int(st.st_mtime)
        except OSError:
            size, mtime = -1, -1
        parts.append(f"{os.path.abspath(f)}:{size}:{mtime}")
    return "|".join(parts)


def save_snapshot(
    path: str,
    *,
    sig: str,
    n_batches: int,
    counts: np.ndarray,
    total_kmers: int,
    total_hits: int,
    total_bases: int,
    total_reads: int,
) -> None:
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        sig=np.array(sig),
        n_batches=np.int64(n_batches),
        counts=counts.astype(np.int64),
        total_kmers=np.int64(total_kmers),
        total_hits=np.int64(total_hits),
        total_bases=np.int64(total_bases),
        total_reads=np.int64(total_reads),
    )
    # np.savez appends .npz to the tmp name
    os.replace(tmp + ".npz", path)


def load_snapshot(path: str, sig: str) -> dict | None:
    """Load and validate a snapshot; None if absent, error on mismatch."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        got = str(z["sig"])
        if got != sig:
            raise ValueError(
                f"checkpoint {path} was written for different inputs/params:\n"
                f"  checkpoint: {got}\n  current:    {sig}"
            )
        return {
            "n_batches": int(z["n_batches"]),
            "counts": z["counts"].astype(np.int64),
            "total_kmers": int(z["total_kmers"]),
            "total_hits": int(z["total_hits"]),
            "total_bases": int(z["total_bases"]),
            "total_reads": int(z["total_reads"]),
        }
