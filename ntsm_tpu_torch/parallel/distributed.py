"""Several processes over torch.distributed (counterpart of
ntsm_tpu/parallel/distributed.py, and of ntsm_tpu/parallel/mesh.py's
per-device count merge).

The port runs one process for each GPU, PyTorch's own idiom, where the JAX
package meshes all the local devices of one process.  ``count
--distributed`` gives each rank its stride shard of the input files
(:func:`host_file_shard`) and sums the ranks' count vectors and totals at
the end (:func:`merge_count_results`): integer sums, so the merged
counts.txt is byte-identical to one process's.  ``eval --distributed``
deals the all-vs-all row blocks out to the ranks and gathers their
statistics on rank 0 (eval/rect.py:compute_score_all_cuda), which emits.

The collectives carry host arrays (the packed count vector, the eval
blocks' statistics), so the process group is gloo, which also runs where
NCCL cannot: several ranks on one card, and the CPU.  The rendezvous is
read from the JAX package's variables (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID), so one launch script drives both
packages, or else from torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK):

    torchrun --nproc-per-node G -m ntsm_tpu_torch count --distributed ...

runs G ranks on one host, one GPU each.  With neither set the run is one
process, as the JAX package's is off a pod.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the gloo process group from the arguments, the JAX package's
    variables or torchrun's; True when it was joined, False when nothing
    names a group (one process)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None and process_id is None:
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")):
            return False
        # torchrun's variables; env:// also joins the store its agent holds
        with stdout_shield():
            dist.init_process_group("gloo", init_method="env://")
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed: the coordinator address, the number of processes "
                         "and this process's id must all be given")
    with stdout_shield():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return True


def rank() -> int:
    """This process's rank: 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes: 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """This rank's card, cuda:LOCAL_RANK (torchrun's), else cuda:(rank mod
    the cards of the host), made the current device."""
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local else rank() % max(1, torch.cuda.device_count())
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def host_file_shard(paths, process_id: int | None = None, num: int | None = None) -> list:
    """This process's shard of the input file list (stride partition)."""
    pid = rank() if process_id is None else process_id
    n = world_size() if num is None else num
    return list(paths)[pid::n]


@contextlib.contextmanager
def stdout_shield():
    """Route OS-level stdout to stderr for the duration: stdout is a
    byte-parity contract (counts.txt, summary.tsv), and a collective
    backend's setup messages are diagnostics like any other."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def allreduce_sum(x_np: np.ndarray) -> np.ndarray:
    """Sum a host array across all processes; every process returns the
    global total (one process: the array itself)."""
    if world_size() == 1:
        return x_np
    t = torch.from_numpy(np.array(x_np))  # a copy: all_reduce writes in place
    with stdout_shield():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def merge_count_results(result, max_counts_thresh: float | None = None):
    """Combine the ranks' CountResults into the global one: counts and
    totals summed, early-term OR'd, in one all-reduce of the JAX package's
    packed layout (counts, then total_kmers, total_hits, total_bases,
    total_reads and early).

    `max_counts_thresh` is the -m threshold (max_counts_threshold(n_kmers,
    cov_thresh)).  Each rank compares it with its own hits during the run,
    so the merged total is checked again here: a cohort that crosses it
    with no rank crossing it alone reports early_term.  One process: the
    result itself."""
    from ntsm_tpu_torch.count.golden import CountResult

    if world_size() == 1:
        return result
    packed = np.concatenate([
        result.counts.astype(np.int64),
        np.array([result.total_kmers, result.total_hits, result.total_bases,
                  result.total_reads, 1 if result.early_term else 0], dtype=np.int64),
    ])
    total = allreduce_sum(packed)
    early = bool(total[-1] > 0)
    if max_counts_thresh is not None and max_counts_thresh != 0 and not math.isinf(
            max_counts_thresh):
        early = early or int(total[-4]) > max_counts_thresh
    return CountResult(
        counts=total[:-5],
        total_kmers=int(total[-5]),
        total_hits=int(total[-4]),
        total_bases=int(total[-3]),
        total_reads=int(total[-2]),
        early_term=early,
        stages=result.stages,  # this rank's own
    )
