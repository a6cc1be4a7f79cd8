"""Counting engines (counterpart of ntsm_tpu/count/engine.py).

:func:`run_count` runs the v3 engine by default (run_count_v3 there): a
host feed thread and the fused count kernel, described below.  With
``version=1`` it runs :func:`run_count_v1`, the unpacked-codes engine (the
fused v1 count step of count/kernel.py: window hash, bucket probe and
count in one kernel); with ``version=2`` it runs :func:`run_count_v2`,
the hit-list engine (count/kernel_v2.py:count_step_v2: the window hash and
a 16-slot bucket lookup in one kernel that lists the hit ids, and an
ordering stage that sorts them; the host turns them into counts).

The v3 engine:

A producer thread reads batches (the native reader releases the GIL),
2-bit packs them and fuses each into one pinned [rows, 3L/8] u8 host
buffer.  The main thread copies it to the device without blocking and
launches the fused count step (count/kernel_v3.py:count_step_v3: window
hash, probe and count in one kernel) on PyTorch's current stream.  The
per-k-mer counts stay on the device as int32 [n_kmers + 1] for the whole
run; per-batch diagnostics [n_valid, n_cand, n_hits] are fetched to the
host in groups, which also drives -m early termination (reference:
FingerPrint.hpp:41-43,476-487).

The -m cadence is the JAX engine's, so a -m run stops on the same batch:
with window = max(2, early_term_check_every), once 2*window batches are
pending the older window is drained, and a drain that crosses the threshold
drains the rest too — every dispatched batch is in the counts, so it must
be in the totals.
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ntsm_tpu_torch.count.golden import CountResult, count_codes_batch, max_counts_threshold
from ntsm_tpu_torch.count.kernel import count_step, make_table_arrays
from ntsm_tpu_torch.count.kernel_v2 import (
    SLOTS_V2,
    count_step_v2,
    hits_to_kmer_counts,
    make_table_v2,
    pack_batch_fast,
)
from ntsm_tpu_torch.count.kernel_v3 import TableV3, count_step_v3
from ntsm_tpu_torch.io.fastx import BatchReader, ParallelFileReader, _bounded_put
from ntsm_tpu_torch.io.sites import SiteTable, build_lookup
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans
from ntsm_tpu_torch.utils.formats import cpp_general


@dataclass
class EngineConfig:
    batch_reads: int = 32768
    segment_len: int = 256
    early_term_check_every: int = 8  # batches between host-side -m checks
    checkpoint_path: str | None = None  # periodic restartable snapshots
    checkpoint_every: int = 64  # batches between snapshots
    fail_after_batches: int | None = None  # fault injection (tests)


UPLOAD_DEPTH = 3  # batches the producer thread may run ahead
# The v3 engine's stages: the consumer's (the site table's build, waiting
# on the feed, upload and launch, the diag drains, snapshots), the
# producer's (waiting on the reader, the pinned buffer, the 2-bit pack into
# it, waiting on the full upload queue) and each -t reader thread's parse.
COUNT_STAGES = ("table", "wait", "dispatch", "drain", "checkpoint",
                "read", "pin", "pack", "put", "parse")


def _used_rows(lengths: np.ndarray) -> int:
    """Rows up to the last one holding bases (at least one): the reader
    pads a short final batch with empty rows, which have no valid window."""
    nz = np.flatnonzero(lengths)
    return int(nz[-1]) + 1 if nz.size else 1


def run_count(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
    device="cuda",
    version: int = 3,
) -> CountResult:
    """Count the site k-mers of `filenames` on `device` ("cuda" or "cpu")
    with engine `version` (3, the default, 2 or 1).

    "cuda" needs a CUDA device and runs the hand-written kernels; "cpu"
    runs their plain PyTorch versions.  There is no fallback between the
    two."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_count: device cuda needs a CUDA device, and none is available")
    if version == 1:
        return run_count_v1(table, filenames, opts, config, device)
    if version == 2:
        return run_count_v2(table, filenames, opts, config, device)
    if version != 3:
        raise ValueError(f"run_count: no engine version {version}")
    return _run_count_v3(table, filenames, opts, config, device)


def _run_count_v3(table, filenames, opts, config, device) -> CountResult:
    """The v3 engine, its stages timed by a stage recorder (utils/spans.py)
    into CountResult.stages.  With opts.trace it runs under torch.profiler
    (CPU activity, and the card's kernels and copies on the card), its
    stages recorded as the spans ntsm.count.<stage> (COUNT_STAGES; the
    feed's producer and reader threads on their own thread ids), and the
    trace written to the directory opts.trace when the run ends, on error
    and after -m too (a *.pt.trace.json that TensorBoard and Perfetto read;
    the JAX engine's jax.profiler.trace contract).  Without it no profiler
    object is made."""
    if not opts.trace:
        return _count_v3(table, filenames, opts, config, device,
                         spans.Recorder("count", COUNT_STAGES))
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rec = None

    def ready(prof) -> None:
        path = spans.export_trace(prof, opts.trace)
        if rec is not None:
            rec.write_into(path)

    with profile(activities=activities, on_trace_ready=ready):
        rec = spans.Recorder("count", COUNT_STAGES)
        return _count_v3(table, filenames, opts, config, device, rec)


def _count_v3(table, filenames, opts, config, device, rec) -> CountResult:
    """The v3 engine's body; rec (a spans.Recorder) times its stages."""
    stage = rec.stage
    config = config or EngineConfig(
        batch_reads=opts.batch_reads,
        segment_len=opts.segment_len,
        checkpoint_path=opts.checkpoint,
        checkpoint_every=opts.checkpoint_every,
    )
    k, L = table.k, config.segment_len
    n_kmers = table.n_kmers
    with stage("table"):
        tab = TableV3.from_hashes(table.kmer_hashes, device)
    counts = torch.zeros(n_kmers + 1, dtype=torch.int32, device=device)
    host_counts = np.zeros(n_kmers, dtype=np.int64)  # restored from a snapshot
    total_kmers = total_hits = total_bases = total_reads = 0
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    check_term = max_counts != 0 and not math.isinf(max_counts)
    early = False

    # --- checkpoint/resume (see count/checkpoint.py) ---
    skip_batches = 0
    sig = None
    if config.checkpoint_path:
        from ntsm_tpu_torch.count.checkpoint import load_snapshot, params_sig

        sig = params_sig(filenames, k, L, config.batch_reads, n_kmers)
        snap = load_snapshot(config.checkpoint_path, sig)
        if snap is not None:
            skip_batches = snap["n_batches"]
            host_counts += snap["counts"]
            total_kmers = snap["total_kmers"]
            total_hits = snap["total_hits"]
            total_bases = snap["total_bases"]
            total_reads = snap["total_reads"]
            print(
                f"Resuming from checkpoint {config.checkpoint_path} "
                f"({skip_batches} batches done)",
                file=sys.stderr,
            )

    def host_counts_now() -> np.ndarray:
        return counts[:n_kmers].cpu().numpy().astype(np.int64) + host_counts

    # dense: reads packed per row (separator + k-1 halo)
    rkw = dict(k=k, seglen=L, batch=config.batch_reads, dense=True)
    n_threads = min(opts.threads, len(filenames))
    if n_threads > 1 and not config.checkpoint_path:
        # thread-per-file-group fan-out (the reference's -t semantics,
        # FingerPrint.hpp:47)
        reader = ParallelFileReader(filenames, threads=n_threads, recorder=rec, **rkw)
    else:
        if n_threads > 1:
            print(
                "ntsm count: --checkpoint requires the deterministic "
                "single-stream reader; -t ignored",
                file=sys.stderr,
            )
        reader = BatchReader(filenames, **rkw)

    window = max(2, config.early_term_check_every)
    pending: deque = deque()  # per-batch diag [3] int32, on the device

    def drain(n: int) -> None:
        """Fetch the oldest n pending diags in one copy and add them up."""
        nonlocal total_kmers, total_hits
        n = min(n, len(pending))
        if n == 0:
            return
        d = torch.stack([pending.popleft() for _ in range(n)]).cpu().numpy()
        total_kmers += int(d[:, 0].sum(dtype=np.int64))
        total_hits += int(d[:, 2].sum(dtype=np.int64))

    # Producer: read + pack + fuse off the main thread; the native parse
    # and pack release the GIL, so batch N+1 is prepared while the device
    # runs batch N.
    upload_q: queue.Queue = queue.Queue(maxsize=UPLOAD_DEPTH)
    stop = threading.Event()
    sentinel = object()
    prod_err: list = []
    pin = device.type == "cuda"

    def _producer():
        it = iter(reader)
        try:
            n = 0
            while True:
                with stage("read"):
                    batch = next(it, None)
                if batch is None:
                    break
                n += 1
                if n <= skip_batches:
                    continue  # deterministic reader: parse-only skip on resume
                rows = _used_rows(batch.lengths)
                with stage("pin"):
                    fused = torch.empty((rows, 3 * L // 8), dtype=torch.uint8, pin_memory=pin)
                with stage("pack"):
                    packed, vbits = pack_batch_fast(batch.codes[:rows])
                    np.concatenate([packed, vbits], axis=1, out=fused.numpy())
                with stage("put"):
                    put = _bounded_put(upload_q, stop, (fused, batch.n_reads, batch.n_bases))
                if not put:
                    return
        except BaseException as e:  # surfaced on the consumer side
            prod_err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            _bounded_put(upload_q, stop, sentinel)

    # verbose progress (reference: every 1e6 reads at -v -v -v,
    # FingerPrint.hpp:70-79); per batch with throughput at -v -v
    t_start = time.monotonic()
    next_read_mark = 1_000_000
    prod = threading.Thread(target=_producer, daemon=True)
    prod.start()
    batch_idx = skip_batches
    last_ckpt_idx = skip_batches
    try:
        while True:
            with stage("wait"):
                item = upload_q.get()
            if item is sentinel:
                if prod_err:
                    raise prod_err[0]
                break
            fused, n_reads, n_bases = item
            with stage("dispatch"):
                f = fused.to(device, non_blocking=True)
                pending.append(count_step_v3(f[:, : L // 4], f[:, L // 4 :], tab, counts, k, L))
            batch_idx += 1
            total_bases += n_bases
            total_reads += n_reads
            with stage("drain"):
                while len(pending) >= 2 * window:
                    # drain the older half; the newer half keeps the device busy
                    drain(window)
                    if check_term and total_hits > max_counts:
                        drain(len(pending))
                        early = True
                        break
            if early:
                break
            if config.checkpoint_path and (
                batch_idx // config.checkpoint_every
                > last_ckpt_idx // config.checkpoint_every
            ):
                from ntsm_tpu_torch.count.checkpoint import save_snapshot

                with stage("checkpoint"):
                    drain(len(pending))  # snapshot state = exactly batch_idx batches
                    save_snapshot(
                        config.checkpoint_path,
                        sig=sig,
                        n_batches=batch_idx,
                        counts=host_counts_now(),
                        total_kmers=total_kmers,
                        total_hits=total_hits,
                        total_bases=total_bases,
                        total_reads=total_reads,
                    )
                last_ckpt_idx = batch_idx
            if opts.verbose > 2 and total_reads >= next_read_mark:
                next_read_mark = (total_reads // 1_000_000 + 1) * 1_000_000
                print(
                    f"Current Total: {total_reads} reads, {total_kmers} k-mers, "
                    f"{total_hits} total counts, and {total_bases} total bases ",
                    file=sys.stderr,
                )
            elif opts.verbose > 1:
                el = time.monotonic() - t_start
                print(
                    f"batch {batch_idx}: {total_reads} reads, "
                    f"{total_bases} bases, {total_bases / el / 1e6:.1f} Mbase/s",
                    file=sys.stderr,
                )
            if (
                config.fail_after_batches is not None
                and batch_idx - skip_batches >= config.fail_after_batches
            ):
                raise RuntimeError("ntsm: injected failure (fail_after_batches)")
        with stage("drain"):
            drain(len(pending))
    finally:
        # unblock the producer (it may be parked on a full queue) and wait
        # for it to close its reader
        stop.set()
        prod.join(timeout=10)
    stages = rec.times(batches=batch_idx - skip_batches)
    if opts.verbose > 1:
        print("stage budget: " + " ".join(f"{k} {stages[k]:.2f}s" for k in COUNT_STAGES)
              + f" ({stages['batches']} batches)", file=sys.stderr)
    if check_term and not early:
        early = total_hits > max_counts
    if early:
        print("Reached desired (-m) threshold", file=sys.stderr)

    return CountResult(
        counts=host_counts_now(),
        total_kmers=total_kmers,
        total_hits=total_hits,
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
        stages=stages,
    )


def run_count_v1(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
    device="cuda",
) -> CountResult:
    """The v1 engine (ntsm_tpu/count/engine.py:run_count_v1): one read
    segment a row, each batch uploaded as [B, L] u8 codes and [B] int32
    lengths (pinned, non-blocking on the card) and counted by
    count/kernel.py:count_step (one kernel launch a batch) on PyTorch's
    current stream.  The counts and both totals stay on the device; -m is
    checked every early_term_check_every batches, so a -m run stops on the
    same batch as the JAX v1 engine.  No checkpoint; -t is ignored, as in
    the JAX v1."""
    device = torch.device(device)
    config = config or EngineConfig(
        batch_reads=opts.batch_reads, segment_len=opts.segment_len
    )
    k, n_kmers = table.k, table.n_kmers
    keys, vals = make_table_arrays(build_lookup(table.kmer_hashes), n_kmers, device)
    counts = torch.zeros(n_kmers + 1, dtype=torch.int32, device=device)
    total_kmers = torch.zeros((), dtype=torch.int64, device=device)
    total_hits = torch.zeros((), dtype=torch.int64, device=device)
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    check_term = max_counts != 0 and not math.isinf(max_counts)
    total_bases = total_reads = n_batches = 0
    early = False
    pin = device.type == "cuda"

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory().to(device, non_blocking=True) if pin else t

    reader = BatchReader(filenames, k=k, seglen=config.segment_len, batch=config.batch_reads)
    for batch in reader:
        n_valid, n_found = count_step(
            upload(batch.codes), upload(batch.lengths), keys, vals, counts,
            k=k, n_kmers=n_kmers,
        )
        total_kmers += n_valid
        total_hits += n_found
        total_bases += batch.n_bases
        total_reads += batch.n_reads
        n_batches += 1
        if check_term and n_batches % config.early_term_check_every == 0:
            if int(total_hits) > max_counts:
                early = True
                break
    if check_term and not early:
        early = int(total_hits) > max_counts
    if early:
        print("Reached desired (-m) threshold", file=sys.stderr)

    return CountResult(
        counts=counts[:n_kmers].cpu().numpy().astype(np.int64),
        total_kmers=int(total_kmers),
        total_hits=int(total_hits),
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
    )


def run_count_v2(
    table: SiteTable,
    filenames,
    opts: Options,
    config: EngineConfig | None = None,
    device="cuda",
) -> CountResult:
    """The v2 engine (ntsm_tpu/count/engine.py:run_count_v2): one read
    segment a row, each batch 2-bit packed and uploaded as one [B, 3L/8]
    buffer (pinned, non-blocking on the card), its hit ids listed by
    count/kernel_v2.py:count_step_v2 on PyTorch's current stream (its table
    a TableV2, built once), with one batch in flight.  A drain fetches the
    batch's two totals, then top[:n_found] only, and adds the hits into
    host counts through the table's vals (hits_to_kmer_counts); a batch
    with more hits than its id list holds is recounted on the host
    (count/golden.py:count_codes_batch).
    -m is checked after each drain, so a -m run stops on the same batch as
    the JAX v2 engine.  No checkpoint; -t is ignored, as in the JAX v2."""
    device = torch.device(device)
    config = config or EngineConfig(
        batch_reads=opts.batch_reads, segment_len=opts.segment_len
    )
    k, L, n_kmers = table.k, config.segment_len, table.n_kmers
    lookup = build_lookup(table.kmer_hashes, slots=SLOTS_V2)
    table_v2 = make_table_v2(lookup, n_kmers, device)
    sorted_hashes = np.sort(table.kmer_hashes)
    sort_order = np.argsort(table.kmer_hashes, kind="stable")
    counts = np.zeros(n_kmers, dtype=np.int64)
    total_kmers = total_hits = total_bases = total_reads = 0
    max_counts = max_counts_threshold(n_kmers, opts.cov_thresh)
    check_term = max_counts != 0 and not math.isinf(max_counts)
    early = False
    pin = device.type == "cuda"

    def drain(entry) -> None:
        nonlocal total_kmers, total_hits, total_bases, total_reads
        (top, n_found, n_valid), batch = entry
        nf, nv = torch.stack([n_found, n_valid]).tolist()
        total_kmers += nv
        total_bases += batch.n_bases
        total_reads += batch.n_reads
        if nf > top.shape[0]:  # more hits than the id list holds: exact host recount
            hit_idx, _ = count_codes_batch(batch.codes, k, sorted_hashes, sort_order)
            np.add.at(counts, hit_idx, 1)
            total_hits += hit_idx.shape[0]
        else:
            hits_to_kmer_counts(top[:nf].cpu().numpy(), lookup, n_kmers, counts)
            total_hits += nf

    reader = BatchReader(filenames, k=k, seglen=L, batch=config.batch_reads)
    pending = None  # (the step's outputs, its host batch): one batch in flight
    for batch in reader:
        packed, vbits = pack_batch_fast(batch.codes)
        fused = torch.from_numpy(np.concatenate([packed, vbits], axis=1))
        if pin:
            fused = fused.pin_memory().to(device, non_blocking=True)
        out = count_step_v2(fused[:, : L // 4], fused[:, L // 4 :], table_v2, k=k, L=L)
        if pending is not None:
            drain(pending)
        pending = (out, batch)
        if check_term and total_hits > max_counts:
            early = True
            break
    if pending is not None and not early:
        drain(pending)
        if check_term:
            early = total_hits > max_counts
    if early:
        print("Reached desired (-m) threshold", file=sys.stderr)

    return CountResult(
        counts=counts,
        total_kmers=total_kmers,
        total_hits=total_hits,
        total_bases=total_bases,
        total_reads=total_reads,
        early_term=early,
    )


def format_info_summary(
    table: SiteTable, result: CountResult, opts: Options
) -> tuple[str, str | None]:
    """FingerPrint::printInfoSummary text (src/FingerPrint.hpp:313-349).

    Returns (summary_text, warning_or_None).
    """
    mx, _ = result.site_max_sum(table)
    site_coverage = int(((mx[:, 0] > 0) | (mx[:, 1] > 0)).sum())
    out = (
        f"Total Bases Considered: {result.total_bases}\n"
        f"Total k-mers Considered: {result.total_kmers}\n"
        f"Total k-mers Recorded: {result.total_hits}\n"
        f"Distinct k-mers in initial set: {table.n_kmers}\n"
        f"Total Sites: {table.n_sites}\n"
        f"Sites Covered by at least one k-mer: {site_coverage}\n"
    )
    warning = None
    n_sites = table.n_sites
    cov_per = site_coverage / n_sites if n_sites else 0.0
    if cov_per < opts.site_cov_threshold:
        warning = (
            f"Warning: site coverage is : {cpp_general(cov_per, 6)}"
            "(<75%). Data may be sorted or sparse along the genome. "
            "Any PCA projection may be inaccurate."
        )
    return out, warning
