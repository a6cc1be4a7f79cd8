"""Driver of the count-file cell: one pass is one `ntsm eval -a` over the
cohort's count files on local disk, through the function `python -m
ntsm_tpu_torch eval` calls (ntsm_tpu_torch.cli.eval_cmd.run), so that the
files' load and the prepare are inside the pass.

Set-up draws the cohort as the eval cells do (portbench/gen.py), writes a
count file a sample into the run's work directory with the benchmark's
own writer (as ntsmCount writes them: #@TK, #@KS, the header line, a row a
locus), flushes each to the disk and reads it once, so that the window
reads the files back from the page cache as a re-run does and no
writeback of set-up's writes falls inside it, and warms up with one call
on the first `warmup_samples` files.
A pass runs from the files' directory with their names as its arguments,
as a user runs `ntsm eval -a *_counts.txt > pairs.tsv`, on the default
engine and card; its table goes to a file of its own in the work
directory.  The judge reads the count files back from disk with
portbench/ref_countfile.py, scores them with portbench/ref_eval.py and
holds each pass's table against that with the eval cells' row judge
(drivers/eval.py, mode "all"): the number of lines, and the place and
fields of a sample of rows drawn from the seed and of every duplicate
pair.
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import gen, ref_countfile, ref_eval
from portbench import tracefile as tr
from portbench.drivers import eval as cohort

PASS_SPAN = "portbench.eval_cli.pass"
THREADS = min(8, os.cpu_count() or 1)
COLUMNS = b"#locusID\tcountAT\tcountCG\tsumAT\tsumCG\tdistinctAT\tdistinctCG\n"


def _digits(v: np.ndarray) -> tuple:
    """([n, w] ASCII digits of v >= 0, right-aligned in the widest's w;
    [n, w] mask without the leading zeros)."""
    v = v.astype(np.int64)
    width = len(str(int(v.max(initial=0))))
    place = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = (v[:, None] // place % 10 + ord("0")).astype(np.uint8)
    return digits, (v[:, None] >= place) | (place == 1)


def write_count_files(directory: str, names: list, mx: np.ndarray, cfg: dict) -> int:
    """One count file a sample of the [N, L, 2] max counts `mx`, named by
    `names`: #@TK (kmers_seen_per_count times the sample's counted
    maxima), #@KS k, the header line, then per locus its ID (portbench/gen
    site names), the two maxima, their sums (kmers_per_allele times the
    maxima) and the two distinct counts (kmers_per_allele), tab-separated.
    Each file's rows are built as one byte array and the file is flushed
    to the disk (fsync), files on THREADS threads.  Returns the bytes
    written."""
    N, L, _ = mx.shape
    kpa = int(cfg["kmers_per_allele"])
    ids = np.array([s.encode() for s in gen.site_names(L)])
    id_bytes = ids.view(np.uint8).reshape(L, -1)
    tab = np.full((L, 1), ord("\t"), np.uint8)
    tail_row = np.frombuffer(b"\t%d\t%d\n" % (kpa, kpa), np.uint8)
    tail = np.broadcast_to(tail_row, (L, tail_row.size))
    whole = np.ones((L, 1), bool)
    totals = mx.sum(axis=(1, 2), dtype=np.int64)

    def one(s: int) -> int:
        counts = mx[s].astype(np.int64)
        parts, keep = [id_bytes], [id_bytes != 0]
        for col in (counts[:, 0], counts[:, 1], counts[:, 0] * kpa, counts[:, 1] * kpa):
            digits, mask = _digits(col)
            parts += [tab, digits]
            keep += [whole, mask]
        parts.append(tail)
        keep.append(np.ones(tail.shape, bool))
        body = np.hstack(parts)[np.hstack(keep)]
        head = b"#@TK\t%d\n#@KS\t%d\n" % (totals[s] * cfg["kmers_seen_per_count"], cfg["k"])
        with open(os.path.join(directory, names[s]), "wb") as fh:
            fh.write(head + COLUMNS)
            fh.write(body.tobytes())
            fh.flush()
            os.fsync(fh.fileno())
        return len(head) + len(COLUMNS) + body.size

    with ThreadPoolExecutor(THREADS) as pool:
        return sum(pool.map(one, range(N)))


def call(argv: list, directory: str, table: str) -> None:
    """`ntsm eval <argv>` run from `directory`, its stdout into the file
    `table`; raises where it exits other than 0."""
    from ntsm_tpu_torch.cli import eval_cmd

    err = io.StringIO()
    cwd = os.getcwd()
    with open(table, "w") as out:
        os.chdir(directory)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = eval_cmd.run(argv)
        finally:
            os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"ntsm eval exited {rc}: {err.getvalue()[-2000:]}")


def setup(run) -> None:
    cfg, tf, st = run.config, run.traffic, run.state
    N, L = cfg["n_samples"], cfg["n_sites"]
    t0 = time.monotonic()
    mx, edges = gen.make_cohort(run.device, run.seed, N, L, tf["cov_lo"], tf["cov_hi"],
                                tf["crosstalk"], tf["dup_share"])
    t1 = time.monotonic()
    st["dups"] = cohort.dup_pairs(edges)
    rng = gen.rng_for(run.seed, 4)
    st["wanted"] = np.unique(np.concatenate([
        rng.integers(0, N * (N - 1) // 2, tf["sample_pairs"]),
        cohort.triu_index(st["dups"][:, 0], st["dups"][:, 1], N)]))
    st["dir"] = os.path.join(run.work, "counts")
    os.makedirs(st["dir"])
    st["names"] = cohort.names(N)
    st["bytes"] = write_count_files(st["dir"], st["names"], mx, cfg)
    del mx  # the judge reads the files back, not the drawn counts
    for n in st["names"]:  # each file read once: the page cache holds it, as on a re-run
        with open(os.path.join(st["dir"], n), "rb") as fh:
            while fh.read(1 << 24):
                pass
    flags = ["-a"] + (["--device", "cpu"] if run.device == "cpu" else [])
    st["argv"] = flags + st["names"]
    st["passes"] = 0
    t2 = time.monotonic()
    warm = flags + st["names"][: tf["warmup_samples"]]
    call(warm, st["dir"], os.path.join(run.work, "warm.tsv"))
    gc.collect()  # set-up's garbage collected before the window
    print(f"portbench: cohort drawn in {t1 - t0:.3f} s; {N} count files of {L} loci, "
          f"{st['bytes']} bytes, written, flushed and read in {t2 - t1:.3f} s; "
          f"warm-up {time.monotonic() - t2:.3f} s", file=sys.stderr)


def run_pass(run, trace_dir) -> dict:
    from ntsm_tpu_torch.io import countfile

    st, N = run.state, run.config["n_samples"]
    table = os.path.join(run.work, f"pairs{st['passes']}.tsv")
    st["passes"] += 1
    counters = getattr(countfile, "counters", None)  # the loader's counters, where it has them
    before = counters.get("bytes") if counters else None
    prof, span = contextlib.nullcontext(), contextlib.nullcontext
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device == "cuda" else [])
        prof, span = profile(activities=acts), record_function
    with prof as p:
        with span(PASS_SPAN):
            call(st["argv"], st["dir"], table)
            if run.device == "cuda":
                torch.cuda.synchronize()
    if trace_dir:
        p.export_chrome_trace(os.path.join(trace_dir, "pass.json"))
    read = counters["bytes"] - before if before is not None else None
    return dict(work={"eval_pairs_s": N * (N - 1) // 2}, table=table, bytes_read=read,
                trace_dir=trace_dir)


def release(run) -> None:
    """Nothing of the program's is held between passes."""


def reference(run, dtype=torch.float64) -> dict:
    """The plain reference's cohort columns in `dtype` (float32: the
    control), from the count files on disk as ref_countfile reads them."""
    cfg, st = run.config, run.state
    if "files" not in st:
        st["files"] = ref_countfile.read_cohort([os.path.join(st["dir"], n) for n in st["names"]])
    c = st["files"]
    cols = ref_eval.sample_columns(
        c.max_counts, c.sum_counts.sum(axis=(1, 2)), c.total_kmers, c.ks,
        float(c.distinct.sum()), float(cfg["genome_size"]), cfg["min_cov"])
    return dict(cols=cols, mx_dev=torch.from_numpy(c.max_counts).to(run.device), dtype=dtype)


def table_output(run, path: str) -> dict:
    """A pass's table file as the row judge takes it: its line count and
    the rows drawn (`wanted`)."""
    sink = cohort.RowSink(run.state["wanted"])
    with open(path, "rb") as fh:
        sink.write(fh.read())
    return dict(rows=sink.rows, lines=sink.lines)


def judge(run, outs: list) -> list:
    t0 = time.monotonic()
    ref = reference(run)
    run.state["ref"] = ref
    t1 = time.monotonic()
    checks = cohort.judge_rows(run, ref, [table_output(run, o["table"]) for o in outs])
    print(f"portbench: count files read back and columns made in {t1 - t0:.3f} s, "
          f"{len(outs)} tables judged in {time.monotonic() - t1:.3f} s", file=sys.stderr)
    return checks


# the eval cells' (portbench/control.py calls them on this driver)
judge_rows = cohort.judge_rows
control_outputs = cohort.control_outputs


def layer_context(run, outs: list) -> dict:
    """Each traced pass's trace and bytes read, the device's busy time."""
    traces, read, busy, window, gaps, cover = [], [], 0.0, 0.0, [], []
    for o in outs:
        t = tr.load(os.path.join(o["trace_dir"], "pass.json"))
        w = t.window([PASS_SPAN])
        if w is None:
            continue
        traces.append(t)
        read.append(o["bytes_read"])
        busy += tr.busy_s(t, *w)
        window += w[1] - w[0]
        gaps += tr.idle_gaps(t, *w)
        cover.append(tr.covered_s(t, ("ntsm.eval.",), *w) / (w[1] - w[0]))
    print("portbench: the ntsm.eval spans cover "
          + ", ".join(f"{100 * c:.1f}%" for c in cover) + " of the traced passes", file=sys.stderr)
    names = sorted({n for t in traces for n, _, _, _ in t.spans if n.startswith("ntsm.eval.")})
    if traces:
        print("portbench: seconds a traced pass: " + ", ".join(
            f"{n[len('ntsm.eval.'):]} {sum(t.span_total(n)[0] for t in traces) / len(traces):.4f}"
            for n in names), file=sys.stderr)
    gaps.sort(key=lambda g: -g[1])
    return dict(traces=traces, bytes_read=read, busy_s=busy, window_s=window,
                breakdown=dict(device_ops=tr.top_kernels(traces), idle_gaps=gaps[:10]))
