"""Driver of the count cells: one pass is one `ntsm count` of a sample's
FASTQ files through the Python API, `ntsm_tpu_torch.api.count`, on a site
table loaded in set-up.

Set-up writes the site FASTA and the read files into the run's work
directory, flushes each read file to the disk and reads it once, so that
every pass reads the files from the page cache as a re-run does and no
writeback of set-up's writes falls inside the window, loads the site
table (as a lab loads it once for its samples), warms the engine up on
one whole pass of the files (the buffers, pinned blocks and arenas that a
pass fills) and collects set-up's garbage.  The judge holds
every pass's CountResult (the per-k-mer counts, total_kmers, total_hits,
total_bases, total_reads, and that -m never stopped a pass early) against
portbench/ref_count.py on the same reads, exactly.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

from portbench import gen, ref_count
from portbench import tracefile as tr


def setup(run) -> None:
    cfg, tf, st = run.config, run.traffic, run.state
    t0 = time.monotonic()
    at_win, cg_win = gen.site_windows(gen.rng_for(run.seed, 1), cfg["n_sites"], cfg["window"],
                                      cfg["k"])
    sites = os.path.join(run.work, "sites.fa")
    gen.write_sites(sites, at_win, cg_win, cfg["k"])
    n, files = cfg["reads_per_file"], cfg["files"]
    reads = gen.make_reads(gen.rng_for(run.seed, 2), at_win, cg_win, n * files, cfg["read_len"],
                           tf["carry"], tf["sub_rate"], tf["n_rate"], tf["rc_share"])
    rng_q = gen.rng_for(run.seed, 3)
    paths, size = [], 0
    for f in range(files):
        paths.append(os.path.join(run.work, f"R{f + 1}.fq"))
        size += gen.write_fastq(paths[-1], rng_q, reads[f * n:(f + 1) * n], f + 1, tf["q_lo"],
                                tf["q_hi"])
    t1 = time.monotonic()
    for path in paths:
        with open(path, "rb") as fh:
            os.fsync(fh.fileno())
            while fh.read(1 << 24):
                pass
    st.update(at_win=at_win, cg_win=cg_win, reads=reads, files=paths)
    t2 = time.monotonic()

    from ntsm_tpu_torch import api

    st["table"] = api.load_sites(sites, k=cfg["k"])
    t3 = time.monotonic()
    count_once(run, paths, None)
    gc.collect()
    print(f"portbench: reads drawn and {size} bytes of FASTQ written in {t1 - t0:.3f} s, "
          f"flushed and read in {t2 - t1:.3f} s; sites loaded in {t3 - t2:.3f} s; "
          f"warm-up pass {time.monotonic() - t3:.3f} s", file=sys.stderr)


def count_once(run, files, trace_dir):
    from ntsm_tpu_torch import api

    cfg = run.config
    opts = api.Options(trace=trace_dir)
    return api.count(run.state["table"], files, max_cov=cfg["max_cov"], threads=cfg["threads"],
                     device=run.device, opts=opts)


def run_pass(run, trace_dir) -> dict:
    res = count_once(run, run.state["files"], trace_dir)
    return dict(work={"count_mbase_s": res.total_bases / 1e6},
                result=dict(counts=res.counts, total_kmers=res.total_kmers,
                            total_hits=res.total_hits, total_bases=res.total_bases,
                            total_reads=res.total_reads, early_term=bool(res.early_term)),
                trace_dir=trace_dir)


def release(run) -> None:
    run.state.pop("table", None)


def reference(run, key_bits: int = 64) -> dict:
    """The plain reference's counts of the run's reads (the control with
    key_bits < 64)."""
    st = run.state
    k = run.config["k"]
    if "sites" not in st:
        st["sites"] = ref_count.SiteKmers(st["at_win"], st["cg_win"], k, run.device)
    return ref_count.count(st["reads"], st["sites"], k, run.device, key_bits=key_bits)


TOTALS = ("total_kmers", "total_hits", "total_bases", "total_reads")


def compare(want: dict, results: list) -> list:
    """[(name, value, limit)]: k-mers whose count differs (the most in a
    pass), total fields that differ and passes that stopped early, over
    every pass."""
    counts_off = totals_off = early = 0
    for got in results:
        c = np.asarray(got["counts"], dtype=np.int64)
        if c.shape != want["counts"].shape:
            counts_off = max(counts_off, max(c.size, want["counts"].size))
        else:
            counts_off = max(counts_off, int((c != want["counts"]).sum()))
        totals_off += sum(int(got[t] != want[t]) for t in TOTALS)
        early += int(got["early_term"])
    return [("kmer_counts_off", counts_off, 0), ("totals_off", totals_off, 0),
            ("early_stops", early, 0)]


def judge(run, outs: list) -> list:
    want = reference(run)
    run.state["want"] = want
    return compare(want, [o["result"] for o in outs])


PREFIX = "ntsm.count."
CONSUMER = tuple(PREFIX + n for n in ("table", "wait", "dispatch", "drain"))


def layer_context(run, outs: list) -> dict:
    """The traces the program wrote (one a pass; each pass's window is its
    own spans' extent, which leaves out the profiler's start and stop) and
    what the readers need beside them.  Prints, a traced pass, the share
    of its host events' extent that the spans' extent spans and the share
    of the extent under the engine loop's own spans, the number of threads with
    ntsm.count.parse spans (the reader threads') and the seconds a pass of
    each ntsm.count span."""
    traces, busy, window, gaps, cover, parsers = [], 0.0, 0.0, [], [], []
    for o in outs:
        files = [f for f in os.listdir(o["trace_dir"]) if f.endswith(".json")]
        if not files:
            continue
        with open(os.path.join(o["trace_dir"], files[0])) as fh:
            obj = json.load(fh)
        t = tr.parse(obj)
        w = t.window([s for s, _, _, _ in t.spans if s.startswith(PREFIX)])
        if w is None:
            continue
        traces.append(t)
        parsers.append(len({e.get("tid") for e in obj["traceEvents"]
                            if e.get("name") == PREFIX + "parse"}))
        busy += tr.busy_s(t, *w)
        window += w[1] - w[0]
        gaps += tr.idle_gaps(t, *w)
        whole = t.window()
        cover.append(((w[1] - w[0]) / (whole[1] - whole[0]),
                      tr.covered_s(t, CONSUMER, *w) / (w[1] - w[0])))
    print("portbench: the ntsm.count spans' extent over all host events' extent, and the "
          "engine loop's spans over the extent, a traced pass: "
          + ", ".join(f"{100 * a:.1f}% / {100 * b:.1f}%" for a, b in cover), file=sys.stderr)
    print(f"portbench: threads with ntsm.count.parse spans in a traced pass: "
          f"{sorted(set(parsers))}", file=sys.stderr)
    names = sorted({n for t in traces for n, _, _, _ in t.spans if n.startswith(PREFIX)})
    if traces:
        print("portbench: seconds a traced pass: " + ", ".join(
            f"{n[len(PREFIX):]} {sum(t.span_total(n)[0] for t in traces) / len(traces):.4f}"
            for n in names), file=sys.stderr)
    want = run.state.get("want") or reference(run)
    n_kmers = int(want["counts"].size)
    n_buckets = 1
    while n_buckets * 8 < max(2 * n_kmers, 16):
        n_buckets *= 2
    gaps.sort(key=lambda g: -g[1])
    return dict(traces=traces, busy_s=busy, window_s=window, passes=len(traces),
                totals={t: want[t] for t in TOTALS}, n_buckets=n_buckets,
                breakdown=dict(device_ops=tr.top_kernels(traces), idle_gaps=gaps[:10]))
