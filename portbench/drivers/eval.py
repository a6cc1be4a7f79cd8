"""Driver of the eval cells: one pass is one `ntsm eval` of the whole
cohort, `ntsm_tpu_torch.eval.driver.run_eval` on the device engine, with
the cohort handed over in memory as the program's CountData (the count
files' parse is left out: see the configuration's `reduced`).

The traffic's `mode` picks the run: "default" (all pairs scored, the
pairs under the score threshold printed), "all" (-a: every pair printed)
or "pca" (-p with the rotation and center files written in set-up).  The
table goes to a sink that keeps what the judge compares: every row, or
under -a the rows of a sample of pairs drawn from the seed.  The judge
holds the rows against portbench/ref_eval.py: which pairs are printed and
in what order, every integer column, and each float column within the
configuration's tolerance beyond its six printed decimals.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

from portbench import gen, ref_eval
from portbench import roofline as rf
from portbench import tracefile as tr

FLOAT_COLS = ("relate", "homConcord", "cov1", "cov2", "errorRate1", "errorRate2")
INT_COLS = ("ibs0", "ibs2", "het1", "het2", "sharedHet", "hom1", "hom2", "sharedHom", "n",
            "miss1", "miss2", "allHom1", "allHom2", "allHet1", "allHet2")
HEADER = ("sample1\tsample2\tscore\tsame\tdist\trelate\tibs0\tibs2\thomConcord"
          "\thet1\thet2\tsharedHet\thom1\thom2\tsharedHom\tn"
          "\tcov1\tcov2\terrorRate1\terrorRate2\tmiss1\tmiss2"
          "\tallHom1\tallHom2\tallHet1\tallHet2")
COLS = HEADER.split("\t")
HALF_DIGIT = 5e-7  # half a unit of the sixth printed decimal


class RowSink:
    """The table's destination.  The program writes text to it and its
    native row formatter bytes to .buffer (this object).  It counts the
    lines and keeps every row, or only the rows whose numbers (0 = the
    first after the header) are in `wanted`."""

    def __init__(self, wanted: np.ndarray | None = None):
        self.wanted = wanted
        self.next = 0  # index into wanted
        self.lines = 0
        self.partial = b""
        self.chunks = [] if wanted is None else None
        self.rows = {}
        self.buffer = self

    def write(self, x) -> int:
        data = x.encode() if isinstance(x, str) else x
        if self.chunks is not None:
            self.chunks.append(bytes(data))
            return len(x)
        arr = np.frombuffer(data, np.uint8)
        nl = np.flatnonzero(arr == 10)
        w = self.wanted
        while self.next < w.size and w[self.next] + 1 < self.lines + nl.size:
            idx = int(w[self.next]) + 1 - self.lines  # the line's index in this chunk
            start = nl[idx - 1] + 1 if idx > 0 else 0
            head = self.partial if idx == 0 else b""
            self.rows[int(w[self.next])] = (head + arr[start:nl[idx]].tobytes()).decode()
            self.next += 1
        self.partial = arr[nl[-1] + 1:].tobytes() if nl.size else self.partial + bytes(data)
        self.lines += nl.size
        return len(x)

    def flush(self) -> None:
        pass

    def text_rows(self) -> list:
        text = b"".join(self.chunks).decode()
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        return lines


def name(s: int) -> str:
    return f"s{s:05d}_counts.txt"


def names(n: int) -> list:
    return [name(s) for s in range(n)]


def triu_pair(r: np.ndarray, n: int):
    """(i, j) of the r-th pair of the i<j triangle in row order."""
    r = np.asarray(r, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(np.arange(n - 1, 0, -1))])
    i = np.searchsorted(starts, r, side="right") - 1
    return i, i + 1 + (r - starts[i])


def triu_index(i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    return i * n - i * (i + 1) // 2 + (j - i - 1)


def dup_pairs(edges: np.ndarray) -> np.ndarray:
    """Every pair (i < j) of samples of one genotype group, from the
    generator's (source, copy) edges."""
    parent: dict = {}

    def root(x):
        while parent.get(x, x) != x:
            x = parent[x]
        return x

    for s, d in edges.tolist():
        parent[root(d)] = root(s)
    groups: dict = {}
    for x in {int(v) for v in edges.reshape(-1)}:
        groups.setdefault(root(x), []).append(x)
    out = [(a, b) for g in groups.values() for ia, a in enumerate(sorted(g))
           for b in sorted(g)[ia + 1:]]
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def make_data(mx: np.ndarray, cfg: dict, opts):
    """The program's CountData of the cohort, as the count files of the
    configuration would load (13 k-mers an allele, sums 13 times the
    maxima, #@TK 37,000 times the counted maxima)."""
    from ntsm_tpu_torch.eval.model import CountData

    n, L, _ = mx.shape
    tot = mx.sum(axis=(1, 2), dtype=np.int64)
    return CountData(
        filenames=names(n), locus_ids=gen.site_names(L),
        distinct=np.full((L, 2), cfg["kmers_per_allele"], dtype=np.int64),
        max_counts=mx, sum_counts=mx * cfg["kmers_per_allele"],
        raw_total_kmers=tot * cfg["kmers_seen_per_count"], ks=np.full(n, cfg["k"], np.int64),
        total_counts=tot).prepare(opts)


def options(run, pca_paths=None):
    from ntsm_tpu_torch.options import Options

    cfg, tf = run.config, run.traffic
    kw = dict(engine="cuda", all=tf["mode"] == "all", dim=cfg["dim"], min_cov=cfg["min_cov"],
              score_thresh=cfg["score_thresh"], cov_skew=cfg["cov_skew"],
              genome_size=cfg["genome_size"])
    if pca_paths:
        kw.update(pca=pca_paths[0], norm=pca_paths[1])
    return Options(**kw)


def setup(run) -> None:
    cfg, tf, st = run.config, run.traffic, run.state
    N, L = cfg["n_samples"], cfg["n_sites"]
    rot = cen = paths = None
    if tf["mode"] == "pca":
        rot, cen = gen.rotation(run.seed, L, cfg["dim"], tf["rotation_scale"])
        rot_path, norm_path, rot, cen = gen.write_pca_artifacts(run.work, rot, cen)
        paths = (rot_path, norm_path)
    mx, edges = gen.make_cohort(
        run.device, run.seed, N, L, tf["cov_lo"], tf["cov_hi"], tf["crosstalk"],
        tf["dup_share"], rotation=rot, clusters=tf.get("clusters", 16),
        cluster_step=tf.get("cluster_step", 0.0), dirty_every=tf.get("dirty_every", 0),
        dirty_share=tf.get("dirty_share", 0.0))
    st.update(mx=mx, dups=dup_pairs(edges), rot=rot, cen=cen)
    n_pairs = N * (N - 1) // 2
    rng = gen.rng_for(run.seed, 4)
    if tf["mode"] == "all":
        st["wanted"] = np.unique(np.concatenate([
            rng.integers(0, n_pairs, tf["sample_pairs"]),
            triu_index(st["dups"][:, 0], st["dups"][:, 1], N)]))
    opts = options(run, paths)
    st["opts"] = opts
    st["data"] = make_data(mx, cfg, opts)
    warm = make_data(np.ascontiguousarray(mx[: tf["warmup_samples"]]), cfg, opts)
    with contextlib.redirect_stderr(io.StringIO()):
        from ntsm_tpu_torch.eval.driver import run_eval

        run_eval(warm, opts, RowSink(), device=run.device)


def run_pass(run, trace_dir) -> dict:
    from ntsm_tpu_torch.eval.driver import run_eval

    st, cfg = run.state, run.config
    N = cfg["n_samples"]
    sink = RowSink(st.get("wanted"))
    prof = contextlib.nullcontext()
    span = contextlib.nullcontext
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device == "cuda" else [])
        prof = profile(activities=acts)
        span = record_function
    with prof as p, contextlib.redirect_stderr(io.StringIO()):
        with span("portbench.eval.pass"):
            times = run_eval(st["data"], st["opts"], sink, device=run.device)
            if run.device == "cuda":
                torch.cuda.synchronize()
    if trace_dir:
        p.export_chrome_trace(os.path.join(trace_dir, "pass.json"))
    print("portbench: stages " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()),
          file=sys.stderr)
    work = ({"eval_pca_samples_s": N} if run.traffic["mode"] == "pca"
            else {"eval_pairs_s": N * (N - 1) // 2})
    rows = sink.rows if sink.chunks is None else sink.text_rows()
    return dict(work=work, rows=rows, lines=sink.lines if sink.chunks is None else None,
                times=times, trace_dir=trace_dir)


def release(run) -> None:
    run.state.pop("data", None)


def reference(run, dtype=torch.float64) -> dict:
    """The plain reference's cohort columns, and for -p its cloud and
    candidate list, in `dtype` (float32: the control)."""
    cfg, st = run.config, run.state
    mx = st["mx"]
    L = cfg["n_sites"]
    tot = mx.sum(axis=(1, 2), dtype=np.int64)
    cols = ref_eval.sample_columns(
        mx, tot * cfg["kmers_per_allele"], tot * cfg["kmers_seen_per_count"],
        np.full(mx.shape[0], cfg["k"]), float(cfg["kmers_per_allele"] * 2 * L),
        float(cfg["genome_size"]), cfg["min_cov"])
    ref = dict(cols=cols, mx_dev=torch.from_numpy(mx).to(run.device), dtype=dtype)
    if run.traffic["mode"] == "pca":
        cloud = ref_eval.project(ref["mx_dev"], st["cen"], st["rot"], cfg["min_cov"], cfg["dim"],
                                 dtype=dtype)
        rad = ref_eval.radii(cols["error_rate"], cols["miss"], L, cfg["pc_error_thresh"],
                             cfg["pc_miss_site1"], cfg["pc_miss_site2"],
                             cfg["pc_search_radius1"], cfg["pc_search_radius2"])
        ii, jj = ref_eval.candidates(cloud, rad)
        ref.update(cloud=cloud, cand=(ii, jj))
    return ref


def expected_rows(run, ref: dict, pairs: np.ndarray) -> dict:
    """{(i, j): row fields as numbers} of the reference for `pairs`."""
    cfg = run.config
    if not pairs.size:
        return {}
    ii, jj = pairs[:, 0].copy(), pairs[:, 1].copy()
    cols = ref["cols"]
    s = ref_eval.pair_stats(ref["mx_dev"], ii, jj, cols["cov"], cfg["min_cov"], cfg["cov_skew"],
                            dtype=ref["dtype"])
    dist = (ref_eval.dist_sq(ref["cloud"], ii, jj) if "cloud" in ref
            else np.full(ii.size, -1.0))
    out = {}
    for p, (i, j) in enumerate(zip(ii.tolist(), jj.tolist())):
        out[(i, j)] = dict(
            score=s["score"][p], dist=dist[p], relate=s["relate"][p], homConcord=s["homc"][p],
            cov1=cols["cov"][i], cov2=cols["cov"][j], errorRate1=cols["error_rate"][i],
            errorRate2=cols["error_rate"][j], ibs0=s["ibs0"][p], ibs2=s["ibs2"][p],
            het1=s["hets1"][p], het2=s["hets2"][p], sharedHet=s["shet"][p], hom1=s["homs1"][p],
            hom2=s["homs2"][p], sharedHom=s["shom"][p], n=s["n"][p], miss1=cols["miss"][i],
            miss2=cols["miss"][j], allHom1=cols["homs"][i], allHom2=cols["homs"][j],
            allHet1=cols["hets"][i], allHet2=cols["hets"][j])
    return out


def format_row(i: int, j: int, e: dict, same: str, pca: bool) -> str:
    """A row as the program prints it (the control's output)."""
    f = lambda x: "%f" % x  # noqa: E731
    vals = [name(i), name(j), f(e["score"]), same,
            f(e["dist"]) if pca else "-1", f(e["relate"])]
    vals += [str(int(e[c])) for c in ("ibs0", "ibs2")] + [f(e["homConcord"])]
    vals += [str(int(e[c])) for c in ("het1", "het2", "sharedHet", "hom1", "hom2", "sharedHom", "n")]
    vals += [f(e[c]) for c in ("cov1", "cov2", "errorRate1", "errorRate2")]
    vals += [str(int(e[c])) for c in ("miss1", "miss2", "allHom1", "allHom2", "allHet1", "allHet2")]
    return "\t".join(vals)


def parse_rows(rows) -> list:
    """[(i, j, fields)] of row strings; None for a row that does not parse."""
    out = []
    for r in rows:
        f = r.split("\t")
        try:
            out.append((int(f[0][1:6]), int(f[1][1:6]), dict(zip(COLS, f))) if len(f) == len(COLS)
                       else None)
        except ValueError:
            out.append(None)
    return out


def judge_rows(run, ref: dict, outs: list) -> list:
    """[(name, value, limit)] over every pass: rows_off (rows missing,
    extra, misplaced or unparsable), fields_off (integer, name and `same`
    fields that differ), score_gap and float_gap (the largest gap between
    a printed number and the reference's beyond half a unit of the sixth
    decimal, relative to max(1, |reference|))."""
    cfg, tf, st = run.config, run.traffic, run.state
    N, thresh = cfg["n_samples"], cfg["score_thresh"]
    mode = tf["mode"]
    pca = mode == "pca"
    rng = gen.rng_for(run.seed, 5)
    # the pairs checked: a sample of the pairs that are scored, the planted
    # duplicates and every printed pair
    if pca:
        ci, cj = ref["cand"]
        cand_pos = {key: p for p, key in enumerate((ci * N + cj).tolist())}
        pos_of = lambda i, j: cand_pos.get(i * N + j, -1)  # noqa: E731
        take = rng.integers(0, ci.size, min(tf["sample_pairs"], ci.size)) if ci.size else []
        sample = [(int(ci[t]), int(cj[t])) for t in take]
        for a, b in st["dups"].tolist():
            sample.append((b, a) if b * N + a in cand_pos else (a, b))
    else:
        if mode == "all":
            sample = list(zip(*[x.tolist() for x in triu_pair(st["wanted"], N)]))
        else:
            r = rng.integers(0, N * (N - 1) // 2, tf["sample_pairs"])
            sample = list(zip(*[x.tolist() for x in triu_pair(r, N)]))
            sample += [tuple(p) for p in st["dups"].tolist()]
        pos_of = lambda i, j: int(triu_index(i, j, N)) if i < j else -1  # noqa: E731
    parsed = []
    for o in outs:
        if mode == "all":
            parsed.append({k: parse_rows([v])[0] for k, v in o["rows"].items()})
        else:
            parsed.append(parse_rows(o["rows"]))
    printed = set()
    for p in parsed:
        for x in (p.values() if isinstance(p, dict) else p):
            if x is not None and 0 <= min(x[0], x[1]) and max(x[0], x[1]) < N and x[0] != x[1]:
                printed.add((x[0], x[1]))
    checked = sorted(set(sample) | printed)
    want = expected_rows(run, ref, np.array(checked, dtype=np.int64).reshape(-1, 2))
    rows_off = fields_off = 0
    score_gap = float_gap = 0.0

    def fields(i, j, got, e):
        nonlocal fields_off, score_gap, float_gap
        same = "1" if (mode != "all" or e["score"] < thresh) else "0"
        fields_off += int(got["same"] != same)
        fields_off += int(got["sample1"] != name(i)) + int(got["sample2"] != name(j))
        for c in INT_COLS:
            try:
                fields_off += int(int(got[c]) != int(e[c]))
            except ValueError:
                fields_off += 1
        gaps = {}
        for c in ("score",) + FLOAT_COLS + (("dist",) if pca else ()):
            try:
                v = float(got[c])
            except ValueError:
                v = float("inf")
            gaps[c] = max(0.0, abs(v - e[c]) - HALF_DIGIT) / max(1.0, abs(e[c]))
        if not pca:
            fields_off += int(got["dist"] != "-1")
        score_gap = max(score_gap, gaps.pop("score"))
        float_gap = max([float_gap] + list(gaps.values()))

    for o, p in zip(outs, parsed):
        if mode == "all":
            rows_off += int(o["lines"] != N * (N - 1) // 2 + 1)
            for r, i, j in zip(st["wanted"].tolist(), *[x.tolist() for x in
                                                        triu_pair(st["wanted"], N)]):
                x = p.get(r)
                if x is None or (x[0], x[1]) != (i, j):
                    rows_off += 1
                    continue
                fields(x[0], x[1], x[2], want[(x[0], x[1])])
            continue
        if not p or p[0] is not None or o["rows"][0] != HEADER:
            rows_off += 1  # the header line
        body = p[1:] if p else []
        seen, last = set(), -1
        for x in body:
            if x is None:
                rows_off += 1
                continue
            i, j, got = x
            pos = pos_of(i, j)
            e = want.get((i, j))
            if pos < 0 or e is None or not e["score"] < thresh or pos <= last:
                rows_off += 1  # not a scored pair, not under the threshold, or out of order
            last = max(last, pos)
            seen.add((i, j))
            if e is not None:
                fields(i, j, got, e)
        for q in sample:
            e = want[q]
            if pos_of(*q) >= 0 and e["score"] < thresh and q not in seen:
                rows_off += 1  # a pair under the threshold that was not printed
    return [("rows_off", rows_off, 0), ("fields_off", fields_off, 0),
            ("score_gap", score_gap, cfg["score_tolerance"]),
            ("float_gap", float_gap, cfg["score_tolerance"])]


def judge(run, outs: list) -> list:
    ref = reference(run)
    run.state["ref"] = ref
    return judge_rows(run, ref, outs)


def control_outputs(run, ref32: dict) -> list:
    """The output of one pass of the control, the reference in float32 in
    the program's place: the rows it would print, for the judge."""
    cfg, tf, st = run.config, run.traffic, run.state
    N, thresh = cfg["n_samples"], cfg["score_thresh"]
    mode = tf["mode"]
    if mode == "all":
        i, j = triu_pair(st["wanted"], N)
        e = expected_rows(run, ref32, np.stack([i, j], 1))
        rows = {r: format_row(a, b, e[(a, b)], "1" if e[(a, b)]["score"] < thresh else "0", False)
                for r, a, b in zip(st["wanted"].tolist(), i.tolist(), j.tolist())}
        return [dict(rows=rows, lines=N * (N - 1) // 2 + 1)]
    if mode == "pca":
        pairs = np.stack(ref32["cand"], 1)
    else:
        # the planted duplicates and a sample of the other pairs
        rng = gen.rng_for(run.seed, 6)
        i, j = triu_pair(rng.integers(0, N * (N - 1) // 2, tf["sample_pairs"]), N)
        pairs = np.unique(np.concatenate([np.stack([i, j], 1), st["dups"]]), axis=0)
    e = expected_rows(run, ref32, pairs)
    rows = [HEADER] + [format_row(a, b, e[(a, b)], "1", mode == "pca")
                       for a, b in pairs.tolist() if e[(a, b)]["score"] < thresh]
    return [dict(rows=rows)]


def layer_context(run, outs: list) -> dict:
    """Each pass's stage times and trace, with the valid pair-sites of the
    pass's kernels counted from the cohort."""
    cfg, st = run.config, run.state
    N, L, mc = cfg["n_samples"], cfg["n_sites"], cfg["min_cov"]
    traces, busy, window, gaps = [], 0.0, 0.0, []
    for o in outs:
        t = tr.load(os.path.join(o["trace_dir"], "pass.json"))
        w = t.window(["portbench.eval.pass"])
        if w is None:
            continue
        traces.append(t)
        busy += tr.busy_s(t, *w)
        window += w[1] - w[0]
        gaps += tr.idle_gaps(t, *w)
    mx = torch.from_numpy(st["mx"]).to(run.device)
    valid = ((mx[:, :, 0] > mc) | (mx[:, :, 1] > mc)).double()
    ctx = dict(traces=traces, times=[o["times"] for o in outs], busy_s=busy, window_s=window,
               n_samples=N, n_sites=L)
    if run.traffic["mode"] == "pca":
        ii, jj = st["ref"]["cand"]
        per = 0.0
        for r0 in range(0, N, 512):  # valid sites of each candidate pair, from V V^T
            nn = (valid[r0:r0 + 512] @ valid.T).cpu().numpy()
            sel = (ii >= r0) & (ii < r0 + 512)
            per += float(nn[ii[sel] - r0, jj[sel]].sum())
        ctx.update(least_s=rf.pair_block_least_s(per, int(np.unique(np.concatenate([ii, jj])).size),
                                                 L, int(ii.size)), kernel="pair_")
    else:
        v = valid.sum(0)
        ctx.update(least_s=rf.pair_stats_least_s(float((v * (v - 1) / 2).sum()), N, L),
                   kernel="pair_stats_kernel")
    gaps.sort(key=lambda g: -g[1])
    ctx["breakdown"] = dict(device_ops=tr.top_kernels(traces), idle_gaps=gaps[:10])
    return ctx
