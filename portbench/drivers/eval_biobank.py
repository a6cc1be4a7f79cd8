"""Driver of the biobank-scale -p cell: one pass is one `ntsm eval -p` of
the whole cohort through `run_eval` on the device engine, as in the eval
cells (portbench/drivers/eval.py, whose set-up, pass, sink and row judge
it runs), at a size where their reference and validity product would not
fit.  It replaces:

* the reference's candidate list, by portbench/ref_eval_blocked.py's (in
  blocks of rows, on the card);
* the valid pair-sites of the candidate pairs behind the pair kernel's
  roofline, counted in blocks of rows and columns;
* and adds the check `totals_off` (limit 0; the count cells' name for a
  pass's totals against the reference's, which the benchmark's fault tests
  know): each pass's candidate count, the program's
  `eval/pca.py:counters["candidates"]`, against the length of the
  reference's list.

Set-up draws the cohort, warms up on its first `warmup_samples` samples,
then runs one whole pass and collects the garbage, so that the window
starts from the state a pass leaves.  A program without the device search
(eval/search_kernel.py) cannot run the cohort: set-up stops at once.  On
the CPU (the benchmark's tests) the configuration's `cpu_sizes` cut the
cohort, its clusters and its dirty samples.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import os
import sys

import numpy as np
import torch

from portbench import ref_eval, ref_eval_blocked, roofline_search
from portbench import roofline as rf
from portbench import run as R
from portbench import tracefile as tr
from portbench.drivers import eval as cohort

BLOCK = 4096  # rows (and columns) a block of the validity product


def _cut_for_cpu(run) -> None:
    """The configuration's cpu_sizes over its own keys and the traffic's."""
    sizes = run.config.get("cpu_sizes", {})
    run.config = {**run.config, **{k: v for k, v in sizes.items() if k in run.config}}
    run.traffic = {**run.traffic, **{k: v for k, v in sizes.items() if k in run.traffic}}


def _candidate_count():
    """The program's count of candidate pairs so far, or None where it
    keeps none."""
    from ntsm_tpu_torch.eval import pca

    counters = getattr(pca, "counters", None)
    return counters.get("candidates") if counters else None


def setup(run) -> None:
    if importlib.util.find_spec("ntsm_tpu_torch.eval.search_kernel") is None:
        raise R.SetupError("the program has no device candidate search "
                           "(ntsm_tpu_torch.eval.search_kernel): its host search would build "
                           "an [N, N] matrix, and its planes would not fit the card")
    if run.device == "cpu":
        _cut_for_cpu(run)
    cohort.setup(run)
    from ntsm_tpu_torch.eval.driver import run_eval

    with contextlib.redirect_stderr(io.StringIO()):
        run_eval(run.state["data"], run.state["opts"], cohort.RowSink(), device=run.device)
    if run.device == "cuda":
        torch.cuda.synchronize()
    gc.collect()


def run_pass(run, trace_dir) -> dict:
    before = _candidate_count()
    out = cohort.run_pass(run, trace_dir)
    after = _candidate_count()
    out["candidates"] = None if before is None else after - before
    return out


release = cohort.release
judge_rows = cohort.judge_rows
expected_rows = cohort.expected_rows


def reference(run, dtype=torch.float64) -> dict:
    """The plain reference's cohort columns, cloud and candidate list in
    `dtype` (float32: the control), the list in blocks of rows."""
    cfg, st = run.config, run.state
    mx = st["mx"]
    L = cfg["n_sites"]
    tot = mx.sum(axis=(1, 2), dtype=np.int64)
    cols = ref_eval.sample_columns(
        mx, tot * cfg["kmers_per_allele"], tot * cfg["kmers_seen_per_count"],
        np.full(mx.shape[0], cfg["k"]), float(cfg["kmers_per_allele"] * 2 * L),
        float(cfg["genome_size"]), cfg["min_cov"])
    ref = dict(cols=cols, mx_dev=torch.from_numpy(mx).to(run.device), dtype=dtype)
    cloud = ref_eval.project(ref["mx_dev"], st["cen"], st["rot"], cfg["min_cov"], cfg["dim"],
                             dtype=dtype)
    rad = ref_eval.radii(cols["error_rate"], cols["miss"], L, cfg["pc_error_thresh"],
                         cfg["pc_miss_site1"], cfg["pc_miss_site2"], cfg["pc_search_radius1"],
                         cfg["pc_search_radius2"])
    ii, jj, within = ref_eval_blocked.search(cloud, rad, device=run.device)
    ref.update(cloud=cloud, cand=(ii, jj), within=within)
    return ref


def judge(run, outs: list) -> list:
    ref = reference(run)
    run.state["ref"] = ref
    checks = judge_rows(run, ref, outs)
    want = int(ref["cand"][0].size)
    off = sum(abs(o["candidates"] - want) if o.get("candidates") is not None else want
              for o in outs)
    print(f"portbench: {want} candidate pairs a pass ({ref['within']} inside a finite radius); "
          f"the program's counts {[o.get('candidates') for o in outs]}", file=sys.stderr)
    return checks + [("totals_off", off, 0)]


def control_outputs(run, ref32: dict) -> list:
    """The output of one pass of the control, the reference in float32 in
    the program's place: the header and the rows of its candidate pairs
    whose float32 score is under the threshold (the statistics of every
    candidate pair computed in blocks, the rows only of those)."""
    cfg = run.config
    ii, jj = ref32["cand"]
    s = ref_eval.pair_stats(ref32["mx_dev"], ii, jj, ref32["cols"]["cov"], cfg["min_cov"],
                            cfg["cov_skew"], dtype=ref32["dtype"])
    under = np.flatnonzero(s["score"] < cfg["score_thresh"])
    pairs = np.stack([ii[under], jj[under]], 1)
    e = expected_rows(run, ref32, pairs)
    rows = [cohort.HEADER] + [cohort.format_row(a, b, e[(a, b)], "1", True)
                              for a, b in pairs.tolist() if e[(a, b)]["score"] < cfg["score_thresh"]]
    return [dict(rows=rows)]


def _valid(mx_dev: torch.Tensor, r0: int, r1: int, mc: int) -> torch.Tensor:
    """[r1 - r0, L] float32 0/1: the sites where a sample has a count above
    mc (exact in float32 products and sums below 2^24 sites)."""
    x = mx_dev[r0:r1]
    return ((x[:, :, 0] > mc) | (x[:, :, 1] > mc)).float()


def valid_pair_sites(mx_dev: torch.Tensor, ii: np.ndarray, jj: np.ndarray, mc: int,
                     block: int = BLOCK) -> float:
    """The sites valid in both samples, summed over the pairs (ii[p],
    jj[p]): the product of the validity planes in blocks of rows and
    columns, each read where the pairs fall."""
    n = mx_dev.shape[0]
    bi, bj = ii // block, jj // block
    total = 0.0
    for r in np.unique(bi).tolist():
        sel = bi == r
        vr = _valid(mx_dev, r * block, min(n, (r + 1) * block), mc)
        for c in np.unique(bj[sel]).tolist():
            cs = sel & (bj == c)
            vc = _valid(mx_dev, c * block, min(n, (c + 1) * block), mc)
            nn = (vr @ vc.T).double()
            pi = torch.from_numpy(ii[cs] - r * block).to(nn.device)
            pj = torch.from_numpy(jj[cs] - c * block).to(nn.device)
            total += float(nn[pi, pj].sum())
    return total


def layer_context(run, outs: list) -> dict:
    """Each pass's stage times and trace; the pair kernel's least time from
    the valid sites of the reference's candidate pairs, the radius kernel's
    from its cloud and its pairs inside a finite radius."""
    cfg, st = run.config, run.state
    N, L = cfg["n_samples"], cfg["n_sites"]
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
    ref = st["ref"]
    ii, jj = ref["cand"]
    per = valid_pair_sites(ref["mx_dev"], ii, jj, cfg["min_cov"])
    touched = int(np.unique(np.concatenate([ii, jj])).size)
    gaps.sort(key=lambda g: -g[1])
    return dict(traces=traces, times=[o["times"] for o in outs], busy_s=busy, window_s=window,
                n_samples=N, n_sites=L, kernel="pair_",
                least_s=rf.pair_block_least_s(per, touched, L, int(ii.size)),
                search_least_s=roofline_search.search_least_s(N, cfg["dim"], ref["within"]),
                breakdown=dict(device_ops=tr.top_kernels(traces), idle_gaps=gaps[:10]))
