"""Eval-mode dispatch: all-vs-all, PCA-filtered and debug-recall modes
(counterpart of ntsm_tpu/eval/driver.py).

Dispatch mirrors ntsmEval's main (src/ntSeqMatchEval.cpp:304-341) and
computeScorePCA (src/CompareCounts.hpp:285-528): one sample -> single-sample
QC (with the PC columns under -p); --only_merge -> merge only; otherwise
all-vs-all, or with -p the PCA-filtered comparison (-b: its debug-recall
harness), on the exact host engine or the device engine; -e merges
afterwards.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ntsm_tpu_torch.eval import exact
from ntsm_tpu_torch.eval.exact import HEADER, PairResult, pair_score, results_row
from ntsm_tpu_torch.eval.merge import merge_counts
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.eval.pca import (
    calc_distance_sq,
    pair_dist_sq,
    pca_candidate_arrays,
    project_pcs,
    search_radii,
    sq_dists_blocked,
)
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils.formats import cpp_to_string


def compute_score_pca(data: CountData, opts: Options, out, cloud: np.ndarray) -> None:
    """PCA-filtered comparison on the exact engine (computeScorePCA,
    CompareCounts.hpp:285-391)."""
    radii = search_radii(data, opts)
    out.write(HEADER)
    out.write("\n")
    ii, jj = pca_candidate_arrays(cloud, radii, opts.dim)
    if not ii.size:
        return
    got = exact.native_pair_stats(data, opts, ii, jj)
    if got is not None:
        score, tallies = got
        exact._emit_pairs(data, opts, out, ii, jj, score, tallies,
                          dist=pair_dist_sq(cloud, ii, jj, opts.dim))
        return
    for i, k in zip(ii.tolist(), jj.tolist()):
        score, nv, rel = pair_score(data, i, k, opts)
        if opts.all or score < opts.score_thresh:
            dist = cpp_to_string(calc_distance_sq(cloud, i, k, opts.dim))
            res = PairResult(i=i, j=k, score=score, n=nv, relate=rel)
            out.write(results_row(data, res, dist, opts))
            out.write("\n")


def compute_score_pca_debug(data: CountData, opts: Options, out, cloud: np.ndarray) -> None:
    """Debug recall harness for the PCA heuristic (-b;
    CompareCounts.hpp:392-527): given ground-truth same-origin groups,
    report per true pair how many candidate pairs the heuristic would
    evaluate at that distance and whether each sample's radius tier covers
    the pair.  Host only, as in the JAX package."""
    radii = search_radii(data, opts)
    file_to_id = {name: i for i, name in enumerate(data.filenames)}
    true_pairs: list[tuple[int, int]] = []
    seen = set()
    with open(opts.debug) as fh:
        for line in fh:
            values = line.split()
            for a in range(len(values)):
                for b in range(a + 1, len(values)):
                    for v in (values[a], values[b]):
                        if v not in file_to_id:
                            print(f"missing file {v}", file=sys.stderr)
                    x = file_to_id[values[a]]
                    y = file_to_id[values[b]]
                    p = (x, y) if x <= y else (y, x)
                    if p not in seen:
                        seen.add(p)
                        true_pairs.append(p)

    out.write(HEADER)
    out.write("\tpairs\tcandidates1\tcandidates2\tpossible\tradius1\tradius2\tcorrect\n")
    if opts.all:
        # reference order (CompareCounts.hpp:312-434): the header and the
        # truth file come BEFORE the -a rejection, so stdout carries the
        # header line when it exits
        print("Currently unable to output all pairs in debug mode.", file=sys.stderr)
        raise SystemExit(1)

    c = cloud[:, : opts.dim]
    sq = sq_dists_blocked(c)
    n = data.n_samples

    def pruned_candidates(x: int) -> int:
        cnt = 0
        for k in np.nonzero(sq[x] < radii[x])[0]:
            k = int(k)
            if radii[x] == radii[k]:
                if k <= x:
                    continue
            elif radii[x] < radii[k]:
                continue
            cnt += 1
        return cnt

    for x, y in true_pairs:
        score, nv, rel = pair_score(data, x, y, opts)
        distance = calc_distance_sq(cloud, x, y, opts.dim)
        # pairs evaluated at this distance across all query points
        pairs = int(sum(((sq[i] < distance) & (np.arange(n) > i)).sum() for i in range(n)))
        res = PairResult(i=x, j=y, score=score, n=nv, relate=rel)
        out.write(results_row(data, res, cpp_to_string(distance), opts))
        out.write(
            "\t"
            + "\t".join(
                [
                    str(pairs),
                    str(pruned_candidates(x)),
                    str(pruned_candidates(y)),
                    str(len(data.filenames) - 1),
                    cpp_to_string(radii[x]),
                    cpp_to_string(radii[y]),
                    "1",
                ]
            )
        )
        out.write("\n")


def scores_pairs(opts: Options, n_files: int) -> bool:
    """Whether a run over n_files scores pairs, which is where engine
    "auto" means the device engine: single-sample QC, --only_merge and the
    -b harness (which scores its true pairs on the host, as the JAX package
    does) score none."""
    return n_files > 1 and not opts.only_merge and not (opts.pca and opts.debug)


def run_eval(data: CountData, opts: Options, out, device="cuda"):
    """Top-level dispatch (ntSeqMatchEval.cpp:304-341).  The device engine
    (opts.engine == "cuda") runs on `device`; its stage times are returned
    (eval/rect.py:compute_score_all_cuda, compute_score_pca_cuda, the
    latter with the projection's seconds under "project"), else None."""
    if data.n_samples == 1:
        cloud = None
        if opts.pca:
            cloud = project_pcs(data, opts)[:, : opts.dim]
        exact.compute_score_single(data, opts, out, cloud=cloud)
        return None
    times = None
    if opts.only_merge:
        if not opts.merge:
            print("(-l) cannot be used without --merge (-e) option.", file=sys.stderr)
            raise SystemExit(1)
        print(" (-l) option detected. Not performing analysis, only merging.", file=sys.stderr)
    elif not opts.pca:
        print(
            "Performing all-to-all score computation.\n"
            "Specify -p (--pca) to enable faster comparisons.",
            file=sys.stderr,
        )
        if opts.engine == "cuda":
            from ntsm_tpu_torch.eval.rect import compute_score_all_cuda

            times = compute_score_all_cuda(data, opts, out, device)
        else:
            exact.compute_score_all(data, opts, out)
    else:
        t0 = time.monotonic()
        cloud = project_pcs(data, opts)
        project_s = time.monotonic() - t0
        if opts.debug:
            compute_score_pca_debug(data, opts, out, cloud)
        elif opts.engine == "cuda":
            from ntsm_tpu_torch.eval.rect import compute_score_pca_cuda

            times = dict(project=project_s,
                         **compute_score_pca_cuda(data, opts, out, cloud, device))
        else:
            compute_score_pca(data, opts, out, cloud)
    if opts.merge:
        merge_counts(data, opts.merge)
    return times
