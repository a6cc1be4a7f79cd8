"""Eval-mode dispatch (counterpart of ntsm_tpu/eval/driver.py:run_eval).

Dispatch mirrors ntsmEval's main (src/ntSeqMatchEval.cpp:304-341): one
sample -> single-sample QC; --only_merge -> merge only; otherwise the
all-vs-all comparison, on the exact host engine or the device engine;
-e merges afterwards.  The PCA-filtered (-p) and debug (-b) modes are not
ported yet; the CLI refuses them.
"""

from __future__ import annotations

import sys

from ntsm_tpu_torch.eval import exact
from ntsm_tpu_torch.eval.merge import merge_counts
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options


def run_eval(data: CountData, opts: Options, out, device="cuda"):
    """Top-level dispatch (ntSeqMatchEval.cpp:304-341).  The device engine
    (opts.engine == "cuda") runs on `device`; its stage times are returned
    (eval/rect.py:compute_score_all_cuda), else None."""
    if opts.pca or opts.debug:
        raise NotImplementedError("eval -p / -b are not yet ported to ntsm_tpu_torch")
    if data.n_samples == 1:
        exact.compute_score_single(data, opts, out)
        return None
    times = None
    if opts.only_merge:
        if not opts.merge:
            print("(-l) cannot be used without --merge (-e) option.", file=sys.stderr)
            raise SystemExit(1)
        print(" (-l) option detected. Not performing analysis, only merging.", file=sys.stderr)
    else:
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
    if opts.merge:
        merge_counts(data, opts.merge)
    return times
