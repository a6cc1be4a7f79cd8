"""eval_pca.score_s (s/pass): run_eval's stage times 'tiles' (the host
plan of the candidate pairs) and 'score' (the candidate-pair kernel and
its fetch) a -p pass (host clock)."""

from portbench.tracefile import stage_mean


def read(ctx):
    return stage_mean(ctx, "tiles", "score")
