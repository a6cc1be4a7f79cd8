"""eval_pca.project_s (s/pass): run_eval's stage time 'project' a -p pass (host
clock, eval/driver.py and eval/rect.py:compute_score_pca_cuda)."""

from portbench.tracefile import stage_mean


def read(ctx):
    return stage_mean(ctx, "project")
