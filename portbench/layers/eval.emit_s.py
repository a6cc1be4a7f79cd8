"""eval.emit_s (s/pass): run_eval's stage time 'emit' a pass (host
clock, eval/rect.py:compute_score_all_cuda)."""

from portbench.tracefile import stage_mean


def read(ctx):
    return stage_mean(ctx, "emit")
