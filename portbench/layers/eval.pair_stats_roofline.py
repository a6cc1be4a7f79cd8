"""eval.pair_stats_roofline (%): the all-pairs kernel (pair_stats_kernel,
csrc/pair_stats.cu): the least time of a pass (8 f64 operations a valid
pair-site, counted from the cohort as the sum over sites of C(valid
samples, 2); portbench/roofline.py) over its device time in the
benchmark's torch.profiler trace of the pass."""

from portbench.tracefile import kernel_share


def read(ctx):
    return kernel_share(ctx, "pair_stats_kernel", ctx["least_s"])
