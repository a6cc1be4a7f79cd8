"""eval_pca.pair_block_roofline (%): the candidate-pair kernel's two
instances (pair_tiles_kernel, pair_sparse_kernel, csrc/pair_block_stats.cu):
the larger of a pass's operation bound (8 f64 operations a valid
pair-site of the reference's candidate pairs) and byte bound (each touched
row once, the list and the results) over their device time in the
benchmark's torch.profiler trace."""

from portbench.tracefile import kernel_share


def read(ctx):
    return kernel_share(ctx, ctx["kernel"], ctx["least_s"])
