"""eval_pca.project_self_s (s/pass): the program's ntsm.eval.project span
a -p pass less the part its .quantize and .matmul children cover: its
child ntsm.eval.project.copy (on the device engine, eval/project_kernel.py:
the wait for each block's quantized values in pinned memory, so the
quantize kernel's own time; on the host path, eval/pca.py: the contiguous
copies of each row block's counts), the loads of the centers and the
rotation, and the loop between.  With eval_pca.quantize_s and
eval_pca.matmul_s it adds up to the span, so to eval_pca.project_s."""

from portbench.spanread import self_s


def read(ctx):
    return self_s(ctx, "ntsm.eval.project",
                  ("ntsm.eval.project.quantize", "ntsm.eval.project.matmul"))
