"""eval_pca.project_self_s (s/pass): the program's ntsm.eval.project span
a -p pass less the part its .quantize and .matmul children cover: the
contiguous copies of each row block's counts (its child
ntsm.eval.project.copy), the loads of the centers and the rotation, and
the loop between.  With eval_pca.quantize_s and eval_pca.matmul_s it adds
up to the span, so to eval_pca.project_s."""

from portbench.spanread import self_s


def read(ctx):
    return self_s(ctx, "ntsm.eval.project",
                  ("ntsm.eval.project.quantize", "ntsm.eval.project.matmul"))
