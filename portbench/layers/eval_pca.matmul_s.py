"""eval_pca.matmul_s (s/pass): the program's ntsm.eval.project.matmul
spans a -p pass (eval/pca.py: each row block's f64 product with the
[sites, dim] rotation, np.matmul)."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.project.matmul")
