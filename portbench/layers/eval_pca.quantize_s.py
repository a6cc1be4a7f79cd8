"""eval_pca.quantize_s (s/pass): the program's ntsm.eval.project.quantize
spans a -p pass (eval/pca.py: the native, or numpy, quantize of each row
block's counts into centered f64 values)."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.project.quantize")
