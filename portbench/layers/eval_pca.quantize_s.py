"""eval_pca.quantize_s (s/pass): the program's ntsm.eval.project.quantize
spans a -p pass.  On the device engine (eval/project_kernel.py:
project_planes) each is the enqueue of one 128-row block's quantize
kernel (csrc/project_quantize.cu), which returns before the kernel ends;
the wait for its values is the sibling span ntsm.eval.project.copy.  On
the host path (eval/pca.py:project_pcs) each is the native, or numpy,
quantize of a row block's counts into centered f64 values."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.project.quantize")
