"""eval_pca.upload_gb_s (GB/s): the cohort's count planes, n_samples x
n_sites x 8 bytes (two int32 counts a sample-site), over the seconds a
pass of the program's ntsm.eval.upload.copy spans (eval/rect.py:
device_planes, the host-to-device copies of each row block's counts).
None for a program without the span."""

from portbench.spanread import span_s


def read(ctx):
    s = span_s(ctx, "ntsm.eval.upload.copy")
    if not s:
        return None
    return ctx["n_samples"] * ctx["n_sites"] * 8 / s / 1e9
