"""eval_cli.load_s (s/pass): the program's ntsm.eval.load spans a pass
(eval/model.py:load_count_data: every count file read and parsed into the
planes, native or exact path), in the benchmark's torch.profiler trace of
the pass; None where the program opens no such span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.load")
