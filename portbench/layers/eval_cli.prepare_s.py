"""eval_cli.prepare_s (s/pass): the program's ntsm.eval.prepare spans a
pass (eval/model.py:CountData.prepare: the per-sample het, hom and miss
counts, error rates and coverages), in the benchmark's torch.profiler trace
of the pass; None where the program opens no such span."""

from portbench.spanread import span_s


def read(ctx):
    return span_s(ctx, "ntsm.eval.prepare")
