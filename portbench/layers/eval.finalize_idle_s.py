"""eval.finalize_idle_s (s/pass): the card's idle seconds inside the
program's ntsm.eval.finalize spans (eval/rect.py: the host f64 finalize of
each fetched block), each span less the union of the device's intervals in
it, in the benchmark's torch.profiler trace of the pass.  Near
eval.finalize_s while nothing overlaps finalize on the card."""

from portbench.spanread import idle_s


def read(ctx):
    return idle_s(ctx, "ntsm.eval.finalize")
