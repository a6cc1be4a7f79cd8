"""eval.emit_idle_s (s/pass): the card's idle seconds inside the program's
ntsm.eval.emit spans (eval/emit.py's row formatter on each block), each
span less the union of the device's intervals in it, in the benchmark's
torch.profiler trace of the pass."""

from portbench.spanread import idle_s


def read(ctx):
    return idle_s(ctx, "ntsm.eval.emit")
