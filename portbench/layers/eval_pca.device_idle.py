"""eval_pca.device_idle (%): 1 less the union of the card's kernel, copy
and set intervals over each traced -p pass (the benchmark's span around
run_eval)."""

from portbench.tracefile import idle_share


def read(ctx):
    return idle_share(ctx)
