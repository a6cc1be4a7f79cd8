"""count.device_idle (%): 1 less the union of the card's kernel, copy and
set intervals over each traced pass's extent (its first to its last
ntsm.count span)."""

from portbench.tracefile import idle_share


def read(ctx):
    return idle_share(ctx)
