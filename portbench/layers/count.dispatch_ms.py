"""count.dispatch_ms (ms/batch): the count engine's time a batch to
upload it and launch the fused step, its ntsm.count.dispatch spans."""


def read(ctx):
    s = n = 0
    for t in ctx["traces"]:
        ds, dn = t.span_total("ntsm.count.dispatch")
        s, n = s + ds, n + dn
    return 1e3 * s / n if n else None
