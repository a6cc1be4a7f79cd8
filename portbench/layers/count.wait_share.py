"""count.wait_share (%): the count engine's time waiting for the host feed
(the reader and packer thread), its spans ntsm.count.wait over the sum of
its .wait, .dispatch and .drain spans, in the traces the program writes
under `count --trace`."""

STAGES = ("wait", "dispatch", "drain")


def read(ctx):
    tot = {s: sum(t.span_total(f"ntsm.count.{s}")[0] for t in ctx["traces"]) for s in STAGES}
    whole = sum(tot.values())
    return 100.0 * tot["wait"] / whole if whole > 0 else None
