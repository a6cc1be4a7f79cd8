"""Reading the program's own spans (ntsm_tpu_torch/utils/spans.py) in a
cell's traced passes: their seconds a pass, a span's self time, and the
device's idle time inside a span.  Each function returns None where the
traces hold no such span (a program without it)."""

from __future__ import annotations

from portbench import tracefile as tr


def _per_pass(ctx: dict, per_trace):
    """Mean over the traced passes of per_trace(trace), or None where it
    is None in every trace."""
    got = [per_trace(t) for t in ctx["traces"]]
    if all(g is None for g in got):
        return None
    return sum(g or 0.0 for g in got) / len(got)


def _named(t: tr.Trace, name: str) -> list:
    return [(s, e) for n, s, e, _ in t.spans if n == name]


def span_s(ctx: dict, name: str):
    """Seconds a pass of the spans called `name`."""
    return _per_pass(ctx, lambda t: sum(e - s for s, e in _named(t, name)) or None)


def self_s(ctx: dict, name: str, children: tuple):
    """Seconds a pass of the spans called `name` less the part of each
    that the spans called in `children` cover."""

    def one(t):
        outer = _named(t, name)
        if not outer:
            return None
        kids = sorted((s, e) for n, s, e, _ in t.spans if n in children)
        total = 0.0
        for lo, hi in outer:
            covered, reach = 0.0, lo
            for s, e in kids:
                s, e = max(s, reach), min(e, hi)
                if e > s:
                    covered += e - s
                    reach = e
            total += hi - lo - covered
        return total

    return _per_pass(ctx, one)


def idle_s(ctx: dict, name: str):
    """Seconds a pass in which the device was idle inside the spans called
    `name`: each span's length less the union of the device's intervals
    within it.  None where no device work was traced (a CPU run)."""
    if not any(t.device for t in ctx["traces"]):
        return None

    def one(t):
        spans = _named(t, name)
        return sum(e - s - tr.busy_s(t, s, e) for s, e in spans) if spans else None

    return _per_pass(ctx, one)
