"""Reading a torch.profiler chrome trace: host spans, device intervals,
device busy time, idle gaps and the device time of each kernel.

A trace is the JSON object `export_chrome_trace` and
`tensorboard_trace_handler` write: "traceEvents" of complete events ("ph":
"X") with "ts" and "dur" in microseconds.  Host spans are the
"user_annotation" events (record_function); device work is every event of
the categories in DEVICE_CATS.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclass
class Trace:
    """Events of one traced pass, times in seconds."""

    spans: list = field(default_factory=list)  # (name, start, end, cat) on the host
    device: list = field(default_factory=list)  # (name, start, end, cat) on the card

    def span_total(self, name: str) -> tuple:
        """(seconds, count) of the host spans called `name`."""
        sel = [e - s for n, s, e, _ in self.spans if n == name]
        return sum(sel), len(sel)

    def window(self, names=None) -> tuple:
        """(start, end) of the host spans named in `names` (all spans when
        None)."""
        sel = [(s, e) for n, s, e, _ in self.spans if names is None or n in names]
        if not sel:
            return None
        return min(s for s, _ in sel), max(e for _, e in sel)

    def kernel_s(self, part: str) -> float:
        """Device seconds of the kernels whose name holds `part`."""
        return sum(e - s for n, s, e, c in self.device if c == "kernel" and part in n)


def load(path: str) -> Trace:
    with open(path) as fh:
        return parse(json.load(fh))


def parse(obj) -> Trace:
    events = obj["traceEvents"] if isinstance(obj, dict) else obj
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s = float(ev["ts"]) * 1e-6
        item = (ev.get("name", ""), s, s + float(ev["dur"]) * 1e-6, cat)
        if cat in DEVICE_CATS:
            t.device.append(item)
        elif cat in HOST_CATS:
            t.spans.append(item)
    t.device.sort(key=lambda x: x[1])
    t.spans.sort(key=lambda x: x[1])
    return t


def busy_intervals(trace: Trace, lo: float, hi: float) -> list:
    """The union of the device's intervals, clipped to [lo, hi]."""
    out = []
    for _, s, e, _ in trace.device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered_s(trace: Trace, prefixes: tuple, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] under the union of the host spans whose names
    start with one of `prefixes`."""
    covered, reach = 0.0, lo
    for s, e in sorted((s, e) for n, s, e, _ in trace.spans if n.startswith(prefixes)):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            covered += e - s
            reach = e
    return covered


def busy_s(trace: Trace, lo: float, hi: float) -> float:
    return sum(e - s for s, e in busy_intervals(trace, lo, hi))


def idle_gaps(trace: Trace, lo: float, hi: float) -> list:
    """[(name, seconds)] of each idle stretch of the device in [lo, hi],
    named by the innermost host span open at its middle ("host" where none
    is)."""
    busy = busy_intervals(trace, lo, hi)
    edges, t = [], lo
    for s, e in busy:
        if s > t:
            edges.append((t, s))
        t = max(t, e)
    if hi > t:
        edges.append((t, hi))
    starts = [s for _, s, _, _ in trace.spans]
    out = []
    for s, e in edges:
        mid = (s + e) / 2
        name, best = "host", None
        for n, ss, se, _ in trace.spans[: bisect.bisect_right(starts, mid)]:
            if ss <= mid <= se and (best is None or se - ss < best):
                name, best = n, se - ss
        out.append((name, e - s))
    return out


def top_kernels(traces, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time."""
    tot: dict = {}
    for t in traces:
        for name, s, e, _ in t.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(ctx: dict):
    """100 x the device's idle share of the traced passes, or None where
    no device work was traced (a CPU run)."""
    if not any(t.device for t in ctx["traces"]) or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def stage_mean(ctx: dict, *keys: str):
    """Mean seconds a pass of the sum of run_eval's stage times `keys`."""
    times = [t for t in ctx["times"] if t]
    if not times:
        return None
    return sum(sum(t[k] for k in keys) for t in times) / len(times)


def kernel_share(ctx: dict, part: str, least_s: float):
    """100 x the least time of the traced passes' kernels named `part`
    (least_s a pass) over their device time, or None without them."""
    dev = sum(t.kernel_s(part) for t in ctx["traces"])
    if dev <= 0:
        return None
    return 100.0 * least_s * len(ctx["traces"]) / dev
