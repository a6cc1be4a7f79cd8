"""Card timing shared by chip_smoke.py and the experiment programs: the
card line, and CUDA-event times of a call in ms.

:func:`device_ms` is the device time of a call that never waits for the
device; :func:`event_ms` is for a call that does (a plain version that
indexes with a mask, a wrapper that checks its indices' range), so its
interval also holds the host's part."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


_spin_cycles_per_ms = None


def _spin(ms: float) -> None:
    """Keep the device busy for about `ms` (torch.cuda._sleep, calibrated
    once), so that the host can queue work behind it."""
    global _spin_cycles_per_ms
    if _spin_cycles_per_ms is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**6)
        end.record()
        torch.cuda.synchronize()
        _spin_cycles_per_ms = 10**6 / max(start.elapsed_time(end), 1e-3)
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms))


def device_ms(fn, iters: int = 20) -> float:
    """Median device time of one fn() call in ms, for a fn that never waits
    for the device.

    After a warm-up call, each of `iters` calls is queued behind a
    device-side spin sized to outlast the host's time to enqueue it, between
    two CUDA events: the interval is the call's device time.  (Events around
    a call the device does not wait for measure the wrapper's host time
    instead: the device idles until each launch.)  One call at a time, so
    that a call of many small kernels never fills the launch queue, which
    would make the host wait.  If the device has reached the first event by
    the time the host has queued the call, the interval holds host time: the
    call is queued again behind a spin 4x longer, and at a 2 s spin this
    raises RuntimeError (fn waits for the device)."""
    return device_ms_parts([fn], iters)[0]


def device_ms_parts(fns, iters: int = 20) -> list:
    """:func:`device_ms` of calls made one after another, each timed apart:
    the median device time of each fns[i]() in ms, with an event between
    consecutive calls (for the parts of a step, e.g. its kernels)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2.0 * host_ms + 0.5
    times = []
    while len(times) < iters:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
        _spin(spin_ms)
        events[0].record()
        for fn, end in zip(fns, events[1:]):
            fn()
            end.record()
        caught_up = events[0].query()
        torch.cuda.synchronize()
        if not caught_up:
            times.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
        elif spin_ms >= 2000.0:
            raise RuntimeError(
                "device_ms: the device caught up with the host while one call was "
                "queued behind a 2 s spin (does fn wait for the device?); use event_ms "
                "for such a call")
        else:
            spin_ms = min(2000.0, 4 * spin_ms)
    return [statistics.median(t[i] for t in times) for i in range(len(fns))]


def event_ms(fn, iters: int = 15) -> float:
    """Median time of one fn() call in ms between CUDA events recorded
    around it, after a warm-up call and a synchronize before each: for a fn
    that waits for the device inside, where :func:`device_ms` cannot queue
    calls; the interval holds the host's part of the call too."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
