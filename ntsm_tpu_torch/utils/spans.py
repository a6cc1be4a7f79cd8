"""The stage recorder of count and eval: the seconds each stage of a run
took, and, while torch.profiler traces, each stage as a span on the
trace's timeline.

A :class:`Recorder` is made on the thread that owns the run (the count
engine's consumer, ``run_eval``).  Whether the profiler is on is read
there, once, because torch.profiler reaches only the thread that started
it.  A stage ``name`` of a recorder of area ``area``:

- with tracing off takes two clock reads and adds to ``budget[name]``;
- with tracing on, on the recorder's own thread, is also the span
  ``record_function("ntsm.<area>.<name>")``, which the profiler nests with
  the aten ops and the device events;
- with tracing on, on any other thread (the count feed's producer and
  readers), where ``record_function`` does not reach the trace, also keeps
  ``(name, t0_ns, t1_ns, thread id)`` from ``time_ns()``;
  :meth:`Recorder.write_into` appends those to the finished trace file on
  the trace's own clock (an event's ``ts`` plus the file's
  ``baseTimeNanoseconds`` / 1e3 is ``time_ns()`` / 1e3).

Code that cannot be handed a recorder (``eval/pca.py:project_pcs``, the
count-file load in ``eval/model.py`` and ``io/countfile.py``) reaches the
current one of its context through :func:`stage`; :func:`recording`
makes a recorder current, and :func:`recorder` joins the current one.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import socket
import threading
from time import perf_counter_ns, time_ns

import torch

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("ntsm_stage_recorder", default=None)


class Recorder:
    """Stage seconds of one run (``budget``, summed over threads; every
    name in ``keys`` present from the start) and, while tracing, its spans."""

    def __init__(self, area: str, keys=()):
        self.area = area
        self.budget = dict.fromkeys(keys, 0.0)
        self.tracing = torch._C._autograd._profiler_enabled()
        self.kept = [] if self.tracing else None  # spans of the other threads
        self._owner = threading.get_ident()
        self._lock = threading.Lock()  # stages of several threads add to one name

    def _add(self, name: str, ns: int) -> None:
        with self._lock:
            self.budget[name] = self.budget.get(name, 0.0) + ns * 1e-9

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the body as stage `name` (see the module's docstring)."""
        if not self.tracing:
            t0 = perf_counter_ns()
            try:
                yield
            finally:
                self._add(name, perf_counter_ns() - t0)
        elif threading.get_ident() == self._owner:
            t0 = perf_counter_ns()  # the span's own cost inside the stage: budget >= span
            try:
                with torch.profiler.record_function(f"ntsm.{self.area}.{name}"):
                    yield
            finally:
                self._add(name, perf_counter_ns() - t0)
        else:
            t0 = time_ns()
            try:
                yield
            finally:
                t1 = time_ns()
                self._add(name, t1 - t0)
                self.kept.append((name, t0, t1, threading.get_native_id()))

    def times(self, **extra) -> dict:
        """A copy of the budget, with `extra` (counts) added."""
        with self._lock:
            return dict(self.budget, **extra)

    def write_into(self, path: str) -> None:
        """Append the spans kept on other threads to the chrome trace at
        `path` (as torch.profiler exports it) as complete events on their
        own thread ids."""
        if not self.kept:
            return
        with open(path) as fh:
            obj = json.load(fh)
        base = int(obj.get("baseTimeNanoseconds", 0))  # absent: ts is since the epoch
        pid = os.getpid()
        obj["traceEvents"].extend(
            {"ph": "X", "cat": "user_annotation", "name": f"ntsm.{self.area}.{name}",
             "pid": pid, "tid": tid, "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3}
            for name, t0, t1, tid in list(self.kept))
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
        os.replace(tmp, path)


def recorder(area: str, keys=()) -> Recorder:
    """The current recorder of `area`, its budget given the names in
    `keys`; where none is current, a new one (not made current)."""
    rec = _CURRENT.get()
    if rec is None or rec.area != area:
        return Recorder(area, keys)
    with rec._lock:
        for k in keys:
            rec.budget.setdefault(k, 0.0)
    return rec


@contextlib.contextmanager
def recording(area: str, keys=()):
    """A new recorder of `area`, current until the block ends."""
    rec = Recorder(area, keys)
    token = _CURRENT.set(rec)
    try:
        yield rec
    finally:
        _CURRENT.reset(token)


def stage(name: str):
    """Stage `name` of the current recorder; nothing where none is."""
    rec = _CURRENT.get()
    return contextlib.nullcontext() if rec is None else rec.stage(name)


def export_trace(prof, dir_name: str) -> str:
    """Write prof's chrome trace into `dir_name` under the name
    torch.profiler.tensorboard_trace_handler gives
    (<host>_<pid>.<ms>.pt.trace.json, which TensorBoard and Perfetto read);
    returns its path."""
    os.makedirs(dir_name, exist_ok=True)
    path = os.path.join(dir_name, f"{socket.gethostname()}_{os.getpid()}."
                                  f"{time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path
