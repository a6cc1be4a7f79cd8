"""The stage recorder (ntsm_tpu_torch/utils/spans.py) and the stages it
times in count and eval: the budget and its nesting, nothing made with
tracing off, spans of other threads written into a trace on its clock, the
count engine's CountResult.stages and its `count --trace` spans on the
producer's and the readers' threads, and run_eval's ntsm.eval.* spans with
the stage dict the benchmark reads."""

import glob
import io
import itertools
import json
import pathlib
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntsm_tpu_torch.cli import count_cmd
from ntsm_tpu_torch.count.engine import COUNT_STAGES, EngineConfig, run_count
from ntsm_tpu_torch.eval.driver import run_eval
from ntsm_tpu_torch.eval.model import load_count_data
from ntsm_tpu_torch.io.sites import load_site_table
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans
from portbench import tracefile

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
COUNTS = [str(FIX / f"{s}_counts.txt") for s in ("sampleA", "sampleA2", "sampleB", "sampleC",
                                                  "sampleLow")]
# PR 16's keys of run_eval's stage dict, which the benchmark's readers take
ALL_KEYS = {"upload", "score", "finalize", "emit", "blocks"}
PCA_KEYS = {"project", "candidates", "upload", "tiles", "score", "finalize", "emit", "pairs"}
EVAL_SPANS = {"upload", "upload.copy", "upload.copy.fill", "samples", "score", "launch", "fetch",
              "finalize", "emit"}
PCA_SPANS = EVAL_SPANS | {"candidates", "candidates.radii", "candidates.search",
                          "candidates.search.radius", "candidates.search.order", "tiles",
                          "project", "project.copy", "project.quantize", "project.matmul"}


def _trace(directory) -> tracefile.Trace:
    files = glob.glob(str(pathlib.Path(directory) / "*.pt.trace.json"))
    assert len(files) == 1, files
    return tracefile.load(files[0])


def _raw_events(directory) -> list:
    (path,) = glob.glob(str(pathlib.Path(directory) / "*.pt.trace.json"))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _named(trace, name) -> list:
    return [(s, e) for n, s, e, _ in trace.spans if n == name]


def test_budget_sums_and_nests(monkeypatch):
    ticks = itertools.count(0, 1000)  # every clock read 1 us after the last
    monkeypatch.setattr(spans, "perf_counter_ns", lambda: next(ticks))
    rec = spans.Recorder("t", ("outer", "inner", "never"))
    assert rec.tracing is False and rec.kept is None
    for _ in range(3):
        with rec.stage("outer"):
            with rec.stage("inner"):
                pass
            with rec.stage("inner"):
                pass
    got = rec.times(n=7)
    # outer: 5 reads a round (t0, 2 x inner's two, t1) apart = 5 us; inner 1 us each
    assert got == {"outer": pytest.approx(3 * 5e-6), "inner": pytest.approx(6 * 1e-6),
                   "never": 0.0, "n": 7}
    with pytest.raises(ValueError):
        with rec.stage("raised"):
            raise ValueError
    assert rec.times()["raised"] == pytest.approx(1e-6)


def test_tracing_off_makes_no_span_and_keeps_nothing(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a span was made with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = spans.Recorder("t")

    def other_thread():
        with rec.stage("x"):
            pass

    worker = threading.Thread(target=other_thread)
    with rec.stage("x"):
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and rec.kept is None
    with spans.recording("t", ("y",)) as cur:
        with spans.stage("y"):
            pass
        assert cur.times()["y"] > 0
        assert spans.recorder("t", ("z",)) is cur and cur.times()["z"] == 0.0
        assert spans.recorder("u") is not cur
    assert spans.recorder("t") is not cur
    with spans.stage("nothing current"):
        pass


def _export(prof, tmp_path) -> tracefile.Trace:
    return tracefile.load(spans.export_trace(prof, str(tmp_path / "trace")))


def test_nested_spans_on_the_owner_thread(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = spans.Recorder("t")
        assert rec.tracing and rec.kept == []
        with rec.stage("outer"):
            with rec.stage("inner"):
                time.sleep(0.002)
    t = _export(prof, tmp_path)
    ((o0, o1),), ((i0, i1),) = _named(t, "ntsm.t.outer"), _named(t, "ntsm.t.inner")
    assert o0 <= i0 < i1 <= o1
    assert rec.kept == [] and rec.times()["outer"] >= rec.times()["inner"] >= 0.002


def test_other_thread_spans_land_on_the_trace_clock(tmp_path):
    """While the main thread is inside a span, a second thread records a
    span between two events the main thread waits on; written into the
    exported trace, it lies within the main thread's span to 1 ms."""
    started, done = threading.Event(), threading.Event()

    def worker(rec):
        started.wait(timeout=30)
        with rec.stage("worker"):
            time.sleep(0.02)
        done.set()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = spans.Recorder("t")
        th = threading.Thread(target=worker, args=(rec,))
        th.start()
        with rec.stage("main"):
            time.sleep(0.005)
            started.set()
            assert done.wait(timeout=30)
            time.sleep(0.005)
        th.join(timeout=30)
    assert not th.is_alive()
    path = spans.export_trace(prof, str(tmp_path / "trace"))
    rec.write_into(path)
    t = tracefile.load(path)
    ((m0, m1),), ((w0, w1),) = _named(t, "ntsm.t.main"), _named(t, "ntsm.t.worker")
    assert m0 - 1e-3 <= w0 < w1 <= m1 + 1e-3 and w1 - w0 >= 0.02
    tids = {e["name"]: e["tid"] for e in _raw_events(tmp_path / "trace")
            if e.get("name", "").startswith("ntsm.t.")}
    assert tids["ntsm.t.worker"] == th.native_id != tids["ntsm.t.main"]
    assert rec.times()["worker"] == pytest.approx(w1 - w0, abs=1e-6)


def test_budget_loses_no_update_across_threads(monkeypatch):
    """More threads than cores add to one name, with a short switch
    interval; each stage reads a clock of its own thread 1 us apart, so a
    lost update would show as a shorter total."""
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0) + 1000
        return local.t

    monkeypatch.setattr(spans, "perf_counter_ns", clock)
    rec = spans.Recorder("t")
    n_threads, n_iter = 32, 300

    def work():
        for _ in range(n_iter):
            with rec.stage("x"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert rec.times()["x"] == pytest.approx(n_threads * n_iter * 1e-6, rel=1e-9)


def _count_two_files(opts):
    table = load_site_table(str(FIX / "sites.fa"), 19, allow_dupes=False)
    files = [str(FIX / "sampleA.fq"), str(FIX / "sampleA2.fq")]
    return run_count(table, files, opts, EngineConfig(batch_reads=16, segment_len=128),
                     device="cpu")


def test_count_result_stages(capsys):
    t0 = time.monotonic()
    res = _count_two_files(Options(threads=2, verbose=2))
    wall = time.monotonic() - t0
    st = res.stages
    assert set(st) == set(COUNT_STAGES) | {"batches"} and st["batches"] > 2
    assert all(st[k] >= 0 for k in COUNT_STAGES)
    assert st["parse"] > 0 and st["wait"] > 0 and st["dispatch"] > 0 and st["pack"] > 0
    assert st["pack"] + st["pin"] + st["put"] + st["read"] <= wall
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("stage budget:")]
    assert len(line) == 1 and all(f" {k} " in line[0] for k in COUNT_STAGES)
    assert line[0].endswith(f"({st['batches']} batches)")
    plain = _count_two_files(Options(threads=2))
    assert (res.counts == plain.counts).all() and res.total_hits == plain.total_hits


def test_count_trace_holds_the_feed_threads(tmp_path, capsys):
    """count --trace -t 2: the producer's stages on one thread of their
    own, each reader's parse on its own, every batch's put ending before
    the wait that receives it ends."""
    argv = ["--device", "cpu", "-t", "2", "--trace", str(tmp_path / "trace"), "-s",
            str(FIX / "sites.fa"), str(FIX / "sampleA.fq"), str(FIX / "sampleB.fq")]
    assert count_cmd.run(argv) == 0
    capsys.readouterr()
    events = [e for e in _raw_events(tmp_path / "trace") if e.get("ph") == "X"]
    tid = {}
    for e in events:
        if e["name"].startswith("ntsm.count."):
            tid.setdefault(e["name"][len("ntsm.count."):], set()).add(e["tid"])
    assert {"read", "pack", "pin", "put", "parse", "wait", "dispatch", "table"} <= set(tid)
    (main,), (producer,) = tid["wait"], tid["read"]
    assert tid["pack"] == tid["pin"] == tid["put"] == {producer} and producer != main
    assert len(tid["parse"]) == 2 and not tid["parse"] & {main, producer}
    t = _trace(tmp_path / "trace")
    puts, waits = _named(t, "ntsm.count.put"), _named(t, "ntsm.count.wait")
    assert len(waits) == len(puts) + 1  # the last wait receives the end of the feed
    assert all(p1 <= w1 + 1e-3 for (_, p1), (_, w1) in zip(puts, waits))


@pytest.mark.parametrize("pca", [False, True])
def test_run_eval_spans_and_stage_keys(pca, tmp_path):
    kw = dict(engine="cuda", all=True)
    if pca:
        kw.update(pca=str(FIX / "rotation.tsv"), norm=str(FIX / "center.txt"), dim=5)
    opts = Options(**kw)
    data = load_count_data(COUNTS, opts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        times = run_eval(data, opts, io.StringIO(), device="cpu")
    t = _export(prof, tmp_path)
    want = PCA_SPANS if pca else EVAL_SPANS
    names = {n[len("ntsm.eval."):] for n, _, _, _ in t.spans if n.startswith("ntsm.eval.")}
    assert names == want
    assert set(times) == want | {"kept"} | ({"pairs", "project_blocks"} if pca else {"blocks"})
    assert set(times) >= (PCA_KEYS if pca else ALL_KEYS)
    # each child span inside its parent; the parents' times hold their children's
    kids = {"score": ("launch", "fetch"), "upload": ("upload.copy",),
            "upload.copy": ("upload.copy.fill",)}
    if pca:
        kids.update(candidates=("candidates.radii", "candidates.search"),
                    **{"candidates.search": ("candidates.search.radius",
                                             "candidates.search.order")},
                    project=("project.copy", "project.quantize", "project.matmul"))
    for parent, children in kids.items():
        outer = _named(t, f"ntsm.eval.{parent}")
        for c in children:
            for s, e in _named(t, f"ntsm.eval.{c}"):
                assert any(s0 <= s and e <= e0 for s0, e0 in outer), (parent, c)
        assert times[parent] >= sum(times[c] for c in children)
    assert times["score"] - times["launch"] - times["fetch"] < 0.05
