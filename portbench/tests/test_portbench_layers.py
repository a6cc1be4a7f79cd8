"""Each per-layer reader on a small recorded trace or stage dict."""

from __future__ import annotations

import json
import os

import pytest

from conftest import manifest
from portbench import roofline as rf
from portbench import run as R
from portbench import tracefile as tr

LAYERS = os.path.join(R.HERE, "layers")


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def count_trace():
    """One pass: wait 0-600 us, dispatch 600-700, wait 700-900, dispatch
    900-1000, drain 1000-1100; two kernels of 50 us and a copy of 20."""
    return tr.parse({"traceEvents": [
        ev("ntsm.count.table", 0, 0, "user_annotation"),
        ev("ntsm.count.wait", 0, 600, "user_annotation"),
        ev("ntsm.count.dispatch", 600, 100, "user_annotation"),
        ev("ntsm.count.wait", 700, 200, "user_annotation"),
        ev("ntsm.count.dispatch", 900, 100, "user_annotation"),
        ev("ntsm.count.drain", 1000, 100, "user_annotation"),
        ev("Memcpy HtoD", 650, 20, "gpu_memcpy"),
        ev("void count_step_kernel(PackedBatch, int)", 680, 50, "kernel"),
        ev("void count_step_kernel(PackedBatch, int)", 950, 50, "kernel"),
        ev("ntsm.count.wait", 0, 1100, "gpu_user_annotation"),
    ]})


def read(name, ctx):
    return R.load_module(os.path.join(LAYERS, name + ".py")).read(ctx)


def count_ctx(t):
    w = t.window(["ntsm.count.wait", "ntsm.count.dispatch", "ntsm.count.drain",
                  "ntsm.count.table"])
    return dict(traces=[t], busy_s=tr.busy_s(t, *w), window_s=w[1] - w[0],
                totals=dict(total_bases=8000, total_kmers=5000, total_hits=10),
                n_buckets=1024)


def test_trace_reading_by_hand():
    t = count_trace()
    assert t.window() == (0.0, pytest.approx(1100e-6))
    assert t.span_total("ntsm.count.wait") == (pytest.approx(800e-6), 2)
    assert tr.busy_s(t, 0.0, 1100e-6) == pytest.approx(120e-6)  # 650-730 and 950-1000
    loop = ("ntsm.count.wait", "ntsm.count.dispatch")  # 0-1000, the drain left out
    assert tr.covered_s(t, loop, 0.0, 1100e-6) == pytest.approx(1000e-6)
    assert tr.covered_s(t, loop, 650e-6, 950e-6) == pytest.approx(300e-6)
    gaps = tr.idle_gaps(t, 0.0, 1100e-6)
    assert gaps[0] == ("ntsm.count.wait", pytest.approx(650e-6))
    assert tr.top_kernels([t])[0] == ["void count_step_kernel(PackedBatch, int)",
                                      pytest.approx(100e-6)]


def test_count_readers():
    ctx = count_ctx(count_trace())
    assert read("count.wait_share", ctx) == pytest.approx(100 * 800 / 1100)
    assert read("count.dispatch_ms", ctx) == pytest.approx(0.1)
    assert read("count.device_idle", ctx) == pytest.approx(100 * (1 - 120 / 1100))
    least = rf.count_step_least_s(3000, 5000, 5000, 10, 1024, 2)
    assert read("count.step_roofline", ctx) == pytest.approx(100 * least / 100e-6)


def test_readers_return_nothing_without_device_work():
    t = tr.parse([e for e in json.loads(json.dumps({"traceEvents": []}))["traceEvents"]])
    ctx = dict(traces=[t], busy_s=0.0, window_s=1.0, totals=dict(total_bases=1, total_kmers=1,
               total_hits=0), n_buckets=16, times=[], least_s=1.0, kernel="pair_")
    for name in ("count.step_roofline", "count.device_idle", "eval.device_idle",
                 "eval.pair_stats_roofline", "eval_pca.pair_block_roofline", "eval.score_s",
                 "count.wait_share", "count.dispatch_ms"):
        assert read(name, ctx) is None, name


def feed_trace(parse, pack, table):
    """One pass of the host feed's spans: `parse` [(tid, ts, dur)] of the
    reader threads, `pack` [(ts, dur)] of the producer, the consumer's
    table span of `table` us."""
    u = "user_annotation"
    return tr.parse({"traceEvents": [
        *(dict(ev("ntsm.count.parse", ts, d, u), tid=tid) for tid, ts, d in parse),
        *(dict(ev("ntsm.count.pack", ts, d, u), tid=3) for ts, d in pack),
        dict(ev("ntsm.count.table", 0, table, u), tid=1),
        dict(ev("ntsm.count.wait", table, 900, u), tid=1)]})


def test_feed_readers_sum_threads_and_average_passes():
    """Pass 1: parse 300 + 200 on thread 11 and 150 + 400 on thread 12,
    pack 60 + 40, table 90; pass 2: parse 500 and 300, pack 50, table 110
    (us).  A reader gives the mean over the passes of the sum over the
    threads."""
    ctx = dict(traces=[
        feed_trace([(11, 0, 300), (12, 100, 150), (11, 400, 200), (12, 300, 400)],
                   [(200, 60), (500, 40)], 90),
        feed_trace([(11, 0, 500), (12, 0, 300)], [(600, 50)], 110)])
    assert read("count.parse_s", ctx) == pytest.approx((1050 + 800) / 2 * 1e-6)
    assert read("count.pack_s", ctx) == pytest.approx((100 + 50) / 2 * 1e-6)
    assert read("count.table_s", ctx) == pytest.approx((90 + 110) / 2 * 1e-6)


@pytest.mark.parametrize("name", ["count.parse_s", "count.pack_s", "count.table_s"])
def test_feed_readers_return_nothing_without_their_span(name):
    bare = tr.parse({"traceEvents": [ev("ntsm.count.wait", 0, 900, "user_annotation"),
                                     ev("ntsm.count.dispatch", 900, 100, "user_annotation")]})
    assert read(name, dict(traces=[bare, bare])) is None


def test_parse_spans_of_two_threads_reach_the_reader(tmp_path):
    """The program's stage recorder keeps the spans of threads that the
    profiler does not reach and writes them into the exported trace on
    their own thread ids: both reader threads' parse spans are in the
    trace, and count.parse_s is their summed seconds."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from ntsm_tpu_torch.utils import spans

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = spans.Recorder("count", ("parse",))

        def parse():
            for _ in range(3):
                with rec.stage("parse"):
                    time.sleep(0.002)

        threads = [threading.Thread(target=parse) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    path = spans.export_trace(prof, str(tmp_path))
    rec.write_into(path)
    with open(path) as fh:
        obj = json.load(fh)
    parsed = [e for e in obj["traceEvents"] if e.get("name") == "ntsm.count.parse"]
    assert len(parsed) == 6 and len({e["tid"] for e in parsed}) == 2
    got = read("count.parse_s", dict(traces=[tr.parse(obj)]))
    assert got == pytest.approx(rec.budget["parse"], rel=1e-6)
    assert got >= 6 * 0.002


def test_eval_readers():
    t = tr.parse({"traceEvents": [
        ev("portbench.eval.pass", 0, 10000, "user_annotation"),
        ev("void pair_stats_kernel<1, 1>(int const*)", 100, 4000, "kernel"),
        ev("void pair_tiles_kernel<4>(int const*)", 5000, 500, "kernel"),
        ev("void pair_sparse_kernel(int const*)", 6000, 500, "kernel")]})
    times = [dict(upload=0.5, score=1.0, finalize=2.0, emit=0.25, tiles=0.1, project=7.0,
                  candidates=1.0), dict(upload=0.7, score=1.2, finalize=2.2, emit=0.35,
                                        tiles=0.3, project=8.0, candidates=2.0)]
    ctx = dict(traces=[t], times=times, busy_s=tr.busy_s(t, 0, 0.01), window_s=0.01,
               least_s=0.4e-3, kernel="pair_")
    assert read("eval.upload_s", ctx) == pytest.approx(0.6)
    assert read("eval.score_s", ctx) == pytest.approx(1.1)
    assert read("eval.finalize_s", ctx) == pytest.approx(2.1)
    assert read("eval.emit_s", ctx) == pytest.approx(0.3)
    assert read("eval_pca.project_s", ctx) == pytest.approx(7.5)
    assert read("eval_pca.candidates_s", ctx) == pytest.approx(1.5)
    assert read("eval_pca.score_s", ctx) == pytest.approx(1.3)
    assert read("eval.device_idle", ctx) == pytest.approx(50.0)
    assert read("eval.pair_stats_roofline", ctx) == pytest.approx(10.0)
    assert read("eval_pca.pair_block_roofline", ctx) == pytest.approx(100 * 0.4 / 5.0)


def test_every_listed_metric_has_a_reader():
    for m in manifest()["per_layer"]:
        assert os.path.exists(os.path.join(LAYERS, m["name"] + ".py")), m["name"]
