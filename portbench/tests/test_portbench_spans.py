"""The readers of the program's own spans (portbench/spanread.py and the
five layers that use it) on a recorded trace with known idle times, and
on a CPU run of the harness."""

from __future__ import annotations

import os

import pytest

from portbench import run as R
from portbench import tracefile as tr

LAYERS = os.path.join(R.HERE, "layers")
NEW = ("eval.finalize_idle_s", "eval.emit_idle_s", "eval_pca.quantize_s", "eval_pca.matmul_s",
       "eval_pca.project_self_s")


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def read(name, ctx):
    return R.load_module(os.path.join(LAYERS, name + ".py")).read(ctx)


def pass_trace(shift=0.0):
    """One pass (us): finalize 1000-3000 with a kernel 1500-2000 inside
    (idle 1500) and 5000-6000 with a copy 4800-5200 across its start (idle
    800); emit 6000-7000 with nothing on the card (idle 1000); project
    7000-8000 with copy 7000-7100, quantize 7100-7400, matmul 7400-7500 and
    a cpu op inside quantize (self time 1000 - 400 = 600)."""
    u = "user_annotation"
    return tr.parse({"traceEvents": [ev(n, ts + shift, d, c) for n, ts, d, c in (
        ("portbench.eval.pass", 0, 10000, u),
        ("ntsm.eval.finalize", 1000, 2000, u),
        ("void pair_stats_kernel<2, 2>(int const*)", 1500, 500, "kernel"),
        ("ntsm.eval.finalize", 5000, 1000, u),
        ("Memcpy DtoH (Device -> Pageable)", 4800, 400, "gpu_memcpy"),
        ("ntsm.eval.emit", 6000, 1000, u),
        ("ntsm.eval.project", 7000, 1000, u),
        ("ntsm.eval.project.copy", 7000, 100, u),
        ("ntsm.eval.project.quantize", 7100, 300, u),
        ("aten::empty", 7200, 10, "cpu_op"),
        ("ntsm.eval.project.matmul", 7400, 100, u))]})


def test_readers_on_a_known_trace():
    ctx = dict(traces=[pass_trace(), pass_trace(20000.0)])
    assert read("eval.finalize_idle_s", ctx) == pytest.approx(2300e-6)
    assert read("eval.emit_idle_s", ctx) == pytest.approx(1000e-6)
    assert read("eval_pca.quantize_s", ctx) == pytest.approx(300e-6)
    assert read("eval_pca.matmul_s", ctx) == pytest.approx(100e-6)
    assert read("eval_pca.project_self_s", ctx) == pytest.approx(600e-6)


def test_readers_return_nothing_without_the_spans():
    """The parent's program opens no ntsm.eval span: every new reader
    returns None, and the idle readers also without device work (a CPU
    run), while the span readers still read there."""
    bare = tr.parse({"traceEvents": [ev("portbench.eval.pass", 0, 100, "user_annotation"),
                                     ev("k", 10, 10, "kernel")]})
    for name in NEW:
        assert read(name, dict(traces=[bare])) is None, name
    host = pass_trace()
    host.device = []
    for name in NEW:
        got = read(name, dict(traces=[host]))
        assert (got is None) == name.endswith("idle_s"), name


def test_cpu_run_reports_the_span_metrics(tiny):
    """A traced CPU run of each eval cell: the projection's three parts
    read and add up to eval_pca.project_s; the idle readers (device_trace)
    read nothing from a CPU run."""
    for cell in ("eval_pca.1kg3202", "eval.1kg3202"):
        res = R.run_cell(cell, 2**31 + 99, 0.2, 1, device="cpu", manifest_path=tiny[0],
                         search=tiny[1])
        assert res["correct"] is True
        got = {k: v["value"] for k, v in res["metrics"].items()}
        assert not {"eval.finalize_idle_s", "eval.emit_idle_s"} & set(got)
        if cell.startswith("eval_pca"):
            parts = got["eval_pca.quantize_s"] + got["eval_pca.matmul_s"] + got[
                "eval_pca.project_self_s"]
            # the stage's clock runs inside its span: a few profiler events apart
            assert parts == pytest.approx(got["eval_pca.project_s"], rel=0.01, abs=5e-4)
            assert min(got["eval_pca.quantize_s"], got["eval_pca.matmul_s"]) > 0
