"""The biobank-scale -p cell (drivers/eval_biobank.py) on the CPU: a run at
the configuration's cpu_sizes is correct, its candidate total matches the
reference's, and it reads the new span metrics and the projection's; the radius kernel's
roofline reads only from a device trace; the readers give nothing without
the program's spans (the parent's case); a program without the device
search stops in set-up; the blocked validity product and control are the
eval driver's."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from portbench import roofline as rf
from portbench import roofline_search
from portbench import run as R
from portbench import tracefile as tr

CELL = "eval_pca.gnomad_v31"
LAYERS = os.path.join(R.HERE, "layers")
SPAN_METRICS = ("eval_pca.search_radius_s", "eval_pca.search_order_s", "eval_pca.upload_gb_s")
ROOFLINE = "eval_pca.search_roofline"
# the projection's span metrics, which the cell reports as eval_pca.1kg3202 does
PROJECTION = ("eval_pca.quantize_s", "eval_pca.matmul_s", "eval_pca.project_self_s")


def read(name, ctx):
    return R.load_module(os.path.join(LAYERS, name + ".py")).read(ctx)


def driver():
    return R.load_module(os.path.join(R.HERE, "drivers", "eval_biobank.py"))


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_pass_at_cpu_sizes(trace, tiny, capsys):
    res = R.run_cell(CELL, 2**32 + 41, 0.2, trace, device="cpu", manifest_path=tiny[0],
                     search=tiny[1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["totals_off"] == {"value": 0, "limit": 0}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    err = capsys.readouterr().err
    assert "candidate pairs a pass" in err and "pairs 1128.000" in err  # 48 samples: all pairs
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if trace:
        for name in SPAN_METRICS:
            assert got[name] > 0, name
        for name in PROJECTION:
            assert got[name] >= 0, name
        assert ROOFLINE not in got  # no device trace on the CPU
    else:
        assert set(got) == {"eval_pca_samples_s", "setup_s"}


def test_cpu_sizes_cut_only_their_keys():
    cfg = R.load_json(os.path.join(R.HERE, "configs", "hs_n10_gnomad_v31.json"))
    tf = R.load_json(os.path.join(R.HERE, "traffic", "swap_check_pca_biobank.json"))
    run = R.Run(name=CELL, cell={}, config=dict(cfg), traffic=dict(tf), seed=1, device="cpu",
                work="", trace=False, search=[R.HERE], manifest={})
    driver()._cut_for_cpu(run)
    assert (run.config["n_samples"], run.config["n_sites"]) == (48, 600)
    assert (run.traffic["clusters"], run.traffic["dirty_every"]) == (4, 16)
    assert "clusters" not in run.config and "n_samples" not in run.traffic
    assert (cfg["n_samples"], tf["clusters"]) == (32768, 160)  # the files are not touched


def test_a_program_without_the_search_stops_in_setup(tiny, monkeypatch):
    real = importlib.util.find_spec

    def find_spec(name, *a, **kw):
        return None if name == "ntsm_tpu_torch.eval.search_kernel" else real(name, *a, **kw)

    monkeypatch.setattr(importlib.util, "find_spec", find_spec)
    with pytest.raises(R.SetupError, match="no device candidate search"):
        R.run_cell(CELL, 7, 0.1, 0, device="cpu", manifest_path=tiny[0], search=tiny[1])


def test_span_readers_on_a_known_trace_and_without_the_spans():
    t = tr.parse({"traceEvents": [
        ev("portbench.eval.pass", 0, 10000), ev("ntsm.eval.upload.copy", 10, 400),
        ev("ntsm.eval.upload.copy", 500, 600), ev("ntsm.eval.candidates.search.radius", 2000, 30),
        ev("ntsm.eval.candidates.search.radius", 2100, 20),
        ev("ntsm.eval.candidates.search.order", 2050, 40)]})
    ctx = dict(traces=[t, t], n_samples=1000, n_sites=500)
    assert read("eval_pca.search_radius_s", ctx) == pytest.approx(50e-6)
    assert read("eval_pca.search_order_s", ctx) == pytest.approx(40e-6)
    assert read("eval_pca.upload_gb_s", ctx) == pytest.approx(1000 * 500 * 8 / 1000e-6 / 1e9)
    bare = tr.parse({"traceEvents": [ev("portbench.eval.pass", 0, 100),
                                     ev("ntsm.eval.candidates.search", 10, 50),
                                     ev("k", 10, 10, "kernel")]})
    for name in SPAN_METRICS + (ROOFLINE,):
        assert read(name, dict(traces=[bare], n_samples=4, n_sites=4, search_least_s=1.0)) is None


def test_search_roofline_reads_the_radius_kernel():
    t = tr.parse({"traceEvents": [
        ev("portbench.eval.pass", 0, 10000),
        ev("void (anonymous namespace)::pca_radius_kernel<false>(double const*)", 100, 600,
           "kernel"),
        ev("void (anonymous namespace)::pca_radius_kernel<true>(double const*)", 800, 400,
           "kernel"),
        ev("void (anonymous namespace)::pair_tiles_kernel<1, 1>(int const*)", 2000, 900,
           "kernel")]})
    ctx = dict(traces=[t], search_least_s=20e-6)
    assert read(ROOFLINE, ctx) == pytest.approx(100 * 20e-6 / 1000e-6)
    assert read(ROOFLINE, dict(traces=[t])) is None  # the eval driver's context: no bound


def test_search_bound():
    # 32,768 points of 20 dimensions, 5M pairs inside a radius: bytes lead
    got = roofline_search.search_least_s(32768, 20, 5_000_000)
    n_bytes = 32768 * 21 * 8 + 5_000_000 * 12
    assert got == pytest.approx(max(n_bytes / rf.HBM_BYTES_PER_S,
                                    5_000_000 * 60 / rf.F64_OPS_PER_S))
    # a brute-force pass computes every pair's distance: never faster than the bound
    brute = 32768**2 * 60 / rf.F64_OPS_PER_S
    assert got < brute
    assert roofline_search.search_least_s(10, 3, 0) > 0


def test_valid_pair_sites_and_control_are_the_eval_drivers(tiny):
    """The blocked product against the sites counted pair by pair; the
    control's rows against the eval driver's control on the same run."""
    drv = driver()
    rng = np.random.default_rng(3)
    mx = rng.poisson(1.5, size=(23, 57, 2)).astype(np.int32)
    ii, jj = rng.integers(0, 23, 40), rng.integers(0, 23, 40)
    valid = (mx > 1).any(2)
    want = float((valid[ii] & valid[jj]).sum())
    for block in (1, 5, 64):
        assert drv.valid_pair_sites(torch.from_numpy(mx), ii, jj, 1, block=block) == want
    bench = R.load_json(tiny[0])
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    run = R.Run(name=CELL, cell=cell, config=R.load_json(R.find(tiny[1], "configs", cell["config"],
                                                                 ".json")),
                traffic=R.load_json(R.find(tiny[1], "traffic", cell["traffic"], ".json")),
                seed=2**31 + 5, device="cpu", work=str(tiny[1][0]), trace=False, search=tiny[1],
                manifest=bench)
    drv.setup(run)
    drv.release(run)
    ref32 = drv.reference(run, torch.float32)
    cohort = R.load_module(os.path.join(R.HERE, "drivers", "eval.py"))
    assert drv.control_outputs(run, ref32) == cohort.control_outputs(run, ref32)
    ref = drv.reference(run)
    assert ref["within"] > 0 and ref["cand"][0].size > 0
