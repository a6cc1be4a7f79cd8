"""The harness end to end on the CPU: the result line, a run without a
card, a cell added by files of its own, and what the process loads."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, cells
from portbench import run as R

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_pass_result_line(cell, trace, tiny):
    res = R.run_cell(cell, 2**31 + 77, 0.2, trace, device="cpu", manifest_path=tiny[0],
                     search=tiny[1])
    assert list(res)[: len(KEYS)] == list(KEYS)
    assert set(res) <= set(KEYS) | {"breakdown", "checks"} and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    if trace:
        # no device number from a CPU run; the host spans and stage times are read
        assert not any(k.endswith(("roofline", "idle")) for k in res["metrics"])
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    res = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          cells()[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "metrics" not in res.stdout and "needs 1 CUDA device" in res.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench import run; "
            "run.check_program('cpu')")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env={"PATH": os.environ["PATH"]})
    assert res.returncode != 0 and "ntsm_tpu_torch cannot be imported" in res.stderr
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cells()[0],
                          "--seed", "5", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env={"PATH": os.environ["PATH"]})
    assert res.returncode != 0 and "metrics" not in res.stdout


def test_a_new_cell_needs_only_files_of_its_own(tmp_path, tiny):
    """A cell, configuration and traffic mix added beside the committed
    ones, in a manifest of their own: the harness finds them by name."""
    bench = R.load_json(tiny[0])
    tmp_path = tmp_path / "extra"
    for kind in ("configs", "traffic"):
        (tmp_path / kind).mkdir(parents=True)
    cfg = R.load_json(os.path.join(tiny[1][0], "configs", "tiny_hs_n10_sample.json"))
    cfg.update(n_sites=120, reads_per_file=800)
    (tmp_path / "configs" / "extra_sample.json").write_text(json.dumps(cfg))
    tf = R.load_json(os.path.join(BENCH, "traffic", "wgs_pe150.json"))
    tf.update(carry=0.5, sub_rate=0.01)
    (tmp_path / "traffic" / "dense_reads.json").write_text(json.dumps(tf))
    bench["workloads"].append(dict(name="count.dense", config="extra_sample",
                                   traffic="dense_reads", chips=1, why="a throwaway cell"))
    next(m for m in bench["end_to_end"] if m["name"] == "count_mbase_s")["workloads"].append(
        "count.dense")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = R.run_cell("count.dense", 99, 0.1, 0, device="cpu",
                     manifest_path=str(tmp_path / "BENCHMARK.json"),
                     search=[str(tmp_path)] + tiny[1])
    assert res["correct"] and set(res["metrics"]) == {"count_mbase_s", "setup_s"}


def test_the_count_cell_waits_whole_in_pending(monkeypatch, tmp_path):
    """count.wgs_pe150, its configuration and its metrics wait in
    portbench/pending/ (its run-to-run spread, PERF.md), each metric
    listing the cell, and the CPU tests' manifest adds them; a pending/
    that is empty or absent adds nothing."""
    import conftest

    bench = R.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    pending = R.load_json(os.path.join(BENCH, "pending", "count.wgs_pe150.json"))
    cell = pending["workloads"][0]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == (
        "count.wgs_pe150", "hs_n10_sample", "wgs_pe150", 1)
    assert [c["name"] for c in pending["configs"]] == ["hs_n10_sample"]
    assert [m["name"] for m in pending["end_to_end"]] == ["count_mbase_s"]
    assert {m["name"] for m in pending["per_layer"]} == {
        "count.wait_share", "count.dispatch_ms", "count.step_roofline", "count.device_idle",
        "count.parse_s", "count.pack_s", "count.table_s"}
    assert all(m["workloads"] == [cell["name"]]
               for m in pending["end_to_end"] + pending["per_layer"])
    assert cell["name"] not in {w["name"] for w in bench["workloads"]}
    assert cell["name"] in cells()
    for with_dir in (False, True):
        bare = tmp_path / f"bench{int(with_dir)}"
        (bare / "pending" if with_dir else bare).mkdir(parents=True)
        monkeypatch.setattr(conftest, "BENCH", str(bare))
        assert conftest.manifest() == bench


def test_nothing_loads_jax_or_the_jax_package(tiny):
    """After the harness and a CPU pass of each driver, no module whose
    top-level name is jax, jaxlib, flax or ntsm_tpu is loaded (compared
    whole: ntsm_tpu_torch begins with ntsm_tpu)."""
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]); from portbench import run\n"
        "for c in json.loads(sys.argv[4]):\n"
        "    r = run.run_cell(c, 3, 0.1, 0, device='cpu', manifest_path=sys.argv[2],\n"
        "                     search=json.loads(sys.argv[3]))\n"
        "    assert r['correct'], c\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    res = subprocess.run([sys.executable, "-c", code, ROOT, tiny[0], json.dumps(tiny[1]),
                          json.dumps(cells())], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.splitlines()[-1]))
    assert "ntsm_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ntsm_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ntsm_tpu_torch_fake", object())
    assert "ntsm_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ntsm_tpu.fake", object())
    assert "ntsm_tpu" in R.forbidden_modules()
