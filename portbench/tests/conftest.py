"""Fixtures of the benchmark's CPU tests: a throwaway manifest whose cells
run the real drivers on tiny configurations of their own, in a temporary
directory, so that nothing under portbench/ is edited.  The manifest holds
the committed cells and those under portbench/pending/ (entries kept for a
later BENCHMARK.json; the directory may be empty or absent), so every
driver is tested."""

from __future__ import annotations

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_SIZES = {
    "hs_n10_sample": dict(n_sites=300, reads_per_file=3000),
    "hs_n10_cohort3202": dict(n_samples=40, n_sites=600),
    "hs_n10_files320": dict(n_samples=40, n_sites=600),
}
TINY_TRAFFIC = dict(sample_pairs=100, warmup_samples=8, carry=0.3, dup_share=0.1)


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def manifest():
    """BENCHMARK.json with the entries of portbench/pending/ added."""
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    pending = os.path.join(BENCH, "pending")
    for name in sorted(os.listdir(pending)) if os.path.isdir(pending) else []:
        for key, entries in _load(os.path.join(pending, name)).items():
            bench[key] += entries
    return bench


@pytest.fixture
def tiny(tmp_path):
    """(manifest path, search directories): the committed and pending
    cells on tiny copies of their configurations and traffic."""
    bench = manifest()
    for kind in ("configs", "traffic"):
        (tmp_path / kind).mkdir()
    for c in bench["configs"]:
        cfg = _load(os.path.join(ROOT, c["file"]))
        cfg.update(TINY_SIZES.get(c["name"], {}))
        (tmp_path / "configs" / f"tiny_{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tf = _load(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        tf.update({k: v for k, v in TINY_TRAFFIC.items() if k in tf})
        (tmp_path / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tf))
        w["config"] = f"tiny_{w['config']}"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), [str(tmp_path), BENCH]


def cells():
    return [w["name"] for w in manifest()["workloads"]]
