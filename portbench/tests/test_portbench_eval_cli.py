"""The count-file cell (drivers/eval_cli.py) on the CPU: a run on a small
manifest is correct and reads its three per-layer metrics; a count file
altered on disk after the passes makes it not correct (the reference reads
the files, not the drawn counts); the readers give nothing without the
program's spans and counter (the parent's case); the benchmark's writer
writes what the program's writer writes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench import gen, ref_countfile
from portbench import run as R
from portbench import tracefile as tr

CELL = "eval_cli.n320_files"
LAYERS = os.path.join(R.HERE, "layers")
METRICS = ("eval_cli.load_s", "eval_cli.prepare_s", "eval_cli.load_mb_s")


@pytest.fixture
def small(tmp_path, tiny):
    """(manifest, search): the cell on 8 count files of 500 loci."""
    cfg = R.load_json(os.path.join(R.HERE, "configs", "hs_n10_files320.json"))
    cfg.update(n_samples=8, n_sites=500)
    (tmp_path / "small" / "configs").mkdir(parents=True)
    (tmp_path / "small" / "configs" / "tiny_hs_n10_files320.json").write_text(json.dumps(cfg))
    return tiny[0], [str(tmp_path / "small")] + tiny[1]


def read(name, ctx):
    return R.load_module(os.path.join(LAYERS, name + ".py")).read(ctx)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(trace, small):
    res = R.run_cell(CELL, 2**32 + 19, 0.2, trace, device="cpu", manifest_path=small[0],
                     search=small[1])
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if trace:
        assert set(got) == set(METRICS) and all(v > 0 for v in got.values())
    else:
        assert set(got) == {"eval_pairs_s", "setup_s"}


def test_a_file_altered_on_disk_is_caught(small, monkeypatch):
    """After the passes (in `release`, before the judge) one locus of one
    file gets 7 more A/T k-mers: the reference, read from disk, no longer
    agrees with the tables the passes printed."""
    real = R.load_module

    def load(path):
        mod = real(path)
        if path.endswith("eval_cli.py"):
            def release(run):
                f = os.path.join(run.state["dir"], run.state["names"][3])
                with open(f) as fh:
                    lines = fh.read().split("\n")
                row = lines[3].split("\t")
                row[1] = str(int(row[1]) + 7)
                lines[3] = "\t".join(row)
                with open(f, "w") as fh:
                    fh.write("\n".join(lines))
            mod.release = release
        return mod

    monkeypatch.setattr(R, "load_module", load)
    res = R.run_cell(CELL, 2**32 + 23, 0.1, 0, device="cpu", manifest_path=small[0],
                     search=small[1])
    assert res["correct"] is False
    assert res["checks"]["float_gap"]["value"] > res["checks"]["float_gap"]["limit"]


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_readers_on_a_known_trace_and_without_the_spans():
    t = tr.parse({"traceEvents": [
        ev("portbench.eval_cli.pass", 0, 10000), ev("ntsm.eval.load", 100, 4000),
        ev("ntsm.eval.load.read", 100, 1000), ev("ntsm.eval.prepare", 4200, 500)]})
    ctx = dict(traces=[t, t], bytes_read=[2_000_000, 6_000_000])
    assert read("eval_cli.load_s", ctx) == pytest.approx(4000e-6)
    assert read("eval_cli.prepare_s", ctx) == pytest.approx(500e-6)
    assert read("eval_cli.load_mb_s", ctx) == pytest.approx(8.0 / 8000e-6)
    # the parent: no ntsm.eval span and no counter
    bare = tr.parse({"traceEvents": [ev("portbench.eval_cli.pass", 0, 100),
                                     ev("k", 10, 10, "kernel")]})
    for ctx in (dict(traces=[bare], bytes_read=[None]), dict(traces=[t], bytes_read=[None])):
        assert read("eval_cli.load_mb_s", ctx) is None
    for name in METRICS:
        assert read(name, dict(traces=[bare], bytes_read=[None])) is None, name


def test_writer_matches_the_program_and_reads_back(tmp_path):
    from ntsm_tpu_torch.io.countfile import format_counts

    drv = R.load_module(os.path.join(R.HERE, "drivers", "eval_cli.py"))
    cfg = R.load_json(os.path.join(R.HERE, "configs", "hs_n10_files320.json"))
    rng = np.random.default_rng(5)
    mx = rng.poisson(12, (3, 50, 2)).astype(np.int32)
    mx[0, 0] = 0
    mx[1, 1] = (123456, 7)
    names = [f"s{s}_counts.txt" for s in range(3)]
    drv.write_count_files(str(tmp_path), names, mx, cfg)
    ids = gen.site_names(50)
    kpa = cfg["kmers_per_allele"]
    for s, n in enumerate(names):
        want = format_counts(ids, mx[s], mx[s] * kpa, np.full((50, 2), kpa),
                             int(mx[s].sum()) * cfg["kmers_seen_per_count"], cfg["k"])
        assert (tmp_path / n).read_text() == want
    c = ref_countfile.read_cohort([str(tmp_path / n) for n in names])
    np.testing.assert_array_equal(c.max_counts, mx)
    np.testing.assert_array_equal(c.sum_counts, mx * kpa)
    assert c.locus_ids == [i.encode() for i in ids] and list(c.ks) == [cfg["k"]] * 3
