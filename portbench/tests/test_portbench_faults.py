"""The judge catches a broken timed path: with each fault the cell can
have planted under the program (a step that returns its state unchanged,
half of the work left out, an answer altered where it is produced), a CPU
run of the cell, its search for a card skipped, comes out not correct;
and the control reads past the limits while the program reads within
them."""

from __future__ import annotations

import pytest
import torch

from conftest import cells
from portbench import control
from portbench import run as R

COUNT = [c for c in cells() if c.startswith("count.")]
EVAL = [c for c in cells() if not c.startswith("count.")]


def count_fault(kind):
    from ntsm_tpu_torch.count import engine

    real = engine.count_step_v3

    def step(packed, vbits, tab, counts, k, L):
        if kind == "unchanged":
            return real(packed, vbits, tab, torch.zeros_like(counts), k, L)
        if kind == "half":
            h = max(1, packed.shape[0] // 2)
            return real(packed[:h], vbits[:h], tab, counts, k, L)
        diag = real(packed, vbits, tab, counts, k, L)
        counts[0] += 1  # an answer altered
        return diag

    return engine, "count_step_v3", step


def eval_fault(kind, pca):
    from ntsm_tpu_torch.eval import pair_kernel, rect

    if kind == "altered":
        real = rect.finalize

        def fin(data, opts, iu, ju, ints, sums):
            f3, i9 = real(data, opts, iu, ju, ints, sums)
            f3[:, 0] *= 1.001  # every score a part in a thousand off
            return f3, i9

        return rect, "finalize", fin
    name = "pair_block_stats" if pca else "pair_stats"
    real = getattr(pair_kernel, name)

    def stats(*args, **kw):
        ints, sums = real(*args, **kw)
        if kind == "unchanged":
            return torch.zeros_like(ints), torch.zeros_like(sums)
        return ints // 2, sums / 2  # half of the sites, the mean over the rest

    return pair_kernel, name, stats


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", cells())
def test_fault_makes_the_run_not_correct(cell, kind, tiny, monkeypatch):
    if cell in COUNT:
        mod, name, fn = count_fault(kind)
    else:
        mod, name, fn = eval_fault(kind, pca="pca" in cell)
    monkeypatch.setattr(mod, name, fn)
    res = R.run_cell(cell, 2**31 + 901, 0.1, 0, device="cpu", manifest_path=tiny[0],
                     search=tiny[1])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", cells())
def test_control_fails_where_the_program_passes(cell, tiny):
    got = control.readings(cell, 2**31 + 12, device="cpu", manifest_path=tiny[0],
                           search=tiny[1])
    bench = R.load_json(tiny[0])
    c = {w["name"]: w for w in bench["workloads"]}[cell]
    cfg = R.load_json(R.find(tiny[1], "configs", c["config"], ".json"))
    limits = dict(kmer_counts_off=0, totals_off=0, early_stops=0, rows_off=0, fields_off=0,
                  score_gap=cfg.get("score_tolerance"), float_gap=cfg.get("score_tolerance"))
    assert all(v <= limits[n] for n, v in got["program"].items())
    assert any(v > limits[n] for n, v in got["control"].items())
