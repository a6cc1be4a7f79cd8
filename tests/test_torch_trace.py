"""``count --trace DIR``: the v3 engine under torch.profiler (CPU activity
here; the card adds its kernels, which chip_smoke.py phase 20 checks).
The trace is a *.pt.trace.json in DIR that parses as JSON and holds the
engine's stage spans, also when the run ends early on -m or on an error;
counts.txt is the same with and without it, and without --trace no
profiler is made."""

import glob
import json
import pathlib

import pytest
import torch

from ntsm_tpu_torch.cli import count_cmd
from ntsm_tpu_torch.count.engine import EngineConfig, run_count
from ntsm_tpu_torch.io.sites import load_site_table
from ntsm_tpu_torch.options import Options

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
SPANS = ("ntsm.count.table", "ntsm.count.wait", "ntsm.count.dispatch", "ntsm.count.drain",
         "ntsm.count.checkpoint")


def _run(argv, capsys):
    rc = count_cmd.run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _trace_names(directory) -> set:
    files = glob.glob(str(pathlib.Path(directory) / "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("sample", ["sampleA", "sampleLow"])
def test_trace_holds_the_stage_spans_and_counts_are_unchanged(capsys, tmp_path, sample):
    """--checkpoint-every 1, so that the checkpoint stage runs too."""
    args = ["--device", "cpu", "--checkpoint", str(tmp_path / "snap.npz"),
            "--checkpoint-every", "1", "-s", str(FIX / "sites.fa"), str(FIX / f"{sample}.fq")]
    rc, out, _ = _run(["--trace", str(tmp_path / "trace"), *args], capsys)
    assert rc == 0
    assert out == (FIX / f"{sample}_counts.txt").read_text()
    assert set(SPANS) <= _trace_names(tmp_path / "trace")
    (tmp_path / "snap.npz").unlink()
    rc, plain, _ = _run(args, capsys)
    assert rc == 0 and plain == out


def test_trace_written_when_m_ends_the_run(tmp_path, capsys):
    """Small batches, so that -m stops the loop after a few drains."""
    table = load_site_table(str(FIX / "sites.fa"), 19, allow_dupes=False)
    fq = [str(FIX / "sampleA.fq")]
    config = EngineConfig(batch_reads=8, segment_len=128, early_term_check_every=2)
    traced = run_count(table, fq, Options(cov_thresh=0.5, trace=str(tmp_path / "trace")),
                       config, device="cpu")
    assert "Reached desired (-m) threshold" in capsys.readouterr().err
    assert set(SPANS[:4]) <= _trace_names(tmp_path / "trace")
    plain = run_count(table, fq, Options(cov_thresh=0.5), config, device="cpu")
    full = run_count(table, fq, Options(), config, device="cpu")
    assert traced.early_term and traced.total_reads < full.total_reads
    assert (traced.counts == plain.counts).all()
    assert traced.total_reads == plain.total_reads and traced.total_hits == plain.total_hits


def test_trace_written_on_error(tmp_path):
    table = load_site_table(str(FIX / "sites.fa"), 19, allow_dupes=False)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_count(table, [str(FIX / "sampleA.fq")], Options(trace=str(tmp_path / "trace")),
                  EngineConfig(batch_reads=64, segment_len=128, fail_after_batches=1),
                  device="cpu")
    assert {"ntsm.count.table", "ntsm.count.dispatch"} <= _trace_names(tmp_path / "trace")


def test_no_profiler_without_trace(capsys, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a profiler was made without --trace")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rc, out, _ = _run(["--device", "cpu", "-s", str(FIX / "sites.fa"), str(FIX / "sampleA.fq")],
                      capsys)
    assert rc == 0 and out == (FIX / "sampleA_counts.txt").read_text()
