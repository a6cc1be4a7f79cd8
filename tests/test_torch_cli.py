"""The port's ``count`` CLI: stdout byte-equal to the reference fixtures on
--device cpu, the JAX CLI's error texts, no silent move to the CPU, no jax
import, and chip_smoke.py refusing to run without a card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from ntsm_tpu.cli import count_cmd as jax_count_cmd
from ntsm_tpu_torch.cli import count_cmd, main
from tests.synth import make_site_fasta

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
SAMPLES = ["sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow",
           "sampleA_junk", "sampleA_badqual"]


def _run(argv, capsys, mod=count_cmd):
    rc = mod.run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("sample", SAMPLES)
def test_cli_stdout_matches_fixture(capsys, sample):
    rc, out, err = _run(
        ["--device", "cpu", "-s", str(FIX / "sites.fa"), str(FIX / f"{sample}.fq")], capsys
    )
    assert rc == 0
    assert out == (FIX / f"{sample}_counts.txt").read_text()
    assert "Total k-mers Recorded:" in err and "Time:" in err


def test_cli_golden_engine_and_summary_file(capsys, tmp_path):
    summary = tmp_path / "summary.txt"
    rc, out, _ = _run(["--engine", "golden", "-o", str(summary),
                       "-s", str(FIX / "sites.fa"), str(FIX / "sampleA.fq")], capsys)
    assert rc == 0
    assert out == (FIX / "sampleA_counts.txt").read_text()
    assert summary.read_text() in (FIX / "sampleA_count_stderr.txt").read_text()


@pytest.mark.parametrize("seglen", ["4096", "262144"])
def test_cli_long_seglen_matches_fixture(capsys, seglen):
    """--seglen takes any multiple of 8 from 64 on (no ceiling: the card's
    window stage cuts a long row into pieces); the counts are the same."""
    rc, out, _ = _run(["--device", "cpu", "--seglen", seglen, "-s", str(FIX / "sites.fa"),
                       str(FIX / "sampleA.fq")], capsys)
    assert rc == 0
    assert out == (FIX / "sampleA_counts.txt").read_text()


def _error_cases(tmp_path, rng):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(rng, n_sites=2, path=sites)
    return {
        "missing_sites": ["reads.fq"],
        "missing_input": ["-s", sites, str(tmp_path / "nope.fq")],
        "k_too_large": ["-k", "33", "-s", sites, sites],
        "no_input": ["-s", sites],
        "bad_flag": ["--bogus", "-s", sites, sites],
        "bad_seglen": ["--seglen", "100", "-s", sites, sites],
    }


@pytest.mark.parametrize(
    "case",
    ["missing_sites", "missing_input", "k_too_large", "no_input", "bad_flag", "bad_seglen"],
)
def test_cli_errors_match_jax_cli(capsys, tmp_path, rng, case):
    argv = _error_cases(tmp_path, rng)[case]
    want = _run(argv, capsys, mod=jax_count_cmd)
    got = _run(argv, capsys)
    assert want[0] == 1
    assert got == want


def test_bad_engine_and_device(capsys):
    args = ["-s", str(FIX / "sites.fa"), str(FIX / "sampleA.fq")]
    for extra in (["--engine", "tpu"], ["--device", "tpu"]):
        rc, out, err = _run([*extra, *args], capsys)
        assert rc == 1 and out == "" and "must be one of" in err


def test_device_cuda_without_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run(["-s", str(FIX / "sites.fa"), str(FIX / "sampleA.fq")], capsys)
    assert rc == 1
    assert out == ""  # nothing was counted, on the CPU or elsewhere
    assert "--device cuda needs a CUDA device" in err


def test_main_dispatch(capsys):
    assert main([]) == 1
    assert main(["--help"]) == 0
    assert main(["eval", "a", "b"]) == 1
    assert "input file a does not exist" in capsys.readouterr().err
    assert main(["vcf", "a", "b"]) == 1
    assert "Missing variants (-s)" in capsys.readouterr().err
    assert main(["sitegen", "bogus"]) == 1
    assert "unknown target" in capsys.readouterr().err
    assert main(["bogus"]) == 1
    assert main(["count", "--version"]) == 0
    assert "ntsm_tpu_torch" in capsys.readouterr().err


def test_port_imports_no_jax():
    """Every module of the port imports without jax or ntsm_tpu, and
    without pandas or sklearn, which the card machine lacks."""
    code = (
        "import pkgutil, sys, ntsm_tpu_torch\n"
        "for m in pkgutil.walk_packages(ntsm_tpu_torch.__path__, 'ntsm_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ntsm_tpu', 'pandas', 'sklearn'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, alone):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


STOP_CHILDREN_SCRIPT = """
import json, multiprocessing, subprocess, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke


def square(x):
    return x * x


def phase():
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.map(square, [3])


if __name__ == "__main__":
    subreaper = chip_smoke.become_subreaper()
    assert phase() == [9]
    subprocess.run(["sh", "-c", "sleep 60 & echo $!"], check=True, stdout=sys.stderr)
    tracker = multiprocessing.resource_tracker._resource_tracker._pid
    left = chip_smoke.stop_children()
    print(json.dumps(dict(subreaper=subreaper, tracker=tracker, left=left,
                          children=chip_smoke.child_pids())))
"""


def test_chip_smoke_stops_what_it_started(tmp_path):
    """chip_smoke.stop_children ends the spawn pool's resource tracker (it
    outlives the pool and ignores SIGTERM) and an orphan of a child (this
    process is its subreaper), and reaps both: nothing outlives the run."""
    script = tmp_path / "run.py"
    script.write_text(STOP_CHILDREN_SCRIPT)
    res = subprocess.run([sys.executable, str(script), str(ROOT)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    orphan = int(res.stderr.split()[0])
    assert out["subreaper"] and out["tracker"] is not None
    assert not os.path.exists(f"/proc/{out['tracker']}")
    assert [x.split(" ", 1) for x in out["left"]] == [[str(orphan), "sleep 60"]]
    assert not os.path.exists(f"/proc/{orphan}")
    assert out["children"] == []
    assert "leaked" not in res.stderr
