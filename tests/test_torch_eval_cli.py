"""The port's ``eval`` CLI on --device cpu: stdout byte-equal to the
reference fixtures with both engines (-p, its single-sample PC columns and
-b included), the merge files, the JAX CLI's error texts, the loaders
against the JAX package's, the `auto` engine, and no silent move to the
CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntsm_tpu.cli import eval_cmd as jax_eval_cmd
from ntsm_tpu.eval.model import load_count_data as jax_load_count_data
from ntsm_tpu.io.countfile import load_count_files as jax_load_count_files
from ntsm_tpu.options import Options as JOptions
from ntsm_tpu_torch.cli import eval_cmd, main
from ntsm_tpu_torch.eval.model import load_count_data
from ntsm_tpu_torch.io.countfile import format_counts, load_count_planes
from ntsm_tpu_torch.options import Options

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
COUNT_FILES = [
    "sampleA_counts.txt",
    "sampleA2_counts.txt",
    "sampleB_counts.txt",
    "sampleC_counts.txt",
    "sampleLow_counts.txt",
]
# tests/test_parity_eval.py:CASES as command lines
CASES = {
    "eval_default.tsv": [],
    "eval_all.tsv": ["-a"],
    "eval_all_c2.tsv": ["-a", "-c", "2"],
    "eval_all_noskew.tsv": ["-a", "-w", "0"],
    "eval_all_g.tsv": ["-a", "-g", "80000"],
}
ENGINES = ["cuda", "exact"]
PCA = ["-d", "5", "-p", "rotation.tsv", "-n", "center.txt"]
# tests/test_parity_eval.py's -p cases as command lines
PCA_CASES = {
    "eval_pca.tsv": ["-a", *PCA, *COUNT_FILES],
    "eval_single_pca.tsv": [*PCA, "sampleA_counts.txt"],
}


def _run(argv, capsys, mod=eval_cmd):
    rc = mod.run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fixture", sorted(CASES))
def test_eval_stdout_matches_fixture(capsys, monkeypatch, fixture, engine):
    monkeypatch.chdir(FIX)
    rc, out, err = _run(["--device", "cpu", "--engine", engine, *CASES[fixture],
                         *COUNT_FILES], capsys)
    assert rc == 0
    assert out == (FIX / fixture).read_text()
    assert "Performing all-to-all score computation." in err and "Time:" in err


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fixture", ["eval_default.tsv", "eval_all.tsv"])
def test_eval_without_native_library_matches_fixture(capsys, monkeypatch, fixture, engine):
    """The Python paths (count parse, exact pair loop, row formatting) that
    run when the host library cannot be built print the same bytes."""
    from ntsm_tpu_torch import native

    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.chdir(FIX)
    rc, out, _ = _run(["--device", "cpu", "--engine", engine, *CASES[fixture],
                       *COUNT_FILES], capsys)
    assert rc == 0
    assert out == (FIX / fixture).read_text()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fixture", sorted(PCA_CASES))
def test_eval_pca_matches_fixture(capsys, monkeypatch, fixture, engine):
    monkeypatch.chdir(FIX)
    rc, out, err = _run(["--device", "cpu", "--engine", engine, *PCA_CASES[fixture]], capsys)
    assert rc == 0
    assert out == (FIX / fixture).read_text()
    assert "all-to-all" not in err


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_pca_without_native_library_matches_fixture(capsys, monkeypatch, engine):
    """The Python projection, exact pair loop and row formatting print the
    same -p table as the host library."""
    from ntsm_tpu_torch import native

    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.chdir(FIX)
    rc, out, _ = _run(["--device", "cpu", "--engine", engine, *PCA_CASES["eval_pca.tsv"]],
                      capsys)
    assert rc == 0
    assert out == (FIX / "eval_pca.tsv").read_text()


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_debug_matches_fixture(capsys, monkeypatch, engine):
    """-b: the reference's header and its rows once sorted (the reference
    iterates a hash set; tests/test_parity_eval.py:74-92)."""
    monkeypatch.chdir(FIX)
    rc, out, _ = _run(["--device", "cpu", "--engine", engine, *PCA, "-b", "debug_groups.txt",
                       *COUNT_FILES], capsys)
    assert rc == 0
    got = out.splitlines()
    want = (FIX / "eval_debug.tsv").read_text().splitlines()
    assert got[0] == want[0]
    assert sorted(got[1:]) == sorted(want[1:])


def test_debug_with_all_exits_1_after_header(capsys, monkeypatch):
    """-b -a: the header, then exit 1, as the JAX CLI (and the reference)."""
    monkeypatch.chdir(FIX)
    argv = ["--engine", "exact", "-a", *PCA, "-b", "debug_groups.txt", *COUNT_FILES]
    with pytest.raises(SystemExit) as want_exit:
        jax_eval_cmd.run(argv)
    want = capsys.readouterr()
    with pytest.raises(SystemExit) as got_exit:
        eval_cmd.run(["--device", "cpu", *argv[2:]])
    got = capsys.readouterr()
    assert got_exit.value.code == want_exit.value.code == 1
    assert got.out == want.out and got.out.startswith("sample1\t")
    assert got.out.rstrip("\n").endswith("\tcorrect") and got.out.count("\n") == 1
    assert "Currently unable to output all pairs in debug mode." in got.err


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_single_matches_fixture(capsys, monkeypatch, engine):
    monkeypatch.chdir(FIX)
    rc, out, _ = _run(["--device", "cpu", "--engine", engine, "sampleA_counts.txt"], capsys)
    assert rc == 0
    assert out == (FIX / "eval_single.tsv").read_text()


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_merge_matches_fixtures(capsys, monkeypatch, tmp_path, engine):
    monkeypatch.chdir(FIX)
    merged = tmp_path / "merged.txt"
    rc, out, err = _run(["--device", "cpu", "--engine", engine, "-o", "-e", str(merged),
                         *COUNT_FILES[:2]], capsys)
    assert rc == 0
    assert out == (FIX / "eval_merge_stdout.txt").read_text()
    assert merged.read_text() == (FIX / "merged_counts.txt").read_text()
    assert "only merging" in err


def test_eval_all_and_merge_in_one_run(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(FIX)
    merged = tmp_path / "merged.txt"
    rc, out, _ = _run(["--device", "cpu", "--engine", "cuda", "-a", "-e", str(merged),
                       *COUNT_FILES[:2]], capsys)
    assert rc == 0
    assert merged.read_text() == (FIX / "merged_counts.txt").read_text()
    assert out.splitlines()[1] == (FIX / "eval_all.tsv").read_text().splitlines()[1]


def test_python_m_entry_point():
    """`python -m ntsm_tpu_torch eval` prints the fixture, as a user runs it."""
    res = subprocess.run(
        [sys.executable, "-m", "ntsm_tpu_torch", "eval", "--device", "cpu",
         "--engine", "cuda", "-a", *COUNT_FILES],
        cwd=FIX, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout == (FIX / "eval_all.tsv").read_text()


def _error_cases(tmp_path):
    return {
        "no_input": ["-a"],
        "missing_file": ["missing_counts.txt", str(FIX / "sampleA_counts.txt")],
        "bad_flag": ["--bogus", str(FIX / "sampleA_counts.txt")],
        "pca_without_norm": ["-a", "-p", "rot.tsv", str(FIX / "sampleA_counts.txt"),
                             str(FIX / "sampleB_counts.txt")],
    }


@pytest.mark.parametrize("case", ["no_input", "missing_file", "bad_flag", "pca_without_norm"])
def test_eval_errors_match_jax_cli(capsys, tmp_path, case):
    argv = _error_cases(tmp_path)[case]
    want = _run(argv, capsys, mod=jax_eval_cmd)
    got = _run(argv, capsys)
    assert want[0] == 1
    assert got == want


def test_only_merge_without_merge_matches_jax_cli(capsys):
    argv = ["--engine", "exact", "-o", str(FIX / "sampleA_counts.txt"),
            str(FIX / "sampleB_counts.txt")]
    with pytest.raises(SystemExit) as want_exit:
        jax_eval_cmd.run(argv)
    want = capsys.readouterr()
    with pytest.raises(SystemExit) as got_exit:
        eval_cmd.run(argv)
    got = capsys.readouterr()
    assert got_exit.value.code == want_exit.value.code == 1
    assert (got.out, got.err) == (want.out, want.err)
    assert "cannot be used without --merge" in got.err


def test_bad_engine_and_device(capsys):
    args = [str(FIX / "sampleA_counts.txt"), str(FIX / "sampleB_counts.txt")]
    for extra in (["--engine", "tpu"], ["--device", "tpu"]):
        rc, out, err = _run([*extra, *args], capsys)
        assert rc == 1 and out == "" and "must be one of" in err


def test_device_cuda_without_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [str(FIX / "sampleA_counts.txt"), str(FIX / "sampleB_counts.txt")]
    rc, out, err = _run(["--engine", "cuda", "-a", *args], capsys)
    assert rc == 1
    assert out == ""  # nothing was scored, on the CPU or elsewhere
    assert "--device cuda needs a CUDA device" in err
    # auto is the card's engine wherever pairs are scored, at any size
    for flags in (["-a"], [], ["-a", "-p", str(FIX / "rotation.tsv"), "-n",
                               str(FIX / "center.txt"), "-d", "5"]):
        rc, out, err = _run([*flags, *args], capsys)
        assert rc == 1 and out == "", flags
        assert "--device cuda needs a CUDA device" in err
    # single-sample QC does no device work: no card needed
    rc, out, _ = _run([args[0]], capsys)
    assert rc == 0 and out.startswith("sample\tcov\t")


def test_auto_engine_resolves_to_cuda(capsys, monkeypatch):
    """--engine auto runs the device engine for -a, the default all-vs-all
    and -p, and the exact engine where no pairs are scored (one file,
    --only_merge, -b)."""
    from ntsm_tpu_torch.eval import driver

    seen = []
    monkeypatch.setattr(driver, "run_eval",
                        lambda data, opts, out, device="cuda": seen.append((opts.engine, device)))
    monkeypatch.chdir(FIX)
    cases = {
        "cuda": [["-a", *COUNT_FILES], COUNT_FILES, ["-a", *PCA, *COUNT_FILES]],
        "exact": [COUNT_FILES[:1], ["-o", "-e", "unused.txt", *COUNT_FILES[:2]],
                  [*PCA, "-b", "debug_groups.txt", *COUNT_FILES]],
    }
    for engine, argvs in cases.items():
        for argv in argvs:
            seen.clear()
            assert _run(["--device", "cpu", *argv], capsys)[0] == 0
            assert seen == [(engine, "cpu")], (argv, seen)
    assert not hasattr(eval_cmd, "AUTO_EXACT_MAX")


def test_main_dispatches_eval(capsys, monkeypatch):
    monkeypatch.chdir(FIX)
    assert main(["eval", "--device", "cpu", "-a", *COUNT_FILES]) == 0
    assert capsys.readouterr().out == (FIX / "eval_all.tsv").read_text()
    assert main(["eval", "--version"]) == 0
    assert "ntsm_tpu_torch" in capsys.readouterr().err


def test_loaders_match_jax(tmp_path):
    """load_count_data against the JAX package's on the fixtures, and the
    id-mapped fill of load_count_planes against the JAX package's
    per-file loader: a file with reordered loci, and that file beside one
    with a count beyond int32."""
    paths = [str(FIX / f) for f in COUNT_FILES]
    for mc in (0, 1, 2):
        got = load_count_data(paths, Options(min_cov=mc))
        want = jax_load_count_data(paths, JOptions(min_cov=mc, engine="exact"))
        np.testing.assert_array_equal(got.max_counts, want.max_counts)
        np.testing.assert_array_equal(got.sum_counts, want.sum_counts)
        for key in ("cov", "error_rate", "hets", "homs", "miss", "total_counts"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
        assert got.locus_ids == want.locus_ids

    # a file whose loci come in another order, and one past int32
    lines = (FIX / "sampleB_counts.txt").read_text().splitlines(keepends=True)
    head = [ln for ln in lines if ln.startswith("#") or not ln.strip()]
    rows = [ln for ln in lines if ln not in head]
    shuffled = tmp_path / "shuffled_counts.txt"
    shuffled.write_text("".join(head) + "".join(rows[::-1]))
    big = tmp_path / "big_counts.txt"
    f0 = rows[0].split("\t")
    big.write_text("".join(head) + "\t".join([f0[0], str(2**33), *f0[2:]]) + "".join(rows[1:]))
    for extra in ([str(shuffled)], [str(shuffled), str(big)]):
        files = paths[:2] + extra
        got = load_count_data(files, Options())
        want = jax_load_count_data(files, JOptions(engine="exact"))
        np.testing.assert_array_equal(got.max_counts, want.max_counts)
        np.testing.assert_array_equal(got.sum_counts, want.sum_counts)
        np.testing.assert_array_equal(got.cov, want.cov)
        g_ids, g_dist, g_mc, g_sc, g_tks, g_kss = load_count_planes(files)
        w_ids, w_dist, w_files = jax_load_count_files(files)
        assert g_ids == w_ids
        np.testing.assert_array_equal(g_dist, w_dist)
        np.testing.assert_array_equal(g_mc, np.stack([w.max_counts for w in w_files]))
        np.testing.assert_array_equal(g_sc, np.stack([w.sum_counts for w in w_files]))
        assert (list(g_tks), list(g_kss), list(g_mc.sum(axis=(1, 2)))) == (
            [w.raw_total_kmers for w in w_files], [w.k for w in w_files],
            [w.total_counts for w in w_files])


def test_format_counts_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    ids = [f"rs{i}" for i in range(50)]
    mx = rng.integers(0, 90, size=(50, 2))
    text = format_counts(ids, mx, mx * 7, np.full((50, 2), 13), 12345, 19)
    p = tmp_path / "a_counts.txt"
    p.write_text(text)
    got = load_count_data([str(p), str(p)], Options())
    np.testing.assert_array_equal(got.max_counts[1], mx)
    np.testing.assert_array_equal(got.sum_counts[0], mx * 7)
    assert list(got.raw_total_kmers) == [12345, 12345] and list(got.ks) == [19, 19]
