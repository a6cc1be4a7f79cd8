"""The count-file load of `ntsm eval` (eval/model.py:load_count_data over
io/countfile.py) against the benchmark's plain reader and scorer
(portbench/ref_countfile.py, portbench/ref_eval.py) on seeded count files:
the native path, a file whose loci come in another order (the id-mapped
fill), a value past int32 in a later file and in the first (the planes
widened to int64) and files without #@ headers (as `ntsm vcf` writes
them); the loader's counters, each file read once; the load's and the
prepare's spans in a profiled run; the CLI's stdout with the recorder on
and off."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntsm_tpu_torch import api
from ntsm_tpu_torch.cli import eval_cmd
from ntsm_tpu_torch.eval.model import load_count_data
from ntsm_tpu_torch.io import countfile
from ntsm_tpu_torch.io.countfile import format_counts
from ntsm_tpu_torch.options import Options
from portbench import ref_countfile, ref_eval, tracefile

torch.set_num_threads(1)

N, L = 8, 300
CASES = ("native", "reordered", "int64", "first_int64", "no_headers")
REORDERED = 5  # the file whose loci are shuffled
BIG = {"int64": 4, "first_int64": 0}  # the file with a sum past int32
FLOATS = ("score", "relate", "homConcord", "cov1", "cov2", "errorRate1", "errorRate2")
INTS = ("ibs0", "ibs2", "het1", "het2", "sharedHet", "hom1", "hom2", "sharedHom", "n",
        "miss1", "miss2", "allHom1", "allHom2", "allHet1", "allHet2")


def write_cohort(directory, case: str) -> list:
    """N count files of L loci, drawn from a fixed seed: diploid genotypes
    at random allele frequencies, Poisson counts around each sample's
    depth, sample 1 sample 0's genotypes, some loci missed."""
    rng = np.random.default_rng(19)
    freq = rng.uniform(0.05, 0.95, L)
    geno = (rng.random((N, L)) < freq).astype(int) + (rng.random((N, L)) < freq)
    geno[1] = geno[0]
    lam = rng.uniform(6, 20, N)[:, None] / 2
    mx = np.stack([rng.poisson(lam * (2 - geno)), rng.poisson(lam * geno)], axis=2)
    mx += rng.poisson(0.2, mx.shape)
    mx[rng.random((N, L)) < 0.05] = 0
    sums = mx * rng.integers(9, 14, (1, L, 1))
    distinct = rng.integers(10, 14, (L, 2))
    ids = [f"rs{7000 + 3 * i}" for i in range(L)]
    paths = []
    for s in range(N):
        order = np.arange(L)
        if case == "reordered" and s == REORDERED:
            order = rng.permutation(L)
        sm = sums[s].copy()
        if s == BIG.get(case):
            sm[7, 0] = 2**31 + 12345
        tk, k = (None, None) if case == "no_headers" else (int(mx[s].sum()) * 37000, 19)
        text = format_counts([ids[i] for i in order], mx[s][order], sm[order], distinct[order],
                             tk, k)
        path = os.path.join(directory, f"sample{s}_counts.txt")
        with open(path, "w") as fh:
            fh.write(text)
        paths.append(path)
    return paths


def plain_columns(paths, opts: Options):
    """(ref_countfile's cohort, ref_eval's sample columns) of the files."""
    c = ref_countfile.read_cohort(paths)
    cols = ref_eval.sample_columns(c.max_counts, c.sum_counts.sum(axis=(1, 2)), c.total_kmers,
                                   c.ks, float(c.distinct.sum()), float(opts.genome_size),
                                   opts.min_cov)
    return c, cols


def cli(argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = eval_cmd.run(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", CASES)
def test_load_equals_the_plain_reader(case, tmp_path):
    paths = write_cohort(tmp_path, case)
    opts = Options()
    got = load_count_data(paths, opts)
    c, cols = plain_columns(paths, opts)
    assert got.locus_ids == [x.decode() for x in c.locus_ids]
    np.testing.assert_array_equal(got.distinct, c.distinct)
    np.testing.assert_array_equal(got.max_counts, c.max_counts)
    np.testing.assert_array_equal(got.sum_counts, c.sum_counts)
    np.testing.assert_array_equal(got.raw_total_kmers, c.total_kmers)
    np.testing.assert_array_equal(got.ks, c.ks)
    np.testing.assert_array_equal(got.total_counts, c.totals)
    for key, ref_key in (("hets", "hets"), ("homs", "homs"), ("miss", "miss")):
        np.testing.assert_array_equal(getattr(got, key), cols[ref_key])
    np.testing.assert_allclose(got.cov, cols["cov"], rtol=1e-15)
    np.testing.assert_allclose(got.error_rate, cols["error_rate"], rtol=1e-13)
    assert (got.error_rate == -1.0).all() == (case == "no_headers")
    if case in BIG:
        assert got.sum_counts.dtype == np.int64 and got.sum_counts[BIG[case], 7, 0] == 2**31 + 12345
    else:
        assert got.max_counts.dtype == got.sum_counts.dtype == np.int32


@pytest.mark.parametrize("case", CASES)
def test_cli_table_equals_the_plain_scorer(case, tmp_path):
    """Every row of `eval -a` (the device engine's plain versions) against
    ref_eval on ref_countfile's counts: the pair's place and names, every
    integer column, `same`, and each float within half a unit of its sixth
    printed decimal (and 1e-9 of the f64 value beyond it)."""
    paths = write_cohort(tmp_path, case)
    opts = Options()
    text, _ = cli(["--device", "cpu", "-a", *paths])
    lines = text.splitlines()
    assert len(lines) == 1 + N * (N - 1) // 2
    header = lines[0].split("\t")
    ii, jj = np.triu_indices(N, 1)
    c, cols = plain_columns(paths, opts)
    s = ref_eval.pair_stats(torch.from_numpy(c.max_counts), ii, jj, cols["cov"], opts.min_cov,
                            opts.cov_skew)
    for p, line in enumerate(lines[1:]):
        row = dict(zip(header, line.split("\t")))
        i, j = int(ii[p]), int(jj[p])
        want = dict(score=s["score"][p], relate=s["relate"][p], homConcord=s["homc"][p],
                    cov1=cols["cov"][i], cov2=cols["cov"][j], errorRate1=cols["error_rate"][i],
                    errorRate2=cols["error_rate"][j], ibs0=s["ibs0"][p], ibs2=s["ibs2"][p],
                    het1=s["hets1"][p], het2=s["hets2"][p], sharedHet=s["shet"][p],
                    hom1=s["homs1"][p], hom2=s["homs2"][p], sharedHom=s["shom"][p], n=s["n"][p],
                    miss1=cols["miss"][i], miss2=cols["miss"][j], allHom1=cols["homs"][i],
                    allHom2=cols["homs"][j], allHet1=cols["hets"][i], allHet2=cols["hets"][j])
        assert (row["sample1"], row["sample2"], row["dist"]) == (paths[i], paths[j], "-1")
        assert row["same"] == ("1" if want["score"] < opts.score_thresh else "0")
        assert {k: int(row[k]) for k in INTS} == {k: int(want[k]) for k in INTS}
        for k in FLOATS:
            e = float(want[k])
            assert abs(float(row[k]) - e) <= 5e-7 + 1e-9 * max(1.0, abs(e)), (p, k, row[k], e)
    # the duplicate pair (0, 1) is the one pair called the same
    assert [ln.split("\t")[3] for ln in lines[1:]].count("1") >= 1
    assert lines[1].split("\t")[3] == "1"


@pytest.mark.parametrize("case", CASES)
def test_counters_match_the_files(case, tmp_path):
    paths = write_cohort(tmp_path, case)
    sizes = [os.path.getsize(p) for p in paths]
    before = dict(countfile.counters)
    load_count_data(paths, Options())
    got = {k: countfile.counters[k] - before[k] for k in before}
    # every file read once; the id-mapped fill takes the reordered file and
    # the file with the value past int32
    want = dict(files=N, bytes=sum(sizes), exact_files=int(case in ("reordered", *BIG)))
    assert got == want


def _spans(t: tracefile.Trace, name: str) -> list:
    return [(s, e) for n, s, e, _ in t.spans if n == name]


@pytest.mark.parametrize("entry", ["cli", "evaluate", "merge_counts"])
@pytest.mark.parametrize("case", ["native", "reordered", "int64"])
def test_profiled_load_has_nested_spans(entry, case, tmp_path):
    """Under torch.profiler the CLI, api.evaluate and api.merge_counts
    open ntsm.eval.load with a .load.read and a .load.parse inside it for
    every file read, then ntsm.eval.prepare after it, with no recorder
    handed to them."""
    paths = write_cohort(tmp_path, case)
    before = dict(countfile.counters)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if entry == "cli":
            cli(["--device", "cpu", "-a", *paths])
        elif entry == "evaluate":
            with contextlib.redirect_stderr(io.StringIO()):
                api.evaluate(paths, device="cpu")
        else:
            api.merge_counts(paths, str(tmp_path / "merged_counts.txt"))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    t = tracefile.load(path)
    (load,) = _spans(t, "ntsm.eval.load")
    (prep,) = _spans(t, "ntsm.eval.prepare")
    assert load[1] <= prep[0]
    reads = _spans(t, "ntsm.eval.load.read")
    parses = _spans(t, "ntsm.eval.load.parse")
    assert len(reads) == countfile.counters["files"] - before["files"]
    assert len(parses) >= len(reads)
    for s, e in reads + parses:
        assert load[0] <= s <= e <= load[1]


@pytest.mark.parametrize("flags", [["-a"], []])
def test_cli_stdout_is_the_same_with_the_recorder_on(flags, tmp_path):
    paths = write_cohort(tmp_path, "reordered")
    argv = ["--device", "cpu", *flags, *paths]
    plain, _ = cli(argv)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _ = cli(argv)
    assert traced == plain and plain.count("\n") >= 2
