"""The port's ``vcf`` (ntsm_tpu_torch/vcf/convert.py, cli/vcf_cmd.py)
against the JAX package's on the same seeded files: the reference fixtures
byte for byte, the long-double center format string for string, and
seeded worlds (overlapping sites, odd genotype fields, multi wraparound,
k, window, -d, -v) with every output file and the stderr text
byte-identical."""

import io
import os
import pathlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from ntsm_tpu.io.sites import load_site_table as jax_load_site_table
from ntsm_tpu.options import Options as JaxOptions
from ntsm_tpu.vcf.convert import VCFConverter as JaxVCFConverter
from ntsm_tpu.vcf.convert import _format_longdouble_g as jax_format_longdouble_g
from ntsm_tpu_torch.cli import vcf_cmd
from ntsm_tpu_torch.io.sites import load_site_table
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.vcf.convert import VCFConverter, _format_longdouble_g, x87_quotient
from tests.synth import make_site_fasta

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    opts = Options(
        snp=str(FIX / "vcf_sites.fa"), ref=str(FIX / "vcf_genome.fa"), k=19, window=31
    )
    table = load_site_table(opts.snp, opts.k, allow_dupes=False)
    conv = VCFConverter(table, opts)
    conv.count(str(FIX / "multi.vcf"))
    out = tmp_path_factory.mktemp("vcf")
    conv.output_matrix(str(out / "vcfout"))
    return conv, out


@pytest.mark.parametrize("name", ["vcfout_matrix.tsv", "vcfout_center.txt"])
def test_fixture_byte_parity(converted, name):
    _, out = converted
    assert (out / name).read_bytes() == (FIX / name).read_bytes()


def test_output_counts_roundtrip(converted, tmp_path):
    """Count files written by --output-counts read back through the port's
    loader and hold genotype-consistent values (multi for het, 2*multi for
    hom)."""
    from ntsm_tpu_torch.eval.model import load_count_data
    from ntsm_tpu_torch.io.countfile import load_count_planes

    conv, _ = converted
    conv.output_counts(str(tmp_path))
    paths = [str(tmp_path / f"{sid}.counts.txt") for sid in conv.sample_ids]
    locus_ids, distinct, mc, sc, tks, kss = load_count_planes(paths)
    assert locus_ids == conv.table.site_ids
    assert set(np.unique(mc)) <= {0, 20, 40}
    data = load_count_data(paths, Options())
    np.testing.assert_array_equal(data.max_counts, mc)


def test_cli_fixture_byte_parity(tmp_path, capsys):
    prefix = str(tmp_path / "out")
    rc = vcf_cmd.run(["-p", prefix, "-s", str(FIX / "vcf_sites.fa"),
                      "-r", str(FIX / "vcf_genome.fa"), str(FIX / "multi.vcf")])
    assert rc == 0
    for name in ("matrix.tsv", "center.txt"):
        assert pathlib.Path(f"{prefix}_{name}").read_bytes() == (FIX / f"vcfout_{name}").read_bytes()
    assert capsys.readouterr().err.startswith("Time: ")


# ---------------------------------------------------------------- long double


def _as_fraction(x: np.longdouble) -> Fraction:
    return Fraction(*x.as_integer_ratio())


def jax_g(x: np.longdouble) -> str:
    """The JAX package's %.19Lg, in C's form: where the 19 rounded digits
    are one digit and zeros in the scientific range (x within 5e-19
    relative of d * 10^e, e < -4 or >= 19), numpy prints the mantissa as
    "d." ("1.e-06") and C's %g, which the port follows, as "d" ("1e-06")."""
    return jax_format_longdouble_g(x).replace(".e", "e")


def _edges() -> list:
    """Long doubles next to the powers of ten where %.19Lg switches form or
    rounds up a digit (9.99...e-5 -> 0.0001), ties at the 20th digit, and
    the extremes of the centers' range."""
    out = []
    for e in (-6, -5, -4, -3, -1, 0, 1, 17, 18, 19, 20):
        p = np.longdouble(10) ** e
        for steps in range(-3, 4):
            x = p
            for _ in range(abs(steps)):
                x = np.nextafter(x, np.longdouble(0) if steps < 0 else np.longdouble(np.inf))
            out.append(x)
    for e in (28, 31, 33, 40):  # 2^-e has > 19 digits ending in 5: exact ties
        out += [np.longdouble(2) ** -e, np.longdouble(3) * np.longdouble(2) ** -e]
    out += [np.longdouble(1) / np.longdouble(n) for n in (3, 6, 7, 9, 11, 3202)]
    return out


def test_longdouble_format_edges():
    for x in _edges():
        assert _format_longdouble_g(_as_fraction(x)) == jax_g(x), x
    for v in (0.0, -0.0, float("inf"), float("-inf"), float("nan"), -float("nan"), 0.5, 1e300):
        assert _format_longdouble_g(v) == jax_g(np.longdouble(v)), v
    assert _format_longdouble_g(_as_fraction(np.longdouble(10) ** -6)) == "1e-06"
    assert _format_longdouble_g(Fraction(10**19)) == "1e+19"


def test_longdouble_format_seeded():
    """2,000 centers sum / n as x87 divides them, and 2,000 long doubles
    of any magnitude, string-equal to the JAX package's %.19Lg (numpy's
    longdouble is the x87 80-bit format on x86-64, where this runs)."""
    assert np.finfo(np.longdouble).nmant == 63
    rng = np.random.default_rng(20261017)
    n = rng.integers(1, 3300, 2000)
    ssum = rng.random(2000) * n
    ssum[::7] = np.round(ssum[::7] * 4) / 4  # sums of halves and quarters
    for s, k in zip(ssum.tolist(), n.tolist()):
        want = jax_g(np.longdouble(s) / np.longdouble(k))
        assert _format_longdouble_g(x87_quotient(s, k)) == want, (s, k)
    mant = rng.integers(1, 2**63, 2000, dtype=np.int64)
    exps = rng.integers(-90, 90, 2000)
    for m, e in zip(mant.tolist(), exps.tolist()):
        x = np.longdouble(m) * np.longdouble(2) ** (e - 62) * (1 if m % 3 else -1)
        assert _format_longdouble_g(_as_fraction(x)) == jax_g(x), x


def test_x87_quotient_rounds_half_to_even():
    # (2^64 + 1) / 2 and (2^64 + 3) / 2 lie halfway between two 64-bit
    # significands (a double over an integer never does): to the even one
    assert x87_quotient(Fraction(2**64 + 1), 2) == 2**63
    assert x87_quotient(Fraction(2**64 + 3), 2) == 2**63 + 2
    assert x87_quotient(Fraction(2**64 + 5), 2) == 2**63 + 2
    third = x87_quotient(1.0, 3)
    assert third.denominator == 2**65 and third.numerator == (2**65 + 1) // 3
    assert x87_quotient(0.0, 5) == 0 and x87_quotient(-1.0, 3) == -third


def test_genotype_fast_path_alignment_guard():
    """Mixed-width genotype fields whose total width lands on 4n-1 must NOT
    take the fast path (they'd misalign); reference semantics default them
    to hom-ref unless the exact 3-char strings match."""
    conv = VCFConverter.__new__(VCFConverter)  # only _parse_genotypes needed
    assert list(conv._parse_genotypes("0|1:7\t1", 2)) == [0, 0]  # len 7 == 4*2-1
    assert list(conv._parse_genotypes("0|1\t1|1", 2)) == [1, 2]
    jax = JaxVCFConverter.__new__(JaxVCFConverter)
    rng = np.random.default_rng(3)
    pool = ["0|0", "0|1", "1|0", "1|1", "./.", "0/1", "0", "1", "0|1:7", ".|.", "1|2"]
    for _ in range(300):
        n = int(rng.integers(1, 9))
        tail = "\t".join(rng.choice(pool[: 4 if rng.random() < 0.5 else len(pool)], n))
        np.testing.assert_array_equal(conv._parse_genotypes(tail, n),
                                      jax._parse_genotypes(tail, n))


# ---------------------------------------------------------------- worlds

GT_PHASED = ["0|0", "0|1", "1|0", "1|1"]
GT_ODD = ["./.", "0/1", "1/1", "0", "1", ".|.", "0|1:35", "1|1:12:7"]


def make_world(seed: int, tmp_path: pathlib.Path) -> dict:
    """A genome (lowercase runs, Ns), a site FASTA over some of its SNPs
    (whole windows or sub-k-mers joined by N, either allele first, some
    sites overlapping), and a multi-sample VCF over those SNPs plus rows the
    converter skips or cannot place."""
    rng = np.random.default_rng(1000 + seed)
    k = int(rng.integers(11, 33))
    window = int(rng.integers(max(21, k), 42))
    n_samples = [0, 1, 3, 8, 17, 40][seed % 6]
    multi = [20, 127, 200][seed % 3]
    dupes = seed % 4 == 1
    verbose = seed % 5
    genome = bytearray(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 6000)].tobytes())
    for _ in range(3):
        s = int(rng.integers(0, 5900))
        genome[s : s + 30] = genome[s : s + 30].lower()
    genome[int(rng.integers(200, 5800))] = ord("N")
    half = window // 2
    positions, p = [], 100
    while p < 5800:
        positions.append(p)
        # a fifth of the SNPs sit close to the previous one: overlapping windows
        p += int(rng.integers(2, 6)) if rng.random() < 0.2 else int(rng.integers(window + 5, 120))
    site_lines, vcf_rows = [], []
    for i, pos in enumerate(positions):
        ref = chr(genome[pos - 1]).upper()
        alt = "ACGT"[(("ACGT".index(ref) if ref in "ACGT" else 0) + int(rng.integers(1, 4))) % 4]
        win = bytes(genome[pos - 1 - half : pos + half]).upper()
        var = win[:half] + alt.encode() + win[half + 1 :]
        entries = [win, var] if rng.random() < 0.5 else [var, win]
        if rng.random() < 0.5:
            entries = [b"N".join(e[j : j + k] for j in range(len(e) - k + 1)) for e in entries]
        rsid = f"rs{i}" if rng.random() < 0.9 else "."
        site_lines += [f">{rsid} ref\n{entries[0].decode()}\n", f">{rsid} var\n{entries[1].decode()}\n"]
        pool = GT_PHASED + (GT_ODD if seed % 3 == 2 else [])
        gts = "\t".join(rng.choice(pool, n_samples)) if n_samples else ""
        cols = ["chr1", str(pos), rsid, ref, alt, ".", "PASS", ".", "GT"]
        vcf_rows.append("\t".join(cols + ([gts] if n_samples else [])))
        if rng.random() < 0.05:  # skipped rows: REF ".", multi-base ALT
            vcf_rows.append("\t".join(["chr1", str(pos), "x", ".", alt, ".", ".", ".", "GT"]
                                      + ([gts] if n_samples else [])))
            vcf_rows.append("\t".join(["chr1", str(pos), "y", ref, alt + "A", ".", ".", ".", "GT"]
                                      + ([gts] if n_samples else [])))
    if seed % 7 == 3:  # a row whose window leaves the chromosome ends the run
        vcf_rows.insert(len(vcf_rows) // 2, "\t".join(["chr1", "3", "edge", "A", "C", ".", ".", ".",
                                                       "GT"] + ["0|1"] * n_samples))
    (tmp_path / "genome.fa").write_text(">chr1 test\n" + genome.decode() + "\n")
    (tmp_path / "sites.fa").write_text("".join(site_lines))
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
    header += "".join(f"\tS{j}" for j in range(n_samples))
    (tmp_path / "multi.vcf").write_text(
        "##fileformat=VCFv4.2\n##source=test\n" + header + "\n" + "\n".join(vcf_rows) + "\n")
    return dict(k=k, window=window, multi=multi, dupes=dupes, verbose=verbose,
                n_samples=n_samples)


def run_converter(pkg: str, world: dict, tmp_path: pathlib.Path) -> dict:
    """Every output of one package's converter on the world: stderr, the
    matrix, the exception (if any), and the matrix/center and count files."""
    Opts, load, Conv = ((Options, load_site_table, VCFConverter) if pkg == "port"
                        else (JaxOptions, jax_load_site_table, JaxVCFConverter))
    err = io.StringIO()
    opts = Opts(snp=str(tmp_path / "sites.fa"), ref=str(tmp_path / "genome.fa"),
                k=world["k"], window=world["window"], multi=world["multi"],
                dupes=world["dupes"], verbose=world["verbose"])
    table = load(opts.snp, opts.k, allow_dupes=opts.dupes, err=err)
    conv = Conv(table, opts, err=err)
    res = {}
    try:
        conv.count(str(tmp_path / "multi.vcf"))
    except IndexError as e:
        res["raised"] = str(e)
    res["mat"] = conv.mat.copy()
    out = tmp_path / pkg
    out.mkdir()
    if "raised" not in res:
        conv.output_counts(str(out))
        try:
            conv.output_matrix(str(out / "m"))
        except SystemExit as e:
            res["exit"] = str(e)
    res["files"] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    res["err"] = err.getvalue()
    return res


@pytest.mark.parametrize("seed", range(24))
def test_converter_matches_jax(seed, tmp_path):
    world = make_world(seed, tmp_path)
    jax = run_converter("jax", world, tmp_path)
    port = run_converter("port", world, tmp_path)
    np.testing.assert_array_equal(port.pop("mat"), jax.pop("mat"))
    assert port == jax
    if world["n_samples"] and "raised" not in jax:
        assert len(jax["files"]) == world["n_samples"] + 2
    if world["dupes"] and world["n_samples"] >= 8 and world["window"] - world["k"] >= 6:
        # overlapping sites share k-mers, which the table keeps (-d): they conflict
        assert "Inconsistent k-mer counts" in jax["err"]


# ---------------------------------------------------------------- CLI errors


def _cli(argv, capsys):
    rc = vcf_cmd.run(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_vcf_missing_site_file(capsys, tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _cli(["-r", str(ref), str(vcf)], capsys)
    assert rc == 1
    assert "Missing variants (-s)" in err


def test_vcf_nonexistent_site_file(capsys, tmp_path):
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _cli(["-s", str(tmp_path / "nope.fa"), "-r", str(ref), str(vcf)], capsys)
    assert rc == 1
    assert "Unable to load variants (-s) file" in err


def test_vcf_missing_ref(capsys, tmp_path):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(np.random.default_rng(1), n_sites=2, path=sites)
    vcf = tmp_path / "a.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n")
    rc, _, err = _cli(["-s", sites, str(vcf)], capsys)
    assert rc == 1
    assert "Unable to load reference file" in err


def test_vcf_no_input(capsys, tmp_path):
    sites = str(tmp_path / "s.fa")
    make_site_fasta(np.random.default_rng(2), n_sites=2, path=sites)
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\nACGT\n")
    rc, _, err = _cli(["-s", sites, "-r", str(ref)], capsys)
    assert rc == 1
    assert "Need Input File" in err


def test_vcf_cli_output_counts_and_version(capsys, tmp_path, monkeypatch):
    """--output-counts writes one count file a sample into the working
    directory, as the JAX CLI does; --version names the port."""
    from ntsm_tpu.cli import vcf_cmd as jax_vcf_cmd

    args = ["--output-counts", "-s", str(FIX / "vcf_sites.fa"), "-r", str(FIX / "vcf_genome.fa"),
            str(FIX / "multi.vcf")]
    got = {}
    for name, mod in (("port", vcf_cmd), ("jax", jax_vcf_cmd)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert mod.run(args) == 0
        got[name] = {p: (tmp_path / name / p).read_bytes() for p in sorted(os.listdir("."))}
    assert got["port"] == got["jax"] and len(got["port"]) > 1
    capsys.readouterr()
    assert vcf_cmd.run(["--version"]) == 0
    assert "ntsm vcf (ntsm_tpu_torch)" in capsys.readouterr().err
