"""The port's ``sitegen`` (ntsm_tpu_torch/sitegen/pipeline.py,
cli/sitegen_cmd.py) against the JAX package's on the same seeded files:
candidates, neighbour sets, the uniqueness filter and the tier files
equal; the PCA within 1e-10 of each column's largest value with the
headers and index byte-identical, against the JAX package's pandas and
sklearn where sklearn's "auto" solver is its exact one, and against
sklearn's exact solver where "auto" would pick the randomized one."""

import io
import pathlib

import numpy as np
import pytest
import torch

from ntsm_tpu.cli import sitegen_cmd as jax_sitegen_cmd
from ntsm_tpu.sitegen import pipeline as jax_pipeline
from ntsm_tpu_torch.cli import sitegen_cmd
from ntsm_tpu_torch.sitegen import pipeline
from tests.synth import random_genome
from tests.test_sitegen_uniqueness import HALF, K, WINDOW, at_cg_alt, oracle_loci, write_world

torch.set_num_threads(1)


def snp_world(seed: int, tmp_path: pathlib.Path, n_snps: int = 14, glen: int = 3000):
    """A genome (two chromosomes, an N) and a SNP VCF with A/T<->C/G SNPs,
    same-group SNPs, a wrong wildtype, '.' IDs, an unknown chromosome and
    edge windows; a quarter of the SNPs copy another SNP's window
    elsewhere, whole or in part, so the uniqueness filter drops k-mers."""
    rng = np.random.default_rng(500 + seed)
    chroms = {"chr1": bytearray(random_genome(rng, glen)), "chr2": bytearray(random_genome(rng, glen // 2))}
    chroms["chr2"][100] = ord("N")
    rows, i = [], 0
    for name, g in chroms.items():
        for pos in range(60, len(g) - 60, len(g) // (n_snps // 2)):
            ref = chr(g[pos - 1])
            if rng.random() < 0.25 and pos + 600 < len(g):
                span = int(rng.integers(K, WINDOW + 1))
                g[pos + 400 : pos + 400 + span] = g[pos - 1 - HALF : pos - 1 - HALF + span]
            kind = rng.random()
            alt = at_cg_alt(ref, rng) if kind < 0.8 else ("A" if ref in "CG" else "T")
            if kind > 0.95 and ref != "N":
                ref = "ACGT"[("ACGT".index(ref) + 1) % 4]  # wildtype does not match
            rid = "." if rng.random() < 0.2 else f"rs{i}"
            rows.append(f"{name}\t{pos}\t{rid}\t{ref}\t{alt}\t.\t.\t.")
            i += 1
    rows.append("chrX\t500\trsX\tA\tC\t.\t.\t.")
    rows.append("chr1\t3\trsEdge\tA\tC\t.\t.\t.")
    ref_path = tmp_path / "genome.fa"
    ref_path.write_text("".join(f">{n}\n{bytes(g).decode()}\n" for n, g in chroms.items()))
    vcf_path = tmp_path / "snps.vcf"
    vcf_path.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                        + "\n".join(rows) + "\n")
    return str(ref_path), str(vcf_path)


def _candidates(sites) -> list:
    return [(s.snp_id, s.chrom, s.pos, s.at_win, s.cg_win, list(s.at_kmers), list(s.cg_kmers))
            for s in sites]


@pytest.mark.parametrize("seed", range(4))
def test_extract_and_filter_match_jax(seed, tmp_path):
    ref, vcf = snp_world(seed, tmp_path)
    for mismatch, indel in ((True, True), (True, False), (False, False)):
        got = {}
        for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
            err = io.StringIO()
            sites = mod.extract_candidates(vcf, ref, err=err)
            cands = _candidates(sites)
            mod.filter_unique(sites, ref, K, mismatch=mismatch, indel=indel, err=err)
            got[name] = (cands, _candidates(sites), err.getvalue())
        assert got["port"] == got["jax"]
        assert got["port"][0] and "Processed" in got["port"][2]
    # the filter dropped something, and kept something
    kept = sum(len(c[5]) + len(c[6]) for c in got["port"][1])
    assert 0 < kept < sum(len(c[5]) + len(c[6]) for c in got["port"][0])


@pytest.mark.parametrize("window,k,mismatch,indel", [(31, 19, 1, 1), (31, 19, 1, 0),
                                                     (25, 15, 1, 1), (35, 21, 0, 0)])
def test_tier_files_match_jax(window, k, mismatch, indel, tmp_path, capsys):
    """`sitegen generate-sites` through both CLIs: the same tier files,
    byte for byte, and the same stderr."""
    ref, vcf = snp_world(window + k, tmp_path)
    out = {}
    for name, mod in (("port", sitegen_cmd), ("jax", jax_sitegen_cmd)):
        (tmp_path / name).mkdir()
        rc = mod.run(["generate-sites", f"name={tmp_path / name / 'w'}", f"ref={ref}", f"vcf={vcf}",
                      f"w={window}", f"k={k}", f"mismatch={mismatch}", f"indel={indel}"])
        assert rc == 0
        out[name] = ({p.name: p.read_bytes() for p in sorted((tmp_path / name).iterdir())},
                     capsys.readouterr().err)
    assert out["port"] == out["jax"]
    files = out["port"][0]
    assert len(files) == window - k + 1
    sizes = [len(files[f"w_n{i}.fa"]) for i in range(window - k + 1)]
    # without the mismatch pass no VAR k-mer (0 exact genome hits) survives
    assert sizes == sorted(sizes) and (sizes[-1] > 0) == bool(mismatch)


def test_generated_sites_count_and_project(rng, tmp_path, monkeypatch):
    """tests/test_sitegen.py's round trips in the port: a het sample's
    reads over the generated tier file cover every site (the golden
    counter), and the PCA files load through eval's -p loaders."""
    from ntsm_tpu_torch.count.golden import count_files
    from ntsm_tpu_torch.eval.pca import load_norm_values, load_rotation
    from ntsm_tpu_torch.io.sites import load_site_table
    from tests.synth import make_reads_fastq
    from tests.test_sitegen import make_world

    ref_path, vcf_path, _ = make_world(rng, tmp_path)
    monkeypatch.chdir(tmp_path)
    sites = pipeline.generate_sites("world", str(ref_path), str(vcf_path), err=io.StringIO())
    table = load_site_table(str(tmp_path / "world_n12.fa"), k=19, allow_dupes=False)
    assert table.n_sites > 0
    site_info = [{"name": s.snp_id, "at_win": s.at_win, "cg_win": s.cg_win}
                 for s in sorted(sites, key=lambda s: s.snp_id) if s.at_kmers and s.cg_kmers]
    make_reads_fastq(rng, site_info, coverage=6, path=str(tmp_path / "reads.fq"))
    mx, _ = count_files(table, [str(tmp_path / "reads.fq")]).site_max_sum(table)
    assert (mx > 0).all()

    pdir = tmp_path / "panel"
    pdir.mkdir()
    genome, snp_sites, multi = panel_world(rng, pdir, 20, 12, 0.0)
    pipeline.generate_pca_rotation("pw", genome, multi, snp_sites, dims=4, err=io.StringIO())
    norm = load_norm_values(str(tmp_path / "pw_center.txt"))
    rot = load_rotation(str(tmp_path / "pw_rotationalMatrix.tsv"), norm.shape[0])
    assert norm.shape == (20,) and rot.shape[0] == 4


@pytest.mark.parametrize("k", [11, 12, 19, 24])
def test_neighbor_sets_match_jax(k):
    rng = np.random.default_rng(k)
    kmers = [bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, k)]) for _ in range(40)]
    kmers.append(b"ACGTTAGCA"[: (k - 1) // 2] + b"A" + b"TGCTAACGT"[-((k - 1) // 2):]
                 if k % 2 else b"A" * k)
    for km in kmers:
        np.testing.assert_array_equal(pipeline.one_mismatch_neighbors(km, k),
                                      jax_pipeline.one_mismatch_neighbors(km, k))
        for got, want in zip(pipeline.indel_neighbors(km, k), jax_pipeline.indel_neighbors(km, k)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pipeline.canonical_codes(km, k),
                                      jax_pipeline.canonical_codes(km, k))
    base = np.stack([np.frombuffer(km, np.uint8) for km in kmers[:40]])
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), base).astype(np.uint64)
    fw = np.zeros(len(codes), np.uint64)
    for j in range(k):
        fw = (fw << np.uint64(2)) | codes[:, j]
    rv = pipeline._revcomp_batch(fw, k)
    np.testing.assert_array_equal(rv, jax_pipeline._revcomp_batch(fw, k))
    for blk in ("_sub_neighbor_block", "_del_neighbor_block", "_ins_neighbor_block"):
        args = (fw, rv, k) if blk == "_sub_neighbor_block" else (fw, k)
        got = getattr(pipeline, blk)(*args)
        np.testing.assert_array_equal(got, getattr(jax_pipeline, blk)(*args))
        mask = pipeline._row_dedup_mask(got.copy())
        np.testing.assert_array_equal(mask, jax_pipeline._row_dedup_mask(got.copy()))


def _engineered(kind: str, rng):
    """The uniqueness tests' worlds (tests/test_sitegen_uniqueness.py): a
    site whose window is copied whole, in part, or with one base deleted or
    inserted elsewhere in the genome, or clean sites at a chromosome edge."""
    genome = bytearray(random_genome(rng, 1600))
    pos = 300
    ref = chr(genome[pos - 1])
    snps = [(pos, ref, at_cg_alt(ref, rng))]
    start = pos - 1 - HALF
    if kind == "whole":
        genome[900 : 900 + WINDOW] = genome[start : start + WINDOW]
    elif kind == "part":
        genome[900 : 900 + K + 3] = genome[start : start + K + 3]
    elif kind in ("deletion", "insertion"):
        km = bytes(genome[start + 2 : start + 2 + K])
        twin = km[:9] + km[10:] if kind == "deletion" else km[:9] + b"G" + km[9:]
        genome[1200 : 1200 + len(twin)] = twin
    else:
        for p in (HALF + 1, 600, 1000):
            snps.append((p, chr(genome[p - 1]), at_cg_alt(chr(genome[p - 1]), rng)))
        snps = snps[1:]
    return bytes(genome), snps


@pytest.mark.parametrize("kind", ["whole", "part", "deletion", "insertion", "edge"])
def test_uniqueness_filter_matches_jax_and_oracle(kind, tmp_path):
    """On each engineered world the port keeps the k-mers the JAX filter
    keeps, with and without the indel pass; with it off, a k-mer is kept
    iff the brute-force string oracle counts exactly one <= 1-mismatch
    genome locus (the indel pass only drops more)."""
    genome, snps = _engineered(kind, np.random.default_rng(len(kind)))
    ref_path, vcf_path = write_world(tmp_path, genome, snps)
    for indel in (False, True):
        kept = {}
        for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
            err = io.StringIO()
            sites = mod.extract_candidates(vcf_path, ref_path, err=err)
            pre = _candidates(sites)
            mod.filter_unique(sites, ref_path, K, mismatch=True, indel=indel, err=err)
            kept[name] = (_candidates(sites), err.getvalue())
        assert kept["port"] == kept["jax"]
        for before, after in zip(pre, kept["port"][0]):
            for j in (5, 6):
                keep = {p for p, _ in after[j]}
                for p, km in before[j]:
                    if indel:
                        assert p not in keep or oracle_loci(genome, km) == 1
                    else:
                        assert (p in keep) == (oracle_loci(genome, km) == 1), (kind, p)
    if kind == "whole":
        assert all(not c[5] and not c[6] for c in kept["port"][0])


# ---------------------------------------------------------------- PCA


def panel_world(rng, tmp_path: pathlib.Path, n_sites: int, n_samples: int, missing: float):
    """A genome, an interleaved site FASTA of whole 31-bp windows at its
    SNPs (REF entry first) and a phased multi-sample VCF over them with a
    share `missing` of ./. fields."""
    glen = 100 * n_sites + 200
    genome = random_genome(rng, glen)
    sites, rows = [], []
    header = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT" + "".join(
        f"\tS{j:02d}" for j in range(n_samples))
    for i in range(n_sites):
        pos = 100 + 100 * i
        win = genome[pos - 1 - HALF : pos + HALF]
        ref = chr(win[HALF])
        alt = at_cg_alt(ref, rng)
        var = win[:HALF] + alt.encode() + win[HALF + 1 :]
        sites.append(f">rs{i} ref\n{win.decode()}\n>rs{i} var\n{var.decode()}\n")
        gts = rng.choice(["0|0", "0|1", "1|0", "1|1"], n_samples)
        gts[rng.random(n_samples) < missing] = "./."
        rows.append("\t".join([f"chr1\t{pos}\trs{i}\t{ref}\t{alt}\t.\t.\t.\tGT", *gts]))
    (tmp_path / "genome.fa").write_text(">chr1\n" + genome.decode() + "\n")
    (tmp_path / "sites.fa").write_text("".join(sites))
    (tmp_path / "multi.vcf").write_text("##fileformat=VCFv4.2\n" + header + "\n" + "\n".join(rows) + "\n")
    return str(tmp_path / "genome.fa"), str(tmp_path / "sites.fa"), str(tmp_path / "multi.vcf")


def read_tsv(path: str):
    lines = pathlib.Path(path).read_text().splitlines()
    index = [ln.split("\t", 1)[0] for ln in lines[1:]]
    values = np.array([[float(v) for v in ln.split("\t")[1:]] for ln in lines[1:]])
    return lines[0], index, values


def assert_tables_close(got: str, want: str):
    """Header and index column byte-identical; every value within 1e-10 of
    its column's largest |value|."""
    gh, gi, gv = read_tsv(got)
    wh, wi, wv = read_tsv(want)
    assert gh == wh and gi == wi and gv.shape == wv.shape
    scale = np.abs(wv).max(axis=0)
    assert (np.abs(gv - wv) <= 1e-10 * scale).all(), np.abs(gv - wv).max(axis=0) / scale


def test_pca_matches_jax_where_sklearn_solves_exactly(tmp_path):
    """12 samples: sklearn's "auto" solver is its exact "full" one, so the
    JAX package's rotation and components are the port's."""
    ref, sites, vcf = panel_world(np.random.default_rng(12), tmp_path, 60, 12, 0.02)
    err = {}
    for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
        e = io.StringIO()
        mod.generate_pca_rotation(str(tmp_path / name), ref, vcf, sites, dims=4, err=e)
        err[name] = e.getvalue()
    assert err["port"] == err["jax"]
    for suffix in ("matrix.tsv", "center.txt"):
        assert (tmp_path / f"port_{suffix}").read_bytes() == (tmp_path / f"jax_{suffix}").read_bytes()
    for suffix in ("rotationalMatrix.tsv", "components.tsv"):
        assert_tables_close(str(tmp_path / f"port_{suffix}"), str(tmp_path / f"jax_{suffix}"))
    header = (tmp_path / "port_rotationalMatrix.tsv").read_text().splitlines()[0]
    assert header == "AlleleID\t0\t1\t2\t3"


def test_pca_is_sklearns_exact_solution_at_cohort_shape(tmp_path):
    """40 samples x 700 sites, dims 4: where sklearn's "auto" picks its
    unseeded randomized solver, the port gives the exact solution, equal to
    PCA(svd_solver="full") on the matrix as pandas reads it, written as
    pandas writes it."""
    import pandas as pd
    from sklearn.decomposition import PCA

    ref, sites, vcf = panel_world(np.random.default_rng(40), tmp_path, 700, 40, 0.01)
    name = str(tmp_path / "panel")
    pipeline.generate_pca_rotation(name, ref, vcf, sites, dims=4, err=io.StringIO())
    dataset = pd.read_csv(f"{name}_matrix.tsv", sep="\t", header=0, index_col=0)
    assert dataset.shape == (700, 40)
    auto = PCA(n_components=4)
    auto.fit(dataset.transpose())
    assert auto._fit_svd_solver == "randomized"
    pca = PCA(n_components=4, svd_solver="full")
    reduced = pca.fit_transform(dataset.transpose())
    comp = pd.DataFrame(pca.components_.transpose()).set_axis(pca.feature_names_in_, axis=0)
    comp.to_csv(tmp_path / "want_rot.tsv", sep="\t", index_label="AlleleID")
    pc = pd.DataFrame(reduced).set_axis(dataset.axes[1], axis=0)
    pc.to_csv(tmp_path / "want_pc.tsv", sep="\t", index_label="SampleID")
    assert_tables_close(f"{name}_rotationalMatrix.tsv", str(tmp_path / "want_rot.tsv"))
    assert_tables_close(f"{name}_components.tsv", str(tmp_path / "want_pc.tsv"))
    rot = read_tsv(f"{name}_rotationalMatrix.tsv")[2]
    np.testing.assert_allclose(rot.T @ rot, np.eye(4), atol=1e-12)


def test_write_table_is_pandas_to_csv(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(9)
    vals = rng.normal(0, 1, (50, 3)) * 10.0 ** rng.integers(-12, 12, (50, 3))
    vals[0, 0], vals[1, 1], vals[2, 2] = -0.0, 1e16, 5e-324
    ids = [f"rs{i}" for i in range(50)]
    pipeline.write_table(str(tmp_path / "got.tsv"), "AlleleID", ids, vals)
    pd.DataFrame(vals).set_axis(ids, axis=0).to_csv(tmp_path / "want.tsv", sep="\t",
                                                    index_label="AlleleID")
    assert (tmp_path / "got.tsv").read_bytes() == (tmp_path / "want.tsv").read_bytes()


def test_pca_dims_warning_matches_jax(tmp_path):
    ref, sites, vcf = panel_world(np.random.default_rng(5), tmp_path, 6, 5, 0.0)
    err = {}
    for name, mod in (("port", pipeline), ("jax", jax_pipeline)):
        e = io.StringIO()
        mod.generate_pca_rotation(str(tmp_path / name), ref, vcf, sites, dims=20, err=e)
        err[name] = e.getvalue()
    assert err["port"] == err["jax"] and "exceeds min(samples, sites)=5" in err["port"]
    assert_tables_close(str(tmp_path / "port_components.tsv"), str(tmp_path / "jax_components.tsv"))


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [[], ["--help"], ["bogus"], ["generate-sites", "name=x"],
                                  ["generate-pca-rot-mat", "name=x", "ref=r"],
                                  ["generate-sites", "noequals"]])
def test_cli_exit_codes_match_jax(argv, capsys):
    codes = []
    for mod in (sitegen_cmd, jax_sitegen_cmd):
        try:
            codes.append(mod.run(list(argv)))
        except SystemExit as e:
            codes.append(("exit", e.code))
        err = capsys.readouterr().err
        if argv and argv[0].startswith("generate") and "=" in argv[-1] and len(argv) < 4:
            assert "missing required param" in err
    assert codes[0] == codes[1]
