"""The port's ``eval -p`` path (ntsm_tpu_torch.eval.pca, the candidate-pair
statistics of eval/pair_kernel.py and rect.compute_score_pca_cuda) against
the JAX package on the same seeded cohorts.

* The projection, the radius tiers and the candidate list are the JAX
  package's bit for bit, order included, on cohorts that fill all three
  tiers.
* The plain candidate-pair statistics against the TPU engine's K5
  (eval/kernels.py:_pair_block_stats_v2 through _chunk_planes and
  blob._unpack_blob): tallies and the hom identities exact, the scores of
  the two loglik sums within 5e-6 rel/abs (the JAX engine's own f32
  tolerance, tests/test_eval_tpu.py:481); joint and ss within 1e-12
  relative of the exact engine's f64 sums (only the summation order
  differs).
* The device engine on the CPU against the JAX exact engine: the same rows
  in the same order, dist strings equal, scores within 1e-9 max(1, |s|).
* No file of the port imports, reads or builds anything of ntsm_tpu/.
"""

import ast
import io
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ntsm_tpu.eval import driver as jdriver
from ntsm_tpu.eval import pca as jpca
from ntsm_tpu.eval.blob import _unpack_blob
from ntsm_tpu.eval.exact import HEADER
from ntsm_tpu.eval.kernels import _chunk_planes, _pair_block_stats_v2, _pair_gather_g
from ntsm_tpu.eval.model import CountData as JCountData
from ntsm_tpu.eval.wire import _device_planes
from ntsm_tpu.options import Options as JOptions
from ntsm_tpu_torch.eval import driver, pair_kernel, pca, rect
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GENOME = 6.2e9
# (seed, N, L, dim, min_cov)
COHORTS = [(1, 40, 600, 3, 1), (2, 64, 1500, 5, 0), (3, 25, 200, 4, 2)]


def make_cohort(seed: int, N: int, L: int) -> np.ndarray:
    """[N, L, 2] int32 counts of three clusters: samples 0 and 1 a duplicate
    pair; every 4th sample (from 3) loses 5% of its sites and every 7th
    (from 5) 40%, so the three radius tiers all appear."""
    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.05, 0.95, L)
    shift = rng.normal(0, 0.2, size=(3, L))
    f = np.clip(freq + shift[np.arange(N) % 3], 0.02, 0.98)
    geno = (rng.random((N, L)) < f).astype(np.int64) + (rng.random((N, L)) < f)
    lam = rng.uniform(8, 20, size=(N, 1))
    mx = np.stack([rng.poisson(lam * (2 - geno)), rng.poisson(lam * geno)], axis=2)
    mx += rng.poisson(0.2, size=mx.shape)
    mx[1] = mx[0]
    for start, step, frac in ((3, 4, 0.05), (5, 7, 0.4)):
        rows = np.arange(start, N, step)
        mx[rows[:, None], np.argsort(rng.random((rows.size, L)), axis=1)[:, : int(frac * L)]] = 0
    return mx.astype(np.int32)


def cohorts(mx: np.ndarray, opts_kw: dict):
    """The same cohort as a JAX CountData and a port CountData, prepared.
    raw_total_kmers puts the clean samples' error rate near 0.001, below
    the small tier's 0.01, and sample 4's at ~0.11."""
    N, L, _ = mx.shape
    distinct = np.full((L, 2), 13, dtype=np.int64)
    sums = (mx.astype(np.int64) * 13).sum(axis=(1, 2)).astype(np.float64)
    raw = np.ceil(sums * GENOME / (distinct.sum() * 0.98)).astype(np.int64)
    raw[4:5] *= 10
    kw = dict(
        filenames=[f"s{i}_counts.txt" for i in range(N)],
        locus_ids=[f"rs{i}" for i in range(L)],
        distinct=distinct,
        max_counts=mx,
        sum_counts=mx * 13,
        raw_total_kmers=raw,
        ks=np.full(N, 19, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)).astype(np.int64),
    )
    return JCountData(**kw).prepare(JOptions(**opts_kw)), CountData(**kw).prepare(Options(**opts_kw))


def write_pca_files(tmp_path, seed: int, L: int, n_pc: int = 6):
    """rot.tsv and norm.txt in the fixtures' format, from a seed; the
    rotation's scale puts a cluster's samples a few units apart."""
    rng = np.random.default_rng(seed)
    rot = rng.normal(0, 2.0 / np.sqrt(L), size=(L, n_pc))
    rot_p, norm_p = tmp_path / f"rot{seed}.tsv", tmp_path / f"norm{seed}.txt"
    norm_p.write_text("".join(f"{v!r}\n" for v in rng.uniform(0, 1, L).tolist()))
    rot_p.write_text("AlleleID\t" + "\t".join(str(c) for c in range(n_pc)) + "\n" + "".join(
        f"rs{i}\t" + "\t".join(repr(x) for x in rot[i].tolist()) + "\n" for i in range(L)))
    return str(rot_p), str(norm_p)


def pca_setup(tmp_path, seed, N, L, dim, mc, **extra):
    rot, norm = write_pca_files(tmp_path, seed, L)
    opts_kw = dict(min_cov=mc, dim=dim, pca=rot, norm=norm, genome_size=GENOME, **extra)
    jd, pd = cohorts(make_cohort(seed, N, L), opts_kw)
    return jd, pd, opts_kw


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,N,L,dim,mc", COHORTS)
def test_project_pcs_matches_jax(tmp_path, seed, N, L, dim, mc, fast):
    jd, pd, kw = pca_setup(tmp_path, seed, N, L, dim, mc)
    got = pca.project_pcs(pd, Options(**kw), fast=fast)
    want = jpca.project_pcs(jd, JOptions(**kw), fast=fast)
    assert got.shape == (N, dim) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    # the engine picks the arithmetic: cuda projects in f64, exact in long double
    engine = "cuda" if fast else "exact"
    np.testing.assert_array_equal(pca.project_pcs(pd, Options(**kw, engine=engine)), got)


def test_projection_python_paths_match_native(tmp_path, monkeypatch):
    """The numpy quantize and the per-step-rounded Python accumulator, which
    run without the host library, give the native helpers' bits."""
    from ntsm_tpu_torch import native

    _, pd, kw = pca_setup(tmp_path, 4, 30, 300, 4, 1)
    want = {fast: pca.project_pcs(pd, Options(**kw), fast=fast) for fast in (True, False)}
    assert native.load() is not None
    monkeypatch.setattr(native, "load", lambda: None)
    for fast in (True, False):
        np.testing.assert_array_equal(pca.project_pcs(pd, Options(**kw), fast=fast), want[fast])


@pytest.mark.parametrize("seed,N,L,dim,mc", COHORTS)
def test_radii_and_candidates_match_jax(tmp_path, seed, N, L, dim, mc):
    jd, pd, kw = pca_setup(tmp_path, seed, N, L, dim, mc)
    radii = pca.search_radii(pd, Options(**kw))
    np.testing.assert_array_equal(radii, jpca.search_radii(jd, JOptions(**kw)))
    o = Options(**kw)
    tiers = [(radii == o.pc_search_radius1 ** 2).sum(), (radii == o.pc_search_radius2 ** 2).sum(),
             (radii == pca.DBL_MAX).sum()]
    assert min(tiers) > 0 and sum(tiers) == N, tiers
    cloud = pca.project_pcs(pd, o, fast=True)
    ii, jj = pca.pca_candidate_arrays(cloud, radii, dim)
    wi, wj = jpca.pca_candidate_arrays(cloud, radii, dim)
    np.testing.assert_array_equal(ii, wi)
    np.testing.assert_array_equal(jj, wj)
    assert 0 < ii.size < N * (N - 1) // 2
    assert (np.diff(ii) >= 0).all() and (ii != jj).all()  # grouped by i, no (i, i)
    assert list(pca.pca_candidates(cloud, radii, dim)) == list(zip(ii.tolist(), jj.tolist()))
    np.testing.assert_array_equal(pca.sq_dists_blocked(cloud), jpca.sq_dists_blocked(cloud))
    assert pca.calc_distance_sq(cloud, 0, 2, dim) == jpca.calc_distance_sq(cloud, 0, 2, dim)


def numpy_exact_sums(mx: np.ndarray, s_single: np.ndarray, mc: int, ii, jj):
    """joint and ss of each pair as ntsm_tpu/native/exact_pairs.cpp:sums_pair
    computes them (tests/test_torch_eval.py:exact_sums), in f64."""
    m = mx.astype(np.float64)
    a, b = m[:, :, 0], m[:, :, 1]
    valid = (((a[ii] > mc) | (b[ii] > mc)) & ((a[jj] > mc) | (b[jj] > mc)))
    aa, bb = a[ii] + a[jj], b[ii] + b[jj]
    den = np.maximum(aa + bb, 1.0)
    fa = np.where(aa > mc, aa / den, 0.0)
    fb = np.where(bb > mc, bb / den, 0.0)
    joint = np.where(valid, aa * fa + bb * fb, 0.0).sum(axis=1)
    ss = np.where(valid, s_single[ii] + s_single[jj], 0.0).sum(axis=1)
    return joint, ss


@pytest.mark.parametrize("mc", [-1, 1, 2])
def test_plain_pair_block_stats_match_tpu_k5(mc):
    """Against _pair_block_stats_v2 on its fused chunked planes, with the
    port's planes padded past n_sites (pad sites in play)."""
    N, L = 45, 333
    mx = make_cohort(50 + mc, N, L)
    jd, pd = cohorts(mx, dict(min_cov=mc))
    rng = np.random.default_rng(60 + mc)
    ii = np.repeat(np.arange(N), rng.integers(0, 12, N)).astype(np.int32)
    jj = ((ii + rng.integers(1, N, ii.size)) % N).astype(np.int32)
    ii[:2], jj[:2] = (0, 1), (1, 0)  # the duplicate pair both ways

    a, b, s = rect.device_planes(pd, "cpu")
    assert a.shape[1] > L
    ints, sums = pair_kernel.pair_block_stats(
        a, b, s, torch.from_numpy(ii), torch.from_numpy(jj), mc, L)
    assert ints.dtype == torch.int32 and sums.dtype == torch.float64
    n, ibs0, shet, h1, h2 = ints.numpy().astype(np.int64)
    joint, ss = sums.numpy()

    A, B = _device_planes(jd)
    g = _pair_gather_g(A.shape[1])
    ll, iv, hi = _pair_block_stats_v2(_chunk_planes(A, B, g), jnp.asarray(ii), jnp.asarray(jj),
                                      mc=float(mc), n_valid=L, narrow=True, g=g)
    llp, iv8 = _unpack_blob(np.asarray(ll), np.asarray(iv), np.asarray(hi))
    w_n, w_ibs0, w_shet, w_shom, w_h1, w_h2, w_homs1, w_homs2 = iv8
    for got, want in ((n, w_n), (ibs0, w_ibs0), (shet, w_shet), (h1, w_h1), (h2, w_h2),
                      (n - h1 - h2 + shet - ibs0, w_shom), (n - h1, w_homs1), (n - h2, w_homs2)):
        np.testing.assert_array_equal(got, want)
    # the scores of both loglik sums, as the engines finalize them
    def score(loglik):
        skew = (jd.cov[ii] * jd.cov[jj]) ** Options().cov_skew
        return loglik / skew / np.maximum(n, 1)

    got_s = score(-2.0 * (joint - ss))
    want_s = score(llp[0].astype(np.float64) + llp[1].astype(np.float64))
    assert np.all(np.abs(got_s - want_s) <= np.maximum(5e-6, 5e-6 * np.abs(want_s)))

    wj, ws = numpy_exact_sums(mx, jd.s_single, mc, ii, jj)
    assert np.all(np.abs(joint - wj) <= 1e-12 * np.maximum(1.0, np.abs(wj)))
    assert np.all(np.abs(ss - ws) <= 1e-12 * np.maximum(1.0, np.abs(ws)))


def test_pair_block_stats_equal_pair_stats_on_the_triangle():
    """The candidate-pair statistics of the whole triangle, in triu order,
    are pair_stats' of the one row block, bit for bit."""
    N, L = 30, 250
    _, pd = cohorts(make_cohort(8, N, L), dict(min_cov=1))
    a, b, s = rect.device_planes(pd, "cpu")
    iu, ju = np.triu_indices(N, 1)
    got = pair_kernel.pair_block_stats(a, b, s, torch.from_numpy(iu.astype(np.int32)),
                                       torch.from_numpy(ju.astype(np.int32)), 1, L)
    want = pair_kernel.pair_stats(a, b, s, 0, N, 1, L)
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-12, atol=0)


def test_pair_block_stats_rejects_bad_pairs():
    a = torch.zeros((4, 8), dtype=torch.int32)
    s = torch.zeros((4, 8), dtype=torch.float64)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    cases = [
        (i32(0, 1), i32(1, 4), ValueError),  # j outside [0, N)
        (i32(-1, 1), i32(1, 2), ValueError),  # i negative
        (i32(0, 2), i32(1, 2), ValueError),  # a pair (i, i)
        (i32(0, 1), i32(1), ValueError),  # lengths differ
        (i32(0, 1).long(), i32(1, 2).long(), TypeError),  # not int32
        (i32(0, 1, 2, 3)[::2], i32(1, 2, 3, 0)[::2], ValueError),  # not contiguous
        (i32(0, 1).to("meta"), i32(1, 2).to("meta"), ValueError),  # another device
    ]
    for ii, jj, err in cases:
        with pytest.raises(err):
            pair_kernel.pair_block_stats(a, a, s, ii, jj, 1, 8)
    before = pair_kernel.launches_block
    ints, sums = pair_kernel.pair_block_stats(a, a, s, i32(0, 3), i32(1, 2), 1, 8)
    assert ints.shape == (5, 2) and sums.shape == (2, 2)
    assert pair_kernel.launches_block == before  # the CPU runs the plain version
    empty = torch.zeros(0, dtype=torch.int32)
    assert pair_kernel.pair_block_stats(a, a, s, empty, empty, 1, 8)[0].shape == (5, 0)


INT_COLS = {
    "ibs0", "ibs2", "het1", "het2", "sharedHet", "hom1", "hom2",
    "sharedHom", "n", "miss1", "miss2", "allHom1", "allHom2",
    "allHet1", "allHet2", "same",
}


def compare_rows(got: str, want: str, what) -> None:
    """The same rows in the same order; every column but score equal, dist
    strings included; scores within 1e-9 max(1, |s|)."""
    cols = HEADER.split("\t")
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (what, len(g), len(w))
    assert g[0] == w[0] == HEADER
    for lg, lw in zip(g[1:], w[1:]):
        fg, fw = lg.split("\t"), lw.split("\t")
        assert len(fg) == len(fw) == len(cols)
        for c, (x, y) in enumerate(zip(fg, fw)):
            if x == y:
                continue
            assert cols[c] == "score", (what, cols[c], x, y)
            assert abs(float(x) - float(y)) <= 1e-9 * max(1.0, abs(float(y))), (what, x, y)


def test_pca_fuzz_device_engine_vs_jax_exact(rng, tmp_path):
    """tests/test_eval_fuzz.py:test_pca_fuzz_tpu_vs_host in the port: the
    device engine (plain version on the CPU) and the port's exact engine
    against the JAX exact engine, on the same cloud."""
    for trial in range(6):
        trng = np.random.default_rng(rng.integers(0, 2**62) + 77 * trial)
        N = int(trng.integers(3, 14))
        L = int(trng.integers(5, 200))
        mx = trng.poisson(trng.uniform(0.5, 30), size=(N, L, 2)).astype(np.int32)
        mx[trng.random(mx.shape[:2]) < trng.uniform(0, 0.5)] = 0
        if trng.integers(0, 2):
            mx[1] = mx[0]
        dim = int(trng.integers(2, 6))
        cloud = trng.normal(0, trng.uniform(0.5, 10), size=(N, dim))
        kw = dict(all=bool(trng.integers(0, 2)) or trial == 0, min_cov=int(trng.choice([0, 1, 2])),
                  dim=dim, pca="unused.tsv")
        jd, pd = cohorts(mx, kw)
        want = io.StringIO()
        jdriver.compute_score_pca(jd, JOptions(**kw), want, cloud)
        got = io.StringIO()
        times = rect.compute_score_pca_cuda(pd, Options(**kw), got, cloud, "cpu")
        compare_rows(got.getvalue(), want.getvalue(), trial)
        assert set(times) >= {"candidates", "upload", "score", "finalize", "emit", "pairs"}
        ex = io.StringIO()
        driver.compute_score_pca(pd, Options(**kw), ex, cloud)
        compare_rows(ex.getvalue(), want.getvalue(), trial)


def test_pca_engine_slices_give_the_same_output(tmp_path, monkeypatch):
    """Several slices of the candidate list and one print the same table,
    as the JAX exact engine prints it (every non-score column)."""
    jd, pd, kw = pca_setup(tmp_path, 1, 40, 600, 3, 1, all=True)
    cloud = pca.project_pcs(pd, Options(**kw), fast=True)
    outs = []
    for block in (1 << 21, 37):
        monkeypatch.setattr(rect, "BLOCK_PAIRS", block)
        out = io.StringIO()
        P = rect.compute_score_pca_cuda(pd, Options(**kw), out, cloud, "cpu")["pairs"]
        outs.append(out.getvalue())
    assert P > 37 and outs[0] == outs[1]
    want = io.StringIO()
    jdriver.compute_score_pca(jd, JOptions(**kw), want, cloud)
    compare_rows(outs[0], want.getvalue(), "slices")


def test_run_eval_pca_dispatch(tmp_path, capsys):
    """run_eval -p: the device engine returns its stage times with the
    projection's, the exact engine none; both print the JAX run_eval's
    table (exact on the JAX side)."""
    jd, pd, kw = pca_setup(tmp_path, 2, 64, 1500, 5, 0, all=True)
    want = io.StringIO()
    jdriver.run_eval(jd, JOptions(**kw, engine="exact"), want)
    for engine in ("cuda", "exact"):
        out = io.StringIO()
        times = driver.run_eval(pd, Options(**kw, engine=engine), out, device="cpu")
        compare_rows(out.getvalue(), want.getvalue(), engine)
        if engine == "cuda":
            assert times["project"] >= 0 and times["pairs"] == out.getvalue().count("\n") - 1
        else:
            assert times is None
    assert "all-to-all" not in capsys.readouterr().err


def _port_files():
    files = sorted((ROOT / "ntsm_tpu_torch").rglob("*"))
    return [p for p in files if p.suffix in (".py", ".cu", ".cuh", ".cpp")] + [ROOT / "chip_smoke.py"]


def _jax_import(node) -> str | None:
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        names = [node.module or ""]
    else:
        return None
    for name in names:
        if name.split(".")[0] in ("jax", "jaxlib", "ntsm_tpu", "pandas", "sklearn"):
            return name
    return None


def test_port_uses_nothing_of_the_jax_package(monkeypatch, tmp_path):
    """No file of ntsm_tpu_torch/ nor chip_smoke.py imports jax or
    ntsm_tpu (nor pandas or sklearn, which the card machine lacks: sitegen's
    PCA is numpy/scipy), or names a path under ntsm_tpu/ outside its docstrings and
    comments (the `replaces=` notes of chip_smoke's kernels line aside);
    the native and kernel builds compile only the port's own sources."""
    import subprocess

    from ntsm_tpu_torch import csrc, native

    files = _port_files()
    assert len(files) > 30
    for path in files:
        text = path.read_text()
        if path.suffix != ".py":
            # C++/CUDA: no #include of a JAX package file
            assert not [ln for ln in text.splitlines()
                        if ln.startswith("#include") and "ntsm_tpu/" in ln], path
            continue
        tree = ast.parse(text)
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        replaces = {id(k.value) for k in ast.walk(tree)
                    if isinstance(k, ast.keyword) and k.arg == "replaces"}
        for node in ast.walk(tree):
            assert _jax_import(node) is None, (path, _jax_import(node))
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs | replaces):
                v = node.value
                assert v != "ntsm_tpu" and "ntsm_tpu/" not in v, (path, node.lineno, v)

    assert all(pathlib.Path(p).parent == ROOT / "ntsm_tpu_torch" / "native" for p in native.SOURCES)
    assert all(pathlib.Path(p).parent == ROOT / "ntsm_tpu_torch" / "csrc" for p in csrc.sources())
    assert all(pathlib.Path(p).exists() for p in native.SOURCES)

    # what the builds would run: capture the commands instead of compiling
    cmds = []

    class Done:
        returncode = 0
        stdout = stderr = ""

        def __init__(self, cmd, *a, **k):
            cmds.append(cmd)

        def communicate(self, timeout=None):
            return "", None

        def poll(self):
            return 0

    monkeypatch.setattr(subprocess, "run", lambda cmd, *a, **k: Done(cmd))
    monkeypatch.setattr(subprocess, "Popen", Done)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(csrc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(csrc, "SO_PATH", str(tmp_path / "k.so"))
    monkeypatch.setattr(csrc, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr("os.replace", lambda *a: None)
    native._build()
    csrc.build()
    assert len(cmds) == 1 + len(csrc.sources()) + 1
    for cmd in cmds:
        for arg in cmd:
            assert "ntsm_tpu/" not in arg.replace("ntsm_tpu_torch/", ""), cmd
    assert sum(arg.endswith((".cpp", ".cu")) for cmd in cmds for arg in cmd) == 2 + len(
        csrc.sources())
