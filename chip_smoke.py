#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ntsm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's three paths, ``ntsm count``, ``ntsm eval -a`` and
``ntsm eval -p``, through their CLI entry points at human scale, after
building the CUDA kernels from ``ntsm_tpu_torch/csrc/`` and holding each
against its plain PyTorch version on the card.  Imports neither jax nor
ntsm_tpu.  Phases, each printing its result; any failure raises and ends
the run with a non-zero exit:

  0. card name and power limit (nvidia-smi), torch/CUDA versions;
     exit 1 if there is no CUDA device
  1. build the kernel library (nvcc) and the host reader (g++)
  2. kernel 1 (window hash) and kernel 2 (probe and count) against their
     plain versions at the main-path shape B = 32768, L = 256; bit-exact
     (tolerance 0: integer outputs), with CUDA-event times per batch
  3. the main path: a 96,287-site table and 360,000 150-bp reads through
     ``ntsm_tpu_torch.cli.main(["count", ...])``; counts.txt must be
     byte-identical to ``--engine golden`` and both kernels' launch
     counters must equal the number of batches
  4. byte parity with the count fixtures in tests/fixtures
  5. the pair-statistics kernel against its plain version at 96,287 sites:
     a 256-row block of a 1,024-sample cohort (diagonal and off-diagonal
     tiles) and the ragged last block, -c -1 and 1; integers bit-exact,
     joint and ss within 1e-12 relative, and bit-equal to the exact
     engine's on a subset; CUDA-event times
  6. the eval -a path: ``ntsm_tpu_torch.cli.main(["eval", "-a", ...])`` on
     320 count files of 96,287 sites (default engine: the card's), against
     ``--engine exact`` on the same files: every non-score column
     byte-identical, scores within 1e-9 max(1, |score|), and the kernel's
     launch counter above 0; pairs/s end to end
  7. the -a scorer at the N = 3202 cohort (1000 Genomes size), in memory,
     through ``run_eval`` into a byte-counting sink; its first rows against
     the exact engine
  8. byte parity with the eval fixtures on the card, -p, its single-sample
     PC columns and -b included
  9. the candidate-pair kernel (-p) against its plain version on the
     phase-5 cohort: a grouped list of 50,037 pairs, -c 1 and -1; integers
     bit-exact, joint and ss within 1e-12 relative, and bit-equal to the
     exact engine's on 2,000 pairs; CUDA-event times
 10. the eval -p path: ``ntsm_tpu_torch.cli.main(["eval", "-a", "-p", ...])``
     on 320 count files of a 16-cluster cohort with 2% dirty samples and a
     96,287-site x 20-PC rotation, against ``--engine exact``: the same
     pairs in the same order, non-score columns (dist included)
     byte-identical, scores within 1e-9 max(1, |score|); the candidate-pair
     kernel launched and the all-vs-all one not
 11. the -p scorer at N = 3202 of the same design, in memory; its stage
     times and its first rows against the exact engine
  then the card line, a kernels JSON line, and the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Generated inputs go to a temporary directory under build/ (removed at the
end).  The synthetic cohorts follow scripts/bench_eval.py:make_count_files:
Poisson counts around coverage 25-35, sample 1 a duplicate of sample 0;
the -p cohorts add its spread=(rotation, 16) cluster layout and make every
50th sample dirty (40% of its sites missing).

Each kernel's bound is the larger of its bytes (each input read once, each
output written once) at the card's 3.35 TB/s and its operations at the
peak rate of their type: 34 TFLOP/s for f64 outside the tensor cores
(NVIDIA's H100 SXM data sheet) and 67 T/s for 32-bit operations (the
float32 rate; a 64-bit integer operation counts as two).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
B, L = 32768, 256  # the engine's default batch: reads x segment length
K = 19
N_SITES = 96_287  # the human site set's size (bench.py)
N_READS = 360_000  # >= 6 full B x L batches once densely packed
READ_LEN = 150
N_EVAL_FILES = 320
N_COHORT = 3202  # the 1000 Genomes cohort
N_PCS = 20  # the reference's rotation: 20 components
N_CLUSTERS = 16  # the -p cohorts' spread (scripts/gen_cohort.py --spread 16)
DIRTY_EVERY = 50  # every 50th sample of a -p cohort is dirty: 2%
LETTERS = np.frombuffer(b"ACGTN", dtype=np.uint8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F64_OPS_PER_S = 34e12  # H100 SXM, outside the tensor cores
OPS32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PAIR_SITE_F64_OPS = 8  # a valid pair-site: 2 divisions, 2 products, 4 sums


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def cuda_ms(fn, iters: int = 15) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """bound_ms and bound_by: the larger of the bytes' and the operations'
    least time on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def max_abs_err(a, b) -> float:
    """0 for bit-equal integer tensors, else at least 1."""
    import torch

    if torch.equal(a, b):
        return 0.0
    return max(1.0, float((a.double() - b.double()).abs().max()))


def random_batch(rng, k: int, rows: int = B, seglen: int = L) -> np.ndarray:
    """[rows, seglen] codes: random bases, 2% Ns and ragged read tails."""
    codes = rng.integers(0, 4, size=(rows, seglen), dtype=np.uint8)
    codes[rng.random((rows, seglen)) < 0.02] = 4
    ends = rng.integers(k, seglen + 1, size=rows)
    codes[np.arange(seglen)[None, :] >= ends[:, None]] = 4
    return codes


# ---------------------------------------------------------------- phase 2


def check_window_hash(device, rng, k: int, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.core.kmers import flat_window_hashes
    from ntsm_tpu_torch.count import hash_kernel
    from ntsm_tpu_torch.count.kernel_v2 import pack_batch_fast, window_hashes_packed

    codes = random_batch(rng, k)
    packed_np, vbits_np = pack_batch_fast(codes)
    packed = torch.from_numpy(packed_np).to(device)
    vbits = torch.from_numpy(vbits_np).to(device)
    h_k, v_k = hash_kernel.window_hashes(packed, vbits, k, L)
    h_p, v_p = window_hashes_packed(packed, vbits, k, L)
    torch.cuda.synchronize()
    check(torch.equal(v_k, v_p), f"window_hash k={k}: valid differs from plain")
    err = max_abs_err(h_k[v_k], h_p[v_p])
    check(err == 0.0, f"window_hash k={k}: h differs from plain where valid")
    # and against the host oracle (core/kmers.py) on a few rows
    h_host, v_host = h_k[:64].cpu().numpy(), v_k[:64].cpu().numpy()
    for r in range(64):
        hg, vg = flat_window_hashes(codes[r], k)
        check(np.array_equal(v_host[r], vg), f"window_hash k={k}: valid != host row {r}")
        check(
            np.array_equal(h_host[r][vg], hg[vg].view(np.int64)),
            f"window_hash k={k}: h != host row {r}",
        )
    ms = cuda_ms(lambda: hash_kernel.window_hashes(packed, vbits, k, L))
    plain_ms = cuda_ms(lambda: window_hashes_packed(packed, vbits, k, L))
    # bytes: packed bases and validity bits in, h (i64) and valid (u8) out;
    # operations: the canonical min and hash64 of each window, ~25 64-bit
    # integer operations
    n_bytes = packed.nbytes + vbits.nbytes + h_k.nbytes + v_k.nbytes
    b = bound(n_bytes, v_k.numel() * 25 * 2, OPS32_PER_S)
    print(f"phase 2: window_hash k={k} B={B} L={L}: bit-exact vs plain and host; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per batch, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}, {n_bytes / 1e6:.1f} MB) [{card}]", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def check_probe(device, rng, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.count.kernel_v2 import pack_batch_fast

    # the bench.py table: 96,287 sites x 26 random 38-bit hashes
    trng = np.random.default_rng(7)
    hashes = np.unique(
        trng.integers(0, (1 << 38) - 1, size=N_SITES * 26, dtype=np.uint64)
    )
    t0 = time.monotonic()
    tab = kernel_v3.TableV3.from_hashes(hashes, device)
    torch.cuda.synchronize()
    print(f"phase 2: table of {hashes.size} k-mers, {tab.n_buckets} buckets built "
          f"on the card in {time.monotonic() - t0:.3f} s", flush=True)

    packed_np, vbits_np = pack_batch_fast(random_batch(rng, K))
    h, valid = hash_kernel.window_hashes(
        torch.from_numpy(packed_np).to(device), torch.from_numpy(vbits_np).to(device), K, L
    )
    # plant table k-mers in 10% of the rows, 40 windows each
    rows = rng.choice(B, size=B // 10, replace=False)
    cols = np.argsort(rng.random((rows.size, L - K + 1)), axis=1)[:, :40]
    planted = rng.choice(hashes, size=cols.shape).view(np.int64)
    r_t = torch.from_numpy(np.repeat(rows, 40)).to(device)
    c_t = torch.from_numpy(cols.ravel()).to(device)
    h[r_t, c_t] = torch.from_numpy(planted.ravel()).to(device)
    n_planted = int(valid[r_t, c_t].sum())

    c_k = torch.zeros(tab.n_kmers + 1, dtype=torch.int32, device=device)
    c_p = torch.zeros_like(c_k)
    d_k = kernel_v3.probe_count(h, valid, tab, c_k)
    d_p = kernel_v3.probe_and_count(
        h, valid, tab.fp, tab.keys, tab.vals, c_p, n_buckets=tab.n_buckets, bbits=tab.bbits
    )
    torch.cuda.synchronize()
    err = max(max_abs_err(c_k, c_p), max_abs_err(d_k, d_p))
    check(err == 0.0, f"probe_count: counts/diag differ from plain ({d_k.tolist()} vs {d_p.tolist()})")
    diag = d_k.tolist()
    check(diag[2] >= n_planted > 0, f"probe_count: {diag[2]} hits for {n_planted} planted k-mers")
    scratch = torch.zeros_like(c_k)
    ms = cuda_ms(lambda: kernel_v3.probe_count(h, valid, tab, scratch))
    plain_ms = cuda_ms(lambda: kernel_v3.probe_and_count(
        h, valid, tab.fp, tab.keys, tab.vals, scratch, n_buckets=tab.n_buckets, bbits=tab.bbits
    ))
    # bytes: h and valid in, the fingerprint plane (every bucket is probed),
    # the key and value rows of each candidate bucket, a count
    # read-modify-write a hit; operations: ~10 64-bit ones a valid window
    n_valid, n_cand, n_hits = diag
    n_bytes = h.nbytes + valid.nbytes + tab.fp.nbytes + n_cand * 8 * (8 + 4) + n_hits * 8
    b = bound(n_bytes, n_valid * 10 * 2, OPS32_PER_S)
    print(f"phase 2: probe_count B={B} L={L}: counts and diag {diag} bit-exact vs plain "
          f"({n_planted} planted); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per batch, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {n_bytes / 1e6:.1f} MB) [{card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


# ---------------------------------------------------------------- phase 3


def write_sites(path: str, rng, n_sites: int, window: int = 31, k: int = K):
    """Interleaved REF/VAR site FASTA like ntsmSiteGen's: per site the AT
    allele's window then the CG allele's, each as its window - k + 1
    k-mers joined by 'N' (tests/synth.py:make_site_fasta, vectorized)."""
    win = rng.integers(0, 4, size=(n_sites, window), dtype=np.uint8)
    half = window // 2
    ref = win[:, half]
    at_ref = (ref == 0) | (ref == 3)
    var = np.where(at_ref, rng.integers(1, 3, n_sites), 3 * rng.integers(0, 2, n_sites))
    at_win, cg_win = win.copy(), win.copy()
    at_win[:, half] = np.where(at_ref, ref, var)
    cg_win[:, half] = np.where(at_ref, var, ref)
    n_sub = window - k + 1

    def entries(w):
        e = np.full((n_sites, n_sub * (k + 1) - 1), 4, dtype=np.uint8)
        for p in range(n_sub):
            e[:, p * (k + 1) : p * (k + 1) + k] = w[:, p : p + k]
        return LETTERS[e]

    at_e, cg_e = entries(at_win), entries(cg_win)
    with open(path, "wb") as fh:
        fh.write(b"".join(
            b">rs%d ref\n%s\n>rs%d var\n%s\n"
            % (100000 + i, at_e[i].tobytes(), 100000 + i, cg_e[i].tobytes())
            for i in range(n_sites)
        ))
    return at_win, cg_win


def write_reads(path: str, rng, at_win, cg_win, n_reads: int, read_len: int = READ_LEN):
    """FASTQ of n_reads reads: 60% carry a random site allele's window at a
    random offset, the rest are random; half are reverse-complemented and
    0.1% of bases are N.  Returns the base count."""
    n_sites, window = at_win.shape
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    n_site = n_reads * 6 // 10
    site = rng.integers(0, n_sites, n_site)
    wins = np.where(rng.integers(0, 2, n_site)[:, None] == 0, at_win[site], cg_win[site])
    off = rng.integers(0, read_len - window + 1, n_site)
    reads[np.arange(n_site)[:, None], off[:, None] + np.arange(window)] = wins
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    reads[rng.random(reads.shape) < 0.001] = 4
    reads = reads[rng.permutation(n_reads)]
    rec = np.empty((n_reads, 10 + read_len + 3 + read_len + 1), dtype=np.uint8)
    rec[:, 0], rec[:, 1], rec[:, 9] = ord("@"), ord("r"), ord("\n")
    digits = np.arange(n_reads)[:, None] // 10 ** np.arange(6, -1, -1) % 10
    rec[:, 2:9] = digits + ord("0")
    rec[:, 10 : 10 + read_len] = LETTERS[reads]
    rec[:, 10 + read_len : 13 + read_len] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, 13 + read_len : 13 + 2 * read_len] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return n_reads * read_len


def cli_count(args) -> str:
    from ntsm_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["count", *args])
    check(rc == 0, f"ntsm count {' '.join(args)} exited {rc}")
    return out.getvalue()


def reset_launches() -> None:
    """Every kernel's launch counter to 0, just before a path is driven."""
    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.eval import pair_kernel

    hash_kernel.launches = kernel_v3.launches = 0
    pair_kernel.launches = pair_kernel.launches_block = 0


def main_path(device, work: str, rng, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.io.fastx import BatchReader

    sites, fq = os.path.join(work, "sites.fa"), os.path.join(work, "reads.fq")
    t0 = time.monotonic()
    at_win, cg_win = write_sites(sites, rng, N_SITES)
    n_bases = write_reads(fq, rng, at_win, cg_win, N_READS)
    n_batches = sum(1 for _ in BatchReader([fq], k=K, seglen=L, batch=B, dense=True))
    print(f"phase 3: wrote {N_SITES} sites and {N_READS} reads ({n_bases} bases, "
          f"{n_batches} batches of {B} x {L}) in {time.monotonic() - t0:.1f} s", flush=True)
    check(n_batches >= 6, f"only {n_batches} batches")

    from ntsm_tpu_torch.eval import pair_kernel

    reset_launches()
    t0 = time.monotonic()
    got = cli_count(["-s", sites, fq])
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = {"window_hash": hash_kernel.launches, "probe_count": kernel_v3.launches}
    check(pair_kernel.launches == pair_kernel.launches_block == 0,
          "ntsm count launched an eval kernel")
    t0 = time.monotonic()
    want = cli_count(["--engine", "golden", "-s", sites, fq])
    gold_sec = time.monotonic() - t0
    check(got == want, "counts.txt differs from --engine golden")
    check(got.count("\n") == N_SITES + 3, "counts.txt has the wrong number of lines")
    for name, n in launches.items():
        check(n == n_batches, f"{name} launched {n} times for {n_batches} batches")
    print(f"phase 3: ntsm count on the card: counts.txt byte-identical to golden "
          f"({gold_sec:.1f} s); launches {launches} = {n_batches} batches; "
          f"{sec:.2f} s end to end (CLI incl. site load), "
          f"{n_bases / sec / 1e6:.2f} Mbase/s [{card}]", flush=True)

    # where the end-to-end time goes: the site load, then the engine alone
    # (its -v -v stage budget goes to stderr)
    from ntsm_tpu_torch.count.engine import run_count
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.options import Options

    t0 = time.monotonic()
    table = load_site_table(sites, K, allow_dupes=False)
    load_sec = time.monotonic() - t0
    t0 = time.monotonic()
    run_count(table, [fq], Options(verbose=2), device=device)
    torch.cuda.synchronize()
    eng_sec = time.monotonic() - t0
    print(f"phase 3: site load {load_sec:.2f} s; engine (table build + {n_batches} "
          f"batches) {eng_sec:.2f} s, {n_bases / eng_sec / 1e6:.2f} Mbase/s [{card}]",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 4


def fixtures(device) -> None:
    from ntsm_tpu_torch.count.engine import EngineConfig, run_count
    from ntsm_tpu_torch.io.countfile import format_counts
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.options import Options

    sites = os.path.join(FIX, "sites.fa")
    samples = ["sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow",
               "sampleA_junk", "sampleA_badqual"]
    for s in samples:
        got = cli_count(["-s", sites, os.path.join(FIX, f"{s}.fq")])
        with open(os.path.join(FIX, f"{s}_counts.txt")) as fh:
            check(got == fh.read(), f"{s}: counts.txt differs from the fixture")
    table = load_site_table(sites, K, allow_dupes=False)
    cfg = EngineConfig(batch_reads=64, segment_len=128, early_term_check_every=2)
    res = run_count(table, [os.path.join(FIX, "sampleA.fq")], Options(cov_thresh=2.0),
                    cfg, device=device)
    mx, sm = res.site_max_sum(table)
    with open(os.path.join(FIX, "device_m2_counts.txt")) as fh:
        check(format_counts(table.site_ids, mx, sm, table.distinct, res.total_kmers, K)
              == fh.read(), "-m 2: counts differ from device_m2_counts.txt")
    with open(os.path.join(FIX, "device_m2_meta.txt")) as fh:
        meta = dict(line.split("=") for line in fh.read().splitlines())
    check(res.early_term == (meta["early_term"] == "True")
          and (res.total_kmers, res.total_hits, res.total_bases, res.total_reads)
          == tuple(int(meta[f"total_{x}"]) for x in ("kmers", "hits", "bases", "reads")),
          "-m 2: totals differ from device_m2_meta.txt")
    print(f"phase 4: {len(samples)} fixture samples and -m 2 byte-identical on the card",
          flush=True)


# ---------------------------------------------------------------- phases 5-8


def make_cohort(device, seed: int, n_samples: int, n_sites: int = N_SITES,
                rotation: np.ndarray | None = None) -> np.ndarray:
    """[n_samples, n_sites, 2] int32 max counts in the distribution of
    scripts/bench_eval.py:make_count_files: per-site allele frequencies in
    [0.05, 0.95], diploid genotypes, Poisson counts around a coverage of
    25-35 with 2% cross-talk; sample 1 has sample 0's genotypes (a swap).
    With a `rotation` [n_sites, >= 2], its spread=(rotation, N_CLUSTERS)
    layout: sample s belongs to cluster s % N_CLUSTERS, whose frequencies
    shift by 0.04 per grid step along sign(rotation[:, 0]) and
    sign(rotation[:, 1]) (clipped to [0.02, 0.98]), and every DIRTY_EVERY-th
    sample loses 40% of its sites.  Drawn on `device` from a seeded torch
    generator, in blocks of rows."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=device, dtype=torch.float64)  # noqa: E731
    freq = 0.05 + 0.9 * u(n_sites)
    deltas = None
    if rotation is not None:
        side = int(np.ceil(np.sqrt(N_CLUSTERS)))
        s0_, s1_ = (torch.from_numpy(np.sign(rotation[:, c])).to(device) for c in (0, 1))
        deltas = torch.stack([
            0.04 * ((c % side - (side - 1) / 2) * s0_ + (c // side - (side - 1) / 2) * s1_)
            for c in range(N_CLUSTERS)
        ])
    out = np.empty((n_samples, n_sites, 2), dtype=np.int32)
    step = 256
    for s0 in range(0, n_samples, step):
        m = min(step, n_samples - s0)
        rows = torch.arange(s0, s0 + m, device=device)
        fs = freq.expand(m, n_sites)
        if deltas is not None:
            fs = torch.clamp(freq + deltas[rows % N_CLUSTERS], 0.02, 0.98)
        geno = (u(m, n_sites) < fs).double() + (u(m, n_sites) < fs).double()
        if s0 == 0 and m > 1:
            geno[1] = geno[0]
        lam = (25.0 + 10.0 * u(m, 1)) / 2.0
        err = (0.02 * lam).expand(m, n_sites)
        at = torch.poisson(lam * (2 - geno), generator=g) + torch.poisson(err, generator=g)
        cg = torch.poisson(lam * geno, generator=g) + torch.poisson(err, generator=g)
        if deltas is not None:
            dirty = ((rows % DIRTY_EVERY) == DIRTY_EVERY - 1)[:, None] & (u(m, n_sites) < 0.4)
            at[dirty] = 0
            cg[dirty] = 0
        out[s0 : s0 + m] = torch.stack([at, cg], dim=2).to(torch.int32).cpu().numpy()
    return out


def write_pca_artifacts(work: str, rotation: np.ndarray) -> tuple:
    """rot.tsv and norm.txt as scripts/bench_eval.py:make_pca_artifacts
    writes them: a header, then one row of components per site; centers
    uniform in [0, 1)."""
    rot, norm = os.path.join(work, "rot.tsv"), os.path.join(work, "norm.txt")
    centers = np.random.default_rng(8).uniform(0, 1, rotation.shape[0])
    with open(norm, "w") as fh:
        fh.write("\n".join(f"{v:.6f}" for v in centers) + "\n")
    with open(rot, "w") as fh:
        fh.write("AlleleID\t" + "\t".join(f"PC{i}" for i in range(rotation.shape[1])) + "\n")
        for i, row in enumerate(site_ids(rotation.shape[0])):
            fh.write(row + "\t" + "\t".join(f"{x:.8f}" for x in rotation[i]) + "\n")
    return rot, norm


def exact_sums(a: np.ndarray, b: np.ndarray, s: np.ndarray, mc: int, ii, jj) -> np.ndarray:
    """[2, P] joint and ss of the pairs (ii, jj) from the host library's
    exact scorer (ntsm_exact_pairs); a, b [N, L] counts, s their s_single."""
    import ctypes

    from ntsm_tpu_torch import native

    lib = native.load()
    check(lib is not None, "the host library did not build")
    A = np.ascontiguousarray(a, dtype=np.float64)
    B = np.ascontiguousarray(b, dtype=np.float64)
    S = np.ascontiguousarray(s, dtype=np.float64)
    cls = np.zeros(a.shape, np.uint8)  # the tallies are not compared here
    ii = np.ascontiguousarray(ii, dtype=np.int32)
    jj = np.ascontiguousarray(jj, dtype=np.int32)
    P = ii.size
    joint, ss, tal = np.empty(P), np.empty(P), np.empty((P, 8), np.int64)
    vp = lambda x: x.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.ntsm_exact_pairs(vp(A), vp(B), vp(cls), vp(S), a.shape[0], a.shape[1], float(mc),
                         vp(ii), vp(jj), P, vp(joint), vp(ss), vp(tal))
    return np.stack([joint, ss])


def site_ids(n_sites: int = N_SITES) -> list:
    return [f"rs{100000 + i}" for i in range(n_sites)]


def write_count_file(job) -> str:
    """One count file, written with the port's format_counts (a process
    pool runs this: the formatting is Python, ~0.3 s a file)."""
    from ntsm_tpu_torch.io.countfile import format_counts

    path, mx = job
    mx = mx.astype(np.int64)
    n = mx.shape[0]
    text = format_counts(site_ids(n), mx, mx * 13, np.full((n, 2), 13),
                         int(mx.sum() * 37000), K)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def cohort_data(mx: np.ndarray, opts):
    """In-memory CountData of a generated cohort, as if loaded from the
    files write_count_file makes."""
    from ntsm_tpu_torch.eval.model import CountData

    n, L, _ = mx.shape
    return CountData(
        filenames=[f"s{s:04d}_counts.txt" for s in range(n)],
        locus_ids=site_ids(L),
        distinct=np.full((L, 2), 13, dtype=np.int64),
        max_counts=mx,
        sum_counts=mx * 13,
        raw_total_kmers=mx.sum(axis=(1, 2)) * 37000,
        ks=np.full(n, K, dtype=np.int64),
        total_counts=mx.sum(axis=(1, 2)),
    ).prepare(opts)


def check_pair_stats(device, mx: np.ndarray, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.eval import pair_kernel

    n = 1024
    ab = torch.from_numpy(np.ascontiguousarray(mx[:n])).to(device)
    a, b = ab[:, :, 0].contiguous(), ab[:, :, 1].contiguous()
    del ab
    res, err = {}, 0.0
    for mc in (-1, 1):
        s = pair_kernel.s_single_plane(a, b, mc)
        for r0, r1 in ((700, 956), (956, n)):
            ik, fk = pair_kernel.pair_stats(a, b, s, r0, r1, mc, N_SITES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ip, fp = pair_kernel.pair_stats_plain(a, b, s, r0, r1, mc, N_SITES)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            check(torch.equal(ik, ip), f"pair_stats -c {mc} rows [{r0},{r1}): tallies differ from plain")
            rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0)).max())
            check(rel <= 1e-12, f"pair_stats -c {mc} rows [{r0},{r1}): f64 relative error {rel:.3g}")
            err = max(err, float((fk - fp).abs().max()))
            # the per-site step moved to pair_site.cuh: joint and ss stay the
            # exact engine's bit for bit (rows r0 and r0 + 1 against all j)
            iu, ju = pair_rows(n, r0, min(r0 + 2, r1))
            want = exact_sums(a[r0:, :N_SITES].cpu().numpy(), b[r0:, :N_SITES].cpu().numpy(),
                              s[r0:, :N_SITES].cpu().numpy(), mc, iu - r0, ju - r0)
            check(np.array_equal(fk[:, : iu.size].cpu().numpy(), want),
                  f"pair_stats -c {mc} rows [{r0},{r1}): joint/ss not bit-equal to the exact engine")
            ms = cuda_ms(lambda: pair_kernel.pair_stats(a, b, s, r0, r1, mc, N_SITES), iters=5)
            P = ik.shape[1]
            # bytes: rows r0.. of A, B, S read once, 36 B of results a pair;
            # operations: the f64 ones of each valid pair-site
            n_bytes = (n - r0) * N_SITES * 16 + P * 36
            bd = bound(n_bytes, float(ik[0].sum()) * PAIR_SITE_F64_OPS, F64_OPS_PER_S)
            print(f"phase 5: pair_stats -c {mc} rows [{r0},{r1}) of {n} x {N_SITES} sites "
                  f"({P} pairs): tallies bit-exact, joint/ss within {rel:.3g} relative of plain "
                  f"and bit-equal to the exact engine on {iu.size} pairs; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bd['bound_ms']:.3f} ms "
                  f"({bd['bound_by']}; {P * N_SITES / ms / 1e6:.1f} Gpair-site/s) [{card}]",
                  flush=True)
            if mc == 1 and r0 == 700:
                res = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bd)
        del s
    return dict(max_abs_err=err, **res)


def pair_rows(n: int, r0: int, r1: int):
    """(iu, ju) of the pairs (i, j > i), i in [r0, r1), in triu order."""
    iu = np.concatenate([np.full(n - 1 - i, i) for i in range(r0, r1)])
    ju = np.concatenate([np.arange(i + 1, n) for i in range(r0, r1)])
    return iu, ju


def cli_eval(args) -> str:
    from ntsm_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["eval", *args])
    check(rc == 0, f"ntsm eval {' '.join(args[:4])} ... exited {rc}")
    return out.getvalue()


def compare_tables(got: str, want: str, what: str) -> int:
    """Non-score columns byte-identical, scores within 1e-9 max(1, |s|);
    returns how many score strings differ."""
    g, w = got.splitlines(), want.splitlines()
    check(len(g) == len(w), f"{what}: {len(g)} lines vs {len(w)}")
    check(g[0] == w[0], f"{what}: header differs")
    differ = 0
    for lg, lw in zip(g[1:], w[1:]):
        fg, fw = lg.split("\t"), lw.split("\t")
        check(fg[:2] == fw[:2] and fg[3:] == fw[3:], f"{what}: row differs: {lg!r} vs {lw!r}")
        if fg[2] != fw[2]:
            differ += 1
            x, y = float(fg[2]), float(fw[2])
            check(abs(x - y) <= 1e-9 * max(1.0, abs(y)), f"{what}: score {fg[2]} vs {fw[2]}")
    return differ


def eval_main_path(mx: np.ndarray, work: str, card: str) -> int:
    import multiprocessing

    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.eval import pair_kernel

    t0 = time.monotonic()
    jobs = [(os.path.join(work, f"s{s:04d}_counts.txt"), mx[s]) for s in range(N_EVAL_FILES)]
    with multiprocessing.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        paths = pool.map(write_count_file, jobs, chunksize=4)
    print(f"phase 6: wrote {len(paths)} count files of {N_SITES} sites in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    n_pairs = N_EVAL_FILES * (N_EVAL_FILES - 1) // 2
    reset_launches()
    t0 = time.monotonic()
    got = cli_eval(["-a", *paths])
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = pair_kernel.launches
    check(hash_kernel.launches == kernel_v3.launches == pair_kernel.launches_block == 0,
          "ntsm eval -a launched a count kernel or pair_block_stats")
    check(launches > 0, "eval -a did not launch pair_stats (the default engine was not the card's)")
    t0 = time.monotonic()
    want = cli_eval(["-a", "--engine", "exact", *paths])
    exact_sec = time.monotonic() - t0
    differ = compare_tables(got, want, "eval -a vs --engine exact")
    check(got.count("\n") == n_pairs + 1, "eval -a printed the wrong number of rows")
    dup = got.splitlines()[1].split("\t")
    check(dup[3] == "1", f"the duplicate pair (s0000, s0001) is not called the same: {dup[:4]}")
    print(f"phase 6: ntsm eval -a on the card, {N_EVAL_FILES} files: {n_pairs} rows, non-score "
          f"columns byte-identical to --engine exact ({exact_sec:.1f} s), {differ} score strings "
          f"differ; pair_stats launches {launches}; {sec:.2f} s end to end (CLI incl. load), "
          f"{n_pairs / sec:.0f} pairs/s [{card}]", flush=True)
    return launches


class ByteSink:
    """A text sink that counts bytes and lines and keeps the first head
    bytes; the native row formatter writes to its .buffer."""

    def __init__(self, head: int = 1 << 20):
        self.n_bytes = self.n_lines = 0
        self.head = bytearray()
        self.cap = head
        self.buffer = self

    def write(self, x) -> int:
        data = x.encode() if isinstance(x, str) else bytes(x)
        self.n_bytes += len(data)
        self.n_lines += data.count(b"\n")
        if len(self.head) < self.cap:
            self.head += data[: self.cap - len(self.head)]
        return len(x)

    def flush(self) -> None:
        pass


def eval_cohort(device, mx: np.ndarray, card: str) -> None:
    import torch

    from ntsm_tpu_torch.eval import exact
    from ntsm_tpu_torch.eval.driver import run_eval
    from ntsm_tpu_torch.options import Options

    opts = Options(all=True, engine="cuda")
    t0 = time.monotonic()
    data = cohort_data(mx, opts)
    prep = time.monotonic() - t0
    n = data.n_samples
    n_pairs = n * (n - 1) // 2
    sink = ByteSink()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        tm = run_eval(data, opts, sink, device=device)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    check(sink.n_lines == n_pairs + 1, f"N={n}: {sink.n_lines} lines for {n_pairs} pairs")
    # the first rows are the pairs (0, j): score them with the exact engine
    k = min(bytes(sink.head).count(b"\n"), n)  # header + pairs (0, 1..k-1)
    head = bytes(sink.head).decode().splitlines()[:k]
    sub = cohort_data(np.ascontiguousarray(mx[:k]), opts)
    ii = np.zeros(k - 1, dtype=np.int64)
    jj = np.arange(1, k)
    score, tallies = exact.native_pair_stats(sub, opts, ii, jj)
    want = io.StringIO()
    want.write(exact.HEADER + "\n")
    exact._emit_pairs(sub, opts, want, ii, jj, score, tallies)
    differ = compare_tables("\n".join(head) + "\n", want.getvalue(), f"N={n} first rows")
    print(f"phase 7: the scorer at N={n} x {N_SITES} sites in memory (prepare {prep:.1f} s): "
          f"{n_pairs} pairs, {sink.n_bytes / 1e9:.2f} GB of rows in {sec:.2f} s = "
          f"{n_pairs / sec:.0f} pairs/s; upload + s_single {tm['upload']:.2f} s, "
          f"kernel + fetch {tm['score']:.2f} s in {tm['blocks']} blocks, finalize "
          f"{tm['finalize']:.2f} s, emit {tm['emit']:.2f} s; first {k - 1} rows match the "
          f"exact engine ({differ} score strings differ) [{card}]", flush=True)


def eval_fixtures() -> None:
    from ntsm_tpu_torch.eval import pair_kernel

    pca = ["-d", "5", "-p", "rotation.tsv", "-n", "center.txt"]

    files = [os.path.join(FIX, f"{s}_counts.txt") for s in
             ("sampleA", "sampleA2", "sampleB", "sampleC", "sampleLow")]
    cases = {"eval_default.tsv": [], "eval_all.tsv": ["-a"],
             "eval_all_c2.tsv": ["-a", "-c", "2"], "eval_all_noskew.tsv": ["-a", "-w", "0"],
             "eval_all_g.tsv": ["-a", "-g", "80000"]}
    cwd = os.getcwd()
    os.chdir(FIX)  # the fixtures print the file names as given
    try:
        names = [os.path.basename(f) for f in files]
        for fixture, flags in cases.items():
            before = pair_kernel.launches
            got = cli_eval(["--engine", "cuda", *flags, *names])
            with open(fixture) as fh:
                check(got == fh.read(), f"{fixture}: eval output differs on the card")
            check(pair_kernel.launches > before, f"{fixture}: pair_stats not launched")
        with open("eval_single.tsv") as fh:
            check(cli_eval(["--engine", "cuda", names[0]]) == fh.read(),
                  "eval_single.tsv differs on the card")
        before = pair_kernel.launches_block
        with open("eval_pca.tsv") as fh:
            check(cli_eval(["--engine", "cuda", "-a", *pca, *names]) == fh.read(),
                  "eval_pca.tsv differs on the card")
        check(pair_kernel.launches_block > before, "eval_pca.tsv: pair_block_stats not launched")
        with open("eval_single_pca.tsv") as fh:
            check(cli_eval(["--engine", "cuda", *pca, names[0]]) == fh.read(),
                  "eval_single_pca.tsv differs on the card")
        got = cli_eval(["--engine", "cuda", *pca, "-b", "debug_groups.txt", *names]).splitlines()
        with open("eval_debug.tsv") as fh:
            want = fh.read().splitlines()
        check(got[0] == want[0] and sorted(got[1:]) == sorted(want[1:]),
              "eval_debug.tsv differs on the card (rows sorted)")
    finally:
        os.chdir(cwd)
    print(f"phase 8: {len(cases)} eval fixtures, eval_single.tsv, eval_pca.tsv and "
          "eval_single_pca.tsv byte-identical with --engine cuda on the card, "
          "eval_debug.tsv equal once sorted", flush=True)


# ---------------------------------------------------------------- phases 9-11


def grouped_pairs(rng, n: int, n_pairs: int):
    """A candidate list grouped by i, ascending, as eval/pca.py gives it:
    a tenth of the samples have long runs (300-1000 pairs), the others 0-5;
    j on either side of i."""
    runs = np.where(rng.random(n) < 0.1, rng.integers(300, 1000, n), rng.integers(0, 6, n))
    ii = np.repeat(np.arange(n), runs)
    check(ii.size >= n_pairs, f"grouped list of {ii.size} pairs < {n_pairs}")
    ii = ii[:n_pairs]
    jj = (ii + rng.integers(1, n, ii.size)) % n
    return ii.astype(np.int32), jj.astype(np.int32)


def check_pair_block_stats(device, mx: np.ndarray, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.eval import pair_kernel

    n, n_pairs = 1024, 50_037  # 390 full blocks of 128 pairs and a ragged one
    ab = torch.from_numpy(np.ascontiguousarray(mx[:n])).to(device)
    a, b = ab[:, :, 0].contiguous(), ab[:, :, 1].contiguous()
    del ab
    ii, jj = grouped_pairs(np.random.default_rng(9), n, n_pairs)
    it, jt = torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device)
    sub = slice(0, 2000)
    rows = np.unique(np.concatenate([ii[sub], jj[sub]]))
    remap = np.full(n, -1, np.int64)
    remap[rows] = np.arange(rows.size)
    res, err = {}, 0.0
    for mc in (1, -1):
        s = pair_kernel.s_single_plane(a, b, mc)
        ik, fk = pair_kernel.pair_block_stats(a, b, s, it, jt, mc, N_SITES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ip, fp = pair_kernel.pair_block_stats_plain(a, b, s, it, jt, mc, N_SITES)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        check(torch.equal(ik, ip), f"pair_block_stats -c {mc}: tallies differ from plain")
        rel = float(((fk - fp).abs() / fp.abs().clamp(min=1.0)).max())
        check(rel <= 1e-12, f"pair_block_stats -c {mc}: f64 relative error {rel:.3g}")
        err = max(err, float((fk - fp).abs().max()))
        ri = torch.from_numpy(rows).to(device)
        want = exact_sums(a[ri].cpu().numpy(), b[ri].cpu().numpy(), s[ri].cpu().numpy(), mc,
                          remap[ii[sub]], remap[jj[sub]])
        check(np.array_equal(fk[:, sub].cpu().numpy(), want),
              f"pair_block_stats -c {mc}: joint/ss not bit-equal to the exact engine")
        ms = cuda_ms(lambda: pair_kernel.pair_block_stats(a, b, s, it, jt, mc, N_SITES), iters=5)
        # bytes: each distinct row of A, B, S read once, the pair list, 36 B
        # of results a pair; operations: the f64 ones of each valid pair-site
        touched = np.unique(np.concatenate([ii, jj])).size
        n_bytes = touched * N_SITES * 16 + n_pairs * (8 + 36)
        bd = bound(n_bytes, float(ik[0].sum()) * PAIR_SITE_F64_OPS, F64_OPS_PER_S)
        print(f"phase 9: pair_block_stats -c {mc}, {n_pairs} grouped pairs of {n} x {N_SITES} "
              f"sites: tallies bit-exact, joint/ss within {rel:.3g} relative of plain and "
              f"bit-equal to the exact engine on {want.shape[1]} pairs; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}); "
              f"{n_pairs * N_SITES / ms / 1e6:.1f} Gpair-site/s [{card}]", flush=True)
        if mc == 1:
            res = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bd)
        del s
    return dict(max_abs_err=err, **res)


def spread_rotation() -> np.ndarray:
    """The -p cohorts' [N_SITES, N_PCS] rotation (scripts/gen_cohort.py
    --spread: normal(0, 0.003) from seed 7)."""
    return np.random.default_rng(7).normal(0, 0.003, size=(N_SITES, N_PCS))


def radius_tiers(data, opts) -> dict:
    from ntsm_tpu_torch.eval.pca import DBL_MAX, search_radii

    radii = search_radii(data, opts)
    return {"small": int((radii == opts.pc_search_radius1 ** 2).sum()),
            "large": int((radii == opts.pc_search_radius2 ** 2).sum()),
            "exhaustive": int((radii >= DBL_MAX).sum())}


def eval_pca_path(device, work: str, rotation: np.ndarray, card: str) -> int:
    import multiprocessing

    import torch

    from ntsm_tpu_torch.eval import pair_kernel
    from ntsm_tpu_torch.options import Options

    t0 = time.monotonic()
    rot, norm = write_pca_artifacts(work, rotation)
    mx = make_cohort(device, 20261018, N_EVAL_FILES, rotation=rotation)
    pdir = os.path.join(work, "pca")
    os.makedirs(pdir)
    jobs = [(os.path.join(pdir, f"s{s:04d}_counts.txt"), mx[s]) for s in range(N_EVAL_FILES)]
    with multiprocessing.get_context("spawn").Pool(os.cpu_count() or 1) as pool:
        paths = pool.map(write_count_file, jobs, chunksize=4)
    tiers = radius_tiers(cohort_data(mx, Options()), Options())
    print(f"phase 10: wrote a {N_SITES} x {N_PCS} rotation, its centers and {len(paths)} count "
          f"files of a {N_CLUSTERS}-cluster cohort in {time.monotonic() - t0:.1f} s; "
          f"radius tiers {tiers}", flush=True)
    check(tiers["exhaustive"] > 0 and tiers["small"] > 0, f"radius tiers {tiers}")

    n_pairs = N_EVAL_FILES * (N_EVAL_FILES - 1) // 2
    args = ["-a", "-p", rot, "-n", norm, *paths]
    reset_launches()
    t0 = time.monotonic()
    got = cli_eval(args)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = pair_kernel.launches_block
    check(launches > 0, "eval -p did not launch pair_block_stats (the default engine was not "
          "the card's)")
    check(pair_kernel.launches == 0, "eval -p launched pair_stats")
    t0 = time.monotonic()
    want = cli_eval(["--engine", "exact", *args])
    exact_sec = time.monotonic() - t0
    differ = compare_tables(got, want, "eval -p vs --engine exact")
    rows = got.count("\n") - 1
    check(0 < rows < n_pairs, f"eval -p printed {rows} rows of {n_pairs} pairs")
    dup = got.splitlines()[1].split("\t")
    check(dup[:2] == [paths[0], paths[1]] and dup[3] == "1",
          f"the duplicate pair (s0000, s0001) is not the first candidate called the same: {dup[:4]}")
    print(f"phase 10: ntsm eval -a -p on the card, {N_EVAL_FILES} files: {rows} candidate rows = "
          f"{rows / n_pairs:.4f} of {n_pairs} pairs, the same pairs and order as --engine exact "
          f"({exact_sec:.1f} s) with every non-score column byte-identical, {differ} score "
          f"strings differ; pair_block_stats launches {launches}; {sec:.2f} s end to end (CLI "
          f"incl. load and projection), {rows / sec:.0f} candidate pairs/s [{card}]", flush=True)
    return launches


def eval_pca_cohort(device, rotation: np.ndarray, work: str, card: str) -> None:
    import torch

    from ntsm_tpu_torch.eval import exact
    from ntsm_tpu_torch.eval.driver import run_eval
    from ntsm_tpu_torch.eval.pca import (
        pair_dist_sq, pca_candidate_arrays, project_pcs, search_radii)
    from ntsm_tpu_torch.options import Options

    t0 = time.monotonic()
    mx = make_cohort(device, 20261019, N_COHORT, rotation=rotation)
    opts = Options(all=True, engine="cuda", pca=os.path.join(work, "rot.tsv"),
                   norm=os.path.join(work, "norm.txt"))
    data = cohort_data(mx, opts)
    prep = time.monotonic() - t0
    n = data.n_samples
    tiers = radius_tiers(data, opts)
    sink = ByteSink()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        tm = run_eval(data, opts, sink, device=device)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    P = tm["pairs"]
    check(sink.n_lines == P + 1, f"N={n} -p: {sink.n_lines} lines for {P} candidates")
    # the first rows against the exact engine on the same candidates
    cloud = project_pcs(data, opts)
    ii, jj = pca_candidate_arrays(cloud, search_radii(data, opts), opts.dim)
    check(ii.size == P, f"N={n} -p: {ii.size} candidates on a second search, {P} in the run")
    k = bytes(sink.head).count(b"\n") - 1
    head = bytes(sink.head).decode().splitlines()[: k + 1]
    # the exact engine on the samples those rows touch (per-sample
    # statistics do not depend on the rest of the cohort)
    rows = np.unique(np.concatenate([ii[:k], jj[:k]]))
    remap = np.full(n, -1, np.int64)
    remap[rows] = np.arange(rows.size)
    sub = cohort_data(np.ascontiguousarray(mx[rows]), opts)
    sub.filenames = [data.filenames[r] for r in rows]
    si, sj = remap[ii[:k]], remap[jj[:k]]
    score, tallies = exact.native_pair_stats(sub, opts, si, sj)
    want = io.StringIO()
    want.write(exact.HEADER + "\n")
    exact._emit_pairs(sub, opts, want, si, sj, score, tallies,
                      dist=pair_dist_sq(cloud, ii[:k], jj[:k], opts.dim))
    differ = compare_tables("\n".join(head) + "\n", want.getvalue(), f"N={n} -p first rows")
    n_pairs = n * (n - 1) // 2
    print(f"phase 11: the -p scorer at N={n} x {N_SITES} sites, dim {N_PCS}, in memory (make "
          f"and prepare {prep:.1f} s); radius tiers {tiers}; {P} candidates = "
          f"{P / n_pairs:.4f} of {n_pairs} pairs, {sink.n_bytes / 1e9:.3f} GB of rows in "
          f"{sec:.2f} s = {P / sec:.0f} candidate pairs/s; project {tm['project']:.2f} s, "
          f"candidates {tm['candidates']:.2f} s, upload + s_single {tm['upload']:.2f} s, kernel + "
          f"fetch {tm['score']:.2f} s, finalize {tm['finalize']:.2f} s, emit {tm['emit']:.2f} s; "
          f"first {k} rows match the exact engine ({differ} score strings differ) [{card}]",
          flush=True)


def main() -> int:
    import torch

    import ntsm_tpu_torch  # noqa: F401  (fails outside a checkout)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}; "
          "matmul TF32 off (no torch matmul on these paths)", flush=True)
    device = torch.device("cuda", 0)

    from ntsm_tpu_torch import csrc, native

    t0 = time.monotonic()
    csrc.build()
    csrc.load()
    build_s = time.monotonic() - t0
    reader = "native C++" if native.load() is not None else "Python (fallback)"
    print(f"phase 1: built {', '.join(os.path.basename(s) for s in csrc.sources())} "
          f"with nvcc in {build_s:.1f} s; host reader: {reader}", flush=True)

    rng = np.random.default_rng(20261016)
    hashes = {k: check_window_hash(device, rng, k, card) for k in (19, 31, 32)}
    probe = check_probe(device, rng, card)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        launches = main_path(device, work, rng, card)
        fixtures(device)

        t0 = time.monotonic()
        cohort = make_cohort(device, 20261017, N_COHORT)
        print(f"phase 5: generated a {N_COHORT}-sample cohort of {N_SITES} sites in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        pair = check_pair_stats(device, cohort, card)
        block = check_pair_block_stats(device, cohort, card)
        launches["pair_stats"] = eval_main_path(cohort, work, card)
        eval_cohort(device, cohort, card)
        del cohort
        eval_fixtures()
        rotation = spread_rotation()
        launches["pair_block_stats"] = eval_pca_path(device, work, rotation, card)
        eval_pca_cohort(device, rotation, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        dict(name="window_hash", route="cuda",
             source="ntsm_tpu_torch/csrc/window_hash.cu",
             replaces="ntsm_tpu/count/pallas_kernel.py:162",
             launches=launches["window_hash"], **hashes[K]),
        dict(name="probe_count", route="cuda",
             source="ntsm_tpu_torch/csrc/probe_count.cu",
             replaces="ntsm_tpu/count/kernel_v3.py:270",
             launches=launches["probe_count"], **probe),
        dict(name="pair_stats", route="cuda",
             source="ntsm_tpu_torch/csrc/pair_stats.cu",
             replaces="ntsm_tpu/eval/pallas_joint.py:54",
             launches=launches["pair_stats"], **pair),
        dict(name="pair_block_stats", route="cuda",
             source="ntsm_tpu_torch/csrc/pair_block_stats.cu",
             replaces="ntsm_tpu/eval/kernels.py:317",
             launches=launches["pair_block_stats"], **block),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
