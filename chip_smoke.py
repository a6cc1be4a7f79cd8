#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ntsm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths, ``ntsm count`` (the v3 engine through the CLI,
the v1 engine through ``run_count(version=1)``), ``ntsm eval -a``,
``ntsm eval -p``, the three experiment programs (P1-P3), the reference
panel's host commands ``ntsm sitegen`` and ``ntsm vcf`` feeding ``eval
-p``, and the Python API, through their entry points at human scale,
after building the CUDA kernels from
``ntsm_tpu_torch/csrc/`` and holding each against its plain PyTorch version
on the card.  Imports neither jax nor ntsm_tpu.  Phases, each printing its
result; any failure raises and ends the run with a non-zero exit:

  0. card name and power limit (nvidia-smi), torch/CUDA versions, the
     host's architecture and its long double's mantissa bits; exit 1 if
     there is no CUDA device
  1. build the kernel library (nvcc) and the host reader (g++)
  2. the count kernels against their plain versions at the main-path shape
     B = 32768, L = 256, bit-exact (tolerance 0: integer outputs), with
     device times per batch: K1 (window hash) at k = 19, 31, 32; K4 (probe
     and count) on planted hashes; the fused count step (window hash, probe
     and count in one kernel) at k = 19, 31, 32 on a table holding real
     k-mers of its batch
  3. the main path: a 96,287-site table and 360,000 150-bp reads through
     ``ntsm_tpu_torch.cli.main(["count", ...])``; counts.txt must be
     byte-identical to ``--engine golden``, the fused step's launch
     counter must equal the number of batches, and the standalone K1, K4
     and K2 and the fused v1 step must not launch
  4. byte parity with the count fixtures in tests/fixtures
  5. the pair-statistics kernel against its plain version at 96,287 sites:
     a 256-row block of a 1,024-sample cohort (diagonal and off-diagonal
     tiles), the ragged last block, and the first full-size row block of
     the N = 3202 cohort (its plain version on 16 of its rows), -c -1 and
     1; integers bit-exact, joint and ss within 1e-12 relative, and
     bit-equal to the exact engine's on a subset; the micro-tile launched;
     device times
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
     phase-5 cohort: a grouped list of 50,037 pairs, -c 1 and -1, planned
     on the host (timed: tiles, sparse pairs, repeats, density); every
     pair's integers bit-exact, joint and ss within 1e-12 relative, and
     bit-equal to the exact engine's on 2,000 pairs of both instances; a
     repeated pair equal to its first listing; device times of the list
     and of each instance alone
 10. the eval -p path: ``ntsm_tpu_torch.cli.main(["eval", "-a", "-p", ...])``
     on 320 count files of a 16-cluster cohort with 2% dirty samples and a
     96,287-site x 20-PC rotation, against ``--engine exact``: the same
     pairs in the same order, non-score columns (dist included)
     byte-identical, scores within 1e-9 max(1, |score|); the candidate-pair
     kernel launched and the all-vs-all one not
 11. the -p scorer at N = 3202 of the same design, in memory; its stage
     times (the plans' among them) and its first rows against the exact
     engine; then the candidate-pair kernel alone on its candidate list as
     phase 9 runs it, the plain version on a sample that reaches every
     thread of both instances
 12. K2 (the window hash from unpacked codes, on the window stage) against
     its plain version at B = 32768, L = 256, k = 19, 31 and 32: random
     codes with 2% Ns and ragged lengths in [0, L]; bit-exact, with device
     times per batch
 13. the v1 path: ``run_count(..., version=1)`` on phase 3's sites and
     reads, one read a row; its counts.txt must be byte-identical to phase
     3's golden text, the fused v1 step's launch counter (window hash,
     bucket probe and count in one kernel) must equal the batch count and
     no other count or eval kernel may launch (K2 alone, K1, K4, the v3
     step); Mbase/s; then on its first batch the fused v1 step against its
     plain version (the whole counts vector, n_valid, n_found), timed
     beside the plain version and the pair it replaced (K2, then the plain
     bucket probe), and the plain probe split into its parts
 14. P1 and P2: the two gather programs as a user runs them
     (``python -m ntsm_tpu_torch.experiments.exp_pallas_gather[2]``): the
     launch floor (an empty kernel, as a single launch and per launch among
     64 back to back), each of their six forms at the scripts' shapes and
     seed equal to its plain version, with the kernel's time and the plain
     version's, which is the one PyTorch call for the form, each as a
     single launch and per launch among 64, then P1's 1-D gather on
     sequential indices (a 32-B sector for 8 gathers, against one a gather)
     and its chained timing as the script made it (30 calls on the host
     clock)
 15. P3: the DMA-probe program: the ring at depths 4, 16 and 64 on the
     script's 32 MiB plane and 512 x 4096 indices equal to the plain XOR,
     with ms and M rows/s beside the plain fp[idx] gather's, then the ring
     at depth 64 on sequential indices, the floor of "every row fetched"
 16. the count-kernels program as a user runs it
     (``python -m ntsm_tpu_torch.experiments.exp_count_kernels``, without
     its -Xptxas pass): K1, K4, the two back to back and the fused step at
     phase 2's shape and at L = 4096 and 65536, each checked against its
     plain version, and the fused step without and with an L2
     access-policy window; K2, K2 + the bucket probe and the fused v1 step
     at L = 256, 4096 and 65536; K1's, K4's and K2's launches in the
     kernels line are this program's (the paths run the fused steps
     instead)
 17. the reference-panel path, host commands feeding the card, each
     through ``ntsm_tpu_torch.cli.main`` and timed (host seconds):
     (a) ``sitegen generate-sites`` on a seeded 1.2-Mbase genome and 8,000
     A/T <-> C/G SNPs 150 bp apart (w 31, k 19, mismatch and indel on): 13
     tier files, each holding the sites of the one before, panel_n12.fa
     loading; (b) a 128-sample phased VCF over them (1% ./., samples
     120-127 copies of 0-7): ``vcf -p`` and ``sitegen
     generate-pca-rot-mat dims=20`` write byte-identical matrix and center
     files, the rotation is orthonormal to 1e-9 and the components are the
     file's centred matrix times it to 1e-9 of each column's largest; (c)
     ``vcf --output-counts`` (128 count files), then ``eval -a -p`` with
     that rotation and centers on the card against ``--engine exact``: the
     same pairs in the same order, non-score columns byte-identical,
     scores within 1e-9 max(1, |score|), the candidate-pair kernel
     launched and the all-vs-all one not, each of the 8 copy pairs a
     candidate called the same; (d) ``vcf -p`` on the vcf fixtures,
     byte-identical to vcfout_matrix.tsv and vcfout_center.txt on this
     host; (e) phase 3's 96,287 site windows laid into a genome with
     random spacers and a 32-sample VCF at their centres: ``vcf -p``, and
     each sample's max counts 2 multi for hom, multi for het, 0 for the
     absent allele on every allele with k-mers; converter and writer
     seconds
 18. the Python API with its defaults (the card): ``api.load_sites`` and
     ``api.count`` on phase 3's input, the fused step launched once a
     batch and no other count kernel, ``api.write_counts`` byte-identical
     to phase 3's golden counts.txt; ``api.evaluate`` on 64 of phase 6's
     files, rows equal to ``eval -a``'s table parsed the same way, the
     pair-statistics kernel launched; ``api.merge_counts`` of 8 files
     byte-identical to ``eval -e out -o``; the launches of phase 17c's
     ``eval -p`` and phase 18's calls join the kernels line's
  then, passed or failed, every process the run started that is still
     there is stopped and reaped (the resource tracker of the spawn pools
     of phases 6 and 10, and anything a child left behind: this process is
     their subreaper), so that none outlives the run; then the card line, a
     kernels JSON line, and the last line
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
float32 rate; a 64-bit integer operation counts as two).  Times are
device times (``ntsm_tpu_torch/utils/timing.py:device_ms``: each call
queued behind a device-side spin, between two events), except for the
calls that wait for the device inside, K4's and the fused step's plain
versions, timed with events around each call (``event_ms``), and the pair
kernels' plain versions, timed once.  The candidate-pair
kernel is timed with its plan made beforehand (the plan is host work,
timed apart).
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import platform
import shutil
import sys
import tempfile
import time

import numpy as np

from ntsm_tpu_torch.utils.timing import card_line, device_ms, event_ms

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
    ms = device_ms(lambda: hash_kernel.window_hashes(packed, vbits, k, L))
    plain_ms = device_ms(lambda: window_hashes_packed(packed, vbits, k, L))
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
    ms = device_ms(lambda: kernel_v3.probe_count(h, valid, tab, scratch))
    plain_ms = event_ms(lambda: kernel_v3.probe_and_count(
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


def check_count_step(device, rng, k: int, card: str) -> dict:
    """Phase 2: the fused count step against its plain version (the plain
    window hash, then the plain probe) on a random batch and a table of
    phase 2's size holding real k-mers of the batch (it cannot take
    planted hashes: it hashes the windows itself)."""
    import torch

    from ntsm_tpu_torch.count import kernel_v3
    from ntsm_tpu_torch.count.kernel_v2 import window_hashes_packed
    from ntsm_tpu_torch.experiments.exp_count_kernels import fused_batch, real_table, split

    packed, vbits = split(fused_batch(device, rng, k, rows=B, seglen=L), L)
    h_p, v_p = window_hashes_packed(packed, vbits, k, L)
    hashes = real_table(h_p, v_p, rng)
    tab = kernel_v3.TableV3.from_hashes(hashes, device)
    c_k = torch.zeros(tab.n_kmers + 1, dtype=torch.int32, device=device)
    c_p = torch.zeros_like(c_k)
    d_k = kernel_v3.count_step_v3(packed, vbits, tab, c_k, k, L)
    d_p = kernel_v3.probe_and_count(
        h_p, v_p, tab.fp, tab.keys, tab.vals, c_p, n_buckets=tab.n_buckets, bbits=tab.bbits
    )
    torch.cuda.synchronize()
    err = max(max_abs_err(c_k, c_p), max_abs_err(d_k, d_p))
    check(err == 0.0, f"count_step k={k}: counts/diag differ from plain "
          f"({d_k.tolist()} vs {d_p.tolist()})")
    diag = d_k.tolist()
    check(diag[2] > 0, f"count_step k={k}: no hits on a table of the batch's k-mers")
    scratch = torch.zeros_like(c_k)
    ms = device_ms(lambda: kernel_v3.count_step_v3(packed, vbits, tab, scratch, k, L))

    def plain():
        h, v = window_hashes_packed(packed, vbits, k, L)
        kernel_v3.probe_and_count(h, v, tab.fp, tab.keys, tab.vals, scratch,
                                  n_buckets=tab.n_buckets, bbits=tab.bbits)
    plain_ms = event_ms(plain)
    # bytes: the fused rows in, the fingerprint plane (every bucket may be
    # probed), the key and value rows of each candidate bucket, a count
    # read-modify-write a hit; operations: the canonical min and hash64 of
    # every window (~25 64-bit integer ones, as K1's) and the probe of each
    # valid window (~10, as K4's)
    n_valid, n_cand, n_hits = diag
    n_windows = packed.shape[0] * (L - k + 1)
    n_bytes = (packed.nbytes + vbits.nbytes + tab.fp.nbytes + n_cand * 8 * (8 + 4)
               + n_hits * 8)
    b = bound(n_bytes, (n_windows * 25 + n_valid * 10) * 2, OPS32_PER_S)
    print(f"phase 2: count_step k={k} B={B} L={L}: counts and diag {diag} bit-exact vs "
          f"plain (table {hashes.size} k-mers, {tab.n_buckets} buckets); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per batch, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}, {n_bytes / 1e6:.1f} MB) [{card}]", flush=True)
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


def cli(args) -> str:
    """``ntsm_tpu_torch.cli.main(args)``'s stdout; exit code 0 required."""
    from ntsm_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(args))
    check(rc == 0, f"ntsm {' '.join(args[:6])} ... exited {rc}")
    return out.getvalue()


def cli_count(args) -> str:
    return cli(["count", *args])


def reset_launches() -> None:
    """Every kernel's launch counter to 0, just before a path is driven."""
    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.count import kernel as kernel_v1
    from ntsm_tpu_torch.eval import pair_kernel
    from ntsm_tpu_torch.experiments import exp_dma_probe, gather

    hash_kernel.launches = hash_kernel.launches_codes = kernel_v3.launches = 0
    kernel_v3.launches_step = kernel_v1.launches_step = 0
    pair_kernel.launches = pair_kernel.launches_block = pair_kernel.launches_block_sparse = 0
    gather.launches.update(dict.fromkeys(gather.launches, 0))
    exp_dma_probe.launches = 0


def main_path(device, work: str, rng, card: str) -> tuple:
    """Phase 3; returns (launches, sites path, reads path, golden counts.txt,
    the sites' (AT, CG) windows)."""
    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.count import kernel as kernel_v1
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
    launches = {"count_step": kernel_v3.launches_step}
    standalone = {"window_hash": hash_kernel.launches, "probe_count": kernel_v3.launches,
                  "window_hash_codes": hash_kernel.launches_codes,
                  "count_step_v1": kernel_v1.launches_step}
    check(pair_kernel.launches == pair_kernel.launches_block
          == pair_kernel.launches_block_sparse == 0,
          "ntsm count launched an eval kernel")
    t0 = time.monotonic()
    want = cli_count(["--engine", "golden", "-s", sites, fq])
    gold_sec = time.monotonic() - t0
    check(got == want, "counts.txt differs from --engine golden")
    check(got.count("\n") == N_SITES + 3, "counts.txt has the wrong number of lines")
    check(launches["count_step"] == n_batches,
          f"count_step launched {launches['count_step']} times for {n_batches} batches")
    check(not any(standalone.values()), f"ntsm count launched a standalone kernel {standalone}")
    print(f"phase 3: ntsm count on the card: counts.txt byte-identical to golden "
          f"({gold_sec:.1f} s); launches {launches} = {n_batches} batches, standalone "
          f"{standalone}; "
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
    return launches, sites, fq, want, (at_win, cg_win)


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
    """Phase 5: the pair-statistics kernel on two views of the phase-5
    cohort, -c -1 and 1: the first 1,024 samples (rows [700, 956), phase
    5's proxy for a small cohort's one block, and the ragged tail [956,
    1024)), and the full N = 3202 cohort's first row block of
    eval/rect.py:row_blocks (the block phase 7 runs).  The plain version
    runs on each whole block, except the full-size one at -c -1: there on
    two of its row tiles (the first and a middle one) and the ragged last,
    which hold every register slot of the launched micro-tile (the whole
    block's plain run takes ~45 s)."""
    import torch

    from ntsm_tpu_torch.eval import pair_kernel
    from ntsm_tpu_torch.eval.rect import BLOCK_PAIRS, row_blocks

    ab = torch.from_numpy(np.ascontiguousarray(mx)).to(device)
    a, b = ab[:, :, 0].contiguous(), ab[:, :, 1].contiguous()
    del ab
    n_all = a.shape[0]
    full = next(row_blocks(n_all, BLOCK_PAIRS))
    n_sms = pair_kernel.sm_count(device)
    res, err = {}, 0.0
    for mc in (-1, 1):
        s_all = pair_kernel.s_single_plane(a, b, mc)
        for n, (r0, r1) in ((1024, (700, 956)), (1024, (956, 1024)), (n_all, full)):
            an, bn, sn = a[:n], b[:n], s_all[:n]
            ik, fk = pair_kernel.pair_stats(an, bn, sn, r0, r1, mc, N_SITES)
            P = ik.shape[1]
            micro = pair_kernel.MICRO_TILES[pair_kernel.micro_tile(P, n_sms)]
            subs = [(r0, r1)]
            if n == n_all and mc == -1:
                ti = pair_kernel.TILE * micro[0]  # rows a tile: thread row ty, slot k
                mid = r0 + ti * ((r1 - r0) // ti // 2)
                last = r0 + ti * ((r1 - r0 - 1) // ti)
                subs = [(r0, r0 + ti), (mid, mid + ti), (last, r1)]
            plain_ms, rel = 0.0, 0.0
            for q0, q1 in subs:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                ip, fp = pair_kernel.pair_stats_plain(an, bn, sn, q0, q1, mc, N_SITES)
                end.record()
                torch.cuda.synchronize()
                plain_ms += start.elapsed_time(end)
                p0 = pair_kernel.n_block_pairs(n, r0, q0)
                sl = slice(p0, p0 + ip.shape[1])
                check(torch.equal(ik[:, sl], ip),
                      f"pair_stats -c {mc} rows [{q0},{q1}) of [{r0},{r1}): tallies differ from plain")
                rel = max(rel, float(((fk[:, sl] - fp).abs() / fp.abs().clamp(min=1.0)).max()))
                err = max(err, float((fk[:, sl] - fp).abs().max()))
            check(rel <= 1e-12, f"pair_stats -c {mc} rows [{r0},{r1}): f64 relative error {rel:.3g}")
            # joint and ss bit-equal to the exact engine's (rows r0 and r0 + 1
            # against all j)
            iu, ju = pair_rows(n, r0, min(r0 + 2, r1))
            want = exact_sums(an[r0:, :N_SITES].cpu().numpy(), bn[r0:, :N_SITES].cpu().numpy(),
                              sn[r0:, :N_SITES].cpu().numpy(), mc, iu - r0, ju - r0)
            check(np.array_equal(fk[:, : iu.size].cpu().numpy(), want),
                  f"pair_stats -c {mc} rows [{r0},{r1}): joint/ss not bit-equal to the exact engine")
            ms = device_ms(lambda: pair_kernel.pair_stats(an, bn, sn, r0, r1, mc, N_SITES),
                           iters=5 if n == 1024 else 3)
            # bytes: rows r0.. of A, B, S read once, 36 B of results a pair;
            # operations: the f64 ones of each valid pair-site
            n_bytes = (n - r0) * N_SITES * 16 + P * 36
            bd = bound(n_bytes, float(ik[0].double().sum()) * PAIR_SITE_F64_OPS, F64_OPS_PER_S)
            print(f"phase 5: pair_stats -c {mc} rows [{r0},{r1}) of {n} x {N_SITES} sites "
                  f"({P} pairs, micro-tile {micro[0]}x{micro[1]}): tallies bit-exact and "
                  f"joint/ss within {rel:.3g} relative of plain on {len(subs)} row range(s), "
                  f"joint/ss bit-equal to the exact engine on {iu.size} pairs; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.1f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}; "
                  f"{P * N_SITES / ms / 1e6:.1f} Gpair-site/s) [{card}]", flush=True)
            if mc == 1 and r0 == 700:
                res.update(ms=ms, plain_ms=plain_ms, library_ms=None, **bd)
            elif mc == 1 and n == n_all:
                res.update(full_block_rows=[r0, r1], full_block_ms=ms,
                           full_block_plain_ms=plain_ms,
                           full_block_bound_ms=bd["bound_ms"],
                           full_block_gpair_sites_per_s=P * N_SITES / ms / 1e6)
        del s_all
    return dict(max_abs_err=err, **res)


def pair_rows(n: int, r0: int, r1: int):
    """(iu, ju) of the pairs (i, j > i), i in [r0, r1), in triu order."""
    iu = np.concatenate([np.full(n - 1 - i, i) for i in range(r0, r1)])
    ju = np.concatenate([np.arange(i + 1, n) for i in range(r0, r1)])
    return iu, ju


def cli_eval(args) -> str:
    return cli(["eval", *args])


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
    check(hash_kernel.launches == kernel_v3.launches == pair_kernel.launches_block
          == pair_kernel.launches_block_sparse == 0,
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
    return launches, paths


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
        before = pair_kernel.launches_block + pair_kernel.launches_block_sparse
        with open("eval_pca.tsv") as fh:
            check(cli_eval(["--engine", "cuda", "-a", *pca, *names]) == fh.read(),
                  "eval_pca.tsv differs on the card")
        check(pair_kernel.launches_block + pair_kernel.launches_block_sparse > before,
              "eval_pca.tsv: pair_block_stats not launched")
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


def instance_plans(plan):
    """(tiles, sparse): copies of a -p plan that hold only the tile
    instance's or only the sparse instance's share (no repeats), for their
    times and bounds."""
    import dataclasses

    from ntsm_tpu_torch.eval.pair_kernel import TILE

    z, none = np.zeros(0, np.int32), np.zeros((2, 0), np.int64)
    tiles = dataclasses.replace(plan, irows=z.reshape(0, 1), islot=z, jrow=z, out=z, dup=none,
                                _dev={})
    sparse = dataclasses.replace(plan, rows=z.reshape(0, TILE), cols=z.reshape(0, TILE),
                                 outs=z.reshape(0, TILE, TILE), dup=none, _dev={})
    return tiles, sparse


def slot_sample(plan, rng, per_slot: int = 4) -> tuple:
    """Output indices of a sample of a plan's pairs that reaches every
    thread of both instances: for each of a tile's TILE x TILE slots (one
    a thread), up to `per_slot` tiles listing a pair there; the sparse
    instance's first two blocks (every thread) and its last.  Returns
    (tile sample, sparse sample, the number of slots some tile lists)."""
    from ntsm_tpu_torch.eval.pair_kernel import SPARSE_PAIRS

    outs = plan.outs.reshape(plan.n_tiles, -1)
    tiled = [col[col >= 0][:per_slot] for col in outs[rng.permutation(plan.n_tiles)].T]
    tiled = np.concatenate(tiled).astype(np.int64) if tiled else np.zeros(0, np.int64)
    q = np.arange(plan.n_sparse)
    last = (plan.n_sparse - 1) // SPARSE_PAIRS * SPARSE_PAIRS
    sp = q[(q < 2 * SPARSE_PAIRS) | (q >= last)]
    return tiled, plan.out[sp].astype(np.int64), int((outs >= 0).any(axis=0).sum())


def check_pair_block_list(device, a, b, ii: np.ndarray, jj: np.ndarray, card: str,
                          what: str, full: bool) -> dict:
    """K5 on the candidate list (ii, jj) of the planes a, b, -c 1 and -1:
    planned on the host (timed), then its pairs against the plain version
    (all of them when `full`, else slot_sample's), integers bit-exact,
    joint and ss within 1e-12 relative, and bit-equal to the exact engine's
    on up to 2,000 of them; the whole list, each instance alone and the
    plain version on each instance's pairs timed.  Returns the -c 1 numbers
    of each instance (with the list's in the tile entry)."""
    import torch

    from ntsm_tpu_torch.eval import pair_kernel

    n = a.shape[0]
    t0 = time.perf_counter()
    plan = pair_kernel.plan_pair_blocks(ii, jj, n)
    plan_ms = (time.perf_counter() - t0) * 1e3
    tiles, sparse = instance_plans(plan)
    idx_t = plan.outs[plan.outs >= 0].astype(np.int64)
    idx_s = plan.out.astype(np.int64)
    if full:
        cmp_t, cmp_s, n_slots = idx_t, idx_s, None
    else:
        cmp_t, cmp_s, n_slots = slot_sample(plan, np.random.default_rng(12))
        check(n_slots == plan.outs[0].size and plan.n_sparse >= pair_kernel.SPARSE_PAIRS,
              f"{what}: the sample reaches {n_slots} tile slots and {plan.n_sparse} sparse "
              "pairs, not every thread of both instances")
    it, jt = torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device)
    sub = np.concatenate([cmp_t[:1000], cmp_s[:1000]])
    rows = np.unique(np.concatenate([ii[sub], jj[sub]]))
    remap = np.full(n, -1, np.int64)
    remap[rows] = np.arange(rows.size)
    ri = torch.from_numpy(rows).to(device)
    res = {}
    for mc in (1, -1):
        s = pair_kernel.s_single_plane(a, b, mc)
        ik, fk = pair_kernel.pair_block_stats(a, b, s, it, jt, mc, N_SITES, plan=plan)
        err, plain = 0.0, {}
        for name, idx in (("tiles", cmp_t), ("sparse", cmp_s)):
            if not idx.size:
                plain[name] = None
                continue
            x = torch.from_numpy(idx).to(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ip, fp = pair_kernel.pair_block_stats_plain(a, b, s, it[x], jt[x], mc, N_SITES)
            end.record()
            torch.cuda.synchronize()
            plain[name] = start.elapsed_time(end)
            check(torch.equal(ik[:, x], ip), f"{what} -c {mc}: {name} tallies differ from plain")
            rel = float(((fk[:, x] - fp).abs() / fp.abs().clamp(min=1.0)).max())
            check(rel <= 1e-12, f"{what} -c {mc}: {name} f64 relative error {rel:.3g}")
            err = max(err, float((fk[:, x] - fp).abs().max()))
        if plan.dup.shape[1]:
            d = torch.from_numpy(plan.dup).to(device)
            check(torch.equal(ik[:, d[0]], ik[:, d[1]]) and torch.equal(fk[:, d[0]], fk[:, d[1]]),
                  f"{what} -c {mc}: a repeated pair's results differ from its first listing")
        want = exact_sums(a[ri].cpu().numpy(), b[ri].cpu().numpy(), s[ri].cpu().numpy(), mc,
                          remap[ii[sub]], remap[jj[sub]])
        check(np.array_equal(fk[:, torch.from_numpy(sub).to(device)].cpu().numpy(), want),
              f"{what} -c {mc}: joint/ss not bit-equal to the exact engine")
        run = lambda p: device_ms(  # noqa: E731
            lambda: pair_kernel.pair_block_stats(a, b, s, it, jt, mc, N_SITES, plan=p), iters=5)
        ms = {"list": run(plan), "tiles": run(tiles) if plan.n_tiles else None,
              "sparse": run(sparse) if plan.n_sparse else None}
        valid = ik[0].double()
        bd = {}
        for name, idx in (("tiles", idx_t), ("sparse", idx_s)):
            # bytes: each distinct row of A, B, S read once, the pair list, 36
            # B of results a pair; operations: the f64 ones of each valid
            # pair-site
            touched = np.unique(np.concatenate([ii[idx], jj[idx]])).size
            n_ops = float(valid[torch.from_numpy(idx).to(device)].sum()) * PAIR_SITE_F64_OPS
            bd[name] = bound(touched * N_SITES * 16 + idx.size * (8 + 36), n_ops, F64_OPS_PER_S)
        fmt = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
        print(f"{what}: pair_block_stats -c {mc}, {ii.size} pairs of {n} x {N_SITES} sites, "
              f"plan {plan_ms:.1f} ms: {plan.n_tiles} tiles holding {idx_t.size} pairs (tile "
              f"density {plan.tile_density():.4f}), {plan.n_sparse} sparse pairs, "
              f"{plan.dup.shape[1]} repeats; density {plan.density():.4f}; tallies bit-exact "
              f"and joint/ss within 1e-12 relative of plain on {cmp_t.size} + {cmp_s.size} "
              f"pairs{'' if full else f' (every one of {n_slots} tile slots)'}, bit-equal to "
              f"the exact engine on {sub.size}; kernel {ms['list']:.3f} ms "
              f"({ii.size * N_SITES / ms['list'] / 1e6:.1f} Gpair-site/s): tiles "
              f"{fmt(ms['tiles'])} ms (bound {bd['tiles']['bound_ms']:.3f}, plain "
              f"{fmt(plain['tiles'])}), sparse {fmt(ms['sparse'])} ms (bound "
              f"{bd['sparse']['bound_ms']:.3f}, plain {fmt(plain['sparse'])}) [{card}]",
              flush=True)
        if mc == 1:
            res = {name: dict(ms=ms[name], plain_ms=plain[name], library_ms=None,
                              max_abs_err=err, **bd[name]) for name in ("tiles", "sparse")}
            res["tiles"].update(list_ms=ms["list"], plan_ms=plan_ms, density=plan.density(),
                                tile_density=plan.tile_density(), tiles=plan.n_tiles,
                                sparse_pairs=plan.n_sparse)
        del s
    return res


def check_pair_block_stats(device, mx: np.ndarray, card: str) -> dict:
    """Phase 9: K5 on 50,037 grouped candidate pairs of the phase-5
    cohort's first 1,024 samples, every pair against the plain version."""
    import torch

    n, n_pairs = 1024, 50_037
    ab = torch.from_numpy(np.ascontiguousarray(mx[:n])).to(device)
    a, b = ab[:, :, 0].contiguous(), ab[:, :, 1].contiguous()
    del ab
    ii, jj = grouped_pairs(np.random.default_rng(9), n, n_pairs)
    return check_pair_block_list(device, a, b, ii, jj, card, "phase 9", full=True)


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


def eval_pca_path(device, work: str, rotation: np.ndarray, card: str) -> tuple:
    """Phase 10; returns the launches of K5's (tile, sparse) instances."""
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
    # the candidate-pair kernel's plan of the list the CLI will score
    from ntsm_tpu_torch.eval.pca import pca_candidate_arrays, project_pcs, search_radii

    popts = Options(all=True, engine="cuda", pca=rot, norm=norm)
    pdata = cohort_data(mx, popts)
    pi, pj = pca_candidate_arrays(project_pcs(pdata, popts), search_radii(pdata, popts),
                                  popts.dim)
    t0 = time.perf_counter()
    plan = pair_kernel.plan_pair_blocks(pi, pj, N_EVAL_FILES)
    print(f"phase 10: plan of its {pi.size} candidates in {(time.perf_counter() - t0) * 1e3:.1f} "
          f"ms: {plan.n_tiles} tiles holding {plan.n_tiled} pairs (tile density "
          f"{plan.tile_density():.4f}), {plan.n_sparse} sparse pairs; density "
          f"{plan.density():.4f}", flush=True)
    del pdata

    n_pairs = N_EVAL_FILES * (N_EVAL_FILES - 1) // 2
    args = ["-a", "-p", rot, "-n", norm, *paths]
    reset_launches()
    t0 = time.monotonic()
    got = cli_eval(args)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = (pair_kernel.launches_block, pair_kernel.launches_block_sparse)
    check(sum(launches) > 0, "eval -p did not launch pair_block_stats (the default engine was "
          "not the card's)")
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
          f"strings differ; pair_block_stats launches {launches} (tiles, sparse); {sec:.2f} s "
          f"end to end (CLI "
          f"incl. load and projection), {rows / sec:.0f} candidate pairs/s [{card}]", flush=True)
    return launches


def eval_pca_cohort(device, rotation: np.ndarray, work: str, card: str) -> tuple:
    """Phase 11; returns the launches of K5's (tile, sparse) instances in
    the scorer's run, then runs K5 alone on its candidate list and returns
    check_pair_block_list's numbers."""
    import torch

    from ntsm_tpu_torch.eval import pair_kernel
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
    reset_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        tm = run_eval(data, opts, sink, device=device)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = (pair_kernel.launches_block, pair_kernel.launches_block_sparse)
    check(sum(launches) > 0 and pair_kernel.launches == 0,
          f"N={n} -p: pair_block_stats launches {launches}, pair_stats {pair_kernel.launches}")
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
          f"candidates {tm['candidates']:.2f} s, upload + s_single {tm['upload']:.2f} s, tiles "
          f"(the plans) {tm['tiles']:.3f} s, kernel + fetch {tm['score']:.3f} s, finalize "
          f"{tm['finalize']:.2f} s, emit {tm['emit']:.2f} s; pair_block_stats launches "
          f"{launches} (tiles, sparse); first {k} rows match the exact engine ({differ} score "
          f"strings differ) [{card}]", flush=True)
    del sink, data, sub
    ab = torch.from_numpy(mx).to(device)
    a, b = ab[:, :, 0].contiguous(), ab[:, :, 1].contiguous()
    del ab, mx
    alone = check_pair_block_list(device, a, b, ii.astype(np.int32), jj.astype(np.int32), card,
                                  f"phase 11, K5 alone on the N={n} list", full=False)
    return launches, alone


# ---------------------------------------------------------------- phases 12-13


def check_window_hash_codes(device, rng, k: int, card: str) -> dict:
    import torch

    from ntsm_tpu_torch.count import hash_kernel
    from ntsm_tpu_torch.count.kernel import window_hashes_codes_plain

    codes_np = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes_np[rng.random((B, L)) < 0.02] = 4
    codes = torch.from_numpy(codes_np).to(device)
    lengths = torch.from_numpy(rng.integers(0, L + 1, size=B).astype(np.int32)).to(device)
    h_k, v_k = hash_kernel.window_hashes_codes(codes, lengths, k)
    h_p, v_p = window_hashes_codes_plain(codes, lengths, k)
    torch.cuda.synchronize()
    check(torch.equal(v_k, v_p), f"window_hash_codes k={k}: valid differs from plain")
    err = max_abs_err(h_k[v_k], h_p[v_p])
    check(err == 0.0, f"window_hash_codes k={k}: h differs from plain where valid")
    ms = device_ms(lambda: hash_kernel.window_hashes_codes(codes, lengths, k))
    plain_ms = device_ms(lambda: window_hashes_codes_plain(codes, lengths, k))
    # bytes: codes and lengths in, h (i64) and valid (u8) out; operations:
    # the canonical min and hash64 of each window, ~25 64-bit integer ones
    n_bytes = codes.nbytes + lengths.nbytes + h_k.nbytes + v_k.nbytes
    b = bound(n_bytes, v_k.numel() * 25 * 2, OPS32_PER_S)
    print(f"phase 12: window_hash_codes k={k} B={B} L={L}: bit-exact vs plain "
          f"({int(v_k.sum())} valid windows); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"per batch, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
          f"{n_bytes / 1e6:.1f} MB) [{card}]", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def probe_split(h, valid, keys, vals, counts, n_kmers: int) -> dict:
    """Device ms of each part of count/kernel.py:bucket_probe on one batch:
    the two [B, W, 8] gathers, the match with its amin, the scatter-add of
    every window (misses into the last slot) and of the found ones only."""
    import torch

    bucket = h & (keys.shape[0] - 1)
    kg, vg = keys[bucket], vals[bucket]

    def match():
        m = kg == h[..., None]
        found = m.any(dim=-1) & valid
        return torch.where(found, torch.where(m, vg, n_kmers).amin(dim=-1), n_kmers)

    idx = match().reshape(-1)
    ones = torch.ones_like(idx, dtype=counts.dtype)
    hit = idx[idx != n_kmers]
    hit_ones = ones[: hit.numel()]
    return {
        "keys[bucket]": device_ms(lambda: keys[bucket]),
        "vals[bucket]": device_ms(lambda: vals[bucket]),
        "match + amin": device_ms(match),
        "index_add_": device_ms(lambda: counts.index_add_(0, idx, ones)),
        "index_add_ of the found only": device_ms(lambda: counts.index_add_(0, hit, hit_ones)),
    }


def v1_path(device, sites: str, fq: str, want: str, card: str) -> tuple:
    """Phase 13: the v1 engine on phase 3's input, then one of its batches
    through the fused v1 step, the plain version and the pair it replaced;
    returns (the fused step's launches, its kernels-line row)."""
    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.count import kernel as kernel_v1
    from ntsm_tpu_torch.count.engine import run_count
    from ntsm_tpu_torch.count.kernel import bucket_probe, make_table_arrays
    from ntsm_tpu_torch.count.kernel_v2 import window_hashes_codes_plain
    from ntsm_tpu_torch.eval import pair_kernel
    from ntsm_tpu_torch.io.countfile import format_counts
    from ntsm_tpu_torch.io.fastx import BatchReader
    from ntsm_tpu_torch.io.sites import build_lookup, load_site_table
    from ntsm_tpu_torch.options import Options

    table = load_site_table(sites, K, allow_dupes=False)
    n, n_batches = table.n_kmers, sum(1 for _ in BatchReader([fq], k=K, seglen=L, batch=B))
    reset_launches()
    t0 = time.monotonic()
    res = run_count(table, [fq], Options(), device=device, version=1)
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = kernel_v1.launches_step
    others = {"window_hash_codes": hash_kernel.launches_codes, "window_hash": hash_kernel.launches,
              "probe_count": kernel_v3.launches, "count_step": kernel_v3.launches_step}
    check(not any(others.values()), f"the v1 engine launched another count kernel {others}")
    check(pair_kernel.launches == pair_kernel.launches_block
          == pair_kernel.launches_block_sparse == 0,
          "the v1 engine launched an eval kernel")
    mx, sm = res.site_max_sum(table)
    got = format_counts(table.site_ids, mx, sm, table.distinct, res.total_kmers, K)
    check(got == want, "v1: counts.txt differs from phase 3's --engine golden")
    check(launches == n_batches, f"count_step_v1 launched {launches} times for "
          f"{n_batches} batches")
    print(f"phase 13: run_count(version=1) on the card, {res.total_reads} reads in "
          f"{n_batches} batches of {B} x {L} (one read a row): counts.txt byte-identical "
          f"to golden; count_step_v1 launches {launches} = {n_batches} batches, no other "
          f"kernel {others}; {sec:.2f} s (table build + batches), "
          f"{res.total_bases / sec / 1e6:.2f} Mbase/s [{card}]", flush=True)

    # one batch: the fused step against its plain version, then each timed
    # beside the pair it replaced (K2, then the plain bucket probe)
    batch = next(iter(BatchReader([fq], k=K, seglen=L, batch=B)))
    codes = torch.from_numpy(batch.codes).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    keys, vals = make_table_arrays(build_lookup(table.kmer_hashes), n, device)
    c_k = torch.zeros(n + 1, dtype=torch.int32, device=device)
    c_p = torch.zeros_like(c_k)
    t_k = kernel_v1.count_step(codes, lengths, keys, vals, c_k, k=K, n_kmers=n)
    h_p, v_p = window_hashes_codes_plain(codes, lengths, K)
    t_p = bucket_probe(h_p, v_p, keys, vals, c_p, n_kmers=n)
    torch.cuda.synchronize()
    err = max(max_abs_err(c_k, c_p), max_abs_err(torch.stack(t_k).long(), torch.stack(t_p)))
    n_valid, n_found = (int(t) for t in t_p)
    check(err == 0.0, f"count_step_v1: counts/totals differ from plain ({[int(t) for t in t_k]} "
          f"vs {[n_valid, n_found]})")
    check(n_found > 0, "count_step_v1: no site k-mer found in the batch")
    scratch = torch.zeros_like(c_k)
    ms = device_ms(lambda: kernel_v1.count_step(codes, lengths, keys, vals, scratch, k=K,
                                                n_kmers=n))

    def plain():
        h, v = window_hashes_codes_plain(codes, lengths, K)
        bucket_probe(h, v, keys, vals, scratch, n_kmers=n)
    plain_ms = device_ms(plain)
    k2_ms = device_ms(lambda: hash_kernel.window_hashes_codes(codes, lengths, K))
    h, valid = hash_kernel.window_hashes_codes(codes, lengths, K)
    probe_ms = device_ms(lambda: bucket_probe(h, valid, keys, vals, scratch, n_kmers=n))
    pair_ms = device_ms(lambda: bucket_probe(
        *hash_kernel.window_hashes_codes(codes, lengths, K), keys, vals, scratch, n_kmers=n))
    # bytes: the codes and lengths in, the key row of each distinct bucket a
    # valid window reaches (read once), a value load and a count
    # read-modify-write a hit, the miss slot; operations: the canonical min
    # and hash64 of each valid window (~25 64-bit integer ones) and its
    # verify (~10)
    rows = int(torch.unique(h_p[v_p] & (keys.shape[0] - 1)).numel())
    n_bytes = codes.nbytes + lengths.nbytes + rows * 64 + n_found * (4 + 8) + 8
    b = bound(n_bytes, n_valid * 35 * 2, OPS32_PER_S)
    print(f"phase 13: count_step_v1 on its first batch ({n_valid} valid windows, {n_found} "
          f"found, {rows} distinct buckets of {keys.shape[0]}): counts, n_valid and n_found "
          f"bit-exact vs plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the pair it "
          f"replaced {pair_ms:.4f} ms (K2 {k2_ms:.4f}, bucket probe {probe_ms:.4f}), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {n_bytes / 1e6:.1f} MB) [{card}]",
          flush=True)
    split = probe_split(h, valid, keys, vals, scratch, n)
    print("phase 13: the plain bucket probe of that batch, by part: "
          + ", ".join(f"{name} {t:.4f} ms" for name, t in split.items()) + f" [{card}]",
          flush=True)
    return launches, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


# ---------------------------------------------------------------- phases 14-15


def gather_program(device, name: str, card: str) -> dict:
    """Phase 14: P1 ("p1") or P2 ("p2") as a user runs it; each form must
    equal its plain version (tolerance 0).  Returns its kernels-line row:
    the program's launches, the sums over its forms of the times it
    measured (single launches, and per launch among gather.IN_STREAM back to
    back), and the launch floor, the empty kernel's single-launch time."""
    import torch

    from ntsm_tpu_torch.experiments import exp_pallas_gather, exp_pallas_gather2, gather

    module = exp_pallas_gather if name == "p1" else exp_pallas_gather2
    reset_launches()
    res = module.run()
    torch.cuda.synchronize()
    launches = dict(gather.launches)
    check(res is not None, f"{module.__name__} ran nothing")
    check(launches["launch_floor"] > 0, f"{name}: the launch floor was not launched")
    floor = res["floor"]
    print(f"phase 14: {name} launch floor (empty kernel): {floor['ms']:.4f} ms a single "
          f"launch, {floor['per_launch_ms']:.4f} ms a launch of {gather.IN_STREAM} back to "
          f"back [{card}]", flush=True)
    row = dict(launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bound_by="bytes", per_launch_ms=0.0, floor_ms=floor["ms"])
    for r in res["forms"]:
        check(r["correct"], f"{name} {r['label']}: differs from its plain version")
        check(launches[r["form"]] > 0, f"{name}: {r['form']} was not launched")
        b = bound(r["n_bytes"], 0, OPS32_PER_S)
        n = r["n"]
        print(f"phase 14: {name} {r['label']} ({r['form']}, {n} gathers): equal to plain; "
              f"kernel {r['ms']:.4f} ms = {n / r['ms'] / 1e3:.0f} M gathers/s, "
              f"{r['per_launch_ms']:.4f} ms a launch of {gather.IN_STREAM} back to back; plain "
              f"= {gather.FORMS[r['form']][2]} {r['library_ms']:.4f} ms = "
              f"{n / r['library_ms'] / 1e3:.0f} M gathers/s, {r['library_per_launch_ms']:.4f} "
              f"ms a call of {gather.IN_STREAM} back to back; bound {b['bound_ms']:.4f} ms "
              f"({r['n_bytes'] / 1e6:.2f} MB) [{card}]", flush=True)
        for key in ("ms", "plain_ms", "library_ms", "per_launch_ms"):
            row[key] += r[key]
        row["bound_ms"] += b["bound_ms"]
    if "sequential" in res:
        q = res["sequential"]
        check(q["correct"], f"{name}: gather_1d on sequential indices differs from plain")
        print(f"phase 14: {name} gather_1d on sequential indices (arange({q['n']}), a 32-B "
              f"sector for 8 gathers): equal to plain; {q['ms']:.4f} ms, "
              f"{q['per_launch_ms']:.4f} ms a launch of {gather.IN_STREAM} back to back "
              f"[{card}]", flush=True)
    if "chain" in res:
        c = res["chain"]
        print(f"phase 14: {name} the script's timing: {c['calls']} chained gather_1d calls on "
              f"the host clock, {c['ms']:.4f} ms a call for {c['n']} gathers = "
              f"{c['n'] / c['ms'] / 1e3:.0f} M gathers/s [{card}]", flush=True)
    forms = sorted({r["form"] for r in res["forms"]})
    row["launches"] = sum(launches[f] for f in forms)
    print(f"phase 14: {module.__name__}: launches {row['launches']} (forms {forms}), launch "
          f"floor {launches['launch_floor']}; the kernels line sums the {len(res['forms'])} "
          "forms' times", flush=True)
    return row


def dma_probe_program(device, card: str) -> dict:
    """Phase 15: P3 as a user runs it; the ring must equal the plain XOR at
    every depth.  Returns its kernels-line row (the depth-64 time)."""
    import torch

    from ntsm_tpu_torch.experiments import exp_dma_probe as p3

    reset_launches()
    res = p3.run(device)
    torch.cuda.synchronize()
    launches = p3.launches
    check(res is not None, "exp_dma_probe ran nothing")
    check(launches > 0, "exp_dma_probe did not launch dma_probe")
    check(res["plane_bytes"] < res["l2_bytes"],
          f"the {res['plane_bytes']} B plane does not fit the {res['l2_bytes']} B L2")
    b = bound(res["n_bytes"], res["n_ops"], OPS32_PER_S)
    n = res["n_rows"]
    row = {}
    for d in res["depths"]:
        check(d["correct"], f"dma_probe depth={d['depth']}: differs from the plain XOR")
        print(f"phase 15: dma_probe depth={d['depth']}, {p3.SCAN} x {p3.N_IDX} random rows of "
              f"the {res['plane_bytes'] / 2**20:.0f} MiB plane (L2-resident: L2 "
              f"{res['l2_bytes'] / 1e6:.0f} MB): equal to the plain XOR; kernel {d['ms']:.4f} ms "
              f"= {n / d['ms'] / 1e3:.1f} M rows/s; plain fp[idx] gather alone "
              f"{res['gather_ms']:.4f} ms = {n / res['gather_ms'] / 1e3:.1f} M rows/s, plain "
              f"gather + XOR tree {res['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {res['n_bytes'] / 1e6:.1f} MB) [{card}]", flush=True)
        if d["depth"] == max(p3.DEPTHS):
            row = dict(launches=launches, max_abs_err=0.0, ms=d["ms"],
                       plain_ms=res["plain_ms"], library_ms=None, **b)
    seq = res["sequential"]
    check(seq["correct"], "dma_probe on sequential indices: differs from the plain XOR")
    print(f"phase 15: dma_probe depth={seq['depth']} on sequential indices (idx_s[s, i] = "
          f"(s * {p3.N_IDX} + i) mod {p3.ROWS}: every row fetched, no randomness, the floor): "
          f"equal to the plain XOR; kernel {seq['ms']:.4f} ms = {n / seq['ms'] / 1e3:.1f} M "
          f"rows/s; the random indices take {row['ms'] / seq['ms']:.3f}x the floor [{card}]",
          flush=True)
    return row


# ---------------------------------------------------------------- phase 16


def count_kernels_program(device, work: str, card: str) -> tuple:
    """Phase 16: the count-kernels program as a user runs it
    (experiments/exp_count_kernels.py, without its -Xptxas pass): K1, K4,
    the two back to back and the fused step at k = 19, 31, 32 (L = 256)
    and at k = 19, L = 4096 and 65536, and the fused step without and with
    an L2 window; K2, K2 + the bucket probe and the fused v1 step at k =
    19, L = 256, 4096 and 65536.  Returns K1's, K4's and K2's launches (the
    program's) and its result."""
    import torch

    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.experiments import exp_count_kernels

    reset_launches()
    res, ok = exp_count_kernels.run(device, work, ptxas=False)
    torch.cuda.synchronize()
    launches = {"window_hash": hash_kernel.launches, "probe_count": kernel_v3.launches,
                "window_hash_codes": hash_kernel.launches_codes}
    check(ok, "exp_count_kernels: a kernel differs from its plain version")
    check(all(launches.values()), f"exp_count_kernels launched {launches}")
    for row in res["cases"]:
        l2 = row["l2"]
        print(f"phase 16: k={row['k']} L={row['L']} B={row['B']}: K1 {min(row['k1']):.4f}, "
              f"K4 {min(row['k4']):.4f}, K1 + K4 {min(row['k1k4']):.4f}, fused step "
              f"{min(row['step']):.4f} ms; with an L2 window over the fp plane "
              f"({l2['set_aside']} B set aside) off/on/on/off "
              f"{l2['off'][0]:.4f}/{l2['on'][0]:.4f}/{l2['on'][1]:.4f}/{l2['off'][1]:.4f} ms, "
              f"set up and reset in {l2['window_host_ms']:.3f} ms [{card}]", flush=True)
    for row in res["v1"]:
        print(f"phase 16: v1 k={row['k']} L={row['L']} B={row['B']}: K2 {min(row['k2']):.4f}, "
              f"K2 + bucket probe {min(row['k2probe']):.4f}, fused v1 step "
              f"{min(row['v1step']):.4f} ms [{card}]", flush=True)
    print(f"phase 16: exp_count_kernels: launches {launches}", flush=True)
    return launches, res


# ---------------------------------------------------------------- phases 17-18


PANEL_GENOME = 1_200_000  # bases of the reference panel's genome (phase 17a)
PANEL_SNPS = 8000  # A/T <-> C/G SNPs, PANEL_SPACING apart
PANEL_SPACING = 150
PANEL_SAMPLES = 128  # the panel VCF's samples; the last PANEL_COPIES copy the first
PANEL_COPIES = 8
PANEL_MISSING = 0.01  # share of ./. genotype fields
FULL_SAMPLES = 32  # phase 17e's VCF over the 96,287 site windows
MULTI = 20  # vcf -m, the default


def vcf_lines(rows: list, gts: np.ndarray) -> str:
    """A multi-sample VCF: rows [(chrom, pos, id, ref, alt)], gts [rows,
    samples] codes 0..4 for 0|0, 0|1, 1|0, 1|1, ./."""
    names = np.array(["0|0", "0|1", "1|0", "1|1", "./."], dtype=object)
    head = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
    head += "".join(f"\tS{j:03d}" for j in range(gts.shape[1])) + "\n"
    return head + "".join(f"{c}\t{p}\t{i}\t{r}\t{a}\t.\t.\t.\tGT\t" + "\t".join(names[g]) + "\n"
                          for (c, p, i, r, a), g in zip(rows, gts))


def random_genotypes(rng, n_rows: int, n_samples: int, missing: float) -> np.ndarray:
    """[n_rows, n_samples] phased genotype codes (vcf_lines) from per-row
    allele frequencies in [0.05, 0.95], a share `missing` of them ./."""
    freq = rng.uniform(0.05, 0.95, (n_rows, 1))
    gts = ((rng.random((n_rows, n_samples)) < freq).astype(np.int64)
           + 2 * (rng.random((n_rows, n_samples)) < freq))
    gts[rng.random(gts.shape) < missing] = 4
    return gts


def read_tsv(path: str) -> tuple:
    with open(path) as fh:
        lines = fh.read().splitlines()
    return (lines[0], [ln.split("\t", 1)[0] for ln in lines[1:]],
            np.array([ln.split("\t")[1:] for ln in lines[1:]], dtype=np.float64))


def panel_path(work: str, card: str) -> dict:
    """Phases 17a-17d: a reference panel through sitegen, vcf and eval -p;
    returns K5's launches (tile, sparse) in 17c's eval -p and the steps'
    seconds."""
    import torch

    from ntsm_tpu_torch.eval import pair_kernel
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.sitegen.pipeline import read_matrix

    secs = {}
    rng = np.random.default_rng(20261019)
    pdir = os.path.join(work, "panel")
    os.makedirs(pdir)
    at = lambda name: os.path.join(pdir, name)  # noqa: E731

    # 17a: the site set of a seeded genome and SNP VCF
    genome = rng.integers(0, 4, PANEL_GENOME)
    pos = 100 + PANEL_SPACING * np.arange(PANEL_SNPS)
    ref = genome[pos - 1]
    is_at = (ref == 0) | (ref == 3)
    alt = np.where(is_at, rng.integers(1, 3, PANEL_SNPS), 3 * rng.integers(0, 2, PANEL_SNPS))
    with open(at("genome.fa"), "wb") as fh:
        fh.write(b">chr1\n" + LETTERS[genome].tobytes() + b"\n")
    snps = [("chr1", int(p), f"rs{i}", chr(LETTERS[r]), chr(LETTERS[a]))
            for i, (p, r, a) in enumerate(zip(pos, ref, alt))]
    with open(at("snps.vcf"), "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("".join(f"{c}\t{p}\t{i}\t{r}\t{a}\t.\t.\t.\n" for c, p, i, r, a in snps))
    t0 = time.monotonic()
    cli(["sitegen", "generate-sites", f"name={at('panel')}", f"ref={at('genome.fa')}",
         f"vcf={at('snps.vcf')}"])
    secs["sitegen generate-sites"] = time.monotonic() - t0
    tiers = []
    for i in range(13):
        check(os.path.exists(at(f"panel_n{i}.fa")), f"sitegen wrote no panel_n{i}.fa")
        with open(at(f"panel_n{i}.fa")) as fh:
            tiers.append({ln.split()[0] for ln in fh if ln.startswith(">")})
    check(not os.path.exists(at("panel_n13.fa")), "sitegen wrote a 14th tier")
    check(all(a <= b for a, b in zip(tiers, tiers[1:])), "a tier misses a site of the tier before")
    table = load_site_table(at("panel_n12.fa"), K, allow_dupes=False)
    check(table.n_sites == len(tiers[12]) > PANEL_SNPS // 2, f"panel_n12.fa: {table.n_sites} sites")
    print(f"phase 17a: sitegen generate-sites on a {PANEL_GENOME}-base genome and {PANEL_SNPS} "
          f"SNPs: 13 nested tiers of {len(tiers[0])} .. {len(tiers[12])} sites, panel_n12.fa "
          f"loads ({table.n_kmers} k-mers) in {secs['sitegen generate-sites']:.2f} s (host)",
          flush=True)

    # 17b: the PCA training matrix and rotation of a 128-sample panel
    gts = random_genotypes(rng, PANEL_SNPS, PANEL_SAMPLES, PANEL_MISSING)
    gts[:, PANEL_SAMPLES - PANEL_COPIES :] = gts[:, :PANEL_COPIES]
    with open(at("panel.vcf"), "w") as fh:
        fh.write(vcf_lines(snps, gts))
    sites = at("panel_n12.fa")
    t0 = time.monotonic()
    cli(["vcf", "-p", at("panel"), "-s", sites, "-r", at("genome.fa"), at("panel.vcf")])
    secs["vcf -p"] = time.monotonic() - t0
    t0 = time.monotonic()
    cli(["sitegen", "generate-pca-rot-mat", f"name={at('panel2')}", f"ref={at('genome.fa')}",
         f"multivcf={at('panel.vcf')}", f"sites={sites}", f"dims={N_PCS}"])
    secs["sitegen generate-pca-rot-mat"] = time.monotonic() - t0
    for name in ("matrix.tsv", "center.txt"):
        check(filecmp.cmp(at(f"panel_{name}"), at(f"panel2_{name}"), shallow=False),
              f"vcf -p and generate-pca-rot-mat wrote different {name}")
    site_list, samples, mat = read_matrix(at("panel2_matrix.tsv"))
    rh, rid, rot = read_tsv(at("panel2_rotationalMatrix.tsv"))
    ch, cid, comp = read_tsv(at("panel2_components.tsv"))
    check(rh == "AlleleID\t" + "\t".join(map(str, range(N_PCS))) and rid == site_list
          and rot.shape == (len(site_list), N_PCS), "rotationalMatrix.tsv's layout")
    check(ch.startswith("SampleID\t0\t") and cid == samples and comp.shape == (PANEL_SAMPLES, N_PCS),
          "components.tsv's layout")
    ortho = float(np.abs(rot.T @ rot - np.eye(N_PCS)).max())
    check(ortho <= 1e-9, f"the rotation's columns are not orthonormal: {ortho:.3g}")
    x = mat.T - mat.T.mean(axis=0)
    proj = float((np.abs(x @ rot - comp) / np.abs(comp).max(axis=0)).max())
    check(proj <= 1e-9, f"components.tsv is not the centred matrix times the rotation: {proj:.3g}")
    print(f"phase 17b: vcf -p ({secs['vcf -p']:.2f} s) and generate-pca-rot-mat dims={N_PCS} "
          f"({secs['sitegen generate-pca-rot-mat']:.2f} s) on {PANEL_SAMPLES} samples x "
          f"{len(site_list)} sites (host): the same matrix and centers byte for byte; the "
          f"rotation orthonormal to {ortho:.2e}, the components the centred matrix times it to "
          f"{proj:.2e}", flush=True)

    # 17c: count files from the panel VCF, eval -p on the card against exact
    cdir = at("counts")
    os.makedirs(cdir)
    t0 = time.monotonic()
    with contextlib.chdir(cdir):
        cli(["vcf", "--output-counts", "-s", sites, "-r", at("genome.fa"), at("panel.vcf")])
    secs["vcf --output-counts"] = time.monotonic() - t0
    paths = [os.path.join(cdir, f"{sid}.counts.txt") for sid in samples]
    check(sorted(os.listdir(cdir)) == sorted(map(os.path.basename, paths)),
          "vcf --output-counts did not write one count file a sample")
    args = ["-a", "-p", at("panel2_rotationalMatrix.tsv"), "-n", at("panel_center.txt"), *paths]
    reset_launches()
    t0 = time.monotonic()
    got = cli_eval(args)
    torch.cuda.synchronize()
    secs["eval -p"] = time.monotonic() - t0
    launches = (pair_kernel.launches_block, pair_kernel.launches_block_sparse)
    check(sum(launches) > 0 and pair_kernel.launches == 0,
          f"eval -p launched pair_block_stats {launches} and pair_stats {pair_kernel.launches}")
    t0 = time.monotonic()
    want = cli_eval(["--engine", "exact", *args])
    secs["eval -p --engine exact"] = time.monotonic() - t0
    differ = compare_tables(got, want, "panel eval -p vs --engine exact")
    rows = {tuple(ln.split("\t")[:2]): ln.split("\t")[3] for ln in got.splitlines()[1:]}
    for j in range(PANEL_COPIES):
        pair = (paths[j], paths[PANEL_SAMPLES - PANEL_COPIES + j])
        check(rows.get(pair) == "1", f"the copy pair {pair} is not a candidate called the same")
    n_pairs = PANEL_SAMPLES * (PANEL_SAMPLES - 1) // 2
    print(f"phase 17c: vcf --output-counts wrote {len(paths)} count files "
          f"({secs['vcf --output-counts']:.2f} s, host); eval -a -p on the card: {len(rows)} "
          f"candidate rows of {n_pairs} pairs, the same pairs and order as --engine exact with "
          f"every non-score column byte-identical, {differ} score strings differ; the "
          f"{PANEL_COPIES} copy pairs called the same; pair_block_stats launches {launches} "
          f"(tiles, sparse); {secs['eval -p']:.2f} s (exact {secs['eval -p --engine exact']:.2f} "
          f"s) [{card}]", flush=True)

    # 17d: the vcf fixtures, whatever this host's long double is
    t0 = time.monotonic()
    cli(["vcf", "-p", at("fixture"), "-s", os.path.join(FIX, "vcf_sites.fa"),
         "-r", os.path.join(FIX, "vcf_genome.fa"), os.path.join(FIX, "multi.vcf")])
    for name in ("matrix.tsv", "center.txt"):
        check(filecmp.cmp(at(f"fixture_{name}"), os.path.join(FIX, f"vcfout_{name}"),
                          shallow=False),
              f"vcf -p: {name} differs from the fixture vcfout_{name}")
    secs["vcf fixtures"] = time.monotonic() - t0
    print("phase 17d: vcf -p on the fixtures: vcfout_matrix.tsv and vcfout_center.txt "
          "byte-identical", flush=True)
    return dict(launches=launches, secs=secs)


def full_width_vcf(work: str, sites: str, windows: tuple) -> dict:
    """Phase 17e: phase 3's 96,287 site windows laid into a genome with
    random spacers, a FULL_SAMPLES-sample VCF at their centres, vcf -p on
    it; each sample's max counts against its genotypes.  Returns the
    steps' seconds."""
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.options import Options
    from ntsm_tpu_torch.vcf.convert import HET, HOM1, HOM2, VCFConverter

    at_win, cg_win = windows
    n_sites, window = at_win.shape
    half = window // 2
    rng = np.random.default_rng(20261020)
    t0 = time.monotonic()
    ref_at = rng.random(n_sites) < 0.5  # the genome carries the AT or the CG allele
    ref_win = np.where(ref_at[:, None], at_win, cg_win)
    alt_base = np.where(ref_at, cg_win[:, half], at_win[:, half])
    starts = np.cumsum(window + rng.integers(10, 41, n_sites)) - window
    genome = rng.integers(0, 4, int(starts[-1]) + window + 40).astype(np.uint8)
    genome[starts[:, None] + np.arange(window)] = ref_win
    fdir = os.path.join(work, "full")
    os.makedirs(fdir)
    ref_path, vcf = os.path.join(fdir, "genome.fa"), os.path.join(fdir, "full.vcf")
    with open(ref_path, "wb") as fh:
        fh.write(b">chr1\n" + LETTERS[genome].tobytes() + b"\n")
    gts = random_genotypes(rng, n_sites, FULL_SAMPLES, PANEL_MISSING)
    rows = [("chr1", int(s) + half + 1, f"rs{100000 + i}", chr(LETTERS[r]), chr(LETTERS[a]))
            for i, (s, r, a) in enumerate(zip(starts, ref_win[:, half], alt_base))]
    with open(vcf, "w") as fh:
        fh.write(vcf_lines(rows, gts))
    secs = {"write": time.monotonic() - t0}

    prefix = os.path.join(fdir, "full")
    t0 = time.monotonic()
    cli(["vcf", "-p", prefix, "-s", sites, "-r", ref_path, vcf])
    secs["vcf -p"] = time.monotonic() - t0

    # the same conversion by its parts: the converter, the check, the writer
    opts = Options(snp=sites, ref=ref_path)
    table = load_site_table(sites, K, allow_dupes=False)
    t0 = time.monotonic()
    conv = VCFConverter(table, opts)
    conv.count(vcf)
    secs["converter"] = time.monotonic() - t0
    mx, _ = conv.site_max_matrix()
    code = np.where(gts == 4, HOM1, np.where(gts == 3, HOM2, np.where(gts == 0, HOM1, HET))).T
    ref_allele = np.where(ref_at, 0, 1)
    want = np.zeros((FULL_SAMPLES, n_sites, 2), dtype=np.int64)
    rows_i = np.arange(n_sites)
    for s in range(FULL_SAMPLES):
        on_ref = np.where(code[s] == HOM1, 2 * MULTI, np.where(code[s] == HET, MULTI, 0))
        on_alt = np.where(code[s] == HOM2, 2 * MULTI, np.where(code[s] == HET, MULTI, 0))
        want[s, rows_i, ref_allele] = on_ref
        want[s, rows_i, 1 - ref_allele] = on_alt
    want[:, table.distinct == 0] = 0  # an allele whose k-mers were all shared
    bad = int((mx != want).any(axis=(0, 2)).sum())
    check(bad == 0, f"vcf: {bad} sites' max counts disagree with their genotypes")
    t0 = time.monotonic()
    conv.output_matrix(prefix + "2")
    secs["writer"] = time.monotonic() - t0
    for name in ("matrix.tsv", "center.txt"):
        check(filecmp.cmp(f"{prefix}_{name}", f"{prefix}2_{name}", shallow=False),
              f"vcf -p's {name} differs")
    print(f"phase 17e: vcf -p on {n_sites} sites x {FULL_SAMPLES} samples ({len(genome)}-base "
          f"genome; inputs written in {secs['write']:.2f} s): {secs['vcf -p']:.2f} s through the "
          f"CLI; converter {secs['converter']:.2f} s, writer {secs['writer']:.2f} s, "
          f"{(secs['converter'] + secs['writer']) / n_sites * 1e6:.2f} us a site (host); every "
          f"sample's max counts {2 * MULTI} / {MULTI} / 0 as its genotypes say on all "
          f"{int((table.distinct > 0).sum())} alleles with k-mers", flush=True)
    return secs


def api_path(sites: str, fq: str, golden_text: str, n_batches: int, count_files: list,
             work: str, card: str) -> dict:
    """Phase 18: the Python API on the card with its defaults; returns the
    launches of the fused count step (api.count) and of pair_stats
    (api.evaluate), and the steps' seconds."""
    import torch

    import ntsm_tpu_torch.api as api
    from ntsm_tpu_torch.count import hash_kernel, kernel_v3
    from ntsm_tpu_torch.count import kernel as kernel_v1
    from ntsm_tpu_torch.eval import pair_kernel

    secs = {}
    t0 = time.monotonic()
    table = api.load_sites(sites)
    reset_launches()
    res = api.count(table, [fq])
    torch.cuda.synchronize()
    secs["count"] = time.monotonic() - t0
    step = kernel_v3.launches_step
    others = (hash_kernel.launches, kernel_v3.launches, hash_kernel.launches_codes,
              kernel_v1.launches_step)
    check(step == n_batches, f"api.count launched the fused step {step} times for {n_batches} batches")
    check(not any(others), f"api.count launched K1, K4, K2 or the v1 step: {others}")
    buf = io.StringIO()
    api.write_counts(buf, table, res)
    check(buf.getvalue() == golden_text, "api.write_counts differs from phase 3's golden counts.txt")

    paths = count_files[:64]
    reset_launches()
    t0 = time.monotonic()
    rows = api.evaluate(paths)
    torch.cuda.synchronize()
    secs["evaluate"] = time.monotonic() - t0
    pair = pair_kernel.launches
    check(pair > 0, "api.evaluate did not launch pair_stats")
    table_rows = api.table_rows(cli_eval(["-a", *paths]))
    as_text = lambda rs: [{k: repr(v) for k, v in r.items()} for r in rs]  # noqa: E731
    check(len(rows) == 64 * 63 // 2 and as_text(rows) == as_text(table_rows),
          "api.evaluate's rows differ from eval -a's table")

    merged, merged_cli = os.path.join(work, "api_merged.txt"), os.path.join(work, "cli_merged.txt")
    t0 = time.monotonic()
    api.merge_counts(paths[:8], merged)
    secs["merge_counts"] = time.monotonic() - t0
    cli_eval(["-e", merged_cli, "-o", *paths[:8]])
    check(filecmp.cmp(merged, merged_cli, shallow=False), "api.merge_counts differs from eval -e -o")
    print(f"phase 18: api.count on phase 3's input with its defaults (the card) "
          f"{secs['count']:.2f} s: the fused step launched {step} times = {n_batches} batches, "
          f"K1, K4, K2 and the v1 step not; write_counts byte-identical to golden; "
          f"api.evaluate on 64 of phase 6's files {secs['evaluate']:.2f} s: {len(rows)} rows equal "
          f"to eval -a's, pair_stats launches {pair}; merge_counts of 8 byte-identical to eval -e "
          f"-o [{card}]", flush=True)
    return dict(count_step=step, pair_stats=pair, secs=secs)


# ---------------------------------------------------------------- processes


def become_subreaper() -> bool:
    """Make this process the parent of every process that one of its
    children leaves behind (Linux prctl PR_SET_CHILD_SUBREAPER), so that
    stop_children finds those too."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def child_pids() -> list:
    """The pids of this process's children, running or exited (/proc)."""
    me, pids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            pids.append(int(name))
    return pids


def describe(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            cmd = fh.read().replace(b"\0", b" ").decode(errors="replace").strip()
        return f"{pid} {cmd}" if cmd else f"{pid} (exited)"
    except OSError:
        return f"{pid} (gone)"


def reaped(pid: int) -> bool:
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        return True


def stop_children(grace_s: float = 5.0) -> list:
    """Stop and reap every process this run started that is still there.
    First the resource tracker that the spawn pools of phases 6 and 10
    start: it outlives the pools, ignores SIGTERM and exits only once its
    pipe is closed, which multiprocessing's own stop does.  Then any other
    child, SIGTERM and after grace_s SIGKILL.  Returns those others, pid
    and command line; the run leaves no process behind either way."""
    import gc
    import signal
    from multiprocessing import resource_tracker

    gc.collect()  # the pools' semaphores, so that the tracker has nothing left to clean
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None and hasattr(tracker, "_stop"):
        tracker._stop()
    pids = child_pids()
    left = [describe(pid) for pid in pids]
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    while pids and time.monotonic() < deadline:
        pids = [pid for pid in pids if not reaped(pid)]
        time.sleep(0.05)
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
    return left


# ---------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    subreaper = become_subreaper()
    try:
        kernels, summary = run_phases(card)
    finally:
        left = stop_children()
        print(f"end: processes of this run still there at its end, now stopped: "
              f"{left or 'none'} (subreaper: {subreaper})", flush=True)
    print(summary, flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(card: str) -> list:
    """Phases 1-18; returns the kernels line's rows and the summary of the
    checks that passed."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}; "
          "matmul TF32 off (no torch matmul on these paths); host "
          f"{platform.machine()}, long double of {np.finfo(np.longdouble).nmant} "
          "mantissa bits (vcf's center file does not use it)", flush=True)
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
    steps = {k: check_count_step(device, rng, k, card) for k in (19, 31, 32)}

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(ROOT, "build"))
    try:
        launches, sites, fq, golden_text, windows = main_path(device, work, rng, card)
        fixtures(device)

        t0 = time.monotonic()
        cohort = make_cohort(device, 20261017, N_COHORT)
        print(f"phase 5: generated a {N_COHORT}-sample cohort of {N_SITES} sites in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        pair = check_pair_stats(device, cohort, card)
        block = check_pair_block_stats(device, cohort, card)
        launches["pair_stats"], count_files = eval_main_path(cohort, work, card)
        eval_cohort(device, cohort, card)
        del cohort
        eval_fixtures()
        rotation = spread_rotation()
        in_cli = eval_pca_path(device, work, rotation, card)
        in_scorer, alone = eval_pca_cohort(device, rotation, work, card)
        # the -p path's launches: phase 10's CLI run and phase 11's scorer run
        launches["pair_block_stats"], launches["pair_block_stats_sparse"] = (
            x + y for x, y in zip(in_cli, in_scorer))
        for key, val in alone["tiles"].items():
            if key in ("ms", "list_ms", "plan_ms", "density", "tile_density", "tiles",
                       "sparse_pairs"):
                block["tiles"][f"n3202_{key}"] = val
        block["sparse"]["n3202_ms"] = alone["sparse"]["ms"]
        hashes_codes = {k: check_window_hash_codes(device, rng, k, card) for k in (19, 31, 32)}
        launches["count_step_v1"], step_v1 = v1_path(device, sites, fq, golden_text, card)
        gathers = {name: gather_program(device, name, card) for name in ("p1", "p2")}
        dma = dma_probe_program(device, card)
        standalone, _ = count_kernels_program(device, work, card)
        launches.update(standalone)
        t0 = time.monotonic()
        panel = panel_path(work, card)
        full_secs = full_width_vcf(work, sites, windows)
        api_run = api_path(sites, fq, golden_text, launches["count_step"], count_files, work, card)
        host = {**panel["secs"], **{f"17e {k}": v for k, v in full_secs.items()},
                **{f"api.{k}": v for k, v in api_run["secs"].items()}}
        print(f"phases 17-18: {time.monotonic() - t0:.1f} s in all; host seconds by step "
              f"{json.dumps({k: round(v, 3) for k, v in host.items()})}", flush=True)
        # the new paths' launches: phase 18's api.count and api.evaluate, 17c's eval -p
        launches["count_step"] += api_run["count_step"]
        launches["pair_stats"] += api_run["pair_stats"]
        launches["pair_block_stats"] += panel["launches"][0]
        launches["pair_block_stats_sparse"] += panel["launches"][1]
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
        dict(name="count_step", route="cuda",
             source="ntsm_tpu_torch/csrc/hash_probe_count.cu",
             replaces="ntsm_tpu/count/pallas_kernel.py:162 + ntsm_tpu/count/kernel_v3.py:270",
             launches=launches["count_step"], **steps[K]),
        dict(name="pair_stats", route="cuda",
             source="ntsm_tpu_torch/csrc/pair_stats.cu",
             replaces="ntsm_tpu/eval/pallas_joint.py:54",
             launches=launches["pair_stats"], **pair),
        dict(name="pair_block_stats", route="cuda",
             source="ntsm_tpu_torch/csrc/pair_block_stats.cu",
             replaces="ntsm_tpu/eval/kernels.py:317",
             launches=launches["pair_block_stats"], **block["tiles"]),
        dict(name="pair_block_stats_sparse", route="cuda",
             source="ntsm_tpu_torch/csrc/pair_block_stats.cu",
             replaces="ntsm_tpu/eval/kernels.py:317",
             launches=launches["pair_block_stats_sparse"], **block["sparse"]),
        dict(name="window_hash_codes", route="cuda",
             source="ntsm_tpu_torch/csrc/window_hash.cu",
             replaces="ntsm_tpu/count/pallas_kernel.py:148",
             launches=launches["window_hash_codes"], **hashes_codes[K]),
        dict(name="count_step_v1", route="cuda",
             source="ntsm_tpu_torch/csrc/hash_bucket_count.cu",
             replaces="ntsm_tpu/count/pallas_kernel.py:148 + ntsm_tpu/count/kernel.py:52",
             launches=launches["count_step_v1"], **step_v1),
        dict(name="gather_p1", route="cuda", source="ntsm_tpu_torch/csrc/gather.cu",
             replaces="scripts/exp_pallas_gather.py:10", **gathers["p1"]),
        dict(name="gather_p2", route="cuda", source="ntsm_tpu_torch/csrc/gather.cu",
             replaces="scripts/exp_pallas_gather2.py:11", **gathers["p2"]),
        dict(name="dma_probe", route="cuda", source="ntsm_tpu_torch/csrc/dma_probe.cu",
             replaces="scripts/exp_dma_probe.py:53", **dma),
    ]
    summary = ("summary: every phase passed: 2, 12 the count kernels bit-exact to their plain "
               "versions; 3, 4, 13 counts.txt byte-identical to golden and the fixtures; 5, 9 "
               "the pair kernels bit-exact; 6, 10 eval -a and -p = --engine exact; 7, 11 the "
               "N = 3202 scorers; 8 the eval fixtures; 14-16 the experiment programs; 17a 13 "
               "nested tiers; 17b vcf -p = generate-pca-rot-mat's matrix and centers, the "
               "rotation orthonormal, the components the centred matrix times it; 17c eval -p "
               "on the panel = --engine exact with K5 launched and the copy pairs called the "
               "same; 17d the vcf fixtures byte-identical; 17e 96,287 sites' max counts = "
               "their genotypes; 18 the API = the CLIs and golden, on the card")
    return kernels, summary


if __name__ == "__main__":
    sys.exit(main())
