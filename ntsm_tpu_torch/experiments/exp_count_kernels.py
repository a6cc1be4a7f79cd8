"""The count path's kernels, timed on the card at the engine's batches:

    python -m ntsm_tpu_torch.experiments.exp_count_kernels [OUT_DIR]

At the engine's batch of L = 256 (B = 32768 reads, k = 19, 31 and 32) and
of the longer segments L = 4096 and 65536 (k = 19; B = 32768 x 256 / L
reads, as ``--seglen`` sizes a batch), on a generated batch (random
bases, 2% N, ragged read ends; seed 20261017) uploaded as the engine
uploads it (one fused [B, 3L/8] row a read) and a table of phase 2's size
(96,287 sites x 26 k-mers) holding ``N_REAL`` distinct k-mers of the
batch's valid windows and random 38-bit hashes for the rest, so that the
probe finds real hits:

* ``k1``: the window hash alone (``count/hash_kernel.py:window_hashes``,
  csrc/window_hash.cu);
* ``k4``: the probe alone on K1's output (``count/kernel_v3.py:probe_count``,
  csrc/probe_count.cu);
* ``k1k4``: the two back to back, the per-batch device time of the path
  before the fused kernel;
* ``step``: the fused count step (``count/kernel_v3.py:count_step_v3``,
  csrc/hash_probe_count.cu), one launch a batch, which the v3 engine runs;
* ``l2``: the fused step without and with a persisting L2 access-policy
  window over the fingerprint plane (:func:`fingerprints_in_l2`), in
  turns: off, on, on, off.  The engine does not set the window.

and the v1 path's kernels at L = 256, 4096 and 65536 (k = 19, the same
batch sizes), on a batch of unpacked codes (:func:`codes_batch`: one read
a row, as the v1 engine uploads it) and a lookup table
(``io/sites.build_lookup``) of the same size and make-up:

* ``k2``: the window hash from codes alone
  (``count/hash_kernel.py:window_hashes_codes``, csrc/window_hash.cu);
* ``k2probe``: K2 then the plain bucket probe (``count/kernel.py:
  bucket_probe``), the v1 step before the fused kernel;
* ``v1step``: the fused v1 count step (``count/kernel.py:count_step``,
  csrc/hash_bucket_count.cu), which the v1 engine runs.

K1's and K2's output must equal their plain versions', and K4's and the
fused steps' counts and diag the plain probe's (exit 1 otherwise).  Times
are device times (``utils/timing.py:device_ms``), two rounds of 20 calls.  Also
compiles the count kernels' sources with ``-Xptxas -v`` (registers,
spills) into OUT_DIR (default ``build/exp_count_kernels``), with a JSON of
the times.  Run from the root of a checkout whose package has no fused
step (before it existed), it times K1, K4 and K1 + K4 alone, and without
the fused v1 step, K2 and K2 + the bucket probe, so that the designs can
be compared in one call.  Exits 1 with no CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.count import hash_kernel, kernel_v3
from ntsm_tpu_torch.count import kernel as kernel_v1
from ntsm_tpu_torch.count.kernel_v2 import (
    pack_batch_fast, window_hashes_codes_plain, window_hashes_packed)
from ntsm_tpu_torch.io.sites import build_lookup
from ntsm_tpu_torch.utils.timing import card_line, device_ms

B, L = 32768, 256
CASES = ((19, 256), (31, 256), (32, 256), (19, 4096), (19, 65536))  # (k, L)
V1_CASES = ((19, 256), (19, 4096), (19, 65536))  # (k, L) of the v1 path
N_TABLE = 96_287 * 26  # phase 2's table: the human site set's k-mers
N_REAL = 250_000  # distinct k-mers of the batch among them
COUNT_SOURCES = ("window_hash", "probe_count", "hash_probe_count", "hash_bucket_count")


def fused_batch(device, rng, k: int, rows: int = B, seglen: int = L) -> torch.Tensor:
    """[rows, 3 seglen / 8] u8 on `device`: packed bases then validity bits
    of random reads (2% N, read ends uniform in [k, seglen]), as the
    engine uploads a batch."""
    codes = rng.integers(0, 4, size=(rows, seglen), dtype=np.uint8)
    codes[rng.random((rows, seglen)) < 0.02] = 4
    ends = rng.integers(k, seglen + 1, size=rows)
    codes[np.arange(seglen)[None, :] >= ends[:, None]] = 4
    packed, vbits = pack_batch_fast(codes)
    return torch.from_numpy(np.concatenate([packed, vbits], axis=1)).to(device)


def codes_batch(device, rng, k: int, rows: int = B, seglen: int = L):
    """(codes [rows, seglen] u8, lengths [rows] int32) on `device`: one
    random read a row (2% N, lengths uniform in [k, seglen]), code 4 past
    its end, as the v1 engine uploads a batch."""
    codes = rng.integers(0, 4, size=(rows, seglen), dtype=np.uint8)
    codes[rng.random((rows, seglen)) < 0.02] = 4
    lengths = rng.integers(k, seglen + 1, size=rows).astype(np.int32)
    codes[np.arange(seglen)[None, :] >= lengths[:, None]] = 4
    return torch.from_numpy(codes).to(device), torch.from_numpy(lengths).to(device)


def split(fused: torch.Tensor, seglen: int = L):
    """(packed, vbits): the column slices of a fused upload."""
    return fused[:, : seglen // 4], fused[:, seglen // 4 :]


def real_table(h: torch.Tensor, valid: torch.Tensor, rng, n_real: int = N_REAL,
               n_table: int = N_TABLE) -> np.ndarray:
    """[<= n_table] distinct uint64 hashes: n_real distinct hashes of valid
    windows (fewer if the batch has fewer), then random 38-bit ones."""
    seen = torch.unique(h[valid]).cpu().numpy().view(np.uint64)
    real = rng.choice(seen, size=min(n_real, seen.size), replace=False)
    rand = rng.integers(0, (1 << 38) - 1, size=n_table - real.size, dtype=np.uint64)
    return rng.permutation(np.unique(np.concatenate([real, rand])))


def build(out_dir: str, names=COUNT_SOURCES) -> None:
    """-Xptxas -v of the kernel sources `names` (the count kernels' by
    default; those this checkout has) into out_dir; prints the register and
    spill lines."""
    nvcc = csrc._nvcc()
    src_dir = os.path.dirname(csrc.sources()[0])
    for name in names:
        src = os.path.join(src_dir, f"{name}.cu")
        if not os.path.exists(src):
            continue
        cubin = os.path.join(out_dir, f"{name}.cubin")
        res = subprocess.run([nvcc, *csrc.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin, src],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise RuntimeError(f"nvcc failed: {res.stdout}{res.stderr}")
        log = res.stdout + res.stderr
        with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as fh:
            fh.write(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:", line.strip(), flush=True)


@contextlib.contextmanager
def fingerprints_in_l2(table):
    """Run the block's work on a stream of its own whose persisting L2
    access-policy window covers the table's fingerprint plane (csrc
    ``ntsm_l2_window``: the L2 set aside for persisting lines, up to the
    device's maximum); yields the bytes set aside.  On exit the caller's
    stream waits for the block's work, and the window, the persisting lines
    and the set-aside are reset, so no later work inherits them.  On the
    CPU it does nothing (yields 0)."""
    if table.fp.device.type != "cuda":
        yield 0
        return
    lib = csrc.load()
    device = table.fp.device
    caller = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(caller)
    sizes = (ctypes.c_long * 2)()

    def window(on: bool) -> None:
        rc = lib.ntsm_l2_window(
            ctypes.c_void_p(table.fp.data_ptr() if on else 0), table.fp.nbytes if on else 0,
            ctypes.c_void_p(stream.cuda_stream), ctypes.cast(sizes, ctypes.c_void_p))
        csrc.check(lib, rc, "l2_window")

    window(True)
    try:
        with torch.cuda.stream(stream):
            yield sizes[0]
    finally:
        caller.wait_stream(stream)
        stream.synchronize()
        window(False)


def rounds(fn) -> list:
    return [device_ms(fn) for _ in range(2)]


def l2_turns(step, tab) -> dict:
    """The fused step without and with the L2 window over the fingerprint
    plane (:func:`fingerprints_in_l2`), in turns: off, on, on, off; the L2
    bytes the device sets aside for persisting lines; and the host ms of
    setting the window up and resetting it (the median of 5)."""
    out = {"off": [device_ms(step)]}
    with fingerprints_in_l2(tab) as set_aside:
        out["on"] = [device_ms(step), device_ms(step)]
    out["off"].append(device_ms(step))
    out["set_aside"] = set_aside
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fingerprints_in_l2(tab):
            pass
        times.append((time.perf_counter() - t0) * 1e3)
    out["window_host_ms"] = float(np.median(times))
    return out


def run_v1(device, rng, card: str):
    """(rows, ok): K2, K2 + the bucket probe and the fused v1 step (where
    the package has it) at V1_CASES, each checked against its plain
    version."""
    has_step = hasattr(kernel_v1, "launches_step")  # not before the fused v1 step
    same = lambda x: "equal to" if x else "DIFFERS from"  # noqa: E731
    rows, ok = [], True
    for k, seglen in V1_CASES:
        n_rows = B * L // seglen
        codes, lengths = codes_batch(device, rng, k, rows=n_rows, seglen=seglen)
        h, valid = hash_kernel.window_hashes_codes(codes, lengths, k)
        hp, vp = window_hashes_codes_plain(codes, lengths, k)
        same_k2 = torch.equal(valid, vp) and torch.equal(h[valid], hp[vp])
        hashes = real_table(h, valid, rng)
        n = int(hashes.size)
        keys, vals = kernel_v1.make_table_arrays(build_lookup(hashes), n, device)
        c_p = torch.zeros(n + 1, dtype=torch.int32, device=device)
        t_p = kernel_v1.bucket_probe(hp, vp, keys, vals, c_p, n_kmers=n)
        ok &= same_k2
        checks = f"K2 {same(same_k2)} plain"
        scratch = torch.zeros_like(c_p)
        row = dict(k=k, L=seglen, B=n_rows, totals=[int(t) for t in t_p], table=n,
                   n_buckets=int(keys.shape[0]))
        row["k2"] = rounds(lambda: hash_kernel.window_hashes_codes(codes, lengths, k))
        row["k2probe"] = rounds(lambda: kernel_v1.bucket_probe(
            *hash_kernel.window_hashes_codes(codes, lengths, k), keys, vals, scratch, n_kmers=n))
        if has_step:
            c_s = torch.zeros_like(c_p)
            t_s = kernel_v1.count_step(codes, lengths, keys, vals, c_s, k=k, n_kmers=n)
            same_step = torch.equal(c_s, c_p) and [int(t) for t in t_s] == row["totals"]
            ok &= same_step
            checks += f", v1 step {same(same_step)} plain"
            row["v1step"] = rounds(lambda: kernel_v1.count_step(
                codes, lengths, keys, vals, scratch, k=k, n_kmers=n))
        times = "; ".join(f"{key} {row[key][0]:.4f} / {row[key][1]:.4f} ms"
                          for key in ("k2", "k2probe", "v1step") if key in row)
        print(f"v1 k={k} L={seglen} B={n_rows}: n_valid, n_found {row['totals']} (table {n}, "
              f"{row['n_buckets']} buckets); {checks}; {times} [{card}]", flush=True)
        rows.append(row)
    return rows, ok


def run(device, out_dir: str, ptxas: bool = True):
    """(result, ok): every measurement at CASES; -Xptxas -v of the count
    sources first when `ptxas`."""
    card = card_line()
    print(card, flush=True)
    t0 = time.monotonic()
    csrc.load()
    if ptxas:
        build(out_dir)
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    has_step = hasattr(kernel_v3, "count_step_v3")  # not before the fused step
    result = {"card": card, "cases": []}
    ok = True
    same = lambda x: "equal to" if x else "DIFFERS from"  # noqa: E731
    rng = np.random.default_rng(20261017)
    for k, seglen in CASES:
        rows = B * L // seglen
        packed, vbits = split(fused_batch(device, rng, k, rows=rows, seglen=seglen), seglen)
        h, valid = hash_kernel.window_hashes(packed, vbits, k, seglen)
        hp, vp = window_hashes_packed(packed, vbits, k, seglen)
        same_k1 = torch.equal(valid, vp) and torch.equal(h[valid], hp[vp])
        hashes = real_table(h, valid, rng)
        tab = kernel_v3.TableV3.from_hashes(hashes, device)
        c_k = torch.zeros(tab.n_kmers + 1, dtype=torch.int32, device=device)
        c_p = torch.zeros_like(c_k)
        d_k = kernel_v3.probe_count(h, valid, tab, c_k)
        d_p = kernel_v3.probe_and_count(h, valid, tab.fp, tab.keys, tab.vals, c_p,
                                        n_buckets=tab.n_buckets, bbits=tab.bbits)
        same_k4 = torch.equal(c_k, c_p) and torch.equal(d_k, d_p)
        ok &= same_k1 and same_k4
        checks = f"K1 {same(same_k1)} plain, K4 {same(same_k4)} plain"
        scratch = torch.zeros_like(c_k)
        row = dict(k=k, L=seglen, B=rows, diag=d_k.tolist(), table=int(hashes.size),
                   n_buckets=tab.n_buckets)
        row["k1"] = rounds(lambda: hash_kernel.window_hashes(packed, vbits, k, seglen))
        row["k4"] = rounds(lambda: kernel_v3.probe_count(h, valid, tab, scratch))
        row["k1k4"] = rounds(lambda: kernel_v3.probe_count(
            *hash_kernel.window_hashes(packed, vbits, k, seglen), tab, scratch))
        if has_step:
            c_s = torch.zeros_like(c_k)
            d_s = kernel_v3.count_step_v3(packed, vbits, tab, c_s, k, seglen)
            same_step = torch.equal(c_s, c_p) and torch.equal(d_s, d_p)
            ok &= same_step
            checks += f", step {same(same_step)} plain"
            step = lambda: kernel_v3.count_step_v3(  # noqa: E731
                packed, vbits, tab, scratch, k, seglen)
            row["step"] = rounds(step)
        times = "; ".join(f"{key} {row[key][0]:.4f} / {row[key][1]:.4f} ms"
                          for key in ("k1", "k4", "k1k4", "step") if key in row)
        print(f"k={k} L={seglen} B={rows}: diag {row['diag']} (table {hashes.size}, "
              f"{tab.n_buckets} buckets); {checks}; {times} [{card}]", flush=True)
        if has_step:
            row["l2"] = l2 = l2_turns(step, tab)
            print(f"k={k} L={seglen}: step with an L2 window over the {tab.fp.nbytes} B fp "
                  f"plane ({l2['set_aside']} B set aside): off {l2['off'][0]:.4f}, on "
                  f"{l2['on'][0]:.4f}, on {l2['on'][1]:.4f}, off {l2['off'][1]:.4f} ms; set "
                  f"up and reset on the host in {l2['window_host_ms']:.3f} ms [{card}]",
                  flush=True)
        result["cases"].append(row)
    result["v1"], ok_v1 = run_v1(device, rng, card)
    ok &= ok_v1
    with open(os.path.join(out_dir, "count_kernels.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result, ok


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exp_count_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else os.path.join("build", "exp_count_kernels")
    os.makedirs(out_dir, exist_ok=True)
    _, ok = run(torch.device("cuda", 0), out_dir)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
