"""The v2 count step, timed on the card at the engine's batch:

    python -m ntsm_tpu_torch.experiments.exp_v2_step [OUT_DIR]

On the batch of chip_smoke.py's phase 19 (:func:`v2_batch`: 32768 reads x
256, random bases, 2% N, ragged read ends, k = 19, uploaded as the engine
uploads it) and a table of the human site set's size (96,287 sites x 26
k-mers: 2^20 buckets of 16) holding 40,000 of the batch's k-mers, fewer
hits than TOPK as in whole genomes:

* ``step``: ``count/kernel_v2.py:count_step_v2``, the lookup and the
  ordering stage of csrc/hash_bucket_hits.cu, on the table's keys as four
  planes (the engine's) and as rows (``TableV2(layout="rows")``);
* ``lookup``, ``order``: its two kernels timed apart in the same calls
  (``utils/timing.py:device_ms_parts``);
* ``order_plain``, ``sort``: the ordering stage's plain version
  (``order_hits_plain``) and ``torch.sort`` of the zero-padded ids, the
  library call it replaces, on the same ids;
* the bounds (:func:`bounds`): the bytes the step must move with 128 B a
  distinct bucket the valid windows reach, and with the 32-byte sectors
  these lookups need; the ordering stage's.

The step's triple must equal ``count_step_v2_plain``'s and the ordering
stage's array ``order_hits_plain``'s (exit 1 otherwise).  Device times,
two rounds of 20 calls.  Also compiles hash_bucket_hits.cu with ``-Xptxas
-v`` into OUT_DIR (default ``build/exp_v2_step``), with a JSON of the
times.  Run by path from the root of a checkout whose package has no
TableV2 (the one-kernel step with torch.sort), with that checkout on
PYTHONPATH, it times that checkout's step, so that the designs can be
compared in one call.  Exits 1 with no CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.count import kernel_v2
from ntsm_tpu_torch.experiments.exp_count_kernels import (
    N_TABLE, build, fused_batch, real_table, split)
from ntsm_tpu_torch.io.sites import build_lookup
from ntsm_tpu_torch.utils.timing import card_line, device_ms

B, L, K = 32768, 256, 19
N_REAL = 40_000  # the batch's k-mers among the table's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
OPS32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
WINDOW_OPS64 = 35  # a valid window's canonical min, hash64 and lookup, 64-bit ops
SECTOR_SLOTS = 4  # keys a 32-byte sector (count/kernel_v2.SECTOR_SLOTS)


def v2_batch(device):
    """(packed, vbits, h, valid, hashes, lookup): phase 19's batch, its
    plain window hashes, and the table's hashes and host lookup table."""
    rng = np.random.default_rng(2)
    packed, vbits = split(fused_batch(device, rng, K, rows=B, seglen=L), L)
    h, valid = kernel_v2.window_hashes_packed(packed, vbits, K, L)
    hashes = real_table(h, valid, rng, n_real=N_REAL, n_table=N_TABLE)
    return packed, vbits, h, valid, hashes, build_lookup(hashes, slots=kernel_v2.SLOTS_V2)


def _bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS32_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return dict(bound_ms=max(t_bytes, t_ops), bound_by=by, bytes=n_bytes)


def bounds(packed, vbits, h, valid, keys, vals, n_kmers: int, cap: int) -> dict:
    """The step's least time on the card (the larger of its bytes at 3.35
    TB/s and its operations, ~35 64-bit ones a valid window, at 67 T/s),
    two ways: "rows", the batch in, one 128-byte key row for each distinct
    bucket a valid window reaches and four bytes a hit out; "sectors", what
    these lookups need: for each distinct bucket, the 32-byte sectors up to
    the lowest sector that decides each of its lookups (a hit's, or the
    bucket's first empty slot's; all four for a miss in the last bucket),
    and the
    whole [cap] id array and the totals out.  Also "order", the ordering
    stage's: the stored ids in, the [cap] array and the totals out."""
    n_buckets, slots = keys.shape
    hv = h[valid]
    bucket = hv & (n_buckets - 1)
    empty = (keys == kernel_v2.EMPTY_KEY) & (vals == n_kmers)
    match = (keys[bucket] == hv[:, None]) & ~empty[bucket]
    hit = match.any(dim=1)
    iota = torch.arange(slots, device=h.device)
    slot = torch.where(match, iota, slots).amin(dim=1)
    filled = (~empty).sum(dim=1)
    n_sectors = slots // SECTOR_SLOTS
    need = torch.where(hit, slot // SECTOR_SLOTS + 1,
                       torch.clamp(filled[bucket] // SECTOR_SLOTS + 1, max=n_sectors))
    need = torch.where((bucket == n_buckets - 1) & ~hit, n_sectors, need)
    most = torch.zeros(n_buckets, dtype=need.dtype, device=h.device)
    most.scatter_reduce_(0, bucket, need, reduce="amax")
    n_valid, n_found = int(hv.numel()), int(hit.sum())
    n_rows = int((most > 0).sum())
    batch = packed.numel() + vbits.numel()
    ops = n_valid * WINDOW_OPS64 * 2
    n_stored = min(n_found, cap)
    return dict(
        rows=_bound(batch + n_rows * slots * 8 + n_found * 4 + 16, ops),
        sectors=_bound(batch + int(most.sum()) * SECTOR_SLOTS * 8 + cap * 4 + 16, ops),
        order=_bound(n_stored * 4 + cap * 4 + 16, 0),
        n_valid=n_valid, n_found=n_found, distinct_buckets=n_rows,
        sectors_needed=int(most.sum()))


def step_kernels(packed, vbits, table) -> list:
    """The names of the CUDA kernels one step on a warm table runs, under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    kernel_v2.count_step_v2(packed, vbits, table, k=K, L=L)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kernel_v2.count_step_v2(packed, vbits, table, k=K, L=L)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def rounds(fn) -> list:
    return [device_ms(fn) for _ in range(2)]


def measure(device, packed, vbits, lookup, n: int) -> tuple:
    """(rows, ok): the step on each layout and its parts, checked against
    the plain versions (the current package); or the step alone (a
    checkout from before TableV2)."""
    cap = min(kernel_v2.TOPK, B * (L - K + 1))
    if not hasattr(kernel_v2, "TableV2"):
        keys, vals = kernel_v2.make_table_v2(lookup, device)
        want = kernel_v2.count_step_v2_plain(packed, vbits, keys, vals, k=K, L=L, n_kmers=n)
        got = kernel_v2.count_step_v2(packed, vbits, keys, vals, k=K, L=L, n_kmers=n)
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        step = rounds(lambda: kernel_v2.count_step_v2(packed, vbits, keys, vals, k=K, L=L,
                                                      n_kmers=n))
        return [dict(layout="rows (one kernel + torch.sort)", ok=ok, step=step)], ok
    from ntsm_tpu_torch.utils.timing import device_ms_parts

    out, ok = [], True
    for layout in kernel_v2.LAYOUTS:
        table = kernel_v2.make_table_v2(lookup, n, device, layout)
        want = kernel_v2.count_step_v2_plain(packed, vbits, table.keys, table.vals, k=K, L=L,
                                             n_kmers=n)
        got = kernel_v2.count_step_v2(packed, vbits, table, k=K, L=L)
        same_step = all(torch.equal(a, b) for a, b in zip(got, want))
        # the ordering stage alone, on the ids and counters one lookup leaves
        kernel_v2.lookup_launch(packed, vbits, table, k=K, L=L, cap=cap)
        ids = kernel_v2.stored_hits(table, cap)
        top, n_found, _ = kernel_v2.order_launch(table, cap)
        n_found = int(n_found)
        plain_top = kernel_v2.order_hits_plain(ids, n_found, cap)
        same_order = torch.equal(top, plain_top)
        ok &= same_step and same_order
        padded = plain_top.clone()
        padded[:min(n_found, cap)] = ids[:min(n_found, cap)]
        row = dict(layout=layout, ok=same_step and same_order, n_found=n_found,
                   order_err=float((top.double() - plain_top.double()).abs().max()))
        row["step"] = rounds(lambda: kernel_v2.count_step_v2(packed, vbits, table, k=K, L=L))
        parts = [device_ms_parts([
            lambda: kernel_v2.lookup_launch(packed, vbits, table, k=K, L=L, cap=cap),
            lambda: kernel_v2.order_launch(table, cap)]) for _ in range(2)]
        row["lookup"] = [p[0] for p in parts]
        row["order"] = [p[1] for p in parts]
        row["order_plain"] = rounds(lambda: kernel_v2.order_hits_plain(ids, n_found, cap))
        row["sort"] = rounds(lambda: torch.sort(padded, descending=True))
        if layout == "planes":
            row["kernels"] = step_kernels(packed, vbits, table)
        out.append(row)
        del table
    return out, ok


def run(device, out_dir: str, ptxas: bool = True):
    card = card_line()
    print(card, flush=True)
    t0 = time.monotonic()
    csrc.load()
    if ptxas:
        build(out_dir, names=("hash_bucket_hits",))
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    packed, vbits, h, valid, hashes, lookup = v2_batch(device)
    n = int(hashes.size)
    keys = torch.from_numpy(lookup.keys.view(np.int64)).to(device)
    vals = torch.from_numpy(lookup.vals).to(device)
    cap = min(kernel_v2.TOPK, B * (L - K + 1))
    bd = bounds(packed, vbits, h, valid, keys, vals, n, cap)
    del keys, vals
    print(f"v2 batch {B} x {L}, k={K}: {bd['n_valid']} valid windows, {bd['n_found']} found; "
          f"table {n} k-mers in {lookup.n_buckets} buckets of 16; {bd['distinct_buckets']} "
          f"distinct buckets reached, {bd['sectors_needed']} sectors needed; bound "
          f"{bd['rows']['bound_ms']:.4f} ms at 128 B a bucket ({bd['rows']['bytes'] / 1e6:.1f} MB), "
          f"{bd['sectors']['bound_ms']:.4f} ms at the sectors needed "
          f"({bd['sectors']['bytes'] / 1e6:.1f} MB), ordering stage "
          f"{bd['order']['bound_ms']:.4f} ms [{card}]", flush=True)
    rows, ok = measure(device, packed, vbits, lookup, n)
    for row in rows:
        times = "; ".join(f"{key} {row[key][0]:.4f} / {row[key][1]:.4f} ms"
                          for key in ("step", "lookup", "order", "order_plain", "sort")
                          if key in row)
        print(f"v2 step, keys as {row['layout']}: {'equal to' if row['ok'] else 'DIFFERS from'} "
              f"plain; {times} [{card}]", flush=True)
        if "kernels" in row:
            print(f"v2 step kernels under torch.profiler: {row['kernels']}", flush=True)
    result = {"card": card, "bounds": bd, "rows": rows}
    with open(os.path.join(out_dir, "v2_step.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result, ok


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exp_v2_step: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else os.path.join("build", "exp_v2_step")
    os.makedirs(out_dir, exist_ok=True)
    _, ok = run(torch.device("cuda", 0), out_dir)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
