"""P3 on the card (counterpart of scripts/exp_dma_probe.py): can a ring of
asynchronous copies gather random 512-B fingerprint rows faster than a
plain gather?

    python -m ntsm_tpu_torch.experiments.exp_dma_probe [OUT_DIR]

The v3 fingerprint plane (NB = 2^22 buckets x 8 slots of u8, 32 MiB) seen
as [65536, 128] u32 rows of 64 buckets each; 512 launches of 4096 random
row indices (seed 0).  :func:`xor_probe` fetches every indexed row through
``csrc/dma_probe.cu``'s depth-S ring (one CUDA block a launch) and
XOR-reduces the rows into one [128] u32; :func:`xor_probe_plain` is
``fp[idx.flatten()]`` and a halving XOR tree.  Prints, for depths 4, 16
and 64, whether the kernel is correct, its time and M rows/s beside the
plain gather's (``fp[idx.flatten()]`` alone), then the ring at depth 64 on
sequential indices (:func:`sequential_idx`: the same 2M rows of 512 B,
every row fetched, no randomness), the floor of what the random ones can
reach.  With OUT_DIR, also compiles ``csrc/dma_probe.cu`` with ``-Xptxas
-v`` (registers, shared memory, spills) into it.  Exits 1 with no CUDA
device.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.experiments import exp_count_kernels
from ntsm_tpu_torch.utils.timing import card_line, device_ms

NB = 1 << 22  # buckets of the v3 fp plane
ROWS = NB // 64  # [ROWS, 128] u32 view: 64 buckets' 8-B rows in a 512-B row
LANES = 128
N_IDX = 4096  # indices a launch
SCAN = 512  # launches
DEPTHS = (4, 16, 64)
MAX_DEPTH = 64  # 64 ring slots: 32 KB of shared memory

launches = 0


def xor_probe_plain(fp: torch.Tensor, idx_s: torch.Tensor) -> torch.Tensor:
    """XOR of the rows fp[idx_s[s, i]] over all s and i: [128] int32."""
    rows = fp[idx_s.reshape(-1)]
    while rows.shape[0] > 1:
        if rows.shape[0] % 2:
            rows = torch.cat([rows, torch.zeros_like(rows[:1])])
        half = rows.shape[0] // 2
        rows = rows[:half] ^ rows[half:]
    return rows[0] if rows.shape[0] else torch.zeros(fp.shape[1], dtype=fp.dtype, device=fp.device)


def xor_probe(fp: torch.Tensor, idx_s: torch.Tensor, depth: int) -> torch.Tensor:
    """The XOR of the rows fp[idx_s[s, i]] (fp [rows, 128] int32, the u32
    plane's bits; idx_s [S, N] int32 row indices), fetched through a ring of
    `depth` slots on the card; [128] int32.  CPU tensors run the plain
    version.  An index out of range is the caller's fault."""
    global launches
    for name, t, dim in (("fp", fp, 2), ("idx_s", idx_s, 2)):
        if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"xor_probe: {name} must be a contiguous 2-D int32 tensor")
    if fp.shape[1] != LANES:
        raise ValueError(f"xor_probe: fp rows must be {LANES} values (512 B), got {fp.shape[1]}")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"xor_probe: depth must be in [1, {MAX_DEPTH}], got {depth}")
    if fp.device != idx_s.device:
        raise ValueError("xor_probe: fp and idx_s must be on the same device")
    if fp.device.type == "cpu":
        return xor_probe_plain(fp, idx_s)
    if fp.device.type != "cuda":
        raise ValueError(f"xor_probe: unsupported device {fp.device}")
    if fp.data_ptr() % 16:
        raise ValueError("xor_probe: fp must be 16-B aligned (16-B copies)")
    lib = csrc.load()
    out = torch.zeros(LANES, dtype=torch.int32, device=fp.device)
    rc = lib.ntsm_dma_probe(
        ctypes.c_void_p(fp.data_ptr()), ctypes.c_void_p(idx_s.data_ptr()),
        idx_s.shape[0], idx_s.shape[1], depth, ctypes.c_void_p(out.data_ptr()),
        csrc.stream_ptr(fp.device),
    )
    csrc.check(lib, rc, "dma_probe")
    launches += 1
    return out


def inputs(device, seed: int = 0, n_launch: int = SCAN):
    """(fp [ROWS, 128], idx_s [n_launch, N_IDX]) int32 as the script draws them."""
    rng = np.random.default_rng(seed)
    fp = rng.integers(0, 2**32, size=(ROWS, LANES), dtype=np.uint32)
    idx_s = rng.integers(0, ROWS, size=(n_launch, N_IDX), dtype=np.int32)
    return (torch.from_numpy(fp.view(np.int32)).to(device),
            torch.from_numpy(idx_s).to(device))


def sequential_idx(device, n_launch: int = SCAN) -> torch.Tensor:
    """idx_s[s, i] = (s * N_IDX + i) mod ROWS: [n_launch, N_IDX] int32."""
    return (torch.arange(n_launch * N_IDX, dtype=torch.int32, device=device) % ROWS
            ).reshape(n_launch, N_IDX)


def run(device) -> dict:
    """The program's body on `device`: prints and returns its results.
    Keys: depths, one dict a depth (depth, correct and, on the card, ms);
    sequential, the same for depth MAX_DEPTH on :func:`sequential_idx`;
    n_rows; n_bytes and n_ops, what the bound counts; and on the card
    plain_ms (gather + XOR tree), gather_ms (fp[idx.flatten()] alone),
    plane_bytes, l2_bytes.  CPU tensors run the plain version, untimed."""
    fp, idx_s = inputs(device, n_launch=SCAN)
    n = idx_s.numel()
    want = xor_probe_plain(fp, idx_s)
    # bytes: the indices, each row they touch once, 512 B out; operations:
    # one 32-bit XOR a u32 of every fetched row
    res = dict(depths=[], n_rows=n, n_ops=n * LANES,
               n_bytes=idx_s.nbytes + int(torch.unique(idx_s).numel()) * LANES * 4 + want.nbytes)
    cuda = device.type == "cuda"
    if cuda:
        print(card_line(), flush=True)
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        res.update(plane_bytes=fp.nbytes, l2_bytes=l2)
        print(f"the {fp.nbytes / 2**20:.0f} MiB plane is "
              f"{'L2-resident' if fp.nbytes < l2 else 'larger than L2'} on this card "
              f"(L2 {l2 / 1e6:.0f} MB)", flush=True)
    for depth in DEPTHS:
        ok = torch.equal(xor_probe(fp, idx_s, depth), want)
        row = dict(depth=depth, correct=ok)
        if cuda:
            row["ms"] = device_ms(lambda: xor_probe(fp, idx_s, depth))
            print(f"DMA probe depth={depth:3d}: {row['ms']:8.4f} ms for {n} rows "
                  f"({n / row['ms'] / 1e3:8.2f} M rows/s)  correct={ok}", flush=True)
        else:
            print(f"DMA probe depth={depth:3d}: {n} rows  correct={ok} (plain, untimed)",
                  flush=True)
        res["depths"].append(row)
    seq = sequential_idx(device, idx_s.shape[0])
    ok = torch.equal(xor_probe(fp, seq, MAX_DEPTH), xor_probe_plain(fp, seq))
    res["sequential"] = row = dict(depth=MAX_DEPTH, correct=ok)
    if cuda:
        row["ms"] = device_ms(lambda: xor_probe(fp, seq, MAX_DEPTH))
        print(f"DMA probe depth={MAX_DEPTH:3d} on sequential indices (the floor): "
              f"{row['ms']:8.4f} ms for {n} rows ({n / row['ms'] / 1e3:8.2f} M rows/s)  "
              f"correct={ok}", flush=True)
    else:
        print(f"DMA probe depth={MAX_DEPTH:3d} on sequential indices: {n} rows  correct={ok} "
              f"(plain, untimed)", flush=True)
    if cuda:
        flat = idx_s.reshape(-1)
        res["gather_ms"] = device_ms(lambda: fp[flat])
        res["plain_ms"] = device_ms(lambda: xor_probe_plain(fp, idx_s), iters=5)
        print(f"plain gather fp[idx.flatten()] alone: {res['gather_ms']:8.4f} ms for {n} rows "
              f"({n / res['gather_ms'] / 1e3:8.2f} M rows/s); with the XOR tree "
              f"{res['plain_ms']:8.4f} ms", flush=True)
    return res


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: nothing run", file=sys.stderr)
        return 1
    if argv:
        os.makedirs(argv[0], exist_ok=True)
        exp_count_kernels.build(argv[0], names=("dma_probe",))
    res = run(torch.device("cuda", 0))
    return 0 if all(d["correct"] for d in [*res["depths"], res["sequential"]]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
