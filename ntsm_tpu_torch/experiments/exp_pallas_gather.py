"""P1 on the card (counterpart of scripts/exp_pallas_gather.py): a gather
from a table that fits in L2, at the script's shapes and seed.

    python -m ntsm_tpu_torch.experiments.exp_pallas_gather

(a) the 1-D gather tbl[idx] from a 2^20 u32 table (4 MB) with [4096, 128]
indices, and (b) take_along_axis(tbl, idx, axis=0) from a [8192, 128] u32
table.  Prints the launch floor, whether each form is correct against its
plain version, its time and M gathers/s, and the one PyTorch call's time;
then (a) on sequential indices, which read each 32-B sector of the table
once for 8 gathers where the random ones read a sector a gather; then (a)
timed as the script did: CHAIN calls in a chain, each fed the last output
masked to the table.  Exits 1 with no CUDA device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ntsm_tpu_torch.experiments.gather import (
    IN_STREAM, exit_code, gather_1d, gather_1d_plain, in_stream_ms, program, to_tensor)
from ntsm_tpu_torch.utils.timing import device_ms

TBL = 1 << 20  # 4 MB u32 table
R = 4096
CHAIN = 30  # chained calls the script timed


def cases(device, seed: int = 0) -> list:
    """(label, form, tbl, idx) of the script's two forms, drawn in its order."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**32, size=TBL, dtype=np.uint32)
    idx = rng.integers(0, TBL, size=(R, 128), dtype=np.int32)
    tbl2 = rng.integers(0, 2**32, size=(8192, 128), dtype=np.uint32)
    idx2 = rng.integers(0, 8192, size=(R, 128), dtype=np.int32)
    return [
        ("1D-table gather (4MB table, 524288 idx)", "gather_1d",
         to_tensor(tbl, device), to_tensor(idx, device)),
        ("take_along_axis(axis=0) ([8192,128] table)", "take_along_axis0",
         to_tensor(tbl2, device), to_tensor(idx2, device)),
    ]


def sequential_time(tbl: torch.Tensor, idx: torch.Tensor) -> dict:
    """(a) on sequential indices, arange(n) in idx's shape: the same
    gathers, a 32-B sector of the table for 8 of them (coalesced) where the
    random indices take a sector each; checked against the plain version,
    timed as run_forms times a form; printed."""
    seq = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device).view(idx.shape)
    res = dict(correct=torch.equal(gather_1d(tbl, seq), gather_1d_plain(tbl, seq)),
               n=seq.numel(), ms=device_ms(lambda: gather_1d(tbl, seq)),
               per_launch_ms=in_stream_ms(lambda: gather_1d(tbl, seq)))
    print(f"1D-table gather on sequential indices (arange({res['n']})): correct: "
          f"{res['correct']}\n  {res['ms']:.4f} ms, {res['per_launch_ms']:.4f} ms a launch of "
          f"{IN_STREAM} back to back", flush=True)
    return res


def chain(tbl: torch.Tensor, idx: torch.Tensor, n: int, gather=gather_1d) -> torch.Tensor:
    """n chained gathers, each fed the last output masked to the table
    (o & (TBL - 1)), as scripts/exp_pallas_gather.py:chain_time serialises
    its calls; the table's size is a power of two."""
    o = idx
    for _ in range(n):
        o = gather(tbl, o & (tbl.shape[0] - 1))
    return o


def chain_time(tbl: torch.Tensor, idx: torch.Tensor, n: int = CHAIN) -> dict:
    """The script's timing of the 1-D gather on the card: after a warm-up
    step (the gather and the mask, whose first call would load its kernel),
    n chained calls on the host clock, ending in a synchronize, over n;
    printed in the script's form."""
    chain(tbl, idx, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain(tbl, idx, n)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    print(f"timing 1D-table gather ({tbl.nbytes >> 20} MB table, {idx.numel()} idx):")
    print(f"  {dt * 1e3:.3f} ms for {idx.numel()} gathers -> {idx.numel() / dt / 1e6:.0f} "
          "M gathers/s", flush=True)
    return dict(ms=dt * 1e3, n=idx.numel(), calls=n)


def run() -> dict | None:
    """The program: its results (gather.program: the floor, one dict a form,
    (a) on sequential indices, the chained timing), or None when no card is
    there."""
    return program(cases, extra=lambda made: dict(sequential=sequential_time(*made[0][2:]),
                                                  chain=chain_time(*made[0][2:])))


def main() -> int:
    return exit_code(run())


if __name__ == "__main__":
    sys.exit(main())
