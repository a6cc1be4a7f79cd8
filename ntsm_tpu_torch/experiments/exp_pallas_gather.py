"""P1 on the card (counterpart of scripts/exp_pallas_gather.py): a gather
from a table that fits in L2, at the script's shapes and seed.

    python -m ntsm_tpu_torch.experiments.exp_pallas_gather

(a) the 1-D gather tbl[idx] from a 2^20 u32 table (4 MB) with [4096, 128]
indices, and (b) take_along_axis(tbl, idx, axis=0) from a [8192, 128] u32
table.  Prints whether each form is correct against its plain version,
its time and M gathers/s, and the one PyTorch call's time; exits 1 with
no CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np

from ntsm_tpu_torch.experiments.gather import exit_code, program, to_tensor

TBL = 1 << 20  # 4 MB u32 table
R = 4096


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


def run() -> list[dict] | None:
    """The program: its results, one dict a form (gather.run_forms), or None
    when no card is there."""
    return program(cases)


def main() -> int:
    return exit_code(run())


if __name__ == "__main__":
    sys.exit(main())
