"""P2 on the card (counterpart of scripts/exp_pallas_gather2.py): four 2-D
gather forms from a [4096, 128] i32 table, at the script's shapes and seed.

    python -m ntsm_tpu_torch.experiments.exp_pallas_gather2

A: take_along_axis(axis=0) with [4096, 128] indices; B: the same with
[256, 128]; C: take_along_axis(axis=1), a gather within each row; D: the
row gather t[idx1d] of 256 rows.  Prints the launch floor, whether each
form is correct against its plain version, its time and M gathers/s, and
the one PyTorch call's time; exits 1 with no CUDA device.
"""

from __future__ import annotations

import sys

import numpy as np

from ntsm_tpu_torch.experiments.gather import exit_code, program, to_tensor

R = 256


def cases(device, seed: int = 0) -> list:
    """(label, form, tbl, idx) of the script's four forms, drawn in its order."""
    rng = np.random.default_rng(seed)
    tbl = to_tensor(rng.integers(0, 2**31, size=(4096, 128), dtype=np.int32), device)
    idx_a = rng.integers(0, 4096, size=(4096, 128), dtype=np.int32)
    idx_b = rng.integers(0, 4096, size=(R, 128), dtype=np.int32)
    idx_c = rng.integers(0, 128, size=(4096, 128), dtype=np.int32)
    idx_d = rng.integers(0, 4096, size=(R,), dtype=np.int32)
    return [
        ("A take_along_axis axis=0 same-shape", "take_along_axis0", tbl, to_tensor(idx_a, device)),
        ("B take_along_axis axis=0 fewer rows", "take_along_axis0", tbl, to_tensor(idx_b, device)),
        ("C take_along_axis axis=1", "take_along_axis1", tbl, to_tensor(idx_c, device)),
        ("D row gather t[idx1d]", "row_gather", tbl, to_tensor(idx_d, device)),
    ]


def run() -> dict | None:
    """The program: its results (gather.program: the floor, one dict a
    form), or None when no card is there."""
    return program(cases)


def main() -> int:
    return exit_code(run())


if __name__ == "__main__":
    sys.exit(main())
