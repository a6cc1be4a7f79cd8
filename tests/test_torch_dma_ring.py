"""A numpy model of the ring csrc/dma_probe.cu runs on the card (P3), run
under random interleavings of its warps and copies.

The card kernel cannot run here, so its schedule is restated step by step:
warp c of W owns the slots s < depth with s % W == c and reads the rows
i with (i % depth) % W == c in order, its row k being
k // n_slots * depth + c + W * (k % n_slots); it starts the copies of its
first n_slots rows (an empty group past its last row keeps the count),
then for each row waits until at most n_slots - 1 of its newest groups are
pending (cp.async.wait_group), XORs the row into its 32 x 4 u32 lanes and
refills the slot with its row n_slots later; copies land in any order, and
the blocks' combined accumulators are XORed together.  Integer data: every
comparison is exact."""

import os
import re

import numpy as np
import pytest

from tests.test_torch_experiments import _script_oracle

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "ntsm_tpu_torch", "csrc",
                   "dma_probe.cu")


def kernel_warps() -> int:
    with open(SRC) as fh:
        return int(re.search(r"constexpr int kWarps = (\d+);", fh.read()).group(1))


def warp_rows(c: int, n: int, depth: int, W: int) -> tuple[int, list[int]]:
    """(n_slots, rows) of warp c, by the kernel's arithmetic."""
    n_slots = (depth - c + W - 1) // W if depth > c else 0
    rem = n % depth
    n_rows = n // depth * n_slots + ((rem - c + W - 1) // W if rem > c else 0)
    return n_slots, [k // n_slots * depth + c + W * (k % n_slots) for k in range(n_rows)]


def run_block(fp, idx, depth, W, rng, pending=None, lazy=False) -> tuple[np.ndarray, dict]:
    """One block under a random interleaving (`lazy`: copies land only when
    no warp can move); returns its [128] u32 result and a log: issued (row
    -> slot), consumed (row -> warp), misread (rows whose slot held other
    bytes when read), in_flight_at_end.  `pending` (default n_slots - 1) is
    the groups a warp leaves pending at its wait."""
    n = idx.size
    held = [None] * depth      # the row whose bytes the slot holds
    occupant = [None] * depth  # the row last issued into the slot
    in_flight = {}             # (warp, group) -> (row, slot)
    log = dict(issued={}, consumed={}, misread=[])
    plan = [warp_rows(c, n, depth, W) for c in range(W)]
    groups = [[] for _ in range(W)]  # per warp, in commit order: landed?
    pro = [0] * W                    # prologue groups committed
    pos = [0] * W                    # rows read
    acc = [np.zeros((32, 4), dtype=np.uint32) for _ in range(W)]

    def issue(c: int, row: int) -> None:
        s = row % depth
        assert s % W == c, f"warp {c} issues into slot {s}, not its own"
        assert row not in log["issued"], f"row {row} issued twice"
        # the slot's previous row has been read before it is refilled
        assert occupant[s] is None or occupant[s] in log["consumed"], f"slot {s} refilled early"
        log["issued"][row] = s
        occupant[s] = row
        in_flight[(c, len(groups[c]))] = (row, s)
        groups[c].append(False)

    def step(c: int) -> bool:
        n_slots, rows = plan[c]
        if pro[c] < n_slots:
            if pro[c] < len(rows):
                issue(c, rows[pro[c]])
            else:
                groups[c].append(True)  # an empty group
            pro[c] += 1
            return True
        k = pos[c]
        keep = n_slots - 1 if pending is None else pending
        if not all(groups[c][:len(groups[c]) - keep]):
            return False
        row, s = rows[k], rows[k] % depth
        if held[s] != row:
            log["misread"].append(row)
        if held[s] is not None:
            acc[c] ^= fp[idx[held[s]]].reshape(32, 4)
        log["consumed"][row] = c
        if k + n_slots < len(rows):
            assert rows[k + n_slots] % depth == s
            issue(c, rows[k + n_slots])
        else:
            groups[c].append(True)
        pos[c] += 1
        return True

    while True:
        # a warp with no row skips the ring (n_rows == 0)
        busy = [c for c in range(W) if plan[c][1] and (pro[c] < plan[c][0]
                                                       or pos[c] < len(plan[c][1]))]
        if not busy:
            break
        warps = [("w", c) for c in rng.permutation(busy)]
        lands = [("l", key) for key in in_flight]
        actors = warps + [lands[a] for a in rng.permutation(len(lands))]
        if not lazy:
            actors = [actors[a] for a in rng.permutation(len(actors))]
        for kind, x in actors:
            if kind == "l":
                row, s = in_flight.pop(x)
                held[s] = row
                groups[x[0]][x[1]] = True
                break
            if step(x):
                break
        else:
            raise AssertionError(f"deadlock: warps {busy} wait, nothing in flight")
    log["in_flight_at_end"] = len(in_flight)
    # the combine: XOR of the W accumulators, lane l's 4 u32 at 4l..4l+3
    out = np.zeros(128, dtype=np.uint32)
    for a in acc:
        out ^= a.reshape(128)
    return out, log


def run_ring(fp, idx_s, depth, W, seed, pending=None, lazy=False):
    """Every block of idx_s [S, N] through the model, atomicXor'ed into out."""
    rng = np.random.default_rng(seed)
    out = np.zeros(128, dtype=np.uint32)
    logs = []
    for idx in idx_s:
        got, log = run_block(fp, idx, depth, W, rng, pending, lazy)
        out ^= got
        logs.append(log)
    return out, logs


def _world(seed: int, n: int, n_launch: int):
    rng = np.random.default_rng(seed)
    fp = rng.integers(0, 2**32, size=(40, 128), dtype=np.uint32)
    return fp, rng.integers(0, 40, size=(n_launch, n), dtype=np.int32)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n_idx", [1, 7, 33, "depth-1", 4096])
@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("depth", [1, 2, 4, 16, 64])
def test_ring_model(depth, W, n_idx, lazy):
    n = depth - 1 if n_idx == "depth-1" else n_idx
    fp, idx_s = _world(depth * 100 + W * 10 + n % 97, n, 2 if n < 4096 else 1)
    out, logs = run_ring(fp, idx_s, depth, W, seed=n + depth, lazy=lazy)
    for log in logs:
        # every index issued once into slot i % depth and read once by the
        # slot's warp, after its copy landed and before the slot's refill
        assert sorted(log["issued"]) == list(range(n))
        assert all(s == i % depth for i, s in log["issued"].items())
        assert sorted(log["consumed"]) == list(range(n))
        assert all(c == i % depth % W for i, c in log["consumed"].items())
        if depth % W == 0:  # the slot's warp is the row's warp i % W
            assert all(c == i % W for i, c in log["consumed"].items())
        assert log["misread"] == [] and log["in_flight_at_end"] == 0
    np.testing.assert_array_equal(out, _script_oracle(fp, idx_s))


@pytest.mark.parametrize("depth,n", [(4, 7), (16, 33), (64, 4096), (63, 100)])
def test_warp_rows_partition_the_indices(depth, n):
    """The kernel's index arithmetic: the warps' rows are the indices, each
    once, warp c's in increasing order with slots c, c + W, ... a round."""
    W = kernel_warps()
    seen = []
    for c in range(W):
        n_slots, rows = warp_rows(c, n, depth, W)
        assert rows == sorted(rows) == [i for i in range(n) if i % depth % W == c]
        assert n_slots == len(range(c, depth, W)) <= 16
        seen += rows
    assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("depth", [4, 16, 64])
def test_one_group_too_many_pending_misreads(depth):
    """A wait that leaves n_slots groups pending, one too many, reads rows
    before they land when copies land late: the model tells."""
    fp, idx_s = _world(depth, 256, 1)
    _, logs = run_ring(fp, idx_s, depth, kernel_warps(), seed=depth,
                       pending=depth // kernel_warps(), lazy=True)
    assert logs[0]["misread"]


def test_model_covers_the_kernels_warp_count():
    """The model's W includes the kernel's kWarps, which divides each of the
    program's depths (so row i belongs to warp i % kWarps there)."""
    from ntsm_tpu_torch.experiments import exp_dma_probe

    W = kernel_warps()
    assert W in (1, 2, 4)
    assert all(d % W == 0 for d in exp_dma_probe.DEPTHS)
