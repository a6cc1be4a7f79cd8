"""The candidate-pair kernel of ``eval -p``, csrc/pair_block_stats.cu, timed
on the card at each of its instances:

    python -m ntsm_tpu_torch.experiments.exp_pair_block_stats [OUT_DIR]

On a generated 1,024 x 96,287-site cohort (exp_pair_stats.cohort, seed
20261017), ``-c 1``, each list planned once on the host
(``eval/pair_kernel.py:plan_pair_blocks``, timed) and then run through the
wrapper with its plan (device time, ``utils/timing.py:device_ms``):

* ``lists``: ``phase9``, chip_smoke.py's phase-9 shape (50,037 pairs grouped
  by i: a tenth of the rows with 300-1000 random j's, the rest 0-5), and
  ``j32``, the same i's with every j drawn from 32 rows (perfect reuse of
  the j rows, the same pair-sites), and ``clusters``, a list of eval -p's
  shape (sample s in cluster s % 16 listing half the later members of its
  cluster, every 50th sample an exhaustive row), each at the wrapper's
  threshold;
* ``sweep``: lists of tiles of a set density d (every 16 consecutive rows
  share 128 columns, each listed by 16 d of them), run all on the tile
  instance (in those tiles) and all on the sparse instance: their ms a
  slot and a pair, and the density where the two cost the same, the
  threshold ``pair_kernel.DENSITY_MIN`` should be.

On ``lists`` the ints must equal the plain version's and joint/ss lie
within 1e-12 relative of its (its sums run in another order); on a sweep
list the two instances must agree bit for bit (exit 1 otherwise).  Also
compiles csrc/pair_block_stats.cu and csrc/pair_stats.cu with ``-Xptxas
-v`` (registers, spills of each instance) into OUT_DIR (default
``build/exp_pair_block_stats``), with a JSON of the times.  Exits 1 with
no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.eval import pair_kernel
from ntsm_tpu_torch.experiments.exp_pair_stats import cohort
from ntsm_tpu_torch.utils.timing import card_line, device_ms

N, N_SITES, MC = 1024, 96_287, 1
DENSITIES = (1 / 16, 2 / 16, 3 / 16, 4 / 16, 6 / 16, 8 / 16, 12 / 16, 1.0)
SWEEP_COLS = 128  # columns a 16-row group of a sweep list


def grouped_pairs(rng, n: int, n_pairs: int):
    """chip_smoke.py:grouped_pairs: a tenth of the samples with runs of
    300-1000 pairs, the rest 0-5; j uniform on either side of i."""
    runs = np.where(rng.random(n) < 0.1, rng.integers(300, 1000, n), rng.integers(0, 6, n))
    ii = np.repeat(np.arange(n), runs)[:n_pairs]
    jj = (ii + rng.integers(1, n, ii.size)) % n
    return ii.astype(np.int32), jj.astype(np.int32)


def cluster_pairs(rng, n: int, k: int = 16, keep: float = 0.5):
    """An interleaved cluster list, as eval/pca.py gives a small-tier row's
    candidates: sample s is in cluster s % k, and i lists each later member
    of its cluster with probability `keep`, its j's in random order."""
    ii, jj = [], []
    for i in range(n):
        mem = np.arange(i + k, n, k)
        mem = mem[rng.random(mem.size) < keep]
        ii.append(np.full(mem.size, i))
        jj.append(rng.permutation(mem))
    return np.concatenate(ii).astype(np.int32), np.concatenate(jj).astype(np.int32)


def exhaustive_pairs(n: int, rows):
    """eval/pca.py's exhaustive rows: each i of `rows` (ascending) lists
    every j but itself and the exhaustive j <= i, in index order."""
    rows = np.asarray(rows)
    idx = np.arange(n)
    ii, jj = [], []
    for i in rows:
        ks = idx[~(np.isin(idx, rows) & (idx <= i)) & (idx != i)]
        ii.append(np.full(ks.size, i))
        jj.append(ks)
    return np.concatenate(ii).astype(np.int32), np.concatenate(jj).astype(np.int32)


def merged(*lists):
    """The lists' pairs grouped by i, ascending (stable: each i keeps its
    j order)."""
    ii = np.concatenate([li for li, _ in lists])
    jj = np.concatenate([lj for _, lj in lists])
    o = np.argsort(ii, kind="stable")
    return ii[o], jj[o]


def j32(ii: np.ndarray, jj: np.ndarray) -> np.ndarray:
    """jj folded onto rows [0, 32), moved off i where they meet."""
    j = jj % 32
    return np.where(j == ii, (j + 1) % 32, j).astype(np.int32)


def sweep_list(rng, n: int, density: float):
    """(ii, jj, plan): rows in groups of 16 consecutive samples; each group
    draws SWEEP_COLS columns outside itself, and column x of the group is
    listed by the 16 d rows (x + t) % 16, t < 16 d.  `plan` puts every pair
    on the tile instance, in tiles of 16 rows of a group by 16 of its
    columns: each tile has density d."""
    m = max(1, round(16 * density))
    ii, jj, t_rows, t_cols = [], [], [], []
    x = np.arange(SWEEP_COLS)
    for g0 in range(0, n, 16):
        cols = rng.choice(np.r_[0:g0, g0 + 16:n], SWEEP_COLS, replace=False)
        r = (x[:, None] + np.arange(m)[None, :]) % 16
        ii.append(g0 + r.ravel())
        jj.append(np.repeat(cols, m))
        t_rows += [g0 + np.arange(16)] * (SWEEP_COLS // 16)
        t_cols += list(cols.reshape(-1, 16))
    ii, jj = np.concatenate(ii), np.concatenate(jj)
    o = np.lexsort((jj, ii))
    ii, jj = ii[o].astype(np.int32), jj[o].astype(np.int32)
    rows, cols = np.array(t_rows), np.array(t_cols)
    key = ii.astype(np.int64) * n + jj
    slot = rows[:, :, None].astype(np.int64) * n + cols[:, None, :]
    p = np.searchsorted(key, slot).clip(max=key.size - 1)
    outs = np.where(key[p] == slot, p, -1)
    z = np.zeros(0, np.int32)
    plan = pair_kernel.PairPlan(n, ii.size, rows.astype(np.int32), cols.astype(np.int32),
                                outs.astype(np.int32), z.reshape(0, 1), z, z, z,
                                np.zeros((2, 0), np.int64))
    return ii, jj, plan


def build(out_dir: str) -> None:
    """-Xptxas -v of the two eval pair kernels into out_dir; prints the
    register and spill lines."""
    nvcc = csrc._nvcc()
    src_dir = os.path.dirname(csrc.sources()[0])
    for name in ("pair_block_stats", "pair_stats"):
        cubin = os.path.join(out_dir, f"{name}.cubin")
        res = subprocess.run([nvcc, *csrc.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin,
                              os.path.join(src_dir, f"{name}.cu")],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            raise RuntimeError(f"nvcc failed: {res.stdout}{res.stderr}")
        log = res.stdout + res.stderr
        with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as fh:
            fh.write(log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:", line.strip(), flush=True)


def call(a, b, s, ii: np.ndarray, jj: np.ndarray, plan):
    """(fn, outputs dict): fn() runs the wrapper on the planned list and
    leaves its result in outputs["out"]."""
    it, jt = torch.from_numpy(ii).to(a.device), torch.from_numpy(jj).to(a.device)
    outputs = {}

    def fn():
        outputs["out"] = pair_kernel.pair_block_stats(a, b, s, it, jt, MC, N_SITES, plan=plan)
    return fn, outputs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exp_pair_block_stats: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else os.path.join("build", "exp_pair_block_stats")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    t0 = time.monotonic()
    csrc.load()
    build(out_dir)
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    a, b = cohort(device, n=N)
    s = pair_kernel.s_single_plane(a, b, MC)
    result = {"card": card, "lists": {}, "sweep": {}}
    ok = True

    ii, jj = grouped_pairs(np.random.default_rng(9), N, 50_037)
    clusters = cluster_pairs(np.random.default_rng(10), N)
    lists = {"phase9": (ii, jj), "j32": (ii, j32(ii, jj)),
             "clusters": merged(clusters, exhaustive_pairs(N, np.arange(49, N, 50)))}
    for name, (li, lj) in lists.items():
        t0 = time.perf_counter()
        plan = pair_kernel.plan_pair_blocks(li, lj, N)
        plan_s = time.perf_counter() - t0
        fn, out = call(a, b, s, li, lj, plan)
        fn()
        it, jt = torch.from_numpy(li).to(device), torch.from_numpy(lj).to(device)
        want = pair_kernel.pair_block_stats_plain(a, b, s, it, jt, MC, N_SITES)
        rel = float(((out["out"][1] - want[1]).abs() / want[1].abs().clamp(min=1.0)).max())
        same = torch.equal(out["out"][0], want[0]) and rel <= 1e-12
        ok &= same
        ms = [device_ms(fn, iters=7) for _ in range(2)]
        print(f"{name}: {li.size} pairs, plan {plan_s * 1e3:.1f} ms: {plan.n_tiles} tiles "
              f"({plan.n_tiled} pairs, density {plan.tile_density():.3f}), {plan.n_sparse} "
              f"sparse, {plan.dup.shape[1]} repeats; density {plan.density():.3f}; "
              f"{ms[0]:.3f} / {ms[1]:.3f} ms, {li.size * N_SITES / min(ms) / 1e6:.1f} "
              f"Gpair-site/s; ints {'equal to' if same else 'DIFFER from'} plain, joint/ss "
              f"within {rel:.3g} relative [{card}]",
              flush=True)
        result["lists"][name] = dict(pairs=int(li.size), plan_s=plan_s, tiles=plan.n_tiles,
                                     tiled=plan.n_tiled, sparse=plan.n_sparse,
                                     density=plan.density(), ms=ms)

    rng = np.random.default_rng(11)
    per_slot, per_pair = [], []
    for d in DENSITIES:
        li, lj, tplan = sweep_list(rng, N, d)
        splan = pair_kernel.plan_pair_blocks(li, lj, N, density_min=2.0)
        tfn, tout = call(a, b, s, li, lj, tplan)
        sfn, sout = call(a, b, s, li, lj, splan)
        tfn()
        sfn()
        same = (torch.equal(tout["out"][0], sout["out"][0])
                and torch.equal(tout["out"][1], sout["out"][1]))
        ok &= same
        t_ms = min(device_ms(tfn, iters=5) for _ in range(2))
        s_ms = min(device_ms(sfn, iters=5) for _ in range(2))
        per_slot.append(t_ms / tplan.slots())
        per_pair.append(s_ms / splan.n_sparse)
        print(f"sweep d={d:.4f}: {li.size} pairs; tiles {tplan.n_tiles} (density "
              f"{tplan.tile_density():.3f}) {t_ms:.3f} ms; sparse {splan.n_sparse} pairs "
              f"{s_ms:.3f} ms; {'bit-equal' if same else 'DIFFER'} [{card}]", flush=True)
        result["sweep"][f"{d:.4f}"] = dict(pairs=int(li.size), tiles=tplan.n_tiles,
                                          tile_density=tplan.tile_density(), tile_ms=t_ms,
                                          sparse_ms=s_ms)
    slot_ms, pair_ms = float(np.median(per_slot)), float(np.median(per_pair))
    result["threshold"] = slot_ms / pair_ms
    print(f"tile instance {slot_ms * 1e6:.1f} ns a slot, sparse {pair_ms * 1e6:.1f} ns a pair "
          f"(medians over the sweep, {N_SITES} sites): equal cost at density "
          f"{slot_ms / pair_ms:.3f}; DENSITY_MIN = {pair_kernel.DENSITY_MIN} [{card}]",
          flush=True)
    with open(os.path.join(out_dir, "pair_block_stats.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
