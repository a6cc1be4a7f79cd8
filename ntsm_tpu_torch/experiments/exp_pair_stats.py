"""The all-vs-all pair-statistics kernel, csrc/pair_stats.cu, timed at each
of its instances on the card:

    python -m ntsm_tpu_torch.experiments.exp_pair_stats [OUT_DIR]

Each instance (1x1 and 2x2 pairs a thread) through the C entry point, and
``auto``, the wrapper ``eval/pair_kernel.py:pair_stats``, which picks one
of them by the block's pair count.  Shapes, on a generated N = 3202 x
96,287-site cohort (the distribution of chip_smoke.py's, seed 20261017),
``-c 1``:

* ``full``: rows [0, 740), the first row block of ``eval/rect.py:row_blocks(3202,
  BLOCK_PAIRS)`` (2,095,310 pairs), as phase 7 runs it; ``last``: its
  last block, rows [1835, 3201) (933,661 pairs); ``mid``: rows [0, 96)
  (302,736 pairs), between the instances' ranges;
* ``proxy``: rows [700, 956) of the first 1,024 samples (50,048 pairs),
  phase 5's proxy for a small cohort's one block;
* ``tail``: rows [956, 1024) of the same (2,278 pairs).

Every instance's ints and joint/ss must equal the 1x1 instance's bit for
bit (exit 1 otherwise).  Times are device times
(``utils/timing.py:device_ms``), in two rounds, forward and back, with the
SM clock and power draw sampled by nvidia-smi meanwhile.  Also compiles
``csrc/pair_stats.cu`` with ``-Xptxas -v`` (registers, spills) and writes
its SASS (``cuobjdump -sass``) to OUT_DIR (default
``build/exp_pair_stats``), with a JSON of the times.  Exits 1 with no
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.eval import pair_kernel
from ntsm_tpu_torch.utils.timing import card_line, device_ms

N_COHORT, N_SITES = 3202, 96_287
SHAPES = {"full": (N_COHORT, 0, 740), "last": (N_COHORT, 1835, 3201), "mid": (N_COHORT, 0, 96),
          "proxy": (1024, 700, 956), "tail": (1024, 956, 1024)}
MC = 1


def cohort(device, n: int = N_COHORT, n_sites: int = N_SITES, seed: int = 20261017):
    """(a, b) [n, n_sites] int32: per-site allele frequencies in [0.05, 0.95],
    diploid genotypes, Poisson counts around a coverage of 25-35 with 2%
    cross-talk (chip_smoke.py:make_cohort's distribution)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    freq = 0.05 + 0.9 * torch.rand(n_sites, generator=g, device=device, dtype=torch.float64)
    a = torch.empty((n, n_sites), dtype=torch.int32, device=device)
    b = torch.empty_like(a)
    for r0 in range(0, n, 256):
        m = min(256, n - r0)
        u = lambda: torch.rand((m, n_sites), generator=g, device=device,  # noqa: E731
                               dtype=torch.float64)
        geno = (u() < freq).double() + (u() < freq).double()
        lam = (25.0 + 10.0 * torch.rand((m, 1), generator=g, device=device,
                                        dtype=torch.float64)) / 2.0
        err = (0.02 * lam).expand(m, n_sites)
        a[r0:r0 + m] = (torch.poisson(lam * (2 - geno), generator=g)
                        + torch.poisson(err, generator=g)).int()
        b[r0:r0 + m] = (torch.poisson(lam * geno, generator=g)
                        + torch.poisson(err, generator=g)).int()
    return a, b


def build(out_dir: str) -> None:
    """-Xptxas -v of csrc/pair_stats.cu and its SASS into out_dir; prints
    the register lines."""
    nvcc = csrc._nvcc()
    os.makedirs(csrc.BUILD_DIR, exist_ok=True)
    src = os.path.join(os.path.dirname(csrc.sources()[0]), "pair_stats.cu")
    cubin = os.path.join(csrc.BUILD_DIR, "pair_stats.cubin")
    res = subprocess.run([nvcc, *csrc.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", cubin, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"nvcc failed: {res.stdout}{res.stderr}")
    log = res.stdout + res.stderr
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                          timeout=300).stdout
    with open(os.path.join(out_dir, "pair_stats.sass"), "w") as fh:
        fh.write(sass)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        fh.write(log)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)


def instance_call(a, b, s, n: int, r0: int, r1: int, micro: int):
    """fn() launching csrc/pair_stats.cu at micro-tile `micro`, and its
    outputs (the tile list made once, as the wrapper makes it)."""
    lib = csrc.load()
    P = pair_kernel.n_block_pairs(n, r0, r1)
    ri, rj = pair_kernel.MICRO_TILES[micro]
    tiles = torch.from_numpy(pair_kernel.live_tiles(
        n, r0, r1, pair_kernel.TILE * ri, pair_kernel.TILE * rj)).to(a.device)
    ints = torch.empty((5, P), dtype=torch.int32, device=a.device)
    sums = torch.empty((2, P), dtype=torch.float64, device=a.device)

    def fn():
        rc = lib.ntsm_pair_stats(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(s.data_ptr()), a.shape[1], n, N_SITES, r0, r1, MC,
            ctypes.c_void_p(tiles.data_ptr()), tiles.shape[0], micro,
            ctypes.c_void_p(ints.data_ptr()), ctypes.c_void_p(sums.data_ptr()), P,
            csrc.stream_ptr(a.device))
        csrc.check(lib, rc, "pair_stats")
    return fn, ints, sums


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exp_pair_stats: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = argv[0] if argv else os.path.join("build", "exp_pair_stats")
    os.makedirs(out_dir, exist_ok=True)
    card = card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    t0 = time.monotonic()
    csrc.load()
    build(out_dir)
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)
    t0 = time.monotonic()
    a, b = cohort(device)
    s = pair_kernel.s_single_plane(a, b, MC)
    torch.cuda.synchronize()
    print(f"cohort {N_COHORT} x {N_SITES} in {time.monotonic() - t0:.1f} s", flush=True)

    result = {"card": card, "shapes": {}}
    ok = True
    for shape, (n, r0, r1) in SHAPES.items():
        P = pair_kernel.n_block_pairs(n, r0, r1)
        calls = {}
        for m, (ri, rj) in enumerate(pair_kernel.MICRO_TILES):
            calls[f"{ri}x{rj}"] = instance_call(a, b, s, n, r0, r1, m)
        # the wrapper, on the first n rows (its own tile list and micro-tile)
        an, bn, sn = a[:n], b[:n], s[:n]
        wrap = {}

        def auto():
            wrap["out"] = pair_kernel.pair_stats(an, bn, sn, r0, r1, MC, N_SITES)
        calls["auto"] = (auto, None, None)
        ref_i = ref_f = None
        for name, (fn, ints, sums) in calls.items():
            fn()
            torch.cuda.synchronize()
            if name == "auto":
                ints, sums = wrap["out"]
            if ref_i is None:
                ref_i, ref_f = ints.clone(), sums.clone()
            same = torch.equal(ints, ref_i) and torch.equal(sums, ref_f)
            ok &= same
            print(f"{shape} {name}: {'bit-equal to 1x1' if same else 'DIFFERS from 1x1'}",
                  flush=True)
        n_sites_valid = float(ref_i[0].sum())
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "250"], stdout=subprocess.PIPE, text=True)
        times = {name: [] for name in calls}
        order = list(calls)
        for rnd in (order, order[::-1]):
            for name in rnd:
                iters = 3 if shape == "full" else 7
                times[name].append(device_ms(calls[name][0], iters=iters))
        smi.terminate()
        samples = [ln.split(",") for ln in smi.communicate()[0].splitlines() if "," in ln]
        clk = sorted(float(x[0]) for x in samples)
        pwr = sorted(float(x[1]) for x in samples)
        if clk:
            print(f"{shape}: while timing, SM clock median {clk[len(clk) // 2]:.0f} MHz "
                  f"(min {clk[0]:.0f}), power median {pwr[len(pwr) // 2]:.1f} W "
                  f"({len(clk)} samples)", flush=True)
        micro = pair_kernel.micro_tile(P, pair_kernel.sm_count(device))
        print(f"{shape}: rows [{r0},{r1}) of {n} x {N_SITES} sites, {P} pairs, "
              f"{n_sites_valid:.0f} valid pair-sites, wrapper picks micro-tile "
              f"{pair_kernel.MICRO_TILES[micro]} [{card}]", flush=True)
        for name, ts in times.items():
            print(f"  {name:6s} {ts[0]:10.3f} {ts[1]:10.3f} ms  "
                  f"{P * N_SITES / min(ts) / 1e6:8.1f} Gpair-site/s", flush=True)
        result["shapes"][shape] = dict(rows=[r0, r1], n=n, pairs=P,
                                       valid_pair_sites=n_sites_valid, micro=micro,
                                       ms=times)
    with open(os.path.join(out_dir, "pair_stats.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
