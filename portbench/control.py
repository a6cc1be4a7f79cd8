"""The readings that a cell's limits are set from: on each seed, one pass
of the program judged against the plain reference (the lower reading),
and the control judged the same way (the upper reading).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

The control is the reference put in the program's place in the nearest
precision below the configuration's, or, where the configuration states
no precision, with one of its guarantees broken: the count cells count
with a table keyed by the low 32 bits of each k-mer's hash (the exact
counts broken), the eval cells score in float32 (the configuration's
arithmetic is float64).  The benchmark's own runs never run it.  Prints a
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = os.path.dirname(HERE)
elif os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as R  # noqa: E402


def readings(name: str, seed: int, device: str = "cuda",
             manifest_path: str | None = None, search: list | None = None) -> dict:
    """{"program": checks, "control": checks} of one seed, each checks a
    {name: value} dict."""
    import torch

    manifest = R.load_json(manifest_path or os.path.join(R.ROOT, "BENCHMARK.json"))
    search = search or [HERE]
    cell = {c["name"]: c for c in manifest["workloads"]}[name]
    traffic = R.load_json(R.find(search, "traffic", cell["traffic"], ".json"))
    config = R.load_json(R.find(search, "configs", cell["config"], ".json"))
    driver = R.load_module(R.find(search, "drivers", traffic["driver"], ".py"))
    work = tempfile.mkdtemp(prefix="portbench-control-", dir=os.environ.get("TMPDIR"))
    run = R.Run(name=name, cell=cell, config=config, traffic=traffic, seed=seed, device=device,
                work=work, trace=False, search=search, manifest=manifest)
    out = {"seed": seed}
    try:
        driver.setup(run)
        outs = [driver.run_pass(run, None)]
        driver.release(run)
        out["program"] = {n: v for n, v, _ in driver.judge(run, outs)}
        if traffic["driver"] == "count":
            want = driver.reference(run)
            ctl = [dict(driver.reference(run, key_bits=32), early_term=False)]
            out["control"] = {n: v for n, v, _ in driver.compare(want, ctl)}
        else:
            ref = run.state["ref"]
            ref32 = driver.reference(run, torch.float32)
            ctl = driver.control_outputs(run, ref32)
            out["control"] = {n: v for n, v, _ in driver.judge_rows(run, ref, ctl)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    R.set_cache_env()
    R.check_program("cuda")
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s)), default=float),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
