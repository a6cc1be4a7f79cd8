"""portbench: the benchmark of ntsm_tpu_torch on one or more CUDA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from the cell's entry in
BENCHMARK.json at the root of the checkout: its configuration in
portbench/configs/<config>.json, its traffic in
portbench/traffic/<traffic>.json, the driver the traffic names in
portbench/drivers/<driver>.py and each per-layer metric in
portbench/layers/<metric>.py.  A run makes its inputs from the seed, sets
up and warms the program (set-up, `setup_s`), runs whole passes of the
cell's entry back to back until `--seconds` have passed (the window: a
pass that starts inside it runs to its end), reads the device's peak
memory, frees the program's state and then holds every pass's output
against the plain reference.  It prints each number compared beside its
limit on standard error, and one JSON line last on standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, read from torch.profiler traces of every pass.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT  # run as a script: the harness's modules by their package names
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ntsm_tpu")  # top-level module names
CACHE = os.path.join(ROOT, "build", "portbench")  # compile caches, inside the checkout


class SetupError(RuntimeError):
    """The run cannot measure what it is meant to: no result is printed."""


@dataclass
class Run:
    """One run of one cell: what the driver's set-up, passes and judge see."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: str
    work: str
    trace: bool
    search: list
    manifest: dict
    state: dict = field(default_factory=dict)


def find(search: list, kind: str, name: str, ext: str) -> str:
    """<dir>/<kind>/<name><ext> of the first search directory that has it."""
    for d in search:
        path = os.path.join(d, kind, name + ext)
        if os.path.exists(path):
            return path
    raise SetupError(f"no {kind} file {name}{ext} under {', '.join(search)}")


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def applies(entry: dict, cell: str, reported: set | None = None) -> bool:
    """Whether a metric entry belongs to the cell: listed in its
    `workloads`, or (without one) every cell, or for a per-layer metric
    every cell that reports the metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if reported is not None:
        return entry["moves"] in reported
    return True


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() or f"nvidia-smi: {res.stderr.strip()}"


def check_program(device: str) -> None:
    """The program and both its libraries, or SetupError: no fallback to
    the Python reader or the CPU is measured."""
    try:
        from ntsm_tpu_torch import csrc, native
    except ImportError as e:
        raise SetupError(f"the program ntsm_tpu_torch cannot be imported: {e}") from e
    if native.load() is None:
        raise SetupError("the native host library did not load (the Python reader would run)")
    if device == "cuda":
        try:
            csrc.load()
        except (OSError, RuntimeError) as e:
            raise SetupError(f"the kernel library did not load: {e}") from e


def set_cache_env() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))


def layer_values(run: Run, driver, passes: list, reported: set) -> dict:
    out = {}
    ctx = driver.layer_context(run, passes)
    for entry in run.manifest["per_layer"]:
        if not applies(entry, run.name, reported):
            continue
        reader = load_module(find(run.search, "layers", entry["name"], ".py"))
        value = reader.read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out, ctx


def measure(run: Run, driver, seconds: float, t_start: float) -> dict:
    """Set-up, the window, the judge; returns the result object."""
    import torch

    cuda = run.device == "cuda"
    driver.setup(run)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    setup_s = t0 - t_start
    passes, failed = [], 0
    while not passes or time.monotonic() - t0 < seconds:
        trace_dir = None
        if run.trace:
            trace_dir = os.path.join(run.work, f"trace{len(passes)}")
            os.makedirs(trace_dir)
        try:
            out = driver.run_pass(run, trace_dir)
        except Exception as e:  # a failed pass is counted, and makes the run not correct
            print(f"portbench: pass {len(passes)} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            out = None
        if cuda:
            torch.cuda.synchronize()
        passes.append(dict(out=out, end=time.monotonic(), trace_dir=trace_dir))
        if failed:
            break
    window_s = passes[-1]["end"] - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SetupError(f"modules of the JAX package or of JAX are loaded: {', '.join(found)}")
    done = [p for p in passes if p["out"] is not None]
    driver.release(run)
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.monotonic()
    checks = driver.judge(run, [p["out"] for p in done]) if done else []
    ends = [t0] + [p["end"] for p in passes]
    print(f"portbench: set-up {setup_s:.3f} s, {len(passes)} passes in {window_s:.3f} s, "
          f"judged in {time.monotonic() - t_judge:.3f} s; pass seconds "
          f"{[round(b - a, 3) for a, b in zip(ends, ends[1:])]}", file=sys.stderr)
    correct = failed == 0 and bool(checks) and all(v <= lim for _, v, lim in checks)

    e2e = [m for m in run.manifest["end_to_end"] if applies(m, run.name)]
    reported = {m["name"] for m in e2e}
    metrics, device = {}, {}
    if not run.trace:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = sum(p["out"]["work"][m["name"]] for p in done) / window_s
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if run.trace and done:
        metrics, ctx = layer_values(run, driver, [p["out"] for p in done], reported)
        device = dict(busy_s=ctx.get("busy_s", 0.0), window_s=ctx.get("window_s", 0.0))
        breakdown = ctx.get("breakdown")
    result = {"correct": correct, "attempted": len(passes), "failed": failed,
              "metrics": metrics}
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=int(run.cell.get("chips", 1)),
        memory_peak_bytes=int(peak), **device)
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             manifest_path: str | None = None, search: list | None = None,
             t_start: float | None = None) -> dict:
    """One run of cell `name`; the CPU tests call it with device "cpu"
    (the kernels' plain versions) and their own manifest and files."""
    manifest_path = manifest_path or os.path.join(ROOT, "BENCHMARK.json")
    search = search or [HERE]
    manifest = load_json(manifest_path)
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SetupError(f"no cell {name!r} in {manifest_path}")
    cell = cells[name]
    traffic = load_json(find(search, "traffic", cell["traffic"], ".json"))
    config = load_json(find(search, "configs", cell["config"], ".json"))
    driver = load_module(find(search, "drivers", traffic["driver"], ".py"))
    set_cache_env()
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < int(cell.get("chips", 1))):
        raise SetupError(f"cell {name} needs {cell.get('chips', 1)} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available")
    check_program(device)
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="portbench-", dir=base)
    run = Run(name=name, cell=cell, config=config, traffic=traffic, seed=int(seed),
              device=device, work=work, trace=bool(trace), search=search, manifest=manifest)
    try:
        return measure(run, driver, seconds, T_START if t_start is None else t_start)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        if torch.cuda.is_available():
            print(f"portbench: card {card_line()}", flush=True)
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except SetupError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    print(f"portbench: correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
