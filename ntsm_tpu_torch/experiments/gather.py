"""The gather forms of experiments P1 and P2 (``csrc/gather.cu``), each with
its plain PyTorch version, and the form runner both experiment programs use.

* :func:`gather_1d`        out = tbl[idx]                    (P1 a)
* :func:`take_along_axis0` out[r, c] = tbl[idx[r, c], c]     (P1 b, P2 A, B)
* :func:`take_along_axis1` out[r, m] = tbl[r, idx[r, m]]     (P2 C)
* :func:`row_gather`       out[r, :] = tbl[idx1d[r], :]      (P2 D)

Values are 32-bit, u32 carried as int32 bit patterns; indices are int32.
For CPU tensors a wrapper runs its plain version; for CUDA tensors it
launches its kernel or raises.  An index out of range is the caller's fault,
as on the TPU: the wrappers check dtypes, shapes, contiguity and device.
``launches`` counts each form's kernel launches, and those of
:func:`launch_floor`, an empty kernel whose time is what a launch costs
apart from any work.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.utils.timing import card_line, device_ms

launches = dict.fromkeys(
    ("gather_1d", "take_along_axis0", "take_along_axis1", "row_gather", "launch_floor"), 0)
IN_STREAM = 64  # back-to-back launches that a per-launch time is taken over


def _check(name: str, tbl: torch.Tensor, idx: torch.Tensor, tbl_dim: int, idx_dim: int) -> None:
    for what, t, dim in (("tbl", tbl, tbl_dim), ("idx", idx, idx_dim)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
        if dim and t.dim() != dim:
            raise ValueError(f"{name}: {what} must have {dim} dimensions, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if tbl.device != idx.device:
        raise ValueError(f"{name}: tbl and idx must be on the same device")
    if tbl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tbl.device}")


def _launch(name: str, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
    lib = csrc.load()
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, entry)(*ptrs, ctypes.c_void_p(out.data_ptr()), csrc.stream_ptr(out.device))
    csrc.check(lib, rc, name)
    launches[name] += 1
    return out


def launch_floor(device) -> int:
    """One launch of the empty kernel (one block of 32 threads) on
    `device`'s current stream; returns the entry point's code, 0 (any other
    raises).  It has no plain version: it exists to be timed on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor: needs a CUDA device, got {device}")
    lib = csrc.load()
    rc = lib.ntsm_launch_floor(csrc.stream_ptr(device))
    csrc.check(lib, rc, "launch_floor")
    launches["launch_floor"] += 1
    return rc


def gather_1d_plain(tbl, idx):
    return tbl[idx]


def gather_1d(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl [T] int32, idx int32 of any shape -> tbl[idx]."""
    _check("gather_1d", tbl, idx, 1, 0)
    if tbl.device.type == "cpu":
        return gather_1d_plain(tbl, idx)
    out = torch.empty_like(idx)
    return _launch("gather_1d", "ntsm_gather_1d", out, tbl, idx, idx.numel())


def take_along_axis0_plain(tbl, idx):
    return torch.gather(tbl, 0, idx.long())


def take_along_axis0(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl [T, C], idx [R, C] int32 -> out [R, C], out[r, c] = tbl[idx[r, c], c]."""
    _check("take_along_axis0", tbl, idx, 2, 2)
    if idx.shape[1] != tbl.shape[1]:
        raise ValueError(f"take_along_axis0: idx {tuple(idx.shape)} and tbl "
                         f"{tuple(tbl.shape)} differ in width")
    if tbl.device.type == "cpu":
        return take_along_axis0_plain(tbl, idx)
    out = torch.empty_like(idx)
    return _launch("take_along_axis0", "ntsm_take_axis0", out,
                   tbl, tbl.shape[0], tbl.shape[1], idx, idx.numel())


def take_along_axis1_plain(tbl, idx):
    return torch.gather(tbl, 1, idx.long())


def take_along_axis1(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl [R, C], idx [R, M] int32 -> out [R, M], out[r, m] = tbl[r, idx[r, m]]."""
    _check("take_along_axis1", tbl, idx, 2, 2)
    if idx.shape[0] != tbl.shape[0]:
        raise ValueError(f"take_along_axis1: idx {tuple(idx.shape)} and tbl "
                         f"{tuple(tbl.shape)} differ in rows")
    if tbl.shape[1] > 1536:  # the kernel stages 8 rows in 48 KB of shared memory
        raise ValueError(f"take_along_axis1: rows of {tbl.shape[1]} > 1536 values")
    if tbl.device.type == "cpu":
        return take_along_axis1_plain(tbl, idx)
    out = torch.empty_like(idx)
    return _launch("take_along_axis1", "ntsm_take_axis1", out,
                   tbl, tbl.shape[1], idx, idx.shape[0], idx.shape[1])


def row_gather_plain(tbl, idx):
    return tbl[idx]


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl [T, C], idx [R] int32 -> out [R, C], out[r] = tbl[idx[r]]."""
    _check("row_gather", tbl, idx, 2, 1)
    if tbl.device.type == "cpu":
        return row_gather_plain(tbl, idx)
    if tbl.shape[1] % 4 or tbl.data_ptr() % 16:
        raise ValueError("row_gather: rows must be whole 16-B words, 16-B aligned")
    out = torch.empty((idx.shape[0], tbl.shape[1]), dtype=tbl.dtype, device=tbl.device)
    return _launch("row_gather", "ntsm_row_gather", out, tbl, tbl.shape[1], idx, idx.shape[0])


FORMS = {  # name -> (wrapper, plain version, the one PyTorch call it is on an int64 index)
    "gather_1d": (gather_1d, gather_1d_plain, "tbl[idx]"),
    "take_along_axis0": (take_along_axis0, take_along_axis0_plain, "torch.gather(tbl, 0, idx)"),
    "take_along_axis1": (take_along_axis1, take_along_axis1_plain, "torch.gather(tbl, 1, idx)"),
    "row_gather": (row_gather, row_gather_plain, "tbl[idx]"),
}


def bound_bytes(form: str, tbl: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> int:
    """Bytes a gather must move: the indices and the table elements (rows,
    for row_gather) they touch read once, the output written once."""
    i = idx.long()
    if form == "take_along_axis0":
        i = i * tbl.shape[1] + torch.arange(tbl.shape[1], device=i.device)
    elif form == "take_along_axis1":
        i = i + torch.arange(i.shape[0], device=i.device)[:, None] * tbl.shape[1]
    touched = int(torch.unique(i).numel()) * (tbl.shape[1] if form == "row_gather" else 1)
    return idx.nbytes + touched * tbl.element_size() + out.nbytes


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A u32 or i32 numpy array as an int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def in_stream_ms(fn, n: int = IN_STREAM) -> float:
    """Device time of one fn() among `n` back to back, in ms: device_ms of
    one call that makes the n calls, over n.  Each call's output is dropped
    as it goes, so no more than one is held at a time."""
    def calls():
        for _ in range(n):
            fn()
    return device_ms(calls) / n


def floor_times(device) -> dict:
    """The launch floor on the card: the empty kernel as one timed launch
    (ms, what device_ms adds to every kernel it times) and per launch among
    IN_STREAM back to back (per_launch_ms); printed."""
    res = dict(ms=device_ms(lambda: launch_floor(device)),
               per_launch_ms=in_stream_ms(lambda: launch_floor(device)))
    print(f"launch floor (an empty kernel, 1 block of 32 threads): {res['ms']:.4f} ms "
          f"a single launch, {res['per_launch_ms']:.4f} ms a launch of {IN_STREAM} "
          f"back to back", flush=True)
    return res


def run_forms(cases) -> list[dict]:
    """Run each (label, form, tbl, idx) case: check the wrapper against its
    plain version and print it as the Pallas scripts did ("compiles;
    correct"); for CUDA tensors also time (device time) the kernel and the
    plain version on an int64 index made once, which makes it the one
    PyTorch call for the form, each as a single launch and per launch among
    IN_STREAM back to back, and print ms and M gathers/s.  Returns one dict
    a case: label, form, correct, n (gathers), n_bytes (what the bound
    counts) and, on the card, ms, per_launch_ms, plain_ms = library_ms and
    library_per_launch_ms."""
    results = []
    for label, form, tbl, idx in cases:
        fn, plain, call = FORMS[form]
        out = fn(tbl, idx)
        ok = torch.equal(out, plain(tbl, idx))
        print(f"{label}: compiles; correct: {ok}", flush=True)
        n = out.numel()
        res = dict(label=label, form=form, correct=ok, n=n,
                   n_bytes=bound_bytes(form, tbl, idx, out))
        if tbl.is_cuda:
            idx64 = idx.long()
            res["ms"] = device_ms(lambda: fn(tbl, idx))
            res["per_launch_ms"] = in_stream_ms(lambda: fn(tbl, idx))
            res["plain_ms"] = res["library_ms"] = device_ms(lambda: plain(tbl, idx64))
            res["library_per_launch_ms"] = in_stream_ms(lambda: plain(tbl, idx64))
            print(f"  {res['ms']:.4f} ms for {n} gathers -> {n / res['ms'] / 1e3:.0f} "
                  f"M gathers/s, {res['per_launch_ms']:.4f} ms a launch of {IN_STREAM} "
                  f"back to back; {call} {res['library_ms']:.4f} ms "
                  f"({n / res['library_ms'] / 1e3:.0f} M gathers/s), "
                  f"{res['library_per_launch_ms']:.4f} ms a call of {IN_STREAM} back to back",
                  flush=True)
        results.append(res)
    return results


def program(cases, extra=None) -> dict | None:
    """A gather program's body on the card: the card line, the launch floor
    (:func:`floor_times`), then :func:`run_forms` on ``made =
    cases(cuda)`` and, if given, ``extra(made)``, a dict of further
    results.  Returns dict(floor=, forms=, **extra(made)); None, after a
    message, when there is no CUDA device."""
    if not torch.cuda.is_available():
        print("no CUDA device: nothing run", file=sys.stderr)
        return None
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    res = dict(floor=floor_times(device))
    made = cases(device)
    res["forms"] = run_forms(made)
    if extra is not None:
        res.update(extra(made))
    return res


def exit_code(res) -> int:
    """0 when the program ran and every form, and every further result that
    carries a `correct`, equals its plain version."""
    if not res:
        return 1
    rows = res["forms"] + [v for v in res.values() if isinstance(v, dict) and "correct" in v]
    return 0 if all(r["correct"] for r in rows) else 1
