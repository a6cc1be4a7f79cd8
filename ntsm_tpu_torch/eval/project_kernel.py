"""The ``-p`` projection of the device engine, from the count planes it
uploads (eval/rect.py:device_planes).

Each row block of PROJ_BLK samples is quantized and centered where the
planes are: :func:`quantize_rows` gives the block's [m, L] f64 values, the
arithmetic of the host's one-sweep quantize (eval/pca.py:project_pcs, the
native ``ntsm_quantize_vals``) bit for bit.  For CPU tensors it runs
:func:`quantize_rows_plain`; for CUDA tensors it launches
``csrc/project_quantize.cu`` or raises, with no fallback.
``launches_project`` counts the kernel's launches.

:func:`project_planes` then multiplies each block by the rotation on the
host in f64 BLAS, the same ``np.matmul`` call on the same shapes as
project_pcs(fast=True), so the cloud is that function's (and the JAX
package's) bit for bit.  On the card two device blocks and two pinned host
blocks alternate: block k + 1's kernel and its copy to the host are queued
before the host multiplies block k.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ntsm_tpu_torch import csrc
from ntsm_tpu_torch.eval.pca import PROJ_BLK, projection_operands
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans

launches_project = 0

_PINNED: dict = {}  # (rows, L) -> the two pinned host blocks of this process


def quantize_rows_plain(a, b, r0: int, r1: int, n_sites: int, norm, mc) -> torch.Tensor:
    """[r1 - r0, n_sites] f64: per site ca = a > mc ? a : 0 and cb alike,
    0.0 where ca + cb == 0, else q(ca / (ca + cb)) - norm[j] with q 0 / 0.5
    / 1 by the reference's sign tests (g - 0.25 < 0, g - 0.75 < 0)."""
    x, y = a[r0:r1, :n_sites], b[r0:r1, :n_sites]
    ca = torch.where(x > mc, x, 0).double()
    cb = torch.where(y > mc, y, 0).double()
    den = ca + cb
    # den is integer-valued: max(den, 1) is the divisor of every present
    # site, and the missing ones are set to 0.0 below
    g = ca / den.clamp(min=1.0)
    q = torch.ones_like(g)
    q = torch.where(g - 0.75 < 0, 0.5, q)
    q = torch.where(g - 0.25 < 0, 0.0, q)
    vals = q - norm[:n_sites]
    return vals.masked_fill_(den == 0, 0.0)


def _check(a, b, r0: int, r1: int, n_sites: int, norm, out) -> None:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"a, b must be [N, L] of one shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or norm.dtype != torch.float64:
        raise TypeError(f"a, b must be int32 and norm float64, got {a.dtype}, {b.dtype}, "
                        f"{norm.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and norm.is_contiguous()):
        raise ValueError("a, b, norm must be contiguous")
    if not (a.device == b.device == norm.device):
        raise ValueError("a, b, norm must be on one device")
    N, L = a.shape
    if not 0 <= r0 <= r1 <= N:
        raise ValueError(f"row block [{r0}, {r1}) outside [0, {N})")
    if not 0 <= n_sites <= L or norm.dim() != 1 or norm.shape[0] < n_sites:
        raise ValueError(f"n_sites {n_sites} outside the planes' {L} or the centers' "
                         f"{tuple(norm.shape)}")
    if out is not None and (out.shape != (r1 - r0, n_sites) or out.dtype != torch.float64
                            or not out.is_contiguous() or out.device != a.device):
        raise ValueError(f"out must be a contiguous [{r1 - r0}, {n_sites}] float64 tensor on "
                         f"{a.device}")


def quantize_rows(a, b, r0: int, r1: int, n_sites: int, norm, mc, out=None) -> torch.Tensor:
    """The quantized, centered f64 values of rows [r0, r1) of the [N, L]
    int32 count planes a, b over sites [0, n_sites), as
    :func:`quantize_rows_plain` defines them, into `out` (a contiguous
    [r1 - r0, n_sites] f64 tensor, or a new one); norm: the [>= n_sites]
    f64 centers on the planes' device."""
    global launches_project
    _check(a, b, r0, r1, n_sites, norm, out)
    if a.device.type == "cpu":
        vals = quantize_rows_plain(a, b, r0, r1, n_sites, norm, mc)
        return vals if out is None else out.copy_(vals)
    if a.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {a.device}")
    pitch = a.shape[1]
    if out is None:
        out = torch.empty((r1 - r0, n_sites), dtype=torch.float64, device=a.device)
    if pitch % 4 or any(x.data_ptr() % 16 for x in (a, b, norm, out)):
        raise ValueError("the kernel needs 16-B aligned planes, centers and out, and a pitch "
                         "of a multiple of 4 sites")
    lib = csrc.load()
    row = pitch * a.element_size()  # bytes a plane row
    rc = lib.ntsm_project_quantize(
        ctypes.c_void_p(a.data_ptr() + r0 * row), ctypes.c_void_p(b.data_ptr() + r0 * row),
        pitch, r1 - r0, n_sites, ctypes.c_void_p(norm.data_ptr()), float(mc),
        ctypes.c_void_p(out.data_ptr()), csrc.stream_ptr(a.device))
    csrc.check(lib, rc, "project_quantize")
    launches_project += 1
    return out


def _pinned_pair(rows: int, L: int) -> list:
    """The process's two pinned [rows, L] f64 host blocks (made at the
    first pass of a width; a new width replaces them)."""
    key = (rows, L)
    if key not in _PINNED:
        _PINNED.clear()
        _PINNED[key] = [torch.empty(key, dtype=torch.float64, pin_memory=True) for _ in range(2)]
    return _PINNED[key]


def project_planes(a, b, n_sites: int, opts: Options) -> tuple:
    """(cloud, blocks): the [N, dim] f64 PCA cloud of the samples of the
    count planes a, b ([N, L] int32, sites [0, n_sites) counted), equal bit
    for bit to eval/pca.py:project_pcs(fast=True) of the same counts, and
    the number of row blocks.  Inside a stage recorder (run_eval), each
    block's quantize (on the card: the kernel's enqueue), the wait for its
    values on the host (project.copy; on the card the copy out of the
    device) and its product with the rotation are the stages
    project.quantize, .copy and .matmul."""
    rotT, normv = projection_operands(opts, fast=True)
    if normv.shape[0] != n_sites:
        raise ValueError(f"{normv.shape[0]} centers for {n_sites} sites")
    N = a.shape[0]
    mc = opts.min_cov
    norm = torch.from_numpy(normv).to(a.device)
    cloud = np.empty((N, opts.dim), np.float64)
    blk = min(N, PROJ_BLK)
    bounds = [(r0, min(r0 + blk, N)) for r0 in range(0, N, blk)]
    # two blocks of values where the planes are and, on the card, two
    # pinned host blocks and the events of their copies; on the CPU the
    # values are on the host already
    on_card = a.is_cuda
    dev = [torch.empty((blk, n_sites), dtype=torch.float64, device=a.device) for _ in range(2)]
    host = _pinned_pair(PROJ_BLK, n_sites) if on_card else dev
    done = [torch.cuda.Event(), torch.cuda.Event()] if on_card else None

    def enqueue(k: int) -> None:
        r0, r1 = bounds[k]
        m, i = r1 - r0, k % 2
        with spans.stage("project.quantize"):
            quantize_rows(a, b, r0, r1, n_sites, norm, mc, out=dev[i][:m])
        if on_card:
            host[i][:m].copy_(dev[i][:m], non_blocking=True)
            done[i].record()

    enqueue(0)
    for k, (r0, r1) in enumerate(bounds):
        if k + 1 < len(bounds):
            enqueue(k + 1)  # on the card while the host multiplies block k
        with spans.stage("project.copy"):
            if on_card:
                done[k % 2].synchronize()
        with spans.stage("project.matmul"):
            np.matmul(host[k % 2][: r1 - r0].numpy(), rotT, out=cloud[r0:r1])
    return cloud, len(bounds)
