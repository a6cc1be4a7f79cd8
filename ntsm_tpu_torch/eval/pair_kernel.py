"""The pair statistics of ``eval`` all-vs-all (counterpart of
ntsm_tpu/eval/pallas_joint.py and the pair math of ntsm_tpu/eval/kernels.py).

For every pair (i, j), i < j, of a block of rows [r0, r1) against the whole
cohort, :func:`pair_stats` gives

* ``ints`` [5, P] int32: n, ibs0, sharedHets, hets1, hets2 over the pair's
  valid sites (a site is valid when both samples have an allele count above
  ``mc``);
* ``sums`` [2, P] float64: ``joint`` (sumLogPJoint,
  src/CompareCounts.hpp:1013-1033) and ``ss`` (sumLogPSingle of both
  samples, :968-991) over the same sites;

with P the block's pairs in ``np.triu_indices`` order.  On the TPU these
are K3 (``_joint_frac_kernel``, the fraction jfrac) plus the XLA stages
around it (the integer part jint, the compensated s1 sums, the indicator
tallies); ``joint`` here equals the TPU engine's ``jint - jfrac``.

:func:`pair_stats` is the wrapper: for CPU tensors it runs
:func:`pair_stats_plain`, for CUDA tensors it launches
``csrc/pair_stats.cu`` or raises; it never falls back.  ``launches`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ntsm_tpu_torch import csrc

launches = 0

N_INTS = 5  # n, ibs0, shared_hets, hets1, hets2
# elements of a [T, N, C] broadcast chunk in the plain version: bounds its
# temporaries (a few f64 planes of this size) on either device
PLAIN_CHUNK = {"cpu": 1 << 22, "cuda": 1 << 25}


def n_block_pairs(n_samples: int, r0: int, r1: int) -> int:
    """Pairs (i, j > i) with i in [r0, r1) of an n_samples cohort."""
    return (r1 - r0) * (n_samples - 1) - (r1 * (r1 - 1) - r0 * (r0 - 1)) // 2


def s_single_plane(a: torch.Tensor, b: torch.Tensor, mc: int) -> torch.Tensor:
    """[N, L] f64 per-site single-sample terms (computeSumLogPSingle,
    src/CompareCounts.hpp:968-991) on the planes' device, with the
    arithmetic of eval/model.py:CountData.s_single (a*fa + b*fb, each
    step its own rounding).  Zero counts give 0, so pad columns add
    nothing."""
    af = a.double()
    bf = b.double()
    den = torch.clamp(af + bf, min=1.0)
    zero = torch.zeros((), dtype=torch.float64, device=a.device)
    fa = torch.where(a > mc, af / den, zero)
    fb = torch.where(b > mc, bf / den, zero)
    return af * fa + bf * fb


def pair_stats_plain(a, b, s, r0: int, r1: int, mc: int, n_sites: int):
    """The plain PyTorch version, in int64 / f64 over [T, N, C] chunks:
    (ints [5, P] int32, sums [2, P] float64).

    Only the first ``n_sites`` columns count: pad columns beyond them stay
    invalid for any ``mc`` (their zero counts pass ``> mc`` when mc < 0;
    the JAX engine's n_valid mask, eval/kernels.py:94-103)."""
    N = a.shape[0]
    dev = a.device
    a = a[:, :n_sites].long()
    b = b[:, :n_sites].long()
    s = s[:, :n_sites]
    code = (a > mc).long() | ((b > mc).long() << 1)  # 3 het, 1/2 hom, 0 miss
    budget = PLAIN_CHUNK.get(dev.type, PLAIN_CHUNK["cpu"])
    T = max(1, min(r1 - r0, budget // max(1, N)))
    ints_out, sums_out = [], []
    cols = torch.arange(N, device=dev)
    for t0 in range(r0, r1, T):
        t1 = min(t0 + T, r1)
        C = max(1, budget // ((t1 - t0) * N))
        acc_i = torch.zeros((N_INTS, t1 - t0, N), dtype=torch.int64, device=dev)
        acc_f = torch.zeros((2, t1 - t0, N), dtype=torch.float64, device=dev)
        for c0 in range(0, n_sites, C):
            sl = slice(c0, min(c0 + C, n_sites))
            ci, cj = code[t0:t1, None, sl], code[None, :, sl]
            v = (ci != 0) & (cj != 0)
            acc_i[0] += v.sum(-1)
            acc_i[1] += (v & ((ci ^ cj) == 3)).sum(-1)
            acc_i[2] += ((ci & cj) == 3).sum(-1)
            acc_i[3] += (v & (ci == 3)).sum(-1)
            acc_i[4] += (v & (cj == 3)).sum(-1)
            aa = a[t0:t1, None, sl] + a[None, :, sl]
            bb = b[t0:t1, None, sl] + b[None, :, sl]
            aad, bbd = aa.double(), bb.double()
            den = aad + bbd
            dsafe = torch.where(den > 0, den, torch.ones_like(den))
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            fa = torch.where(aa > mc, aad / dsafe, zero)
            fb = torch.where(bb > mc, bbd / dsafe, zero)
            acc_f[0] += torch.where(v, aad * fa + bbd * fb, zero).sum(-1)
            acc_f[1] += torch.where(v, s[t0:t1, None, sl] + s[None, :, sl], zero).sum(-1)
        upper = cols[None, :] > torch.arange(t0, t1, device=dev)[:, None]
        ints_out.append(acc_i[:, upper].to(torch.int32))
        sums_out.append(acc_f[:, upper])
    if not ints_out:
        return (torch.zeros((N_INTS, 0), dtype=torch.int32, device=dev),
                torch.zeros((2, 0), dtype=torch.float64, device=dev))
    return torch.cat(ints_out, dim=1), torch.cat(sums_out, dim=1)


def _check(a, b, s, r0: int, r1: int, n_sites: int) -> None:
    if a.dim() != 2 or a.shape != b.shape or a.shape != s.shape:
        raise ValueError(f"a, b, s must be [N, L] of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(s.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or s.dtype != torch.float64:
        raise TypeError(f"a, b must be int32 and s float64, got {a.dtype}, {b.dtype}, {s.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and s.is_contiguous()):
        raise ValueError("a, b, s must be contiguous")
    if not (a.device == b.device == s.device):
        raise ValueError("a, b, s must be on one device")
    N, L = a.shape
    if not 0 <= r0 <= r1 <= N:
        raise ValueError(f"row block [{r0}, {r1}) outside [0, {N})")
    if not 0 <= n_sites <= L:
        raise ValueError(f"n_sites {n_sites} outside [0, {L}]")
    if N >= 2**31:
        raise ValueError(f"{N} samples exceed the kernel's int32 indices")


def pair_stats(a, b, s, r0: int, r1: int, mc: int, n_sites: int):
    """(ints [5, P] int32, sums [2, P] float64) for the pairs of rows
    [r0, r1): a, b are [N, L] int32 allele count planes, s is
    :func:`s_single_plane` of them, and only sites [0, n_sites) count."""
    global launches
    _check(a, b, s, r0, r1, n_sites)
    if a.device.type == "cpu":
        return pair_stats_plain(a, b, s, r0, r1, mc, n_sites)
    if a.device.type != "cuda":
        raise ValueError(f"pair_stats: unsupported device {a.device}")
    lib = csrc.load()
    N, L = a.shape
    P = n_block_pairs(N, r0, r1)
    ints = torch.empty((N_INTS, P), dtype=torch.int32, device=a.device)
    sums = torch.empty((2, P), dtype=torch.float64, device=a.device)
    if P == 0:
        return ints, sums
    rc = lib.ntsm_pair_stats(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(s.data_ptr()), L, N, n_sites, r0, r1, int(mc),
        ctypes.c_void_p(ints.data_ptr()), ctypes.c_void_p(sums.data_ptr()), P,
        csrc.stream_ptr(a.device),
    )
    csrc.check(lib, rc, "pair_stats")
    launches += 1
    return ints, sums
