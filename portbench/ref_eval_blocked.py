"""The plain reference's -p candidate list in blocks of rows, for cohorts
whose [N, N, dim] distance tensor (portbench/ref_eval.py:candidates) does
not fit: the same list, from the same f64 arithmetic, with memory
O(block x N).  It runs where the cloud is put (the card in a run) and
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.ref_eval import DBL_MAX

BLOCK = 256  # rows a block: a [BLOCK, N, dim] f64 difference, 1.3 GB at N = 32,768, dim 20


def search(cloud: np.ndarray, rad: np.ndarray, device="cpu", block: int = BLOCK) -> tuple:
    """(ii, jj, within): ref_eval.candidates' list (computeScorePCA's
    candidate pairs in its order) and the number of pairs (i, j != i) with
    a finite r_i and d2(i, j) < r_i, before the pruning rules.  Each block
    of rows: the squared distances to every sample, summed over the dim
    axis as ref_eval sums them; the matches of its finite-radius rows,
    pruned (k > i among equal radii, every k of a smaller radius) and put
    nearest first, ties by index; the exhaustive rows' lists (every
    finite-radius sample and the exhaustive ones after the row, by index).
    The blocks' lists, by row."""
    c = torch.from_numpy(np.ascontiguousarray(cloud, dtype=np.float64)).to(device)
    r = torch.from_numpy(np.ascontiguousarray(rad, dtype=np.float64)).to(device)
    n = c.shape[0]
    cols = torch.arange(n, device=c.device)
    ex = r >= DBL_MAX
    out_i, out_j, within = [], [], 0
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        rows = torch.arange(r0, r1, device=c.device)
        sq = ((c[r0:r1, None, :] - c[None, :, :]) ** 2).sum(-1)
        ri = r[r0:r1, None]
        finite = ri < DBL_MAX
        hit = (sq < ri) & finite
        within += int((hit & (cols[None, :] != rows[:, None])).sum())
        a, k = hit.nonzero(as_tuple=True)
        i = rows[a]
        keep = torch.where(r[k] == r[i], k > i, r[k] < r[i])
        i, k, d = i[keep].cpu().numpy(), k[keep].cpu().numpy(), sq[a[keep], k[keep]].cpu().numpy()
        o = np.lexsort((k, d, i))  # by row, then distance, then index
        ei = (~finite[:, 0]).nonzero(as_tuple=True)[0]
        lists = [(i[o], k[o])]
        if ei.numel():
            e = rows[ei]
            m = (cols[None, :] != e[:, None]) & ~(ex[None, :] & (cols[None, :] <= e[:, None]))
            a2, ek = m.nonzero(as_tuple=True)
            lists.append((e[a2].cpu().numpy(), ek.cpu().numpy()))
        bi = np.concatenate([x[0] for x in lists])
        bj = np.concatenate([x[1] for x in lists])
        o = np.argsort(bi, kind="stable")
        out_i.append(bi[o].astype(np.int64))
        out_j.append(bj[o].astype(np.int64))
    if not out_i:
        return np.empty(0, np.int64), np.empty(0, np.int64), 0
    return np.concatenate(out_i), np.concatenate(out_j), within


def candidates(cloud: np.ndarray, rad: np.ndarray, device="cpu", block: int = BLOCK) -> tuple:
    """(ii, jj) of :func:`search`: ref_eval.candidates' list."""
    ii, jj, _ = search(cloud, rad, device, block)
    return ii, jj
