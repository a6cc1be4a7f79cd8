"""The device engine of ``eval`` all-vs-all and ``eval -p`` (counterpart of
ntsm_tpu/eval/rect.py and eval/tpu.py:compute_score_all_tpu,
compute_score_pca_tpu).

The [N, L] int32 allele count planes go to the device once, a block of
UPLOAD_ROWS samples at a time, with the f64 s_single plane computed there
block by block (device_planes), so that no transient the size of the
cohort exists on the device.  On a card each block goes through a small
ring of pinned host slots: the host fills one slot (a parallel copy on
torch's intra-op threads) while the copy engine drains the one before.
All-vs-all scores the i<j triangle in row blocks with the pair-statistics
kernel; -p scores the candidate list in
slices with the candidate-pair kernel (both in eval/pair_kernel.py).  Each
block's per-pair (ints, joint, ss) is fetched, finalized on the host in f64
with the exact engine's transform and emitted.  Without -a, where only the
pairs under -s print, the selection kernel (pair_kernel.score_select)
drops on the device every pair (of a row block, or of a -p slice) whose
score provably does not, so only the rest are fetched and finalized.  The TPU engine's wire
(u8/u16 planes, the 17 B/pair blob, fetch stacking and grouping, diagonal
gathers) and its load-overlapped streaming (eval/pca_stream.py) are not
ported: the card has f64 and a wide host link, so the plain form comes
first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ntsm_tpu_torch.eval import pair_kernel, search_kernel
from ntsm_tpu_torch.eval.emit import _emit_prepared, _load_row_formatter, _pair_columns, _sample_strings
from ntsm_tpu_torch.eval.exact import DBL_MAX, HEADER
from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.eval.pca import pair_dist_sq, search_radii
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.parallel.distributed import rank, world_size
from ntsm_tpu_torch.utils import spans

SITE_ALIGN = 32  # plane rows padded to 128 bytes; pad sites never count
BLOCK_PAIRS = 1 << 21  # pairs per row block or -p slice: bounds the fetched block
# samples a block of device_planes: ~0.4 GB of counts and ~2 GB of f64
# temporaries at the human site count, whatever N
UPLOAD_ROWS = 512
# device_planes' staging ring: RING_SLOTS host slots of SLOT_BYTES, pinned
# on a card and kept for the process (128 MB whatever N); a block's flat
# counts go through them in slot-sized pieces
RING_SLOTS = 4
SLOT_BYTES = 32 << 20
# The stages of the device engine (utils/spans.py, area "eval"): upload is
# the planes' (upload.copy: the host-to-device path of each count block,
# from its first fill to its last copy's end; upload.copy.fill: the host
# fill of the slots); samples is the per-sample columns of the rows,
# formatted once; score is
# launch (the kernels' enqueue) plus fetch (the block's .cpu(), which waits
# for the kernels and the copy; without -a the kept count, then the kept
# records); -p adds candidates (radii plus search: search.radius, the
# radius kernel's passes and the compaction of each row's matches, and
# search.order, their prune and order, the exhaustive rows and the fetch of
# the list; eval/search_kernel.py) and tiles (the host plan of each slice).
ALL_STAGES = ("upload", "upload.copy", "upload.copy.fill", "samples", "score", "launch",
              "fetch", "finalize", "emit")
PCA_STAGES = ("candidates", "candidates.radii", "candidates.search", "candidates.search.radius",
              "candidates.search.order", "upload", "upload.copy", "upload.copy.fill", "samples",
              "tiles", "score", "launch", "fetch", "finalize", "emit")
# device_planes' uploads: the bytes of the int32 count blocks, the blocks,
# and the bytes that went through pinned slots (all of them on a card, none
# elsewhere)
counters = {"upload_bytes": 0, "upload_chunks": 0, "upload_staged_bytes": 0}
_RINGS = {}  # device -> the process's pinned ring there (staging_ring)


def staging_ring(device: torch.device, n: int) -> tuple:
    """(slots, events, stream): RING_SLOTS int32 host slots of n elements.
    On a card they are pinned, with an event a slot (its last copy) and the
    copy stream, made at the first call of a process and device and reused
    by every later one (a new n replaces them); elsewhere plain slots made
    for the call, and no events or stream."""
    if device.type != "cuda":
        return [torch.empty(n, dtype=torch.int32) for _ in range(RING_SLOTS)], None, None
    ring = _RINGS.get(device)
    if ring is None or ring[0][0].numel() != n:
        ring = _RINGS[device] = (
            [torch.empty(n, dtype=torch.int32, pin_memory=True) for _ in range(RING_SLOTS)],
            [torch.cuda.Event() for _ in range(RING_SLOTS)], torch.cuda.Stream(device))
    return ring


def _block_counts(mc: np.ndarray, r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of the [N, L, 2] counts as one flat tensor over the
    caller's memory; a copy only where they are not one C-contiguous run
    of int32 or int64 (the slots' fill narrows int64)."""
    rows = mc[r0:r1]
    if not (rows.flags.c_contiguous and rows.dtype in (np.int32, np.int64)):
        rows = np.ascontiguousarray(rows, dtype=np.int32)
    return torch.from_numpy(rows).view(-1)


def device_planes(data: CountData, device, rows: int = UPLOAD_ROWS, rec=None,
                  slot_bytes: int = SLOT_BYTES) -> tuple:
    """(a, b, s) on `device`: [N, Lp] int32 count planes, zero-padded to
    SITE_ALIGN sites, and their f64 s_single plane.

    The three are allocated once and filled a block of `rows` samples at a
    time: the block's [m, L, 2] counts reach a landing buffer on the device
    through the staging ring (staging_ring, slots of `slot_bytes`), and are
    split into a and b there and the block's s computed, so only one
    block's transients live at a time.  The block's flat counts are cut
    into slot-sized pieces (across row boundaries); each piece is copied
    into the next slot by a parallel host copy (int64 narrowed to int32 in
    the same copy), after that slot's last copy has drained, then copied
    on.  On a card that copy is asynchronous on the ring's copy stream, so
    the host fills slot k + 1 while slot k goes over the link; a block's
    copies wait on the device for the previous block's split, which the
    host's fills of the ring's other slots hide.  Stage
    upload.copy of `rec` (else of the current recorder) runs from a
    block's first fill to its last copy's end, upload.copy.fill is the
    fills.  The values are the same at any block and slot size."""
    mc = data.max_counts
    if mc.dtype != np.int32 and mc.size and (mc.min() < 0
                                             or mc.max() > np.iinfo(np.int32).max):
        raise ValueError("count outside int32: the device engine cannot hold it")
    stage = spans.stage if rec is None else rec.stage
    N, L = mc.shape[0], mc.shape[1]
    Lp = L + (-L) % SITE_ALIGN
    a = torch.zeros((N, Lp), dtype=torch.int32, device=device)
    b = torch.zeros((N, Lp), dtype=torch.int32, device=device)
    s = torch.empty((N, Lp), dtype=torch.float64, device=device)
    step = max(1, rows)
    dev = a.device
    on_card = dev.type == "cuda"
    per = max(1, slot_bytes // 4)  # int32 counts a slot
    if not on_card:
        per = max(1, min(per, min(step, N) * L * 2))
    slots, drained, copy_stream = staging_ring(dev, per)
    land = torch.empty(min(step, N) * L * 2, dtype=torch.int32, device=dev)
    k = 0  # pieces so far; piece k goes through slot k % RING_SLOTS
    for r0 in range(0, N, step):
        r1 = min(r0 + step, N)
        src = _block_counts(mc, r0, r1)
        n = src.numel()
        dst = land[:n]
        with stage("upload.copy"):
            if on_card:  # the landing buffer's earlier users: the last block's split
                copy_stream.wait_stream(torch.cuda.current_stream(dev))
            for off in range(0, n, per):
                m, j = min(per, n - off), k % RING_SLOTS
                k += 1
                if on_card:
                    drained[j].synchronize()
                with stage("upload.copy.fill"):
                    slots[j][:m].copy_(src[off:off + m])
                if on_card:
                    with torch.cuda.stream(copy_stream):
                        dst[off:off + m].copy_(slots[j][:m], non_blocking=True)
                    drained[j].record(copy_stream)
                else:
                    dst[off:off + m].copy_(slots[j][:m])
            if on_card:
                last = drained[(k - 1) % RING_SLOTS]
                last.synchronize()
                torch.cuda.current_stream(dev).wait_event(last)
        counters["upload_bytes"] += n * 4
        counters["upload_chunks"] += 1
        counters["upload_staged_bytes"] += n * 4 if on_card else 0
        both = dst.view(r1 - r0, L, 2)
        a[r0:r1, :L] = both[:, :, 0]
        b[r0:r1, :L] = both[:, :, 1]
        pair_kernel.s_single_plane(a[r0:r1], b[r0:r1], data._min_cov, out=s[r0:r1])
    return a, b, s


def row_blocks(n_samples: int, block_pairs: int):
    """[r0, r1) row blocks of the i<j triangle, each with at most
    block_pairs pairs (or one row)."""
    r0 = 0
    while r0 < n_samples - 1:
        r1, pairs = r0, 0
        while r1 < n_samples - 1 and (r1 == r0 or pairs + n_samples - 1 - r1 <= block_pairs):
            pairs += n_samples - 1 - r1
            r1 += 1
        yield r0, r1
        r0 = r1


def block_indices(n_samples: int, r0: int, r1: int):
    """(iu, ju) of the block's pairs in np.triu_indices order."""
    rows = np.arange(r0, r1)
    per_row = n_samples - 1 - rows
    iu = np.repeat(rows, per_row)
    starts = np.cumsum(per_row) - per_row
    ju = iu + 1 + (np.arange(iu.size) - np.repeat(starts, per_row))
    return iu, ju


def pair_indices(n_samples: int, r0: int, r1: int, p: np.ndarray):
    """(iu, ju) of the pairs p (indices into the block's np.triu_indices
    order) of the row block [r0, r1)."""
    rows = np.arange(r0, r1)
    per_row = n_samples - 1 - rows
    starts = np.cumsum(per_row) - per_row
    t = np.searchsorted(starts, p, side="right") - 1
    return rows[t], rows[t] + 1 + (p - starts[t])


def fetch_selected(keep_i, keep_f, count) -> tuple:
    """The records of pair_kernel.score_select on the host, in ascending
    p (the order of the block or slice): (p [k] int64, ints [5, k] int32,
    sums [2, k] f64).  The count comes
    first (it waits for the kernels), then only its k records."""
    k = int(count.cpu()[0])
    rec_i, rec_f = keep_i[:k].cpu().numpy(), keep_f[:k].cpu().numpy()
    order = np.argsort(rec_i[:, 0])  # the kept p are distinct
    return rec_i[order, 0].astype(np.int64), rec_i[order, 1:].T, rec_f[order].T


def finalize(data: CountData, opts: Options, iu, ju, ints: np.ndarray, sums: np.ndarray):
    """(f3, i9) row columns of the _pair_columns contract from a block's
    fetched (ints [5, P], sums [2, P]), with the exact engine's f64
    transform (eval/exact.py:native_pair_stats): loglik = -2(joint - ss),
    skewed by (cov_i cov_j)^skew, over n; DBL_MAX where n == 0."""
    n, ibs0, shet, h1, h2 = (x.astype(np.int64) for x in ints)
    joint, ss = sums
    loglik = -2.0 * (joint - ss)
    cov = data.cov.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        sc = loglik / (cov[iu] * cov[ju]) ** opts.cov_skew
        sc = sc / n.astype(np.float64)
    score = np.where(n > 0, sc, DBL_MAX)
    o1, o2 = n - h1, n - h2
    shom = n - h1 - h2 + shet - ibs0
    return _pair_columns(score, ibs0, shet, shom, h1, h2, o1, o2, n)


def compute_score_all_cuda(data: CountData, opts: Options, out, device) -> dict:
    """All-vs-all output identical in layout to the exact engine's.
    Returns the seconds spent in each stage (ALL_STAGES: upload, samples,
    score = launch and fetch, finalize, emit), the number of row blocks and
    `kept`, the pairs finalized on the host.

    Without -a in one process, each block's pair statistics go through
    pair_kernel.score_select where they are: only the pairs it keeps (a
    superset of those under -s) are fetched, put back in the block's order
    and finalized, and the emit's exact test drops the rest, so the table
    is the one a full fetch prints, byte for byte.  With -a every pair
    prints, and every pair is fetched.

    In a process group of W > 1 ranks (parallel/distributed.py; the
    counterpart of ntsm_tpu/eval/rect_mesh.py), block i of the row_blocks
    list belongs to rank i % W: each rank scores its own blocks on its own
    device and sends their statistics to rank 0 (gloo, CPU tensors whose
    shapes every rank derives from the block), and rank 0 takes the blocks
    in order and finalizes and emits them as one process does, so the table
    is byte-identical to one process's.  The other ranks write nothing."""
    me, world = rank(), world_size()
    out.write(HEADER)
    out.write("\n")
    N = data.n_samples
    rec = spans.recorder("eval", ALL_STAGES)
    blocks = kept = 0
    if N < 2:
        return rec.times(blocks=blocks, kept=kept)
    select = not opts.all and world == 1
    with rec.stage("upload"):
        a, b, s = device_planes(data, device, rec=rec)
        if select:
            cov = torch.from_numpy(np.ascontiguousarray(data.cov, dtype=np.float64)).to(a.device)
            thr_hi = pair_kernel.select_threshold(opts.score_thresh)
        if a.is_cuda:
            torch.cuda.synchronize(a.device)
    with rec.stage("samples"):
        lib = _load_row_formatter()
        samp_w = _sample_strings(data) if lib is not None else None
    sent = []  # this rank's sends to rank 0, waited for at the end
    for i, (r0, r1) in enumerate(row_blocks(N, BLOCK_PAIRS)):
        owner = i % world
        if me not in (0, owner):
            continue
        with rec.stage("score"):
            if owner == me:
                with rec.stage("launch"):
                    ints_d, sums_d = pair_kernel.pair_stats(a, b, s, r0, r1, opts.min_cov,
                                                            data.n_sites)
                    if select:
                        picked = pair_kernel.score_select(ints_d, sums_d, cov, r0, N,
                                                          opts.cov_skew, thr_hi)
                with rec.stage("fetch"):
                    if select:
                        p, ints, sums = fetch_selected(*picked)
                    else:
                        ints, sums = ints_d.cpu().numpy(), sums_d.cpu().numpy()
            else:
                ints, sums = _receive_block(owner, i, pair_kernel.n_block_pairs(N, r0, r1))
        if me != 0:
            sent += _send_block(i, ints, sums)
            continue
        with rec.stage("finalize"):
            iu, ju = pair_indices(N, r0, r1, p) if select else block_indices(N, r0, r1)
            f3, i9 = finalize(data, opts, iu, ju, ints, sums)
        with rec.stage("emit"):
            _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w)
        blocks += 1
        kept += iu.size
    for work, _ in sent:
        work.wait()
    return rec.times(blocks=blocks, kept=kept)


def _send_block(i: int, ints: np.ndarray, sums: np.ndarray) -> list:
    """Send block i's (ints [5, P] int32, sums [2, P] f64) to rank 0; the
    tag is the block's index.  Returns the two sends' (handle, tensor): the
    tensors must live until the sends are waited for."""
    tensors = [torch.from_numpy(np.ascontiguousarray(x)) for x in (ints, sums)]
    return [(dist.isend(t, dst=0, tag=i), t) for t in tensors]


def _receive_block(src: int, i: int, n_pairs: int) -> tuple:
    """Block i's (ints, sums) from rank src, as numpy arrays."""
    ints = torch.empty((pair_kernel.N_INTS, n_pairs), dtype=torch.int32)
    sums = torch.empty((2, n_pairs), dtype=torch.float64)
    for x in (ints, sums):
        dist.recv(x, src=src, tag=i)
    return ints.numpy(), sums.numpy()


def compute_score_pca_cuda(data: CountData, opts: Options, out, cloud: np.ndarray,
                           device, planes: tuple | None = None) -> dict:
    """PCA-filtered comparison (computeScorePCA, CompareCounts.hpp:285-391)
    on the device engine: the candidate pairs and their order are the exact
    engine's (eval/driver.py:compute_score_pca), searched on `device`
    (eval/search_kernel.py: the list stays there for the kernels, and one
    host copy serves the plans, finalize and emit) and scored there in
    slices of at most BLOCK_PAIRS, each planned on the host from the host
    list (pair_kernel.plan_pair_blocks).  Returns the seconds spent in each
    stage (PCA_STAGES: candidates, upload, samples, tiles = the plans,
    score = launch and fetch, finalize, emit), the number of candidate
    pairs and `kept`, the candidates finalized on the host; inside
    run_eval's recorder, the projection's stages too.
    `planes`: device_planes(data, device), where the caller has uploaded
    them already (run_eval, which projects from them); else they are
    uploaded here.

    Without -a, each slice's statistics go through pair_kernel.score_select
    on the slice's candidate lists where they are: only the candidates it
    keeps (a superset of those under -s) are fetched, in the list's order,
    and finalized, their distances computed and emitted, and the emit's
    exact test drops the rest, so the table is the one a full fetch
    prints, byte for byte.  With -a every candidate prints, and every
    candidate is fetched."""
    rec = spans.recorder("eval", PCA_STAGES)
    with rec.stage("candidates"):
        with rec.stage("candidates.radii"):
            radii = search_radii(data, opts)
        out.write(HEADER)
        out.write("\n")
        with rec.stage("candidates.search"):
            cloud_d = torch.from_numpy(np.ascontiguousarray(cloud[:, : opts.dim])).to(device)
            radii_d = torch.from_numpy(radii).to(device)
            ii_d, jj_d, ii_all, jj_all = search_kernel.candidate_search(cloud_d, radii_d,
                                                                        stage=rec.stage)
    P = int(ii_all.shape[0])
    kept = 0
    if not P:
        return rec.times(pairs=P, kept=kept)
    select = not opts.all
    with rec.stage("upload"):
        a, b, s = device_planes(data, device, rec=rec) if planes is None else planes
        if select:
            cov = torch.from_numpy(np.ascontiguousarray(data.cov, dtype=np.float64)).to(a.device)
            thr_hi = pair_kernel.select_threshold(opts.score_thresh)
        if a.is_cuda:
            torch.cuda.synchronize(a.device)
    with rec.stage("samples"):
        lib = _load_row_formatter()
        samp_w = _sample_strings(data) if lib is not None else None
    for p0 in range(0, P, BLOCK_PAIRS):
        p1 = min(p0 + BLOCK_PAIRS, P)
        iu, ju = ii_all[p0:p1], jj_all[p0:p1]
        with rec.stage("tiles"):
            plan = pair_kernel.plan_pair_blocks(iu, ju, data.n_samples) if a.is_cuda else None
        with rec.stage("score"):
            with rec.stage("launch"):
                ints_d, sums_d = pair_kernel.pair_block_stats(
                    a, b, s, ii_d[p0:p1], jj_d[p0:p1], opts.min_cov, data.n_sites, plan=plan)
                if select:
                    picked = pair_kernel.score_select(ints_d, sums_d, cov, None, data.n_samples,
                                                      opts.cov_skew, thr_hi,
                                                      pairs=(ii_d[p0:p1], jj_d[p0:p1]))
            with rec.stage("fetch"):
                if select:
                    p, ints, sums = fetch_selected(*picked)
                else:
                    ints, sums = ints_d.cpu().numpy(), sums_d.cpu().numpy()
        with rec.stage("finalize"):
            if select:
                iu, ju = iu[p], ju[p]
            f3, i9 = finalize(data, opts, iu, ju, ints, sums)
            dist = pair_dist_sq(cloud, iu, ju, opts.dim)
        with rec.stage("emit"):
            _emit_prepared(data, opts, out, iu, ju, f3, i9, lib, samp_w, dist=dist)
        kept += iu.size
    return rec.times(pairs=P, kept=kept)
