"""PCA projection and the radius-tier candidate search of ``eval -p``
(counterpart of ntsm_tpu/eval/pca.py, whose names and arithmetic it keeps).

Projection (projectPCs, src/CompareCounts.hpp:116-218): per sample the
genotype fraction AT/(AT+CG) is quantized to {0, 0.5, 1} (thresholds 0.25 /
0.75), missing sites stay 0, the per-site center is subtracted and the
result is rotated into `dim` principal components.  project_pcs runs on
the host, as in the JAX package: the native one-sweep quantize and an f64
BLAS product (fast), the reference's long-double centers and per-step-
rounded f64 accumulator for the exact engine.  The device engine's -p pass
quantizes on the card instead, from the count planes it uploads, and keeps
the same f64 BLAS product (eval/project_kernel.py): the same cloud.

Candidate search (computeScorePCA, :285-528): the reference builds a
nanoflann kd-tree and does per-sample radius queries with asymmetric
pruning rules.  Here the equivalent is the dense pairwise distance matrix
with the same radius tiers and pruning applied as masks.  The candidate SET
and its order are the reference's; only the search algorithm differs.  The
device engine searches on the card instead, in blocks of rows with the same
distance arithmetic (eval/search_kernel.py): the same list.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ntsm_tpu_torch.eval.model import CountData
from ntsm_tpu_torch.options import Options
from ntsm_tpu_torch.utils import spans

DBL_MAX = np.finfo(np.float64).max
# the candidate search, summed over calls (this module's pca_candidate_arrays
# and the device engine's eval/search_kernel.py): rows searched with a finite
# radius, their matches (pairs i != j inside r_i, before the pruning rules),
# pairs listed by the exhaustive rows, pairs listed in all
counters = {"search_rows": 0, "within_radius": 0, "exhaustive": 0, "candidates": 0}


_ARTIFACT_CACHE: dict = {}


def _cached(path: str, build):
    """Parse-once cache for the PCA artifacts, keyed by (path, size,
    mtime): the rotation matrix alone is ~1.9M strtold tokens at the human
    site count."""
    st = os.stat(path)
    key = (path, st.st_size, st.st_mtime_ns)
    hit = _ARTIFACT_CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    val = build()
    _ARTIFACT_CACHE[path] = (key, val)
    return val


def load_norm_values(path: str) -> np.ndarray:
    """Per-site centering values, parsed as long double (:121-134)."""

    def build():
        vals = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                # `ss >> value` on an empty line leaves value uninitialized
                # and the reference still push_backs; blank lines do not
                # occur in real center files, so they count as 0
                vals.append(line if line else "0")
        # one C strtold per token (same parse as per-token np.longdouble)
        return np.array(vals, dtype=np.longdouble)

    return _cached(path, build)


def load_rotation(path: str, n_sites: int) -> np.ndarray:
    """Rotation matrix TSV: header row, then rsID + components per site
    (:136-170).  Returns [n_components, n_sites] longdouble."""

    def build():
        with open(path) as fh:
            header = fh.readline().split()
            comp_num = len(header) - 1
            toks: list = []
            nrows = 0
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                toks.extend(parts[1 : comp_num + 1])
                nrows += 1
        return np.array(toks, dtype=np.longdouble).reshape(nrows, comp_num).T

    rot = _cached(path, build)
    if rot.shape[1] != n_sites:
        raise AssertionError(
            f"rotation matrix rows ({rot.shape[1]}) != norm sites ({n_sites})"
        )
    return rot


PROJ_BLK = 128  # projection row block (buffers ~0.6 GB at the human scale)


class _ProjScratch:
    """Reused projection buffers for one row-block width: fresh [N, L]
    temporaries at cohort scale cost more in page faults than the
    arithmetic; per-row results are the same either way."""

    def __init__(self, blk: int, L: int, fast: bool):
        self.blk = blk
        self.ca, self.cb, self.den, self.g = (
            np.zeros((blk, L), np.float64) for _ in range(4)
        )
        self.vals = np.zeros((blk, L), np.float64 if fast else np.longdouble)
        self.keep, self.low = (np.zeros((blk, L), bool) for _ in range(2))


_DSIZE = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
          np.dtype(np.int32): 4, np.dtype(np.int64): 8}


def _quantize_vals_native(ab, bb, normv, mc, valsm) -> bool:
    """ntsm_quantize_vals when the host library is built and the inputs
    qualify (integer count rows with a unit column stride, f64 centers);
    False -> numpy."""
    from ntsm_tpu_torch import native

    lib = native.load()
    ds = _DSIZE.get(ab.dtype)
    it = ab.dtype.itemsize if ds else 0
    if (
        lib is None
        or ds is None
        or bb.dtype != ab.dtype
        # unit column stride; rows may be a [m, :L] view of [m, Lp]
        or ab.strides[1] != it
        or bb.strides[1] != it
        or ab.strides[0] % it
        or bb.strides[0] % it
        or normv.dtype != np.float64
        or not normv.flags.c_contiguous
    ):
        return False
    m, L = ab.shape
    lib.ntsm_quantize_vals(
        ab.ctypes.data_as(ctypes.c_void_p),
        bb.ctypes.data_as(ctypes.c_void_p),
        ds, m, L, ab.strides[0] // it, bb.strides[0] // it,
        normv.ctypes.data_as(ctypes.c_void_p),
        float(mc),
        valsm.ctypes.data_as(ctypes.c_void_p),
    )
    return True


def _project_rows(sc: _ProjScratch, ab, bb, normv, rotT, mc, out) -> None:
    """Project one row block: quantize {0, 0.5, 1} (reference sign-test
    thresholds), zero missing sites, subtract centers, rotate.  ab/bb:
    [m, L] integer count rows; out: [m, dim] f64.  The arithmetic is the
    reference's projectPCs (:173-210), see project_pcs."""
    valsm = sc.vals[: ab.shape[0]]
    with spans.stage("project.quantize"):
        # one native sweep where it applies, bitwise the f64 vals of the
        # numpy form
        if not (valsm.dtype == np.float64 and _quantize_vals_native(ab, bb, normv, mc, valsm)):
            _quantize_vals_numpy(sc, ab, bb, normv, mc)
    with spans.stage("project.matmul"):
        if valsm.dtype == np.float64:
            np.matmul(valsm, rotT, out=out)
        else:
            # the reference's exact type semantics (projectPCs :173-210 +
            # std::inner_product<double>): vals[j] is a DOUBLE (the q - center
            # long-double subtraction rounds once on store), and the
            # accumulator is a DOUBLE re-rounded after every (double x long
            # double) product-add; an all-long-double matmul with one final
            # cast differs in the last f64 ulp at cohort scale
            _project_exact_rows(valsm.astype(np.float64), rotT, out)


def _quantize_vals_numpy(sc: _ProjScratch, ab, bb, normv, mc) -> None:
    """The quantized, centered values of one row block into sc.vals[:m]
    (f64 or long double), in numpy passes over the reused buffers."""
    m = ab.shape[0]
    cam, cbm, denm, gm = sc.ca[:m], sc.cb[:m], sc.den[:m], sc.g[:m]
    valsm, keepm, lowm = sc.vals[:m], sc.keep[:m], sc.low[:m]
    # ca/cb = where(count > mc, count, 0) as f64 (exact small ints)
    np.copyto(cam, ab)
    np.greater(ab, mc, out=keepm)
    cam *= keepm
    np.copyto(cbm, bb)
    np.greater(bb, mc, out=keepm)
    cbm *= keepm
    np.add(cam, cbm, out=denm)
    # g = ca / den where den > 0 else 0; den is integer-valued, so
    # max(den, 1) selects the same divisor as where(den > 0, den, 1)
    # and 0/1 lands the same 0.0 on missing sites
    np.maximum(denm, 1.0, out=gm)
    np.divide(cam, gm, out=gm)
    # q thresholds, reference sign-test form (g-0.25 < 0, g-0.75 < 0)
    qm = cam  # reuse: ca is dead from here on
    qm.fill(1.0)
    np.subtract(gm, 0.75, out=cbm)
    np.less(cbm, 0.0, out=lowm)
    np.copyto(qm, 0.5, where=lowm)
    np.subtract(gm, 0.25, out=cbm)
    np.less(cbm, 0.0, out=lowm)
    np.copyto(qm, 0.0, where=lowm)
    # vals = q - center where present, exactly 0.0 where missing
    np.subtract(qm, normv[None, :], out=valsm)
    np.equal(denm, 0.0, out=lowm)
    np.copyto(valsm, 0.0, where=lowm)


def _project_exact_rows(vals64: np.ndarray, rotT: np.ndarray, out) -> None:
    """f64-accumulator x long-double-rotation inner products (see
    _project_rows); rotT must be a C-contiguous [L, dim] longdouble."""
    from ntsm_tpu_torch import native

    lib = native.load()
    m, L = vals64.shape
    dim = rotT.shape[1]
    if lib is not None and rotT.flags.c_contiguous:
        lib.ntsm_project_exact(
            vals64.ctypes.data_as(ctypes.c_void_p),
            rotT.ctypes.data_as(ctypes.c_void_p),
            m, L, dim,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return
    acc = np.zeros((m, dim), np.float64)
    for j in range(L):  # per-step f64 rounding, ascending j as inner_product
        acc = (acc + vals64[:, j, None] * rotT[j][None, :]).astype(np.float64)
    out[:] = acc


def projection_operands(opts: Options, fast: bool) -> tuple:
    """(rotT [L, dim], centers [L]) of the projection: f64 for the fast
    arithmetic; for the exact one long double, rotT C-contiguous for the
    native per-step-rounded accumulator."""
    norm = load_norm_values(opts.norm)
    rot = load_rotation(opts.pca, norm.shape[0])
    if opts.dim > rot.shape[0]:
        raise AssertionError("opt::dim exceeds component count (:155)")
    rotT = rot[: opts.dim].T  # [L, dim]
    if fast:
        return rotT.astype(np.float64), norm.astype(np.float64)
    return np.ascontiguousarray(rotT), norm


def project_pcs(data: CountData, opts: Options, fast: bool | None = None) -> np.ndarray:
    """[N, dim] float64 PCA cloud, matching projectPCs' arithmetic
    (:173-210): per site the genotype fraction AT/(AT+CG) is quantized to
    {0, 0.5, 1} (thresholds 0.25/0.75 via the reference's g-0.25/g-0.75
    sign tests), missing sites stay exactly 0.0 (not 0 - center,
    :189-191), the center is subtracted and the row is rotated.

    fast=True computes in f64 (native quantize, BLAS product) instead of
    numpy's software long-double loops.  Defaults to the engine: the device
    engine (``cuda``) projects fast, the exact engine keeps long double for
    bit parity of the dist column with the reference.  Either way the
    cloud is the JAX package's bit for bit on the same inputs.

    Row-blocked into reused scratch buffers (_ProjScratch); each block's
    count rows are copied contiguous so the native quantize takes them.
    Inside a stage recorder (run_eval), the copies, the quantize and the
    product are its stages project.copy, .quantize and .matmul."""
    if fast is None:
        fast = opts.engine == "cuda"
    rotT, normv = projection_operands(opts, fast)
    a, b = data.counts_ab()
    N, L = a.shape
    dim = opts.dim
    mc = opts.min_cov
    cloud = np.empty((N, dim), np.float64)
    blk = min(N, PROJ_BLK)
    sc = _ProjScratch(blk, L, fast)
    for r0 in range(0, N, blk):
        r1 = min(r0 + blk, N)
        with spans.stage("project.copy"):
            ab, bb = np.ascontiguousarray(a[r0:r1]), np.ascontiguousarray(b[r0:r1])
        _project_rows(sc, ab, bb, normv, rotT, mc, cloud[r0:r1])
    return cloud


def calc_distance_sq(cloud: np.ndarray, i: int, j: int, dim: int) -> float:
    """Squared Euclidean distance (calcDistance, :923-932)."""
    d = cloud[i, :dim] - cloud[j, :dim]
    return float(np.sum(d * d))


def pair_dist_sq(cloud: np.ndarray, ii, jj, dim: int) -> np.ndarray:
    """calc_distance_sq of the pairs (ii[p], jj[p]) as one f64 array: the
    -p dist column (ntsm_tpu/eval/driver.py:compute_score_pca)."""
    d = cloud[ii, :dim] - cloud[jj, :dim]
    return (d * d).sum(axis=1)


def search_radii(data: CountData, opts: Options) -> np.ndarray:
    """Per-sample radius tier (:294-308): squared radii or DBL_MAX."""
    n = data.n_samples
    radii = np.full(n, DBL_MAX)
    prop_missing = data.miss.astype(np.float64) / float(data.n_sites)
    tier1 = (data.error_rate < opts.pc_error_thresh) & (prop_missing < opts.pc_miss_site1)
    tier2 = ~tier1 & (prop_missing < opts.pc_miss_site2)
    radii[tier1] = opts.pc_search_radius1 ** 2
    radii[tier2] = opts.pc_search_radius2 ** 2
    return radii


def pca_candidates(cloud: np.ndarray, radii: np.ndarray, dim: int,
                   sq: np.ndarray | None = None):
    """Candidate pairs with the reference's pruning rules (:316-390).

    Yields (i, k) pairs in the reference's emission order: for each sample i
    (ascending), its radius-search matches sorted by distance (nanoflann
    sorts results); exhaustive samples scan k in index order.

    Pruning for a finite-radius i and a match k (dist < r_i, strict per
    nanoflann RadiusResultSet::addPoint):
      * r_i == r_k: keep only k > i
      * r_i <  r_k: skip (k's own larger search will emit the pair)
      * r_i >  r_k: keep (regardless of order)
    For r_i == DBL_MAX (exhaustive): skip j <= i only when r_j is also
    DBL_MAX; all finite-radius j are paired here.
    """
    ii, kk = pca_candidate_arrays(cloud, radii, dim, sq=sq)
    yield from zip(ii.tolist(), kk.tolist())


def sq_dists_blocked(c: np.ndarray) -> np.ndarray:
    """[N, N] squared L2 distances by row-blocked (a-b)^2 accumulation:
    the per-coordinate arithmetic order of nanoflann's L2 accumulation
    (not the |a|^2+|b|^2-2ab matmul form, whose other rounding could flip
    borderline radius comparisons), without an [N, N, dim] transient."""
    n = c.shape[0]
    sq = np.empty((n, n), dtype=np.float64)
    BLK = 64
    for r0 in range(0, n, BLK):
        r1 = min(r0 + BLK, n)
        sq[r0:r1] = ((c[r0:r1, None, :] - c[None, :, :]) ** 2).sum(axis=2)
    return sq


def pca_candidate_arrays(cloud: np.ndarray, radii: np.ndarray, dim: int,
                         sq: np.ndarray | None = None):
    """pca_candidates as (ii, kk) int64 arrays in the identical emission
    order, without materializing millions of pair tuples.  The list comes
    grouped by i, ascending."""
    n = cloud.shape[0]
    c = cloud[:, :dim]
    if sq is None:
        sq = sq_dists_blocked(c)
    idx = np.arange(n)
    exhaust = radii >= DBL_MAX
    parts_i: list = []
    parts_k: list = []
    within = listed_ex = 0
    for i in range(n):
        ri = radii[i]
        if ri < DBL_MAX:
            match = np.nonzero(sq[i] < ri)[0]
            within += int(match.size) - int(sq[i, i] < ri)
            order = match[np.argsort(sq[i][match], kind="stable")]
            rk = radii[order]
            keep = np.where(rk == ri, order > i, rk < ri)
            ks = order[keep]
        else:
            # exhaustive searchers share one match list shape: every j
            # except exhaustive j <= i (k order = index order)
            ks = idx[~(exhaust & (idx <= i)) & (idx != i)]
            listed_ex += int(ks.size)
        if ks.size:
            parts_i.append(np.full(ks.size, i, dtype=np.int64))
            parts_k.append(ks.astype(np.int64))
    counters["search_rows"] += int((radii < DBL_MAX).sum())
    counters["within_radius"] += within
    counters["exhaustive"] += listed_ex
    counters["candidates"] += sum(int(p.size) for p in parts_i)
    if not parts_i:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(parts_i), np.concatenate(parts_k)
