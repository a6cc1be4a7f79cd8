// The radius pass of the eval -p candidate search on the card (the radius
// queries of computeScorePCA, src/CompareCounts.hpp:316-390): for each row i
// in [r0, r1) whose squared radius r_i is finite, every j != i of the cloud
// with d2(i, j) < r_i, strictly.
//
// d2 is the sum of the dim terms (c_i[k] - c_j[k])^2 in the order in which
// numpy sums the last axis of eval/pca.py:sq_dists_blocked (its pairwise
// sum: below 8 terms one after the other; up to 128 eight accumulators, then
// ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) and the rest one after
// the other; beyond 128 the two halves, split at a multiple of 8, each summed
// so and then added).  Every operation is rounded to nearest by name
// (__dsub_rn, __dmul_rn, __dadd_rn), so that no build flag contracts it into
// an FMA, and d2 is the host's bit for bit: a match on the card is a match
// on the host, at any distance from the radius.
//
// A block of kRows threads takes kRows query rows, one a thread, and one
// chunk of the columns (blockIdx.y).  It stages the chunk's points in shared
// memory, as many at a time as 48 KB hold (up to kTile), where every thread
// reads the same point at once (a broadcast).  The cloud comes transposed,
// [dim, n], so that the threads of a warp read their query rows' k-th terms
// from one span of memory.  One kernel for every dim, with one summation:
// numpy's leaf, and above kLeaf terms its split, walked without recursion.
// Two passes with one entry point: the first counts each (row, chunk)'s
// matches; the caller turns the counts into offsets (in row-major order, so
// a row's chunks follow each other) and the second writes each match's i, j
// and d2 at its offset, in ascending j.  A row's matches are so in index
// order, as the host's np.nonzero gives them; the pruning rules and the
// order by distance are the caller's (eval/search_kernel.py).
//
// It replaces no TPU kernel: the JAX package searches on the host.  What
// bounds a brute-force search on the H100 is f64 work: 3 dim operations a
// pair of points, N^2 pairs (1.07e9 at N = 32,768: 6.4e10 operations, ~2 ms
// at the f64 rate outside the tensor cores), twice; the bytes are the cloud
// (5.2 MB at dim 20) and 16 B a match.

#include <algorithm>
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;         // query rows a block, one a thread
constexpr int kTile = 128;         // most points of a chunk staged at a time
constexpr int kShmDoubles = 6144;  // 48 KB of staged points
constexpr int kLeaf = 128;         // numpy's PW_BLOCKSIZE: pairwise_sum's largest leaf

__device__ __forceinline__ double term(double x, double y) {
    const double d = __dsub_rn(x, y);
    return __dmul_rn(d, d);
}

// numpy's leaf (n <= kLeaf) on the query q (its k-th term at q[k * qs]) and
// the point c.
__device__ double leaf(const double* q, long qs, const double* c, int n) {
    if (n < 8) {
        double res = 0.0;  // numpy starts from -0.0; a sum of squares is the same from +0.0
        for (int k = 0; k < n; ++k) res = __dadd_rn(res, term(q[k * qs], c[k]));
        return res;
    }
    double r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = term(q[k * qs], c[k]);
    int i = 8;
    for (; i < n - n % 8; i += 8) {
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = __dadd_rn(r[k], term(q[(i + k) * qs], c[i + k]));
    }
    double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                           __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
    for (; i < n; ++i) res = __dadd_rn(res, term(q[i * qs], c[i]));
    return res;
}

// numpy's pairwise sum of any length: the split of pairwise_sum, without
// recursion (the halves' sums kept on a small stack; 2^24 terms at most
// need 17 levels).
__device__ double dist(const double* q, long qs, const double* c, int n) {
    if (n <= kLeaf) return leaf(q, qs, c, n);
    // post-order walk of the split tree: (offset, length, state) frames
    int off[24], len[24], state[24];
    double left[24];
    int top = 0;
    off[0] = 0;
    len[0] = n;
    state[0] = 0;
    double ret = 0.0;
    while (top >= 0) {
        const int o = off[top], m = len[top];
        if (m <= kLeaf) {
            ret = leaf(q + o * qs, qs, c + o, m);
            --top;
            continue;
        }
        int h = m / 2;
        h -= h % 8;
        if (state[top] == 0) {  // descend into the left half
            state[top] = 1;
            ++top;
            off[top] = o;
            len[top] = h;
            state[top] = 0;
        } else if (state[top] == 1) {  // left done: keep it, descend into the right
            left[top] = ret;
            state[top] = 2;
            ++top;
            off[top] = o + h;
            len[top] = m - h;
            state[top] = 0;
        } else {  // both done
            ret = __dadd_rn(left[top], ret);
            --top;
        }
    }
    return ret;
}

template <bool WRITE>
__global__ void __launch_bounds__(kRows)
    pca_radius_kernel(const double* __restrict__ cloud_t, const double* __restrict__ radii, int n,
                      int dim, int r0, int r1, int n_chunks, int chunk_w, int tile_pts,
                      int* __restrict__ counts, const long long* __restrict__ offsets,
                      int* __restrict__ out_i, int* __restrict__ out_j,
                      double* __restrict__ out_d) {
    extern __shared__ double tile[];  // [tile_pts, dim]
    const int row = r0 + blockIdx.x * kRows + threadIdx.x;
    const double r = row < r1 ? radii[row] : 0.0;
    const bool live = row < r1 && r < DBL_MAX;
    const double* q = cloud_t + row;  // its k-th term at q[k * n]
    const long slot = static_cast<long>(row - r0) * n_chunks + blockIdx.y;
    long long pos = (WRITE && live) ? offsets[slot] : 0;
    int found = 0;
    const int j0 = blockIdx.y * chunk_w;
    const int j1 = min(n, j0 + chunk_w);
    for (int t0 = j0; t0 < j1; t0 += tile_pts) {
        const int m = min(tile_pts, j1 - t0);
        __syncthreads();
        for (int e = threadIdx.x; e < m * dim; e += kRows) {
            const int k = e / m, t = e - k * m;
            tile[t * dim + k] = cloud_t[static_cast<long>(k) * n + t0 + t];
        }
        __syncthreads();
        if (!live) continue;
        for (int t = 0; t < m; ++t) {
            const double d = dist(q, n, tile + t * dim, dim);
            if (d < r && t0 + t != row) {
                if (WRITE) {
                    out_i[pos] = row;
                    out_j[pos] = t0 + t;
                    out_d[pos] = d;
                    ++pos;
                } else {
                    ++found;
                }
            }
        }
    }
    if (!WRITE && row < r1) counts[slot] = found;
}

}  // namespace

// cloud_t [dim, n] f64 (the cloud transposed) and radii [n] f64 (squared;
// DBL_MAX: the exhaustive tier, not searched here) on the device; rows
// [r0, r1); the columns cut into n_chunks chunks of ceil(n / n_chunks);
// dim <= 6144 (a staged point fits in 48 KB).  offsets == NULL: the
// counting pass, counts [r1 - r0, n_chunks] int32 out.  Else the writing
// pass: offsets [r1 - r0, n_chunks] int64 (where each (row, chunk)'s
// matches start), out_i, out_j int32 and out_d f64 out.  Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a dim
// outside [1, 6144].
extern "C" int ntsm_pca_radius(const void* cloud_t, const void* radii, long n, int dim, long r0,
                               long r1, int n_chunks, void* counts, const void* offsets,
                               void* out_i, void* out_j, void* out_d, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dim < 1 || dim > kShmDoubles) return static_cast<int>(cudaErrorInvalidValue);
    if (r1 <= r0 || n <= 0 || n_chunks < 1) return static_cast<int>(cudaGetLastError());
    const int chunk_w = static_cast<int>((n + n_chunks - 1) / n_chunks);
    const int tile_pts = std::min(kTile, kShmDoubles / dim);
    const size_t shm = static_cast<size_t>(tile_pts) * dim * sizeof(double);
    const dim3 grid(static_cast<unsigned int>((r1 - r0 + kRows - 1) / kRows),
                    static_cast<unsigned int>(n_chunks));
    const auto* c = static_cast<const double*>(cloud_t);
    const auto* rad = static_cast<const double*>(radii);
    auto* cnt = static_cast<int*>(counts);
    const auto* offs = static_cast<const long long*>(offsets);
    auto* oi = static_cast<int*>(out_i);
    auto* oj = static_cast<int*>(out_j);
    auto* od = static_cast<double*>(out_d);
    const int N = static_cast<int>(n), R0 = static_cast<int>(r0), R1 = static_cast<int>(r1);
    if (offsets != nullptr)
        pca_radius_kernel<true><<<grid, kRows, shm, st>>>(c, rad, N, dim, R0, R1, n_chunks,
                                                          chunk_w, tile_pts, cnt, offs, oi, oj,
                                                          od);
    else
        pca_radius_kernel<false><<<grid, kRows, shm, st>>>(c, rad, N, dim, R0, R1, n_chunks,
                                                           chunk_w, tile_pts, cnt, offs, oi, oj,
                                                           od);
    return static_cast<int>(cudaGetLastError());
}
