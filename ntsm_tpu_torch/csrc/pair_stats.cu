// The pair-statistics kernel of `ntsm eval` all-vs-all: for every pair
// (i, j), i < j, of a block of rows [r0, r1) against the whole cohort, one
// pass over the sites gives everything a summary.tsv row needs:
//
//   ints [5, P] i32   n, ibs0, sharedHets, hets1, hets2 over the pair's
//                     valid sites (the hom tallies are identities of
//                     these: homs1 = n - hets1, homs2 = n - hets2,
//                     sharedHoms = n - hets1 - hets2 + sharedHets - ibs0)
//   f64  [2, P] f64   joint = sumLogPJoint and ss = sumLogPSingle1 +
//                     sumLogPSingle2 over the pair's valid sites
//
// with P the block's pairs in np.triu_indices order (row i, then j > i).
// The f64 step is pair_site.cuh's ntsm_pair_sums, applied by one thread to
// each of its pairs for the sites in ascending order, so joint and ss are
// the exact engine's bit for bit and the printed scores agree byte for
// byte.  The sum over sites is never split across threads.
//
// Replaces the TPU kernel ntsm_tpu/eval/pallas_joint.py:54
// _joint_frac_kernel (K3, the fractional joint term jfrac, opt-in on the
// TPU; its XLA twin is eval/kernels.py:_joint_tiles) together with the XLA
// stages the TPU engine builds around it (K6): the exact integer joint term
// through (t+1)^2 indicator matmuls (eval/kernels.py:198
// _joint_int_matmuls), the compensated f32 s1 sums (eval/kernels.py:47
// _chunked_matmul_f64) and the 0/1 indicator tallies (eval/rect.py:120
// _f32mm).  Those pieces exist because a TPU has no native f64 and only its
// matrix unit is fast; Hopper has f64, so one kernel computes joint
// (= the TPU engine's jint - jfrac) directly.
//
// What bounds it on the H100: instruction issue and the f64 pipe.  A
// pair-site costs one reciprocal (rcp.approx and four FMAs), two
// 3-operation quotients and eight adds and products, about 20 f64-pipe
// instructions among about 40; no division, no int->f64 conversion and no
// branch to a slow path is left in the pair loop.  Device memory is not the
// limit: each staged value serves TI or TJ pairs.
//
// Design (wrapper: eval/pair_kernel.py:pair_stats; the tile machinery is
// pair_site.cuh's, shared with pair_block_stats.cu's tile instance):
// - a block of 16 x 16 threads owns a TI x TJ tile of pairs (TI = 16 RI,
//   TJ = 16 RJ), rows i0.. against columns j0..; thread (tx, ty) holds the
//   RI x RJ pairs (i0 + ty + 16k, j0 + tx + 16l) in registers, so a staged
//   value feeds RJ (or RI) pairs and RI RJ independent sums hide the f64
//   latency;
// - two instances: 1 x 1 pairs a thread (sites unrolled 16 deep for the
//   same latency hiding), for blocks too small to fill the card with 2 x 2
//   threads, and 2 x 2 (two blocks an SM: 114 registers, no spills; three
//   spill) for the rest; the wrapper picks by the block's pair count
//   (pair_kernel.py:micro_tile);
// - the grid is the list of live tiles (those holding a pair j > i), which
//   the wrapper builds; no block starts only to return;
// - per chunk of SC = 32 sites the block stages its TI rows and TJ columns
//   in shared memory, each sample-site converted once: the counts as f64,
//   s_single, and four bit planes, one word a sample (valid, het, hom AT,
//   hom CG), made by warp ballots;
// - a pair's five tallies for the chunk are popcounts of ANDs of those
//   words, and the same valid word predicates the f64 sums.

#include <cstdint>

#include <cuda_runtime.h>

#include "pair_site.cuh"

namespace {

// RI x RJ pairs a thread, the site loop unrolled UNROLL deep, at least
// MINB blocks an SM (which caps the registers a thread).
template <int RI, int RJ, int UNROLL, int MINB>
__global__ void __launch_bounds__(NTSM_TILE_THREADS, MINB)
pair_stats_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                  const double* __restrict__ S, long pitch, int n_samples,
                  long n_sites, int r0, int r1, long mc, const int32_t* __restrict__ tiles,
                  int32_t* __restrict__ ints, double* __restrict__ sums, long n_pairs) {
    constexpr int TI = NTSM_TY * RI, TJ = NTSM_TX * RJ;
    extern __shared__ __align__(16) unsigned char smem[];
    PairStage<TI, TJ>& st = *reinterpret_cast<PairStage<TI, TJ>*>(smem);

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i0 = r0 + tiles[2 * blockIdx.x] * TI;
    const int j0 = tiles[2 * blockIdx.x + 1] * TJ;

    PairTileAcc<RI, RJ> acc;
    ntsm_tile_pairs<RI, RJ, UNROLL>(
        acc, st, A, B, S, pitch, n_sites, mc, true,
        [&](int e) { return i0 + e < r1 ? i0 + e : -1; },
        [&](int c) { return j0 + c < n_samples ? j0 + c : -1; });

    const long lr0 = r0, last = n_samples - 1;
#pragma unroll
    for (int k = 0; k < RI; ++k) {
        const int i = i0 + ty + NTSM_TY * k;
        if (i >= r1) continue;
        // pairs before row i in this block: sum over r in [r0, i) of (N-1-r)
        const long li = i;
        const long row = (li - lr0) * last - (li * (li - 1) / 2 - lr0 * (lr0 - 1) / 2);
#pragma unroll
        for (int l = 0; l < RJ; ++l) {
            const int j = j0 + tx + NTSM_TX * l;
            if (j >= n_samples || j <= i) continue;
            const long p = row + (j - i - 1);
            if (p >= n_pairs) continue;  // cannot happen for a consistent n_pairs
            ints[p] = acc.n[k][l];
            ints[n_pairs + p] = acc.ibs0[k][l];
            ints[2 * n_pairs + p] = acc.shet[k][l];
            ints[3 * n_pairs + p] = acc.h1[k][l];
            ints[4 * n_pairs + p] = acc.h2[k][l];
            sums[p] = acc.joint[k][l];
            sums[n_pairs + p] = acc.ss[k][l];
        }
    }
}

template <int RI, int RJ, int UNROLL, int MINB>
int launch(const void* A, const void* B, const void* S, long pitch, int n_samples,
           long n_sites, int r0, int r1, long mc, const void* tiles, int n_tiles, void* ints,
           void* sums, long n_pairs, cudaStream_t stream) {
    constexpr int bytes = sizeof(PairStage<NTSM_TY * RI, NTSM_TX * RJ>);
    auto kernel = pair_stats_kernel<RI, RJ, UNROLL, MINB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_tiles, dim3(NTSM_TX, NTSM_TY), bytes, stream>>>(
        static_cast<const int32_t*>(A), static_cast<const int32_t*>(B),
        static_cast<const double*>(S), pitch, n_samples, n_sites, r0, r1, mc,
        static_cast<const int32_t*>(tiles), static_cast<int32_t*>(ints),
        static_cast<double*>(sums), n_pairs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, B: [N, pitch] i32 allele count planes; S: [N, pitch] f64 s_single
// plane; only sites [0, n_sites) are read.  Rows [r0, r1) are scored
// against every column j > i; ints [5, n_pairs] and sums [2, n_pairs] are
// written in np.triu_indices order.  tiles: [n_tiles, 2] i32 (row tile,
// column tile) of the live TI x TJ tiles of micro-tile `micro` (0: 1 x 1,
// 1: 2 x 2 pairs a thread; TI = 16 RI, TJ = 16 RJ, row tiles counted from
// r0).  Launches on `stream`, returns cudaGetLastError() (or
// cudaErrorInvalidValue for an unknown `micro`).
extern "C" int ntsm_pair_stats(const void* A, const void* B, const void* S,
                               long pitch, int n_samples, long n_sites, int r0,
                               int r1, long mc, const void* tiles, int n_tiles, int micro,
                               void* ints, void* sums, long n_pairs, void* stream) {
    if (r1 <= r0 || n_pairs <= 0 || n_tiles <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (micro) {
        case 0:
            return launch<1, 1, 16, 1>(A, B, S, pitch, n_samples, n_sites, r0, r1, mc, tiles,
                                       n_tiles, ints, sums, n_pairs, st);
        case 1:
            return launch<2, 2, 2, 2>(A, B, S, pitch, n_samples, n_sites, r0, r1, mc, tiles,
                                      n_tiles, ints, sums, n_pairs, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
