// The candidate-pair kernel of `ntsm eval -p`: for each pair p of a list,
// (i, j) = (ii[p], jj[p]), one pass over the sites [0, n_sites) gives
//
//   ints [5, P] i32   n, ibs0, sharedHets, hets1, hets2 over the pair's
//                     valid sites
//   sums [2, P] f64   joint = sumLogPJoint and ss = sumLogPSingle1 +
//                     sumLogPSingle2 over the same sites
//
// written at the pair's own index p, so the fetched arrays are in the
// list's (print) order.  The per-site step is pair_site.cuh's, the one
// pair_stats.cu (-a) calls, applied to the sites in ascending order by one
// thread per pair: joint and ss are the exact engine's bit for bit
// (ntsm_exact_pairs, which `--engine exact -p` runs on the same list), so
// `--engine cuda -p` prints the exact engine's table byte for byte.  A
// warp reduction over sites would change the order of the sums and lose
// that.
//
// Replaces ntsm_tpu/eval/kernels.py:317 _pair_block_stats_v2 (K5, XLA,
// called from eval/tpu.py:370), which gathers the paired rows of a fused
// [C/g, N, 2*g*c] u8/u16 chunked layout per scan step and keeps loglik as
// a compensated f32 pair, packed into the narrow wire; the card has f64, so
// the port reads the int32 planes and sums in f64 directly.
//
// Design: one block of THREADS threads takes THREADS consecutive
// candidates.  The list comes grouped by i, ascending (eval/pca.py:
// pca_candidate_arrays), so a block's i rows are mostly one row and its j
// rows are scattered over the cohort.  Per chunk of SC sites the block
// stages each of its pairs' two rows of A, B (i32) and S (f64, the
// s_single plane) into shared memory, element e of a THREADS x SC slab
// being (pair e / SC, site e % SC): neighbouring threads read neighbouring
// sites of one row, and a repeated i row is served by L1 and L2.  Then each
// thread runs the per-site step over the chunk for its own pair.
//
// What bounds it on the H100: f64 arithmetic.  A valid pair-site costs
// the shared step's one reciprocal, two corrected quotients and eight adds
// and products (pair_site.cuh:ntsm_pair_sums), here after four int->f64
// conversions, since each staged value serves one pair.  The bytes are at
// most 16 B for each sample-site touched (A, B, S), read once: 4.9 GB for
// the whole N = 3202 x 96,287 planes, 1.5 ms at the H100 SXM data sheet's
// 3.35 TB/s, below the arithmetic's least time (at its 34 TFLOP/s) for
// any candidate list of more than about 70,000 pairs.  Later work: the
// all-vs-all kernel's staging (f64 counts and bit planes converted once a
// sample-site), several pairs a thread, keeping the ascending order, and
// one staged copy of a repeated i row.

#include <cstdint>

#include <cuda_runtime.h>

#include "pair_site.cuh"

namespace {

constexpr int THREADS = 128;  // pairs per block, one a thread
constexpr int SC = 8;         // sites per staged chunk: 38,912 B of shared memory,
                              // five blocks an SM

__global__ void __launch_bounds__(THREADS)
pair_block_stats_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                        const double* __restrict__ S, long pitch, long n_sites,
                        const int32_t* __restrict__ ii, const int32_t* __restrict__ jj,
                        long n_pairs, long mc, int32_t* __restrict__ ints,
                        double* __restrict__ sums) {
    // +1 pads make the compute loop's row-per-thread reads conflict-free
    __shared__ int32_t a_i[THREADS][SC + 1], b_i[THREADS][SC + 1];
    __shared__ int32_t a_j[THREADS][SC + 1], b_j[THREADS][SC + 1];
    __shared__ double s_i[THREADS][SC + 1], s_j[THREADS][SC + 1];
    __shared__ long row_i[THREADS], row_j[THREADS];  // element offsets, -1 past the list

    const int t = threadIdx.x;
    const long p0 = static_cast<long>(blockIdx.x) * THREADS;
    const long p = p0 + t;
    row_i[t] = p < n_pairs ? static_cast<long>(ii[p]) * pitch : -1;
    row_j[t] = p < n_pairs ? static_cast<long>(jj[p]) * pitch : -1;
    __syncthreads();

    PairAcc acc;
    for (long s0 = 0; s0 < n_sites; s0 += SC) {
        const int width = static_cast<int>(min(static_cast<long>(SC), n_sites - s0));
        for (int e = t; e < THREADS * SC; e += THREADS) {
            const int r = e / SC, c = e % SC;
            const long oi = row_i[r], oj = row_j[r];
            const bool live = c < width && oi >= 0;
            a_i[r][c] = live ? A[oi + s0 + c] : 0;
            b_i[r][c] = live ? B[oi + s0 + c] : 0;
            s_i[r][c] = live ? S[oi + s0 + c] : 0.0;
            a_j[r][c] = live ? A[oj + s0 + c] : 0;
            b_j[r][c] = live ? B[oj + s0 + c] : 0;
            s_j[r][c] = live ? S[oj + s0 + c] : 0.0;
        }
        __syncthreads();
        for (int c = 0; c < width; ++c) {
            ntsm_pair_site(acc, a_i[t][c], b_i[t][c], s_i[t][c], a_j[t][c], b_j[t][c],
                           s_j[t][c], mc);
        }
        __syncthreads();
    }

    if (p >= n_pairs) return;
    ints[p] = acc.n;
    ints[n_pairs + p] = acc.ibs0;
    ints[2 * n_pairs + p] = acc.shet;
    ints[3 * n_pairs + p] = acc.h1;
    ints[4 * n_pairs + p] = acc.h2;
    sums[p] = acc.joint;
    sums[n_pairs + p] = acc.ss;
}

}  // namespace

// A, B: [N, pitch] i32 allele count planes; S: [N, pitch] f64 s_single
// plane; only sites [0, n_sites) are read.  ii, jj: [n_pairs] i32 row
// indices in [0, N), checked by the caller.  ints [5, n_pairs] and sums
// [2, n_pairs] are written at each pair's index.  Launches on `stream`,
// returns cudaGetLastError().
extern "C" int ntsm_pair_block_stats(const void* A, const void* B, const void* S,
                                     long pitch, long n_sites, const void* ii,
                                     const void* jj, long n_pairs, long mc, void* ints,
                                     void* sums, void* stream) {
    if (n_pairs <= 0) return 0;
    const long blocks = (n_pairs + THREADS - 1) / THREADS;
    pair_block_stats_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(A), static_cast<const int32_t*>(B),
        static_cast<const double*>(S), pitch, n_sites, static_cast<const int32_t*>(ii),
        static_cast<const int32_t*>(jj), n_pairs, mc, static_cast<int32_t*>(ints),
        static_cast<double*>(sums));
    return static_cast<int>(cudaGetLastError());
}
