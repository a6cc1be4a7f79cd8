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
// Design (wrapper: eval/pair_kernel.py:pair_stats):
// - a block of 16 x 16 threads owns a TI x TJ tile of pairs (TI = 16 RI,
//   TJ = 16 RJ); thread (tx, ty) holds the RI x RJ pairs (i0 + ty + 16k,
//   j0 + tx + 16l) in registers, so a staged value feeds RJ (or RI) pairs
//   and RI RJ independent sums hide the f64 latency;
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

constexpr int TX = 16, TY = 16;  // threads: columns x rows
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;
constexpr int SC = 32;  // sites per staged chunk: one bit-plane word

// Shared memory of a TI x TJ tile: f64 (a, b) pairs and s_single as
// [SC][T + 1] (the +1 keeps the staging stores free of bank conflicts),
// then one uint4 of bit planes a row and a column.
template <int TI, int TJ>
struct Stage {
    double2 ab_i[SC][TI + 1];
    double2 ab_j[SC][TJ + 1];
    double s_i[SC][TI + 1];
    double s_j[SC][TJ + 1];
    uint4 bits_i[TI];  // x valid, y het, z hom AT, w hom CG
    uint4 bits_j[TJ];
};

// Stage sample `g` (live when g < g_end) for sites s0 + lane: one warp a
// sample, lane = site.
__device__ __forceinline__ void stage_sample(const int32_t* __restrict__ A,
                                             const int32_t* __restrict__ B,
                                             const double* __restrict__ S, long pitch,
                                             int g, int g_end, long s0, int width, long mc,
                                             int lane, double2& ab, double& s, uint4& bits) {
    const bool live = g < g_end && lane < width;
    int a = 0, b = 0;
    double sv = 0.0;
    if (live) {
        const long o = static_cast<long>(g) * pitch + s0 + lane;
        a = A[o];
        b = B[o];
        sv = S[o];
    }
    // pad sites and rows past the cohort stay missing for any mc
    const int code = live ? ntsm_site_code(a, b, mc) : 0;
    ab = make_double2(static_cast<double>(a), static_cast<double>(b));
    s = sv;
    const unsigned v = __ballot_sync(0xffffffffu, code != 0);
    const unsigned h = __ballot_sync(0xffffffffu, code == 3);
    const unsigned at = __ballot_sync(0xffffffffu, code == 1);
    const unsigned cg = __ballot_sync(0xffffffffu, code == 2);
    if (lane == 0) bits = make_uint4(v, h, at, cg);
}

// RI x RJ pairs a thread, the site loop unrolled UNROLL deep, at least
// MINB blocks an SM (which caps the registers a thread).
template <int RI, int RJ, int UNROLL, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
pair_stats_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                  const double* __restrict__ S, long pitch, int n_samples,
                  long n_sites, int r0, int r1, long mc, const int32_t* __restrict__ tiles,
                  int32_t* __restrict__ ints, double* __restrict__ sums, long n_pairs) {
    constexpr int TI = TY * RI, TJ = TX * RJ;
    extern __shared__ __align__(16) unsigned char smem[];
    Stage<TI, TJ>& st = *reinterpret_cast<Stage<TI, TJ>*>(smem);

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TX + tx, warp = tid / 32, lane = tid % 32;
    const int i0 = r0 + tiles[2 * blockIdx.x] * TI;
    const int j0 = tiles[2 * blockIdx.x + 1] * TJ;
    const double mc0 = static_cast<double>(mc > 0 ? mc : 0);

    double joint[RI][RJ], ss[RI][RJ];
    int n[RI][RJ], ibs0[RI][RJ], shet[RI][RJ], h1[RI][RJ], h2[RI][RJ];
#pragma unroll
    for (int k = 0; k < RI; ++k) {
#pragma unroll
        for (int l = 0; l < RJ; ++l) {
            joint[k][l] = ss[k][l] = 0.0;
            n[k][l] = ibs0[k][l] = shet[k][l] = h1[k][l] = h2[k][l] = 0;
        }
    }

    for (long s0 = 0; s0 < n_sites; s0 += SC) {
        const int width = static_cast<int>(min(static_cast<long>(SC), n_sites - s0));
#pragma unroll 4
        for (int e = warp; e < TI + TJ; e += WARPS) {
            if (e < TI) {
                stage_sample(A, B, S, pitch, i0 + e, r1, s0, width, mc, lane,
                             st.ab_i[lane][e], st.s_i[lane][e], st.bits_i[e]);
            } else {
                const int c = e - TI;
                stage_sample(A, B, S, pitch, j0 + c, n_samples, s0, width, mc, lane,
                             st.ab_j[lane][c], st.s_j[lane][c], st.bits_j[c]);
            }
        }
        __syncthreads();

        uint4 bi[RI], bj[RJ];
#pragma unroll
        for (int k = 0; k < RI; ++k) bi[k] = st.bits_i[ty + TY * k];
#pragma unroll
        for (int l = 0; l < RJ; ++l) bj[l] = st.bits_j[tx + TX * l];
#pragma unroll
        for (int k = 0; k < RI; ++k) {
#pragma unroll
            for (int l = 0; l < RJ; ++l) {
                n[k][l] += __popc(bi[k].x & bj[l].x);
                shet[k][l] += __popc(bi[k].y & bj[l].y);
                h1[k][l] += __popc(bi[k].y & bj[l].x);
                h2[k][l] += __popc(bi[k].x & bj[l].y);
                ibs0[k][l] += __popc((bi[k].z & bj[l].w) | (bi[k].w & bj[l].z));
            }
        }

#pragma unroll (UNROLL)
        for (int c = 0; c < width; ++c) {
            double2 abi[RI], abj[RJ];
            double si[RI], sj[RJ];
#pragma unroll
            for (int k = 0; k < RI; ++k) {
                abi[k] = st.ab_i[c][ty + TY * k];
                si[k] = st.s_i[c][ty + TY * k];
            }
#pragma unroll
            for (int l = 0; l < RJ; ++l) {
                abj[l] = st.ab_j[c][tx + TX * l];
                sj[l] = st.s_j[c][tx + TX * l];
            }
            const unsigned bit = 1u << c;
#pragma unroll
            for (int k = 0; k < RI; ++k) {
#pragma unroll
                for (int l = 0; l < RJ; ++l) {
                    const bool valid = (bi[k].x & bj[l].x & bit) != 0;
                    ntsm_pair_sums(joint[k][l], ss[k][l], valid, abi[k].x, abi[k].y, si[k],
                                   abj[l].x, abj[l].y, sj[l], mc0);
                }
            }
        }
        __syncthreads();
    }

    const long lr0 = r0, last = n_samples - 1;
#pragma unroll
    for (int k = 0; k < RI; ++k) {
        const int i = i0 + ty + TY * k;
        if (i >= r1) continue;
        // pairs before row i in this block: sum over r in [r0, i) of (N-1-r)
        const long li = i;
        const long row = (li - lr0) * last - (li * (li - 1) / 2 - lr0 * (lr0 - 1) / 2);
#pragma unroll
        for (int l = 0; l < RJ; ++l) {
            const int j = j0 + tx + TX * l;
            if (j >= n_samples || j <= i) continue;
            const long p = row + (j - i - 1);
            if (p >= n_pairs) continue;  // cannot happen for a consistent n_pairs
            ints[p] = n[k][l];
            ints[n_pairs + p] = ibs0[k][l];
            ints[2 * n_pairs + p] = shet[k][l];
            ints[3 * n_pairs + p] = h1[k][l];
            ints[4 * n_pairs + p] = h2[k][l];
            sums[p] = joint[k][l];
            sums[n_pairs + p] = ss[k][l];
        }
    }
}

template <int RI, int RJ, int UNROLL, int MINB>
int launch(const void* A, const void* B, const void* S, long pitch, int n_samples,
           long n_sites, int r0, int r1, long mc, const void* tiles, int n_tiles, void* ints,
           void* sums, long n_pairs, cudaStream_t stream) {
    constexpr int bytes = sizeof(Stage<TY * RI, TX * RJ>);
    auto kernel = pair_stats_kernel<RI, RJ, UNROLL, MINB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_tiles, dim3(TX, TY), bytes, stream>>>(
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
