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
// A site is valid for a pair when both samples have an allele count above
// min_cov (calcHomHetMiss, src/CompareCounts.hpp:742-768); the per-site f64
// arithmetic is that of the exact engine (ntsm_tpu/native/exact_pairs.cpp:
// sums_pair, eval/exact.py:joint_sum), written with round-to-nearest
// intrinsics so that nvcc contracts nothing into an FMA, and the sites are
// summed in ascending order as that loop sums them.  So joint and ss are
// the exact engine's bit for bit when its library is built without FMA
// (ntsm_tpu_torch/native builds it with -ffp-contract=off),
// and the printed scores agree byte for byte.
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
// Design: one 16 x 16 block per tile of pairs, one thread per pair; tiles
// wholly on or below the diagonal return at once.  A loop over site chunks
// stages the tile's 16 rows and 16 columns of A, B (i32) and S (f64, the
// per-sample s_single plane, eval/model.py:CountData.s_single) in shared
// memory; the int32 tallies and the two f64 sums live in registers.
//
// What bounds it on the H100: f64 arithmetic, with up to two IEEE f64
// divisions per valid pair-site (aa/den and bb/den); a division is a
// software sequence of several f64 operations.  At the N = 3202 cohort over
// 96,287 sites that is about 4.9e11 pair-sites.  Each pair-site reads only
// shared memory (six values, the row ones broadcast), and each staged chunk
// serves 256 pairs, so device memory is not the limit.  Register blocking
// (several pairs a thread), a packed-bit tally path and tensor-core tallies
// are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TI = 16;  // rows (i) per tile = blockDim.y
constexpr int TJ = 16;  // columns (j) per tile = blockDim.x
constexpr int SC = 64;  // sites per staged chunk
constexpr int THREADS = TI * TJ;

__global__ void __launch_bounds__(THREADS)
pair_stats_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                  const double* __restrict__ S, long pitch, int n_samples,
                  long n_sites, int r0, int r1, long mc,
                  int32_t* __restrict__ ints, double* __restrict__ sums,
                  long n_pairs) {
    // +1 pads break the power-of-two strides that would conflict on banks
    __shared__ int32_t a_i[TI][SC + 1], b_i[TI][SC + 1];
    __shared__ double s_i[TI][SC + 1];
    __shared__ int32_t a_j[SC][TJ + 1], b_j[SC][TJ + 1];
    __shared__ double s_j[SC][TJ + 1];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TJ + tx;
    const int i0 = r0 + blockIdx.y * TI;
    const int j0 = blockIdx.x * TJ;
    const int i_end = min(i0 + TI, r1);
    const int j_end = min(j0 + TJ, n_samples);
    // no pair j > i in this tile: every j is at most the smallest i
    if (j_end - 1 <= i0) return;

    const int i = i0 + ty, j = j0 + tx;
    int n = 0, ibs0 = 0, shet = 0, h1 = 0, h2 = 0;
    double joint = 0.0, ss = 0.0;

    for (long s0 = 0; s0 < n_sites; s0 += SC) {
        const int width = static_cast<int>(min(static_cast<long>(SC), n_sites - s0));
        // stage: element e of a TI x SC (or TJ x SC) slab is (row e / SC,
        // site e % SC), so neighbouring threads read neighbouring sites
        for (int e = tid; e < TI * SC; e += THREADS) {
            const int r = e / SC, c = e % SC;
            const int gi = i0 + r, gj = j0 + r;
            const bool live = c < width;
            const long oi = gi * pitch + s0 + c, oj = gj * pitch + s0 + c;
            const bool row_ok = live && gi < i_end, col_ok = live && gj < j_end;
            a_i[r][c] = row_ok ? A[oi] : 0;
            b_i[r][c] = row_ok ? B[oi] : 0;
            s_i[r][c] = row_ok ? S[oi] : 0.0;
            a_j[c][r] = col_ok ? A[oj] : 0;
            b_j[c][r] = col_ok ? B[oj] : 0;
            s_j[c][r] = col_ok ? S[oj] : 0.0;
        }
        __syncthreads();

        for (int c = 0; c < width; ++c) {
            const int ai = a_i[ty][c], bi = b_i[ty][c];
            const int aj = a_j[c][tx], bj = b_j[c][tx];
            // genotype code: bit 0 = AT above min_cov, bit 1 = CG above;
            // 3 = het, 1 = hom AT, 2 = hom CG, 0 = missing
            const int ci = (ai > mc) | ((bi > mc) << 1);
            const int cj = (aj > mc) | ((bj > mc) << 1);
            if (ci == 0 || cj == 0) continue;
            ++n;
            ibs0 += (ci ^ cj) == 3;  // opposite homs
            shet += (ci & cj) == 3;
            h1 += ci == 3;
            h2 += cj == 3;
            const long aa = static_cast<long>(ai) + aj;
            const long bb = static_cast<long>(bi) + bj;
            const double aad = static_cast<double>(aa), bbd = static_cast<double>(bb);
            // valid implies den > 0; the exact engine's guard kept as is
            const double den = static_cast<double>(aa + bb);
            const double dsafe = den > 0.0 ? den : 1.0;
            const double fa = aa > mc ? __ddiv_rn(aad, dsafe) : 0.0;
            const double fb = bb > mc ? __ddiv_rn(bbd, dsafe) : 0.0;
            joint = __dadd_rn(joint, __dadd_rn(__dmul_rn(aad, fa), __dmul_rn(bbd, fb)));
            ss = __dadd_rn(ss, __dadd_rn(s_i[ty][c], s_j[c][tx]));
        }
        __syncthreads();
    }

    if (i >= i_end || j >= j_end || j <= i) return;
    // pairs before row i in this block: sum over r in [r0, i) of (N-1-r)
    const long li = i, lr0 = r0, last = n_samples - 1;
    const long p = (li - lr0) * last - (li * (li - 1) / 2 - lr0 * (lr0 - 1) / 2)
                   + (j - i - 1);
    if (p >= n_pairs) return;  // cannot happen for a consistent n_pairs
    ints[p] = n;
    ints[n_pairs + p] = ibs0;
    ints[2 * n_pairs + p] = shet;
    ints[3 * n_pairs + p] = h1;
    ints[4 * n_pairs + p] = h2;
    sums[p] = joint;
    sums[n_pairs + p] = ss;
}

}  // namespace

// A, B: [N, pitch] i32 allele count planes; S: [N, pitch] f64 s_single
// plane; only sites [0, n_sites) are read.  Rows [r0, r1) are scored
// against every column j > i; ints [5, n_pairs] and sums [2, n_pairs] are
// written in np.triu_indices order.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int ntsm_pair_stats(const void* A, const void* B, const void* S,
                               long pitch, int n_samples, long n_sites, int r0,
                               int r1, long mc, void* ints, void* sums,
                               long n_pairs, void* stream) {
    if (r1 <= r0 || n_pairs <= 0) return 0;
    const dim3 block(TJ, TI);
    const dim3 grid((n_samples + TJ - 1) / TJ, (r1 - r0 + TI - 1) / TI);
    pair_stats_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(A), static_cast<const int32_t*>(B),
        static_cast<const double*>(S), pitch, n_samples, n_sites, r0, r1, mc,
        static_cast<int32_t*>(ints), static_cast<double*>(sums), n_pairs);
    return static_cast<int>(cudaGetLastError());
}
