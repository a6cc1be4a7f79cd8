// The score threshold of eval without -a, on the card: for each pair that
// csrc/pair_stats.cu (a row block of the default all-vs-all) or
// csrc/pair_block_stats.cu (a slice of the -p candidate list) has just
// scored (its ints [5, P] int32 and sums [2, P] f64 on the device), the
// score
//
//   score = n > 0 ? -2(joint - ss) / (cov_i cov_j)^skew / n : DBL_MAX
//
// in the order of operations of the host's finalize (eval/rect.py), and a
// keep rule that can only err towards keeping: a pair is dropped when
// score >= thr_hi, where the caller sets thr_hi a margin above -s.  Every
// operation but pow is rounded to nearest by name (__dsub_rn, __dmul_rn,
// __ddiv_rn), so that no build flag contracts or approximates it; CUDA's pow
// is within 2 ulp of glibc's, which the margin covers.  A NaN score is kept
// (!(NaN >= x)).  So the pairs kept hold every pair the host would print
// without -a; the host scores those again in f64 and its exact test drops
// the rest (eval/pair_kernel.py:score_select).
//
// A pair's (i, j) comes from one of two sources, one instance of the kernel
// each: the i<j triangle from row r0, pair p its p-th in row order (the
// default mode's row block), or the candidate lists ii[p], jj[p] (int32, the
// ones K5 took for the -p slice).
//
// A kept pair goes to compacted records: keep_i [cap, 6] int32 (its index p
// in the block or slice, then n, ibs0, shared_hets, hets1, hets2) and
// keep_f [cap, 2] f64 (joint, ss), at slots taken with one atomic add a
// warp on `count`; the order of the slots is not the order of p.
//
// It replaces no TPU kernel: the JAX engine applies -s on the host, before
// it builds any row column (ntsm_tpu/eval/tpu.py).  What bounds it on the
// H100 is bytes: 36 B a pair read (20 of ints, 16 of sums; 8 more of ii and
// jj from a list), 75 MB for a block of 2M pairs, about 0.022 ms at 3.35
// TB/s, plus 40 B written a kept pair; cov (25 KB at N = 3,202, 256 KB at
// 32,768) stays in L1 and L2, and the f64 work (a pow, two divisions and a
// square root a pair) is far from the f64 peak.  So a thread takes one pair
// a pass, the loads of neighbouring threads are neighbouring words of each
// plane, and one resident wave walks the block in a grid-stride loop that
// stays uniform within a warp, so that the ballot of each pass sees all 32
// lanes.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Pairs of the i<j triangle of n_samples rows in the rows before row i.
__device__ __forceinline__ long long rows_before(long long i, long long n_samples) {
    return i * (2 * n_samples - i - 1) / 2;
}

// The row of the triangle's pair g (pairs numbered row by row): the root of
// rows_before(i) = g in f64, then set right in integers (the f64 root is off
// by at most a few rows for n_samples near 2^31, by none at cohort sizes).
__device__ __forceinline__ long long row_of(long long g, long long n_samples) {
    const double d = 2.0 * static_cast<double>(n_samples) - 1.0;
    const double disc = fmax(d * d - 8.0 * static_cast<double>(g), 0.0);
    long long i = static_cast<long long>((d - sqrt(disc)) * 0.5);
    if (i < 0) i = 0;
    if (i > n_samples - 2) i = n_samples - 2;
    while (i + 1 <= n_samples - 2 && rows_before(i + 1, n_samples) <= g) ++i;
    while (i > 0 && rows_before(i, n_samples) > g) --i;
    return i;
}

// kList: i and j from ii[p], jj[p]; else from the triangle from row r0
template <bool kList>
__global__ void __launch_bounds__(kThreads)
    score_select_kernel(const int* __restrict__ ints, const double* __restrict__ sums, long P,
                        const double* __restrict__ cov, long n_samples, long r0,
                        const int* __restrict__ ii, const int* __restrict__ jj, double skew,
                        double thr_hi, int* __restrict__ keep_i, double* __restrict__ keep_f,
                        unsigned int* __restrict__ count) {
    const long long g0 = kList ? 0 : rows_before(r0, n_samples);
    const long stride = static_cast<long>(gridDim.x) * blockDim.x;
    const int lane = threadIdx.x & 31;
    // base is the same for every thread of a block, so every lane of a warp
    // takes every pass and reaches every ballot
    for (long base = static_cast<long>(blockIdx.x) * blockDim.x; base < P; base += stride) {
        const long p = base + threadIdx.x;
        bool keep = false;
        int v[5];
        double joint = 0.0, ss = 0.0;
        if (p < P) {
#pragma unroll
            for (int k = 0; k < 5; ++k) v[k] = __ldg(ints + k * P + p);
            joint = __ldg(sums + p);
            ss = __ldg(sums + P + p);
            long long i, j;
            if constexpr (kList) {
                i = __ldg(ii + p);
                j = __ldg(jj + p);
            } else {
                const long long g = g0 + p;
                i = row_of(g, n_samples);
                j = i + 1 + (g - rows_before(i, n_samples));
            }
            const int n = v[0];
            double score = DBL_MAX;
            if (n > 0) {
                const double loglik = __dmul_rn(-2.0, __dsub_rn(joint, ss));
                const double skewed = pow(__dmul_rn(__ldg(cov + i), __ldg(cov + j)), skew);
                score = __ddiv_rn(__ddiv_rn(loglik, skewed), static_cast<double>(n));
            }
            keep = !(score >= thr_hi);
        }
        const unsigned int mask = __ballot_sync(0xffffffffu, keep);
        if (mask == 0) continue;
        const int leader = __ffs(mask) - 1;
        unsigned int slot = 0;
        if (lane == leader) slot = atomicAdd(count, static_cast<unsigned int>(__popc(mask)));
        slot = __shfl_sync(0xffffffffu, slot, leader);
        if (!keep) continue;
        slot += __popc(mask & ((1u << lane) - 1u));
        int2* out_i = reinterpret_cast<int2*>(keep_i + 6L * slot);  // 24 B a record: 8-B aligned
        out_i[0] = make_int2(static_cast<int>(p), v[0]);
        out_i[1] = make_int2(v[1], v[2]);
        out_i[2] = make_int2(v[3], v[4]);
        reinterpret_cast<double2*>(keep_f)[slot] = make_double2(joint, ss);
    }
}

// Zeroes count and launches one resident wave of the kList instance on
// `stream`; returns cudaGetLastError().
template <bool kList>
int launch(const void* ints, const void* sums, long P, const void* cov, long n_samples, long r0,
           const void* ii, const void* jj, double skew, double thr_hi, void* keep_i,
           void* keep_f, void* count, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cudaMemsetAsync(count, 0, sizeof(unsigned int), st) != cudaSuccess)
        return static_cast<int>(cudaGetLastError());
    if (P <= 0) return static_cast<int>(cudaGetLastError());
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_select_kernel<kList>,
                                                      kThreads, 0) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    long blocks = (P + kThreads - 1) / kThreads;
    const long cap = static_cast<long>(ntsm_sm_count()) * per_sm;
    if (blocks > cap) blocks = cap;
    score_select_kernel<kList><<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
        static_cast<const int*>(ints), static_cast<const double*>(sums), P,
        static_cast<const double*>(cov), n_samples, r0, static_cast<const int*>(ii),
        static_cast<const int*>(jj), skew, thr_hi, static_cast<int*>(keep_i),
        static_cast<double*>(keep_f), static_cast<unsigned int*>(count));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ints [5, P] int32 and sums [2, P] f64 of the row block starting at row r0
// of an n_samples cohort; cov [n_samples] f64; keep_i [P, 6] int32 and
// keep_f [P, 2] f64 out (8-B and 16-B aligned); count: one u32 on the
// device, set to 0 here, then to the records written.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int ntsm_score_select(const void* ints, const void* sums, long P, const void* cov,
                                 long n_samples, long r0, double skew, double thr_hi,
                                 void* keep_i, void* keep_f, void* count, void* stream) {
    return launch<false>(ints, sums, P, cov, n_samples, r0, nullptr, nullptr, skew, thr_hi,
                         keep_i, keep_f, count, stream);
}

// As ntsm_score_select, for the P candidate pairs (ii[p], jj[p]) of a -p
// slice: ii, jj [P] int32 on the device, each in [0, n_samples).
extern "C" int ntsm_score_select_pairs(const void* ints, const void* sums, long P,
                                       const void* cov, long n_samples, const void* ii,
                                       const void* jj, double skew, double thr_hi, void* keep_i,
                                       void* keep_f, void* count, void* stream) {
    return launch<true>(ints, sums, P, cov, n_samples, 0, ii, jj, skew, thr_hi, keep_i, keep_f,
                        count, stream);
}
