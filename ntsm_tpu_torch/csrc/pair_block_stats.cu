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
// pair_stats.cu (-a) calls, applied to each pair's sites in ascending order
// by one thread: joint and ss are the exact engine's bit for bit
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
// What bounds it on the H100: instruction issue and one thread's serial
// pass over the sites, not bytes.  The earlier design, one thread a pair
// with both rows staged for that pair alone, ran phase 9's list (50,037
// pairs, 1,024 x 96,287) no faster when every j was drawn from 32 rows
// (perfect reuse of the j rows: 63.1 against 48.3 ms), nor with chunks of
// 16 or 32 sites in place of 8: its 391 blocks fit in one wave, and each
// spent ~4 us a chunk of 8 sites on loads, four int->f64 conversions, the
// site codes and the tallies around the shared step.  So the design cuts
// the instructions a pair-site, as pair_stats.cu's tiles do: a value
// staged and converted once serves many pairs.  Measured (NVIDIA H100
// 80GB HBM3, 700 W; experiments/exp_pair_block_stats.py, chip_smoke.py):
// the tile instance costs ~208 ns a slot at 96,287 sites once its grid
// spans several waves (K3's 1x1 pace: 2,006 tiles of the N = 3202 list,
// 115 ms), and one block's serial time, ~14 ms, when it fills less than
// one; the sparse instance ~750 ns a pair over several waves, and ~18-20
// ms for one wave of blocks, which a thread spends in series on its
// chunks' copies (about half) and the per-site step.
//
// Two instances; the wrapper (eval/pair_kernel.py:pair_block_stats) plans
// the list on the host (pair_kernel.plan_pair_blocks) and launches each
// instance that has work:
// - tiles: the list's pairs gathered into 16 x 16 tiles of (row samples)
//   x (column samples), each a list of sample indices, so rows whose j sets
//   overlap form one tile wherever they lie in the cohort.  One block of
//   16 x 16 threads a tile runs pair_site.cuh's tile loop (the one
//   pair_stats.cu runs) on the gathered rows: f64 counts, s_single and
//   ballot-made bit planes staged once a sample-site for 32 sites, popcount
//   tallies, one pair a thread.  A slot of the tile that the list does not
//   hold costs arithmetic but no bytes, and a warp whose slots are all
//   empty skips it; the tile's output-index table (-1: not listed) stays in
//   global memory until the epilogue;
// - sparse: the pairs of tiles below the plan's density threshold, one
//   thread a pair, 128 a block, sorted by i.  The block stages each distinct
//   i row of its pairs once and each pair's j row for that pair, raw, in
//   chunks of 16 sites, through a ring of three shared-memory stages that
//   asynchronous copies (cp.async) fill while the block computes the chunk
//   before: without the ring, a block of the earlier design waited for its
//   loads on every chunk.  Then each thread runs the per-site step
//   (pair_site.cuh:ntsm_pair_site) from shared memory.
// A pair listed more than once is computed once; the wrapper copies its
// results to the other indices.

#include <cstdint>

#include <cuda_runtime.h>

#include "pair_site.cuh"

namespace {

// ---------------------------------------------------------------- tiles

// One tile a block: rows[t * TI + e] and cols[t * TJ + c] are its samples
// (-1: none), outs[(t * TI + r) * TJ + c] the output index of pair (row r,
// column c), -1 where the list does not hold it.
template <int RI, int RJ, int UNROLL, int MINB>
__global__ void __launch_bounds__(NTSM_TILE_THREADS, MINB)
pair_tiles_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                  const double* __restrict__ S, long pitch, long n_sites, long mc,
                  const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ outs, int32_t* __restrict__ ints,
                  double* __restrict__ sums, long n_pairs) {
    constexpr int TI = NTSM_TY * RI, TJ = NTSM_TX * RJ;
    extern __shared__ __align__(16) unsigned char smem[];
    PairStage<TI, TJ>& st = *reinterpret_cast<PairStage<TI, TJ>*>(smem);
    __shared__ int32_t row_s[TI], col_s[TJ];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * NTSM_TX + tx;
    const long t = blockIdx.x;
    for (int e = tid; e < TI; e += NTSM_TILE_THREADS) row_s[e] = rows[t * TI + e];
    for (int c = tid; c < TJ; c += NTSM_TILE_THREADS) col_s[c] = cols[t * TJ + c];
    const int32_t* out = outs + t * TI * TJ;
    bool active = false;
#pragma unroll
    for (int k = 0; k < RI; ++k) {
#pragma unroll
        for (int l = 0; l < RJ; ++l) {
            active |= out[(ty + NTSM_TY * k) * TJ + tx + NTSM_TX * l] >= 0;
        }
    }
    __syncthreads();

    PairTileAcc<RI, RJ> acc;
    ntsm_tile_pairs<RI, RJ, UNROLL>(acc, st, A, B, S, pitch, n_sites, mc, active,
                                    [&](int e) { return row_s[e]; },
                                    [&](int c) { return col_s[c]; });

#pragma unroll
    for (int k = 0; k < RI; ++k) {
#pragma unroll
        for (int l = 0; l < RJ; ++l) {
            const long p = out[(ty + NTSM_TY * k) * TJ + tx + NTSM_TX * l];
            if (p < 0) continue;
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
int launch_tiles(const void* A, const void* B, const void* S, long pitch, long n_sites,
                 long mc, const void* rows, const void* cols, const void* outs, long n_tiles,
                 void* ints, void* sums, long n_pairs, cudaStream_t stream) {
    constexpr int bytes = sizeof(PairStage<NTSM_TY * RI, NTSM_TX * RJ>);
    auto kernel = pair_tiles_kernel<RI, RJ, UNROLL, MINB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned int>(n_tiles), dim3(NTSM_TX, NTSM_TY), bytes, stream>>>(
        static_cast<const int32_t*>(A), static_cast<const int32_t*>(B),
        static_cast<const double*>(S), pitch, n_sites, mc, static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(cols), static_cast<const int32_t*>(outs),
        static_cast<int32_t*>(ints), static_cast<double*>(sums), n_pairs);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- sparse

constexpr int SP_THREADS = 128;  // pairs a block, one a thread
constexpr int SP_SC = 16;        // sites a staged chunk
constexpr int SP_STAGES = 3;     // chunks in flight: a ring of shared-memory stages

// Asynchronous 4- and 8-byte copies from device to shared memory
// (cp.async, sm_80 on): the ring fills while the block computes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of the ring for `rows` staged rows: the raw counts and
// s_single of SP_SC sites a row, [row][SP_SC + 1] (the +1 keeps the compute
// loop's row-per-thread reads free of bank conflicts).
struct SparseStage {
    double* s;
    int32_t* a;
    int32_t* b;
    __device__ __forceinline__ SparseStage(unsigned char* base, int rows) {
        s = reinterpret_cast<double*>(base);
        a = reinterpret_cast<int32_t*>(s + rows * (SP_SC + 1));
        b = a + rows * (SP_SC + 1);
    }
    __host__ __device__ static constexpr long bytes(int rows) {
        return static_cast<long>(rows) * (SP_SC + 1) * 16;
    }
};

// Pair q of the sparse list: its i is irows[blockIdx.x * n_irow + islot[q]]
// (each block's distinct i rows, packed first, then -1), its j jrow[q], its
// output index out[q].  Staged rows: the block's n_i distinct i rows, then
// one j row a pair.
__global__ void __launch_bounds__(SP_THREADS)
pair_sparse_kernel(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                   const double* __restrict__ S, long pitch, long n_sites, long mc,
                   const int32_t* __restrict__ irows, int n_irow,
                   const int32_t* __restrict__ islot, const int32_t* __restrict__ jrow,
                   const int32_t* __restrict__ out, long n_sparse, int32_t* __restrict__ ints,
                   double* __restrict__ sums, long n_pairs) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ long row_off[2 * SP_THREADS];  // element offset of each staged row, -1: none

    const int t = threadIdx.x;
    const int rows = n_irow + SP_THREADS;
    const long q = static_cast<long>(blockIdx.x) * SP_THREADS + t;
    const bool live = q < n_sparse;
    const int32_t gi = t < n_irow ? irows[static_cast<long>(blockIdx.x) * n_irow + t] : -1;
    if (t < n_irow) row_off[t] = gi >= 0 ? static_cast<long>(gi) * pitch : -1;
    row_off[n_irow + t] = live ? static_cast<long>(jrow[q]) * pitch : -1;
    const int si = live ? islot[q] : 0;
    __syncthreads();

    // issue chunk k's copies into its stage (rows without a sample and
    // sites past n_sites are left as they are: no live pair reads them)
    const long n_chunks = (n_sites + SP_SC - 1) / SP_SC;
    auto issue = [&](long k) {
        if (k < n_chunks) {
            const SparseStage st(smem + (k % SP_STAGES) * SparseStage::bytes(rows), rows);
            const long s0 = k * SP_SC;
            for (int e = t; e < rows * SP_SC; e += SP_THREADS) {
                const int r = e / SP_SC, c = e % SP_SC;
                const long o = row_off[r];
                if (o < 0 || s0 + c >= n_sites) continue;
                const int x = r * (SP_SC + 1) + c;
                cp_async4(st.a + x, A + o + s0 + c);
                cp_async4(st.b + x, B + o + s0 + c);
                cp_async8(st.s + x, S + o + s0 + c);
            }
        }
        cp_async_commit();  // an empty group past the end keeps the count
    };
    for (int k = 0; k < SP_STAGES - 1; ++k) issue(k);

    PairAcc acc;
    for (long k = 0; k < n_chunks; ++k) {
        cp_async_wait<SP_STAGES - 2>();  // this thread's copies of chunk k have landed
        __syncthreads();  // everyone's have, and chunk k - 1's stage is free
        issue(k + SP_STAGES - 1);
        if (live) {
            const SparseStage st(smem + (k % SP_STAGES) * SparseStage::bytes(rows), rows);
            const int xi = si * (SP_SC + 1), xj = (n_irow + t) * (SP_SC + 1);
            const int width = static_cast<int>(min(static_cast<long>(SP_SC), n_sites - k * SP_SC));
            for (int c = 0; c < width; ++c) {
                ntsm_pair_site(acc, st.a[xi + c], st.b[xi + c], st.s[xi + c], st.a[xj + c],
                               st.b[xj + c], st.s[xj + c], mc);
            }
        }
    }
    cp_async_wait<0>();

    if (!live) return;
    const long p = out[q];
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
// plane; only sites [0, n_sites) are read.  rows [n_tiles, 16] and cols
// [n_tiles, 16] i32: each tile's samples in [0, N), -1 for none; outs
// [n_tiles, 16, 16] i32: each slot's index in [0, n_pairs), -1 where no pair
// is listed, no index twice.  ints [5, n_pairs] and sums [2, n_pairs] are
// written at those indices.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int ntsm_pair_block_tiles(const void* A, const void* B, const void* S, long pitch,
                                     long n_sites, long mc, const void* rows, const void* cols,
                                     const void* outs, long n_tiles, void* ints, void* sums,
                                     long n_pairs, void* stream) {
    if (n_tiles <= 0) return 0;
    return launch_tiles<1, 1, 16, 1>(A, B, S, pitch, n_sites, mc, rows, cols, outs, n_tiles,
                                     ints, sums, n_pairs, static_cast<cudaStream_t>(stream));
}

// The sparse instance on the same planes: irows [ceil(n_sparse / 128),
// n_irow] i32, each block's distinct i samples packed first, then -1
// (1 <= n_irow <= 128); islot, jrow, out [n_sparse] i32: each pair's slot in
// its block's irows, its j sample, its output index (no index twice).
// Launches on `stream`, returns cudaGetLastError().
extern "C" int ntsm_pair_block_sparse(const void* A, const void* B, const void* S, long pitch,
                                      long n_sites, long mc, const void* irows, int n_irow,
                                      const void* islot, const void* jrow, const void* out,
                                      long n_sparse, void* ints, void* sums, long n_pairs,
                                      void* stream) {
    if (n_sparse <= 0) return 0;
    if (n_irow < 1 || n_irow > SP_THREADS) return static_cast<int>(cudaErrorInvalidValue);
    const long bytes = SP_STAGES * SparseStage::bytes(n_irow + SP_THREADS);
    cudaError_t err = cudaFuncSetAttribute(
        pair_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long blocks = (n_sparse + SP_THREADS - 1) / SP_THREADS;
    pair_sparse_kernel<<<static_cast<unsigned int>(blocks), SP_THREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(A), static_cast<const int32_t*>(B),
        static_cast<const double*>(S), pitch, n_sites, mc, static_cast<const int32_t*>(irows),
        n_irow, static_cast<const int32_t*>(islot), static_cast<const int32_t*>(jrow),
        static_cast<const int32_t*>(out), n_sparse, static_cast<int32_t*>(ints),
        static_cast<double*>(sums), n_pairs);
    return static_cast<int>(cudaGetLastError());
}
