// Kernel 2 of `ntsm count`: probe every valid window's hash in the site
// table and count the exact hits.
//
// Replaces ntsm_tpu/count/kernel_v3.py:probe_and_count, the XLA stage that
// gathers fingerprint rows, compacts the candidates with a hierarchical
// top_k (a TPU has no cheap scatter or atomics), verifies them against the
// key plane and scatter-adds into the counts.  Here every window is its own
// thread and every candidate is verified in place, so there is no
// compaction, no candidate budget and no overflow tier.
//
// Table planes (kernel_v3.TableV3): n_buckets rows of 8 slots,
//   fp   [n_buckets, 8] u8   fingerprint, 0 = empty slot
//   keys [n_buckets, 8] i64  the uint64 hash's bits, -1 = empty slot
//   vals [n_buckets, 8] i32  k-mer index (n_kmers = empty slot)
// Per valid window: bucket = h & (n_buckets - 1); q = max((h >> bbits) &
// 0xFF, 1) with a logical shift; the window is a candidate when any byte of
// its bucket's fingerprint row equals q; the first slot whose key equals h
// is a hit, and counts[vals[slot]] += 1.  diag = [n_valid, n_cand, n_hits]
// is summed per block and added atomically.  Integer atomics are
// order-free, so counts and diag are bit-identical to the plain version
// (ntsm_tpu_torch/count/kernel_v3.py:probe_and_count).
//
// What bounds it on the H100: one random 8-byte fingerprint load per valid
// window from a 34 MB plane at the human-scale table (2^22 buckets), i.e.
// one 32-byte sector per window, and the 70 MB read of h and valid.  The
// plane fits the 50 MB L2, so the dependent random load's latency, not
// bandwidth, is the limit; the grid-stride loop keeps ~1M threads, each
// with its own independent load, in flight.  The row is tested with one
// 64-bit SWAR compare instead of 8 byte compares, and only candidates
// (the true hits plus false positives, 0.23% of the valid windows in
// chip_smoke.py's check batch) touch the 268 MB key plane.
// It measured 0.105 ms a batch on a random batch and 0.156 ms a batch
// inside the engine (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  An L2
// access-policy window pinning the fp plane, and fusing kernel 1 so that h
// is never written to HBM (62 MB a batch today), are later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr uint64_t kOnes = 0x0101010101010101ULL;
constexpr uint64_t kHighs = 0x8080808080808080ULL;

__device__ __forceinline__ int warp_sum(int v) {
    return __reduce_add_sync(0xFFFFFFFFu, v);
}

__global__ void probe_count_kernel(const int64_t* __restrict__ h,
                                   const uint8_t* __restrict__ valid, long n,
                                   const uint64_t* __restrict__ fp_rows,
                                   const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ vals,
                                   uint64_t bucket_mask, int bbits,
                                   int32_t* __restrict__ counts,
                                   int32_t* __restrict__ diag) {
    __shared__ int block_diag[3];
    if (threadIdx.x < 3) block_diag[threadIdx.x] = 0;
    __syncthreads();

    int n_valid = 0, n_cand = 0, n_hits = 0;
    for (long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         t < n; t += static_cast<long>(gridDim.x) * blockDim.x) {
        if (!valid[t]) continue;
        ++n_valid;
        const uint64_t hv = static_cast<uint64_t>(h[t]);
        const uint64_t bucket = hv & bucket_mask;
        uint64_t q = (hv >> bbits) & 0xFFu;
        q = q ? q : 1;
        // any byte of the row equal to q <=> some byte of x is zero
        const uint64_t x = fp_rows[bucket] ^ (q * kOnes);
        if (((x - kOnes) & ~x & kHighs) == 0) continue;
        ++n_cand;
        const int64_t* krow = keys + bucket * 8;
        for (int s = 0; s < 8; ++s) {
            if (krow[s] == static_cast<int64_t>(hv)) {
                atomicAdd(&counts[vals[bucket * 8 + s]], 1);
                ++n_hits;
                break;
            }
        }
    }

    n_valid = warp_sum(n_valid);
    n_cand = warp_sum(n_cand);
    n_hits = warp_sum(n_hits);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(&block_diag[0], n_valid);
        atomicAdd(&block_diag[1], n_cand);
        atomicAdd(&block_diag[2], n_hits);
    }
    __syncthreads();
    if (threadIdx.x < 3) atomicAdd(&diag[threadIdx.x], block_diag[threadIdx.x]);
}

}  // namespace

extern "C" int ntsm_probe_count(const void* h, const void* valid, long n,
                                const void* fp, const void* keys,
                                const void* vals, long n_buckets, int bbits,
                                void* counts, void* diag, void* stream) {
    const int threads = 256;
    probe_count_kernel<<<ntsm_grid(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(h), static_cast<const uint8_t*>(valid), n,
        static_cast<const uint64_t*>(fp), static_cast<const int64_t*>(keys),
        static_cast<const int32_t*>(vals),
        static_cast<uint64_t>(n_buckets - 1), bbits,
        static_cast<int32_t*>(counts), static_cast<int32_t*>(diag));
    return static_cast<int>(cudaGetLastError());
}
