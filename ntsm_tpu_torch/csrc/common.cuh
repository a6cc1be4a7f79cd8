// Shared helpers of the port's kernels: the k-mer hash and the site-table
// probe step of the count path (window_hash.cu, probe_count.cu,
// hash_probe_count.cu, hash_bucket_count.cu), and the grid cap every
// grid-stride kernel uses.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// hash64 of the reference (vendor/KseqHashIterator.hpp:129-139), the same
// steps as ntsm_tpu/native/fastx_reader.cpp:ntsm_hash64, in native uint64.
__device__ __forceinline__ uint64_t ntsm_hash64(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

// The current device's SM count, read once a device.
inline int ntsm_sm_count() {
    static int count[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (count[dev] == 0) {
        int n = 0;
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        count[dev] = n > 0 ? n : 132;
    }
    return count[dev];
}

// Blocks for a grid-stride loop over n items: enough to fill every SM
// several times over, never more than the items need.
inline unsigned int ntsm_grid(long n, int threads) {
    long blocks = (n + threads - 1) / threads;
    const long cap = ntsm_sm_count() * 32L;  // SMs x resident 256-thread blocks, with slack
    if (blocks > cap) blocks = cap;
    return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

// ---- the probe step (K4, csrc/probe_count.cu, and the fused count steps,
// csrc/hash_probe_count.cu and csrc/hash_bucket_count.cu) ----
//
// Table planes (count/kernel_v3.TableV3; the v1 table of io/sites.build_lookup
// is the same keys and vals, without fp): n_buckets rows of 8 slots,
//   fp   [n_buckets, 8] u8   fingerprint, 0 = empty slot
//   keys [n_buckets, 8] i64  the uint64 hash's bits, -1 = empty slot
//   vals [n_buckets, 8] i32  k-mer index (n_kmers = empty slot)
// A valid window's hash h: bucket = h & (n_buckets - 1); q = max((h >>
// bbits) & 0xFF, 1) with a logical shift; the window is a candidate when
// any byte of its bucket's fingerprint row equals q; the first slot whose
// key equals h is a hit, and counts[vals[slot]] += 1.  Split in steps so
// that a thread can issue several windows' row loads before it tests any,
// and verify candidates apart from the test.
struct ProbeTable {
    const uint64_t* __restrict__ fp_rows;
    const int64_t* __restrict__ keys;
    const int32_t* __restrict__ vals;
    uint64_t bucket_mask;
    int bbits;
    int32_t* __restrict__ counts;

    __device__ __forceinline__ uint64_t bucket(uint64_t h) const { return h & bucket_mask; }

    __device__ __forceinline__ uint64_t row(uint64_t bucket) const { return fp_rows[bucket]; }

    // h is a candidate: some byte of its fingerprint row equals q.
    __device__ __forceinline__ bool match(uint64_t h, uint64_t row) const {
        constexpr uint64_t kOnes = 0x0101010101010101ULL;
        constexpr uint64_t kHighs = 0x8080808080808080ULL;
        uint64_t q = (h >> bbits) & 0xFFu;
        q = q ? q : 1;
        // any byte of the row equal to q <=> some byte of x is zero
        const uint64_t x = row ^ (q * kOnes);
        return ((x - kOnes) & ~x & kHighs) != 0;
    }

    // Verify candidate h against its bucket's 8 keys (one 64-byte row, four
    // 16-byte loads in flight) and count a hit at the first equal slot.
    __device__ __forceinline__ void verify(uint64_t h, uint64_t bucket, int& n_hits) const {
        const ulonglong2* krow = reinterpret_cast<const ulonglong2*>(keys + bucket * 8);
        const ulonglong2 k01 = krow[0], k23 = krow[1], k45 = krow[2], k67 = krow[3];
        const int s = k01.x == h ? 0 : k01.y == h ? 1 : k23.x == h ? 2 : k23.y == h ? 3
                    : k45.x == h ? 4 : k45.y == h ? 5 : k67.x == h ? 6 : k67.y == h ? 7 : 8;
        if (s < 8) {
            atomicAdd(&counts[vals[bucket * 8 + s]], 1);
            ++n_hits;
        }
    }

    // The whole step for one valid window; n_cand and n_hits advance.
    __device__ __forceinline__ void count(uint64_t h, uint64_t bucket, uint64_t row,
                                          int& n_cand, int& n_hits) const {
        if (!match(h, row)) return;
        ++n_cand;
        verify(h, bucket, n_hits);
    }
};

// Verify a warp's n queued candidate hashes, one a lane (the fused count
// steps' queues in shared memory).
__device__ __forceinline__ void ntsm_verify_queue(const ProbeTable& table, const uint64_t* queue,
                                                  int n, int lane, int& n_hits) {
    __syncwarp();  // every lane's pushes are in
    for (int i = lane; i < n; i += 32) {
        const uint64_t h = queue[i];
        table.verify(h, table.bucket(h), n_hits);
    }
    __syncwarp();  // every lane has read its entries
}

// *d0 += the block's sum of v0, *d1 of v1, *d2 of v2: a warp sum, one
// shared atomic a warp, one global atomic a block.  Every thread of the
// block calls it once, at the end.  Integer sums (wrapping as int32), so
// order-free.
__device__ __forceinline__ void ntsm_block_add(int32_t* d0, int32_t* d1, int32_t* d2, int v0,
                                               int v1, int v2) {
    __shared__ int block_sum[3];
    if (threadIdx.x < 3) block_sum[threadIdx.x] = 0;
    __syncthreads();
    v0 = __reduce_add_sync(0xFFFFFFFFu, v0);
    v1 = __reduce_add_sync(0xFFFFFFFFu, v1);
    v2 = __reduce_add_sync(0xFFFFFFFFu, v2);
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(&block_sum[0], v0);
        atomicAdd(&block_sum[1], v1);
        atomicAdd(&block_sum[2], v2);
    }
    __syncthreads();
    if (threadIdx.x < 3) atomicAdd(threadIdx.x == 0 ? d0 : threadIdx.x == 1 ? d1 : d2,
                                   block_sum[threadIdx.x]);
}

// diag[0..2] += the block's (n_valid, n_cand, n_hits).
__device__ __forceinline__ void ntsm_diag_add(int32_t* diag, int n_valid, int n_cand,
                                              int n_hits) {
    ntsm_block_add(diag, diag + 1, diag + 2, n_valid, n_cand, n_hits);
}
