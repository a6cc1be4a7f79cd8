// Shared helpers of the count-path kernels (window_hash.cu, probe_count.cu).
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

// Blocks for a grid-stride loop over n items: enough to fill every SM
// several times over, never more than the items need.
inline unsigned int ntsm_grid(long n, int threads) {
    long blocks = (n + threads - 1) / threads;
    const long cap = 132L * 32;  // H100 SMs x resident 256-thread blocks, with slack
    if (blocks > cap) blocks = cap;
    return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}
