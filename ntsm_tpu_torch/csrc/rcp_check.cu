// A test entry point, on no path of the port: is pair_site.cuh's ntsm_rcp
// bit-equal to __drcp_rn on every integer d in [1, 2^33), the whole domain
// of the pair kernels' den (a sum of four int32 counts)?  Integers past
// 2^32 add the 33-bit significands; below 2^33 nothing is subnormal, so
// the check covers every den the kernels can see.

#include <cuda_runtime.h>

#include "pair_site.cuh"

namespace {

constexpr unsigned long long RCP_END = 1ull << 33;

// Counts the mismatches into *bad and keeps the smallest in *first.
__global__ void rcp_check_kernel(unsigned long long* bad, unsigned long long* first) {
    const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
    for (unsigned long long d = blockIdx.x * blockDim.x + threadIdx.x + 1; d < RCP_END;
         d += stride) {
        const double x = static_cast<double>(d);
        if (__double_as_longlong(ntsm_rcp(x)) != __double_as_longlong(__drcp_rn(x))) {
            atomicAdd(bad, 1ull);
            atomicMin(first, d);
        }
    }
}

}  // namespace

// bad, first: one u64 each on the card (bad preset to 0, first to ~0);
// launches on `stream`, returns cudaGetLastError().
extern "C" int ntsm_rcp_check(void* bad, void* first, void* stream) {
    rcp_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(bad), static_cast<unsigned long long*>(first));
    return static_cast<int>(cudaGetLastError());
}
