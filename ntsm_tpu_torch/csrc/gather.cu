// The gather experiments P1 and P2: four gather forms from a table that
// fits in the H100's 50 MB L2.
//
// Replaces the Pallas kernels of scripts/exp_pallas_gather.py (P1: kernel,
// a 1-D gather tbl[idx]; kernel2, take_along_axis(axis=0)) and
// scripts/exp_pallas_gather2.py (P2: try_kernel's bodies kA/kB, axis 0;
// kC, axis 1; kD, a row gather t[idx1d]).  Those asked which gathers Mosaic
// lowers from a VMEM table; here each entry point is the function the Pallas
// body computes, written the way Hopper gathers:
//
//   ntsm_gather_1d     out[i]    = tbl[idx[i]]            one thread an index
//   ntsm_take_axis0    out[r, c] = tbl[idx[r, c], c]      one thread an element
//   ntsm_take_axis1    out[r, m] = tbl[r, idx[r, m]]      rows staged in smem
//   ntsm_row_gather    out[r, :] = tbl[idx[r], :]         one warp a row, 16 B
//
// Values are 32-bit (u32 carried as int32 bit patterns).  An index out of
// range is the caller's fault, as on the TPU: the wrappers
// (ntsm_tpu_torch/experiments/gather.py) check dtypes, shapes, contiguity
// and device only.
//
// What bounds them on the H100: the bytes of the indices and the output
// (each 4 B an element) and the table elements the indices touch, at
// 3.35 TB/s.  The experiments' tables (2-4 MB) stay in L2 after the first
// touch, so a random 4-B gather costs one 32-B L2 sector and the rate is
// bounded by L2 sector throughput and latency rather than by HBM; the
// kernels keep many independent loads in flight (grid-stride loops over
// every element, read-only loads through the texture path) and write
// coalesced.  take_axis1 stages a block's rows (512 B each at the scripts'
// width) in shared memory, the Hopper form of the TPU's lane gather within a
// vreg, so its random reads never leave the SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAxis1Rows = 8;  // rows of tbl a take_axis1 block stages

__global__ void gather_1d_kernel(const int* __restrict__ tbl,
                                 const int* __restrict__ idx, long n,
                                 int* __restrict__ out) {
    for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         i < n; i += static_cast<long>(gridDim.x) * blockDim.x)
        out[i] = __ldg(tbl + __ldg(idx + i));
}

__global__ void take_axis0_kernel(const int* __restrict__ tbl, int C,
                                  const int* __restrict__ idx, long n,
                                  int* __restrict__ out) {
    for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         i < n; i += static_cast<long>(gridDim.x) * blockDim.x) {
        const int c = static_cast<int>(i % C);
        out[i] = __ldg(tbl + static_cast<long>(__ldg(idx + i)) * C + c);
    }
}

// A block owns kAxis1Rows rows at a time: it copies those rows of tbl
// ([R, C]) into shared memory, then each thread gathers its elements of
// out ([R, M]) from there.  Dynamic shared memory: kAxis1Rows * C ints.
__global__ void take_axis1_kernel(const int* __restrict__ tbl, int C,
                                  const int* __restrict__ idx, int R, int M,
                                  int* __restrict__ out) {
    extern __shared__ int rows[];
    for (long r0 = static_cast<long>(blockIdx.x) * kAxis1Rows; r0 < R;
         r0 += static_cast<long>(gridDim.x) * kAxis1Rows) {
        const int nr = static_cast<int>(R - r0 < kAxis1Rows ? R - r0 : kAxis1Rows);
        for (int e = threadIdx.x; e < nr * C; e += blockDim.x)
            rows[e] = __ldg(tbl + r0 * C + e);
        __syncthreads();
        const int* irow = idx + r0 * M;
        int* orow = out + r0 * M;
        for (int e = threadIdx.x; e < nr * M; e += blockDim.x)
            orow[e] = rows[(e / M) * C + __ldg(irow + e)];
        __syncthreads();  // the rows are overwritten by the next group
    }
}

// One warp a row: lane l copies 16-B words l, l + 32, ... of row idx[r].
// C is a multiple of 4 and both tables are 16-B aligned (the wrapper checks).
__global__ void row_gather_kernel(const int4* __restrict__ tbl, int C4,
                                  const int* __restrict__ idx, int R,
                                  int4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long warps = static_cast<long>(gridDim.x) * (blockDim.x / 32);
    for (long r = (blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x) / 32;
         r < R; r += warps) {
        const int4* src = tbl + static_cast<long>(__ldg(idx + r)) * C4;
        int4* dst = out + r * C4;
        for (int c = lane; c < C4; c += 32) dst[c] = __ldg(src + c);
    }
}

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" int ntsm_gather_1d(const void* tbl, const void* idx, long n,
                              void* out, void* stream) {
    gather_1d_kernel<<<ntsm_grid(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tbl), static_cast<const int*>(idx), n,
        static_cast<int*>(out));
    return done();
}

extern "C" int ntsm_take_axis0(const void* tbl, int C, const void* idx, long n,
                               void* out, void* stream) {
    take_axis0_kernel<<<ntsm_grid(n, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tbl), C, static_cast<const int*>(idx), n,
        static_cast<int*>(out));
    return done();
}

extern "C" int ntsm_take_axis1(const void* tbl, int C, const void* idx, int R,
                               int M, void* out, void* stream) {
    const long groups = (static_cast<long>(R) + kAxis1Rows - 1) / kAxis1Rows;
    const size_t smem = static_cast<size_t>(kAxis1Rows) * C * sizeof(int);
    take_axis1_kernel<<<ntsm_grid(groups * kThreads, kThreads), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tbl), C, static_cast<const int*>(idx), R, M,
        static_cast<int*>(out));
    return done();
}

extern "C" int ntsm_row_gather(const void* tbl, int C, const void* idx, int R,
                               void* out, void* stream) {
    row_gather_kernel<<<ntsm_grid(static_cast<long>(R) * 32, kThreads), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(tbl), C / 4, static_cast<const int*>(idx), R,
        static_cast<int4*>(out));
    return done();
}
