// Kernel 1 of `ntsm count`: the canonical k-mer hash and validity of every
// window of a packed read batch.
//
// Replaces the Pallas kernel ntsm_tpu/count/pallas_kernel.py:
// _window_hash_kernel_packed (and its XLA twin count/kernel_v2.py:
// _window_hashes_from).  The TPU kernel emulates uint64 with (hi, lo) uint32
// pairs and rolls whole [tile, L] rows through VMEM; Hopper has native 64-bit
// integer ops, so here one thread owns one window and builds it directly.
//
// Input, per row b (the block layout of kernel_v2.pack_batch):
//   packed[b, j]  holds bases j, j+L/4, j+L/2, j+3L/4 at bit pairs 0/2/4/6,
//                 so base p is at byte p % (L/4), bit pair p / (L/4);
//   vbits[b, j]   bit i is "base j + i*L/8 is a real A/C/G/T inside the read",
//                 so base p is at byte p % (L/8), bit p / (L/8).
// Output: h [B, W] int64 (the uint64 hash's bits) and valid [B, W] bool,
// W = L - k + 1, bit-identical to the plain version
// (ntsm_tpu_torch/count/kernel_v2.py:window_hashes_packed) at every window.
//
// What bounds it on the H100: at the main-path shape (B = 32768, L = 256,
// k = 19; 7.8M windows) it reads 3 MB and writes 70 MB (8 B of hash and
// 1 B of validity per window), which the published 3.35 TB/s moves in
// about 21 us.  It measured 0.315 ms a batch (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md), so memory does not bound it: each thread re-reads
// and re-shifts its own k bases (~20 integer instructions a base, several
// hundred a window with the hash), and instruction issue does.  The design
// accepts that for now: rows are read through L1 (neighbouring threads
// read the same bytes) and the writes are coalesced (thread t writes
// window t).  A rolling form that shares the k-base shift across a row in
// shared memory, and fusing this kernel into the probe so that h never
// reaches HBM, are later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void window_hash_kernel(const uint8_t* __restrict__ packed,
                                   long packed_pitch,
                                   const uint8_t* __restrict__ vbits,
                                   long vbits_pitch, int B, int L, int k,
                                   int64_t* __restrict__ h_out,
                                   uint8_t* __restrict__ valid_out) {
    const int W = L - k + 1;
    const int Q = L / 4, E = L / 8;
    const long total = static_cast<long>(B) * W;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    for (long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         t < total; t += static_cast<long>(gridDim.x) * blockDim.x) {
        const long b = t / W;
        const int w = static_cast<int>(t - b * W);
        const uint8_t* prow = packed + b * packed_pitch;
        const uint8_t* vrow = vbits + b * vbits_pitch;
        // base p = w + j: byte pr at bit pair pq, validity byte vr at bit vq
        int pq = w / Q, pr = w - pq * Q;
        int vq = w / E, vr = w - vq * E;
        uint64_t fw = 0, rv = 0;
        unsigned ok = 1;
        for (int j = 0; j < k; ++j) {
            const uint64_t c = (prow[pr] >> (2 * pq)) & 3u;
            ok &= (vrow[vr] >> vq) & 1u;
            fw = (fw << 2) | c;
            rv |= (3ULL ^ c) << (2 * j);
            if (++pr == Q) { pr = 0; ++pq; }
            if (++vr == E) { vr = 0; ++vq; }
        }
        h_out[t] = static_cast<int64_t>(ntsm_hash64(fw < rv ? fw : rv, mask));
        valid_out[t] = static_cast<uint8_t>(ok);
    }
}

}  // namespace

extern "C" int ntsm_window_hash(const void* packed, long packed_pitch,
                                const void* vbits, long vbits_pitch, int B,
                                int L, int k, void* h_out, void* valid_out,
                                void* stream) {
    const int threads = 256;
    const long total = static_cast<long>(B) * (L - k + 1);
    window_hash_kernel<<<ntsm_grid(total, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), packed_pitch,
        static_cast<const uint8_t*>(vbits), vbits_pitch, B, L, k,
        static_cast<int64_t*>(h_out), static_cast<uint8_t*>(valid_out));
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ntsm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
