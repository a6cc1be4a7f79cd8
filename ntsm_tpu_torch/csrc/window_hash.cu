// The window hash of `ntsm count`: the canonical k-mer hash and validity of
// every window of a read batch, from two input layouts.
//
//   K1, ntsm_window_hash: a 2-bit packed batch (the v3 engine's upload).
//       Replaces the Pallas kernel ntsm_tpu/count/pallas_kernel.py:
//       _window_hash_kernel_packed (and its XLA twin count/kernel_v2.py:
//       _window_hashes_from).
//   K2, ntsm_window_hash_codes: unpacked u8 codes plus row lengths (the v1
//       engine's upload).  Replaces the Pallas kernel
//       ntsm_tpu/count/pallas_kernel.py:_window_hash_kernel (and its XLA
//       twin count/kernel.py:window_hashes).
//
// The TPU kernels emulate uint64 with (hi, lo) uint32 pairs and roll whole
// [tile, L] rows through VMEM; Hopper has native 64-bit integer ops, so here
// one thread owns one window and builds it directly.  Both entry points run
// the same per-window loop (window_hash_kernel below), templated over how a
// base is fetched, so the two layouts cannot drift apart.
//
// K1 input, per row b (the block layout of kernel_v2.pack_batch):
//   packed[b, j]  holds bases j, j+L/4, j+L/2, j+3L/4 at bit pairs 0/2/4/6,
//                 so base p is at byte p % (L/4), bit pair p / (L/4);
//   vbits[b, j]   bit i is "base j + i*L/8 is a real A/C/G/T inside the read",
//                 so base p is at byte p % (L/8), bit p / (L/8).
// K2 input: codes[b, p] u8 (0..3 a base, > 3 not one) and lengths[b] int32;
//   base p of row b is bad when codes[b, p] > 3 or p >= lengths[b] (pad rows
//   of a short last batch have length 0, so all their windows are invalid).
// Output: h [B, W] int64 (the uint64 hash's bits) and valid [B, W] bool,
// W = L - k + 1, bit-identical to the plain versions
// (ntsm_tpu_torch/count/kernel_v2.py:window_hashes_packed,
// ntsm_tpu_torch/count/kernel.py:window_hashes_codes_plain) at every window.
//
// What bounds them on the H100: at the main-path shape (B = 32768, L = 256,
// k = 19; 7.8M windows) K1 reads 3 MB and K2 8.5 MB, and both write 70 MB
// (8 B of hash and 1 B of validity per window), which the published
// 3.35 TB/s moves in 21-24 us.  K1 measured 0.315 ms a batch (NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md), so memory does not bound it: each thread
// re-reads and re-shifts its own k bases (~20 integer instructions a base,
// several hundred a window with the hash), and instruction issue does.  The
// design accepts that for now: rows are read through L1 (neighbouring
// threads read the same or neighbouring bytes) and the writes are coalesced
// (thread t writes window t).  A rolling form that shares the k-base shift
// across a row in shared memory, and fusing this kernel into the probe so
// that h never reaches HBM, are later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// K1's base fetch: two cursors walk the packed bases and the validity bits.
struct PackedRows {
    const uint8_t* packed;
    long packed_pitch;
    const uint8_t* vbits;
    long vbits_pitch;
    int Q, E;  // L/4 and L/8

    struct Cursor {
        const uint8_t* prow;
        const uint8_t* vrow;
        int Q, E, pq, pr, vq, vr;

        __device__ __forceinline__ void next(uint64_t& c, unsigned& good) {
            c = (prow[pr] >> (2 * pq)) & 3u;
            good = (vrow[vr] >> vq) & 1u;
            if (++pr == Q) { pr = 0; ++pq; }
            if (++vr == E) { vr = 0; ++vq; }
        }
    };

    __device__ __forceinline__ Cursor at(long b, int w) const {
        // base w: byte pr at bit pair pq, validity byte vr at bit vq
        const int pq = w / Q, vq = w / E;
        return Cursor{packed + b * packed_pitch, vbits + b * vbits_pitch,
                      Q, E, pq, w - pq * Q, vq, w - vq * E};
    }
};

// K2's base fetch: one code byte a base; the read ends at its row's length.
struct CodeRows {
    const uint8_t* codes;
    long pitch;
    const int* lengths;

    struct Cursor {
        const uint8_t* p;
        int left;  // bases of the read from this one on

        __device__ __forceinline__ void next(uint64_t& c, unsigned& good) {
            const unsigned v = *p++;
            c = v & 3u;
            good = static_cast<unsigned>(v <= 3u && left > 0);
            --left;
        }
    };

    __device__ __forceinline__ Cursor at(long b, int w) const {
        return Cursor{codes + b * pitch + w, lengths[b] - w};
    }
};

template <class Rows>
__global__ void window_hash_kernel(Rows rows, int B, int L, int k,
                                   int64_t* __restrict__ h_out,
                                   uint8_t* __restrict__ valid_out) {
    const int W = L - k + 1;
    const long total = static_cast<long>(B) * W;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    for (long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         t < total; t += static_cast<long>(gridDim.x) * blockDim.x) {
        const long b = t / W;
        const int w = static_cast<int>(t - b * W);
        auto cur = rows.at(b, w);
        uint64_t fw = 0, rv = 0;
        unsigned ok = 1;
        for (int j = 0; j < k; ++j) {
            uint64_t c;
            unsigned good;
            cur.next(c, good);
            ok &= good;
            fw = (fw << 2) | c;
            rv |= (3ULL ^ c) << (2 * j);
        }
        h_out[t] = static_cast<int64_t>(ntsm_hash64(fw < rv ? fw : rv, mask));
        valid_out[t] = static_cast<uint8_t>(ok);
    }
}

template <class Rows>
int launch(const Rows& rows, int B, int L, int k, void* h_out, void* valid_out,
           void* stream) {
    const int threads = 256;
    const long total = static_cast<long>(B) * (L - k + 1);
    window_hash_kernel<<<ntsm_grid(total, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        rows, B, L, k, static_cast<int64_t*>(h_out),
        static_cast<uint8_t*>(valid_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ntsm_window_hash(const void* packed, long packed_pitch,
                                const void* vbits, long vbits_pitch, int B,
                                int L, int k, void* h_out, void* valid_out,
                                void* stream) {
    const PackedRows rows{static_cast<const uint8_t*>(packed), packed_pitch,
                          static_cast<const uint8_t*>(vbits), vbits_pitch,
                          L / 4, L / 8};
    return launch(rows, B, L, k, h_out, valid_out, stream);
}

extern "C" int ntsm_window_hash_codes(const void* codes, long pitch,
                                      const void* lengths, int B, int L, int k,
                                      void* h_out, void* valid_out,
                                      void* stream) {
    const CodeRows rows{static_cast<const uint8_t*>(codes), pitch,
                        static_cast<const int*>(lengths)};
    return launch(rows, B, L, k, h_out, valid_out, stream);
}

extern "C" const char* ntsm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
