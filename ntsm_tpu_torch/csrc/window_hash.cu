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
// No engine launches either: the v3 engine runs the fused count step
// (hash_probe_count.cu), the v1 engine the fused v1 count step
// (hash_bucket_count.cu), which share these kernels' window stage
// (window_stage.cuh).  K1 and K2 stay for the stage's tests and
// chip_smoke.py / experiments/exp_count_kernels.py.
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
// 3.35 TB/s moves in 21-24 us.  Rebuilding each window from its k bases
// (~20 integer instructions a base), K1 took 0.265 ms a batch, and without
// its stores the same, and K2 0.138 ms (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): instruction issue bound them.  Both now stage each row once in
// shared memory (window_stage.cuh: one warp a piece of up to 2,080 bases,
// decoded into linear forward, reverse-complement and validity words) and
// take each window from three words; lane t writes window t of its warp's
// piece, so the stores are coalesced.  K2 stages whole rows (no clip to the
// read), so its h at an invalid window is the hash of the row's codes & 3
// there, as the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_stage.cuh"

namespace {

// One warp a piece of a row, staged once; lane t takes windows w_begin +
// t, w_begin + t + 32, ...
template <class Batch>
__global__ void stage_hash_kernel(Batch in, int k, int64_t* __restrict__ h_out,
                                  uint8_t* __restrict__ valid_out) {
    extern __shared__ uint64_t stage_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    WindowStage st = WindowStage::at(stage_smem, warp, ntsm_stage_bytes(in.L), in.L);
    const int W = in.L - k + 1;
    const uint64_t mask = ntsm_kmer_mask(k);
    const uint32_t kmask = ntsm_good_mask(k);
    ntsm_stage_rows(st, in, k, lane, static_cast<long>(blockIdx.x) * kStageRows + warp,
                    static_cast<long>(gridDim.x) * kStageRows,
                    [&](long b, int w_begin, int w_end) {
        int64_t* h_row = h_out + b * W;
        uint8_t* v_row = valid_out + b * W;
        for (int w = w_begin + lane; w < w_end; w += 32) {
            h_row[w] = static_cast<int64_t>(st.hash(w, k, mask));
            v_row[w] = static_cast<uint8_t>(st.valid(w, kmask));
        }
    });
}

template <class Batch>
int launch(const Batch& in, int k, void* h_out, void* valid_out, void* stream) {
    const StageLaunch cfg = ntsm_stage_launch(in.B, in.L);
    stage_hash_kernel<<<cfg.grid, kStageRows * 32, cfg.smem,
                        static_cast<cudaStream_t>(stream)>>>(
        in, k, static_cast<int64_t*>(h_out), static_cast<uint8_t*>(valid_out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ntsm_window_hash(const void* packed, long packed_pitch,
                                const void* vbits, long vbits_pitch, int B,
                                int L, int k, void* h_out, void* valid_out,
                                void* stream) {
    return launch(ntsm_packed_batch(packed, packed_pitch, vbits, vbits_pitch, B, L), k,
                  h_out, valid_out, stream);
}

extern "C" int ntsm_window_hash_codes(const void* codes, long pitch,
                                      const void* lengths, int B, int L, int k,
                                      void* h_out, void* valid_out,
                                      void* stream) {
    return launch(ntsm_code_batch(codes, pitch, lengths, B, L, false), k, h_out, valid_out,
                  stream);
}

extern "C" const char* ntsm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
