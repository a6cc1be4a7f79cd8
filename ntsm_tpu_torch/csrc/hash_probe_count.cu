// The fused count step of `ntsm count`: hash every window of a packed read
// batch and probe it in the site table, in one kernel, so that the window
// hashes never reach HBM.
//
// Replaces, as one launch a batch, the Pallas kernel
// ntsm_tpu/count/pallas_kernel.py:_window_hash_kernel_packed and the XLA
// stage ntsm_tpu/count/kernel_v3.py:probe_and_count, which
// ntsm_tpu/count/kernel_v3.py:count_step_v3 ("one fused counting step")
// runs back to back with h in HBM between them.  The port's two kernels
// for them, K1 (window_hash.cu) and K4 (probe_count.cu), write and read
// back 70 MB of h and valid a 32768 x 256 batch.
//
// Each warp stages a piece of a row, up to 2,080 bases, in shared memory
// (window_stage.cuh, K1's stage) and takes its windows from there.  Each lane tests a window's validity first and hashes only a valid
// one; it hashes kWindows windows and issues their fingerprint-row loads
// before it tests any (independent loads in flight).  A candidate's hash
// goes to its warp's queue in shared memory; when the queue may not hold
// another round of windows, and at the end, the warp verifies the queued
// candidates with every lane, one each (common.cuh, ProbeTable::verify,
// K4's: the bucket's 8 keys in four 16-byte loads, first matching slot,
// atomicAdd into counts).  Candidates of many rows thus share one round
// trip to the key plane, where verifying each lane's own candidates one
// after another cost a key row and a value load in series for every
// candidate of the warp.  No candidate budget, as in K4.  diag =
// [n_valid, n_cand, n_hits] is summed per block and added atomically;
// integer atomics are order-free, so counts and diag are bit-identical to
// the plain version (count/kernel_v3.py: window_hashes_packed then
// probe_and_count).
//
// What bounds it on the H100: the bytes it must move are the 3.1 MB upload,
// the 33.5 MB fingerprint plane once (2^22 buckets at the human-scale
// table), the key and value rows of each candidate and a count
// read-modify-write a hit, about 0.02 ms at 3.35 TB/s.  The plane fits the
// 50 MB L2, so the pace is set by the random 32-byte sector a valid window
// fetches from L2, the candidates' key rows from HBM, and the hashing
// itself (about half the time without any probe).  On a 32768 x 256 batch
// (k = 19, 9.4% of valid windows hit) it took 0.087 ms against 0.376 ms
// for K1 then K4 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// ntsm_l2_window sets or resets a persisting L2 access-policy window on a
// stream (CUDA's cudaStreamAttributeAccessPolicyWindow), device-wide state
// that experiments/exp_count_kernels.py times the step under, with the
// window over the fingerprint plane.  The v3 engine does not set it: it
// runs on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_stage.cuh"

namespace {

constexpr int kWindows = 4;  // windows a lane hashes before it tests any
constexpr int kQueue = 256;  // candidate hashes a warp holds before it verifies them
constexpr int kQueueBytes = kQueue * 8;

__global__ void __launch_bounds__(kStageRows * 32, 4)
count_step_kernel(PackedBatch in, int k, ProbeTable table, int32_t* __restrict__ diag) {
    extern __shared__ uint64_t stage_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = ntsm_stage_bytes(in.L) + kQueueBytes;
    WindowStage st = WindowStage::at(stage_smem, warp, stride, in.L);
    uint64_t* queue = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(stage_smem) + warp * stride + ntsm_stage_bytes(in.L));
    const unsigned below = (1u << lane) - 1;  // lanes before this one
    const uint64_t mask = ntsm_kmer_mask(k);
    const uint32_t kmask = ntsm_good_mask(k);
    int n_valid = 0, n_cand = 0, n_hits = 0;
    int queued = 0;  // the same in every lane of the warp
    ntsm_stage_rows(st, in, k, lane, static_cast<long>(blockIdx.x) * kStageRows + warp,
                    static_cast<long>(gridDim.x) * kStageRows,
                    [&](long, int w_begin, int w_end) {
        for (int w0 = w_begin + lane; w0 - lane < w_end; w0 += 32 * kWindows) {
            if (queued > kQueue - 32 * kWindows) {
                ntsm_verify_queue(table, queue, queued, lane, n_hits);
                queued = 0;
            }
            uint64_t h[kWindows], row[kWindows];
            bool ok[kWindows];
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                const int w = w0 + 32 * u;
                ok[u] = w < w_end && st.valid(w, kmask);
                if (ok[u]) {
                    h[u] = st.hash(w, k, mask);
                    row[u] = table.row(table.bucket(h[u]));
                }
            }
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                const bool cand = ok[u] && table.match(h[u], row[u]);
                n_valid += ok[u];
                n_cand += cand;
                const unsigned ballot = __ballot_sync(0xFFFFFFFFu, cand);
                if (cand) queue[queued + __popc(ballot & below)] = h[u];
                queued += __popc(ballot);
            }
        }
    });
    ntsm_verify_queue(table, queue, queued, lane, n_hits);
    ntsm_diag_add(diag, n_valid, n_cand, n_hits);
}

}  // namespace

extern "C" int ntsm_count_step(const void* packed, long packed_pitch, const void* vbits,
                               long vbits_pitch, int B, int L, int k, const void* fp,
                               const void* keys, const void* vals, long n_buckets, int bbits,
                               void* counts, void* diag, void* stream) {
    const StageLaunch launch = ntsm_stage_launch(B, L, kQueueBytes);
    const ProbeTable table{static_cast<const uint64_t*>(fp), static_cast<const int64_t*>(keys),
                           static_cast<const int32_t*>(vals),
                           static_cast<uint64_t>(n_buckets - 1), bbits,
                           static_cast<int32_t*>(counts)};
    count_step_kernel<<<launch.grid, kStageRows * 32, launch.smem,
                        static_cast<cudaStream_t>(stream)>>>(
        ntsm_packed_batch(packed, packed_pitch, vbits, vbits_pitch, B, L), k, table,
        static_cast<int32_t*>(diag));
    return static_cast<int>(cudaGetLastError());
}

// A persisting L2 access-policy window over [base, base + bytes) on
// `stream` (bytes > 0), or none (bytes = 0: the window removed, the
// persisting lines released and the set-aside returned to 0).  sizes[0]
// gets the L2 bytes set aside for persisting lines, sizes[1] the window's
// bytes (each capped by the device's maximum).
extern "C" int ntsm_l2_window(const void* base, long bytes, void* stream, long* sizes) {
    cudaStreamAttrValue attr = {};
    size_t set_aside = 0, window = 0;
    if (bytes > 0) {
        int dev = 0, max_persist = 0, max_window = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        set_aside = static_cast<size_t>(bytes) < static_cast<size_t>(max_persist)
                        ? static_cast<size_t>(bytes) : static_cast<size_t>(max_persist);
        window = static_cast<size_t>(bytes) < static_cast<size_t>(max_window)
                     ? static_cast<size_t>(bytes) : static_cast<size_t>(max_window);
        err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, set_aside);
        if (err != cudaSuccess) return static_cast<int>(err);
        attr.accessPolicyWindow.base_ptr = const_cast<void*>(base);
        attr.accessPolicyWindow.num_bytes = window;
        const float ratio = static_cast<float>(set_aside) / static_cast<float>(window);
        attr.accessPolicyWindow.hitRatio = ratio < 1.0f ? ratio : 1.0f;
        attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
        attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    }
    cudaError_t err = cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                                             cudaStreamAttributeAccessPolicyWindow, &attr);
    if (err == cudaSuccess && bytes <= 0) {
        err = cudaCtxResetPersistingL2Cache();
        if (err == cudaSuccess) err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
    }
    sizes[0] = static_cast<long>(set_aside);
    sizes[1] = static_cast<long>(window);
    return static_cast<int>(err);
}
