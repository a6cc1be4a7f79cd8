// The fused v1 count step of `ntsm count`: hash every window of a batch of
// unpacked codes and count it in the site table's buckets, in one kernel,
// so that the window hashes never reach HBM.
//
// Replaces, as one launch a batch, the Pallas kernel
// ntsm_tpu/count/pallas_kernel.py:_window_hash_kernel (K2) and the XLA
// bucket probe that ntsm_tpu/count/kernel.py:count_step_impl runs after
// its window hash: bucket = h & (n_buckets - 1), the bucket's 8 keys
// matched against h, the smallest matching val, counts.at[idx].add(1) with
// every window not found (invalid ones and pad rows included) added to
// the last slot, and the batch's n_valid and n_found.
//
// Each warp stages a piece of a row in shared memory (window_stage.cuh,
// the stage K1, K2 and the v3 step share, from the code decoder), cut to
// the row's read: windows past it and pieces without one are skipped.
// Each lane tests kWindows windows' validity and hashes the valid ones;
// every valid window is a candidate (the v1 table has no fingerprint
// plane), so its hash goes to its warp's queue in shared memory, and when
// the queue may not hold another round, and at the end, the warp verifies
// the queued hashes with every lane, one each (common.cuh,
// ProbeTable::verify: the bucket's 8 keys in four 16-byte loads, the first
// matching slot, atomicAdd into counts).  In a build_lookup table the
// slots of a bucket hold ascending vals, empty slots (key -1, val n_kmers)
// last, so the first matching slot holds the smallest matching val, as
// the plain version's amin.  The miss slot is not counted a window at a
// time: each block adds minus its hits, and block 0 adds B x W once, so
// counts[n_kmers] += B W - n_hits.  At k = 32 the one canonical 32-mer
// whose hash is all ones matches every empty slot of its bucket; verify
// counts it as a hit into counts[n_kmers] (its val), so the miss slot still
// ends at the plain version's.  Integer atomics (int32, wrapping as the
// plain version's) are order-free: counts and the totals are bit-identical
// to the plain version (count/kernel.py: window_hashes_codes_plain then
// bucket_probe).
//
// What bounds it on the H100: the bytes it must move are the codes (8.4 MB
// at 32768 x 256), the key row (64 B) of each distinct bucket the valid
// windows reach, and a value load and count read-modify-write a hit.  At
// the human-scale table (2^22-2^23 buckets, 268-537 MB of keys, more than
// the 50 MB L2) each valid window's key row is a random HBM access.  On a
// 32768 x 256 batch of 150-bp reads (4.24M valid windows, 3.32M distinct
// rows of 2^23 buckets) it took 0.192 ms against a 0.067 ms bound and
// 16.5 ms for K2 then the plain probe; on experiments/exp_count_kernels.py's
// batch it takes 0.164 ms, and 0.047 ms with the verify taken out, so the
// random rows set its pace (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_stage.cuh"

namespace {

constexpr int kWindows = 4;  // windows a lane hashes before it queues any
constexpr int kQueue = 256;  // hashes a warp holds before it verifies them
constexpr int kQueueBytes = kQueue * 8;

// diag = [n_valid, n_found]; misses = B W mod 2^32.
__global__ void __launch_bounds__(kStageRows * 32, 4)
bucket_count_kernel(CodeBatch in, int k, ProbeTable table, int n_kmers, unsigned misses,
                    int32_t* __restrict__ diag) {
    extern __shared__ uint64_t stage_smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = ntsm_stage_bytes(in.L) + kQueueBytes;
    WindowStage st = WindowStage::at(stage_smem, warp, stride, in.L);
    uint64_t* queue = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(stage_smem) + warp * stride + ntsm_stage_bytes(in.L));
    const unsigned below = (1u << lane) - 1;  // lanes before this one
    const uint64_t mask = ntsm_kmer_mask(k);
    const uint32_t kmask = ntsm_good_mask(k);
    int n_valid = 0, n_hits = 0;
    int queued = 0;  // the same in every lane of the warp
    ntsm_stage_rows(st, in, k, lane, static_cast<long>(blockIdx.x) * kStageRows + warp,
                    static_cast<long>(gridDim.x) * kStageRows,
                    [&](long, int w_begin, int w_end) {
        for (int w0 = w_begin + lane; w0 - lane < w_end; w0 += 32 * kWindows) {
            if (queued > kQueue - 32 * kWindows) {
                ntsm_verify_queue(table, queue, queued, lane, n_hits);
                queued = 0;
            }
            uint64_t h[kWindows];
            bool ok[kWindows];
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                const int w = w0 + 32 * u;
                ok[u] = w < w_end && st.valid(w, kmask);
                if (ok[u]) h[u] = st.hash(w, k, mask);
            }
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                n_valid += ok[u];
                const unsigned ballot = __ballot_sync(0xFFFFFFFFu, ok[u]);
                if (ok[u]) queue[queued + __popc(ballot & below)] = h[u];
                queued += __popc(ballot);
            }
        }
    });
    ntsm_verify_queue(table, queue, queued, lane, n_hits);
    const unsigned windows = blockIdx.x == 0 && threadIdx.x == 0 ? misses : 0u;
    ntsm_block_add(diag, table.counts + n_kmers, diag + 1, n_valid,
                   static_cast<int>(windows - static_cast<unsigned>(n_hits)), n_hits);
}

}  // namespace

extern "C" int ntsm_count_step_v1(const void* codes, long pitch, const void* lengths, int B,
                                  int L, int k, const void* keys, const void* vals,
                                  long n_buckets, int n_kmers, void* counts, void* diag,
                                  void* stream) {
    const StageLaunch launch = ntsm_stage_launch(B, L, kQueueBytes);
    const ProbeTable table{nullptr, static_cast<const int64_t*>(keys),
                           static_cast<const int32_t*>(vals),
                           static_cast<uint64_t>(n_buckets - 1), 0,
                           static_cast<int32_t*>(counts)};
    // B W, wrapped to int32 as the plain version's int32 count wraps
    const auto misses =
        static_cast<unsigned>(static_cast<uint64_t>(B) * static_cast<uint64_t>(L - k + 1));
    bucket_count_kernel<<<launch.grid, kStageRows * 32, launch.smem,
                          static_cast<cudaStream_t>(stream)>>>(
        ntsm_code_batch(codes, pitch, lengths, B, L, true), k, table, n_kmers, misses,
        static_cast<int32_t*>(diag));
    return static_cast<int>(cudaGetLastError());
}
