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
// Per valid window, the probe step of common.cuh (ProbeTable, shared with
// the fused count step, hash_probe_count.cu): bucket, fingerprint row test,
// key verify, first matching slot, counts[vals[slot]] += 1.  diag =
// [n_valid, n_cand, n_hits] is summed per block and added atomically.
// Integer atomics are order-free, so counts and diag are bit-identical to
// the plain version (ntsm_tpu_torch/count/kernel_v3.py:probe_and_count).
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
// It measured 0.0696 ms a batch on a table with few hits and 0.105 ms on
// one that 9.4% of the valid windows hit (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md).  The v3 engine no longer launches it: the fused count step
// (hash_probe_count.cu) hashes each window and probes it in one kernel, so
// h never reaches HBM.  It stays for its tests, chip_smoke.py and
// experiments/exp_count_kernels.py.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__global__ void probe_count_kernel(const int64_t* __restrict__ h,
                                   const uint8_t* __restrict__ valid, long n,
                                   ProbeTable table, int32_t* __restrict__ diag) {
    int n_valid = 0, n_cand = 0, n_hits = 0;
    for (long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
         t < n; t += static_cast<long>(gridDim.x) * blockDim.x) {
        if (!valid[t]) continue;
        ++n_valid;
        const uint64_t hv = static_cast<uint64_t>(h[t]);
        const uint64_t bucket = table.bucket(hv);
        table.count(hv, bucket, table.row(bucket), n_cand, n_hits);
    }
    ntsm_diag_add(diag, n_valid, n_cand, n_hits);
}

}  // namespace

extern "C" int ntsm_probe_count(const void* h, const void* valid, long n,
                                const void* fp, const void* keys,
                                const void* vals, long n_buckets, int bbits,
                                void* counts, void* diag, void* stream) {
    const int threads = 256;
    const ProbeTable table{static_cast<const uint64_t*>(fp), static_cast<const int64_t*>(keys),
                           static_cast<const int32_t*>(vals),
                           static_cast<uint64_t>(n_buckets - 1), bbits,
                           static_cast<int32_t*>(counts)};
    probe_count_kernel<<<ntsm_grid(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(h), static_cast<const uint8_t*>(valid), n, table,
        static_cast<int32_t*>(diag));
    return static_cast<int>(cudaGetLastError());
}
