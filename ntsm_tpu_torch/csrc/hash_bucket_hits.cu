// The v2 count step: hash every window of a packed read batch, look each
// valid one up in a 16-slot bucket, and list the hits, in one kernel, so
// that the window hashes never reach HBM.
//
// Replaces the XLA step ntsm_tpu/count/kernel_v2.py:count_step_v2: the
// window hash (K1's XLA twin, _window_hashes_from), the gather of each
// window's bucket row keys[h & (n_buckets - 1)] (16 u64 keys, 128 bytes),
// the lowest matching slot, and lax.top_k of the [B W] hit ids (bucket << 4
// | slot) + 1, whose zeros are the windows without a hit.  top_k only
// compacts: here each hit's id is appended to `ids` (at most `cap` are
// stored), and the wrapper (count/kernel_v2.py:count_step_v2) sorts them
// descending, which gives top_k's array whenever n_found <= cap.  Hits past
// cap are counted and not stored; the engine then recounts the batch on the
// host, as the JAX engine does.
//
// One deliberate difference from the JAX step: a match on an empty slot
// (key all ones, val n_kmers) is a miss.  At k = 32 the one canonical
// 32-mer whose hash is all ones matches every empty slot of its bucket; the
// JAX step reports it found, and its host accumulation then indexes past
// the counts.  Here its slot must also hold a val other than n_kmers (read
// only for that hash), so it counts as --engine golden counts it.
//
// Each warp stages a piece of a row in shared memory (window_stage.cuh, the
// stage of the other count steps, from the packed decoder).  Each lane
// tests kWindows windows' validity and hashes the valid ones; every valid
// window goes to its warp's queue of hashes in shared memory, and when the
// queue may not hold another round, and at the end, the warp looks the
// queued hashes up with every lane, one each: the bucket's 16 keys in eight
// 16-byte loads, all issued before any is compared.  A hit's id goes to the
// warp's hit queue; when that may not hold another round of 32, and at the
// end, lane 0 reserves room in `ids` with one atomicAdd on totals[0] (a
// warp-aggregated counter, which is also n_found) and the warp copies the
// queue there.  n_valid is summed per block and added once a block.
// Integer sums are order-free and the wrapper sorts the ids, so the triple
// is bit-identical to the plain version's (count_step_v2_plain).
//
// What bounds it on the H100: the bytes it must move are the 3.1 MB packed
// batch (32768 x 256), one 128-byte key row for each distinct bucket the
// valid windows reach (random rows of a table larger than the 50 MB L2 at
// human scale) and four bytes a hit id; the hashing is a few dozen 32- and
// 64-bit operations a window.  The design is the simple one: queue, look
// up, append; its times are in PERF.md.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_stage.cuh"

namespace {

constexpr int kSlots = 16;   // keys a bucket: one 128-byte row
constexpr int kSlotBits = 4;  // a hit id is (bucket << kSlotBits | slot) + 1
constexpr int kWindows = 4;  // windows a lane hashes before it queues any
constexpr int kQueue = 256;  // hashes a warp holds before it looks them up
constexpr int kHits = 256;   // hit ids a warp holds before it appends them
constexpr int kQueueBytes = kQueue * 8 + kHits * 4;

struct HitTable {
    const int64_t* __restrict__ keys;  // [n_buckets, 16], 16-byte aligned rows
    const int32_t* __restrict__ vals;  // [n_buckets, 16], n_kmers where empty
    uint64_t bucket_mask;
    int n_kmers;
    int32_t* __restrict__ ids;            // [cap] hit ids, in the order found
    unsigned long long cap;
    unsigned long long* __restrict__ totals;  // [n_found, n_valid]

    // The lowest slot of h's bucket that holds h and is not empty, or -1.
    __device__ __forceinline__ int slot(uint64_t h, uint64_t bucket) const {
        const ulonglong2* row = reinterpret_cast<const ulonglong2*>(keys + bucket * kSlots);
        ulonglong2 r[kSlots / 2];
#pragma unroll
        for (int i = 0; i < kSlots / 2; ++i) r[i] = row[i];
        int s = -1;
#pragma unroll
        for (int i = kSlots / 2 - 1; i >= 0; --i) {
            if (r[i].y == h) s = 2 * i + 1;
            if (r[i].x == h) s = 2 * i;
        }
        if (h == ~0ULL && s >= 0) {  // the empty-slot key: skip the empty slots
            const int32_t* v = vals + bucket * kSlots;
            int t = -1;
            for (int i = kSlots - 1; i >= s; --i)
                if (static_cast<uint64_t>(keys[bucket * kSlots + i]) == h && v[i] != n_kmers) t = i;
            s = t;
        }
        return s;
    }
};

// Append a warp's n held hit ids to table.ids (the first cap hits of the
// batch are stored, whichever warp finds them), with one atomic.
__device__ __forceinline__ void append_hits(const HitTable& table, const int32_t* held, int n,
                                            int lane) {
    __syncwarp();  // every lane's ids are in
    unsigned long long base = 0;
    if (lane == 0 && n > 0) base = atomicAdd(&table.totals[0], static_cast<unsigned long long>(n));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    for (int j = lane; j < n; j += 32)
        if (base + j < table.cap) table.ids[base + j] = held[j];
    __syncwarp();  // every lane has read its entries
}

// Look a warp's n queued hashes up, one a lane; hits go to `held`, which
// holds n_held ids (the same in every lane) and is appended when full.
__device__ __forceinline__ void lookup_queue(const HitTable& table, const uint64_t* queue, int n,
                                             int32_t* held, int& n_held, int lane,
                                             unsigned below) {
    __syncwarp();  // every lane's pushes are in
    for (int i0 = 0; i0 < n; i0 += 32) {
        if (n_held > kHits - 32) {
            append_hits(table, held, n_held, lane);
            n_held = 0;
        }
        int id = 0;
        if (i0 + lane < n) {
            const uint64_t h = queue[i0 + lane];
            const uint64_t bucket = h & table.bucket_mask;
            const int s = table.slot(h, bucket);
            if (s >= 0) id = static_cast<int>((bucket << kSlotBits) | static_cast<uint64_t>(s)) + 1;
        }
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, id != 0);
        if (id) held[n_held + __popc(ballot & below)] = id;
        n_held += __popc(ballot);
    }
    __syncwarp();  // every lane has read its entries
}

__global__ void __launch_bounds__(kStageRows * 32, 4)
bucket_hits_kernel(PackedBatch in, int k, HitTable table) {
    extern __shared__ uint64_t stage_smem[];
    __shared__ unsigned long long block_valid;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = ntsm_stage_bytes(in.L) + kQueueBytes;
    WindowStage st = WindowStage::at(stage_smem, warp, stride, in.L);
    uint8_t* own = reinterpret_cast<uint8_t*>(stage_smem) + warp * stride + ntsm_stage_bytes(in.L);
    uint64_t* queue = reinterpret_cast<uint64_t*>(own);
    int32_t* held = reinterpret_cast<int32_t*>(own + kQueue * 8);
    const unsigned below = (1u << lane) - 1;  // lanes before this one
    const uint64_t mask = ntsm_kmer_mask(k);
    const uint32_t kmask = ntsm_good_mask(k);
    if (threadIdx.x == 0) block_valid = 0;
    int n_valid = 0;
    int queued = 0, n_held = 0;  // the same in every lane of the warp
    ntsm_stage_rows(st, in, k, lane, static_cast<long>(blockIdx.x) * kStageRows + warp,
                    static_cast<long>(gridDim.x) * kStageRows,
                    [&](long, int w_begin, int w_end) {
        for (int w0 = w_begin + lane; w0 - lane < w_end; w0 += 32 * kWindows) {
            if (queued > kQueue - 32 * kWindows) {
                lookup_queue(table, queue, queued, held, n_held, lane, below);
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
    lookup_queue(table, queue, queued, held, n_held, lane, below);
    append_hits(table, held, n_held, lane);
    // n_valid: a warp sum, one shared atomic a warp, one global atomic a block
    n_valid = __reduce_add_sync(0xFFFFFFFFu, n_valid);
    __syncthreads();  // block_valid is set
    if (lane == 0) atomicAdd(&block_valid, static_cast<unsigned long long>(n_valid));
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(&table.totals[1], block_valid);
}

}  // namespace

extern "C" int ntsm_count_step_v2(const void* packed, long packed_pitch, const void* vbits,
                                  long vbits_pitch, int B, int L, int k, const void* keys,
                                  const void* vals, long n_buckets, int n_kmers, void* ids,
                                  long cap, void* totals, void* stream) {
    const StageLaunch launch = ntsm_stage_launch(B, L, kQueueBytes);
    const HitTable table{static_cast<const int64_t*>(keys), static_cast<const int32_t*>(vals),
                         static_cast<uint64_t>(n_buckets - 1), n_kmers,
                         static_cast<int32_t*>(ids), static_cast<unsigned long long>(cap),
                         static_cast<unsigned long long*>(totals)};
    bucket_hits_kernel<<<launch.grid, kStageRows * 32, launch.smem,
                         static_cast<cudaStream_t>(stream)>>>(
        ntsm_packed_batch(packed, packed_pitch, vbits, vbits_pitch, B, L), k, table);
    return static_cast<int>(cudaGetLastError());
}
