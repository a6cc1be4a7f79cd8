// The v2 count step: hash every window of a packed read batch, look each
// valid one up in a 16-slot bucket, and list the hits in descending order,
// in two kernels: the lookup (bucket_hits_kernel), which never lets a window
// hash reach HBM, and the ordering stage (order_hits_kernel).
//
// Replaces the XLA step ntsm_tpu/count/kernel_v2.py:count_step_v2: the
// window hash (K1's XLA twin, _window_hashes_from), the gather of each
// window's bucket row keys[h & (n_buckets - 1)] (16 u64 keys), the lowest
// matching slot, and lax.top_k of the [B W] hit ids (bucket << 4 | slot) +
// 1, whose zeros are the windows without a hit.  top_k only compacts: the
// lookup stores each hit's id (at most `cap` are stored) and the ordering
// stage sorts the stored ids descending and pads them with zeros to cap,
// which gives top_k's array whenever n_found <= cap.  Hits past cap are
// counted and not stored; the engine then recounts the batch on the host,
// as the JAX engine does.
//
// One deliberate difference from the JAX step: a match on an empty slot
// (key all ones, val n_kmers) is a miss.  At k = 32 the one canonical
// 32-mer whose hash is all ones matches every empty slot of its bucket; the
// JAX step reports it found, and its host accumulation then indexes past
// the counts.  Here its slot must also hold a val other than n_kmers, so it
// counts as --engine golden counts it.
//
// What bounds it on the H100: the bytes it must move are the 3.1 MB packed
// batch (32768 x 256), the key sectors the valid windows' lookups need, and
// four bytes a hit id; the hashing is a few dozen 32- and 64-bit operations
// a window.  At the human site set's size (2.5M k-mers in 2^20 buckets of
// 16, 2.4 keys a bucket) nearly every bucket is reached by a batch, and
// about four lookups in five are decided by the first sector of 4 slots.
// On the card the lookups' instructions and latency, not their bytes, set
// its time: it runs as long on a table that fits the L2 many times over
// (PERF.md).
//
// The lookup.  One resident wave of blocks; each warp stages piece after
// piece of the batch's rows in shared memory (window_stage.cuh, from the
// packed decoder), so a warp's lookups overlap the hashing of its next
// pieces (with a warp a piece, every lookup at the end of a piece left its
// latency exposed).  Each lane tests kWindows windows' validity and hashes
// the valid ones into the warp's ring of queued hashes in shared memory.
// Each lane keeps kPerLane lookups in flight across hashing rounds: before
// a round the warp compares the key sectors it loaded before the last one,
// refills the freed slots from the ring and loads the next sectors, which
// arrive while it hashes.  A bucket is read a 32-byte sector (4 slots) at a
// time, and a lookup stops at the lowest matching slot or at the first
// sector whose last slot is empty: the table fills each bucket's slots from
// 0 up (io/sites.build_lookup; TableV2 checks it), so a sector's last key
// tells whether the bucket ends there, and in every bucket but the last an
// empty slot is exactly a key of all ones (a real key of all ones lies in
// bucket n_buckets - 1).  In that last bucket a lookup reads on until it
// finds its hash, and the all-ones hash reads the vals of the slots it
// matches.  The keys come as sectors: sector p of bucket b at keys + b *
// bucket_stride + p * plane_stride, either the [n_buckets, 16] rows
// (strides 16, 4) or four planes [4][n_buckets][4] (strides 4, 4
// n_buckets), whose first plane, which nearly every lookup needs, is a
// quarter of the keys (count/kernel_v2.TableV2 builds them once a table).
// A hit's id goes to the warp's hit queue; when that may not hold another
// round, and at the end, lane 0 reserves room with one atomicAdd on
// totals[0] (which is also n_found), and the first cap hits of the batch
// are stored, each in the list of its bin (kBins bins by the id's top
// bits; the lanes of a bin take their places with one atomic on the bin's
// count).  n_valid is summed per block and added once a block.
//
// The ordering stage, one block a bin, reads n_found and the bins' counts
// on the device.  Bin b's ids go to top[offset, offset + count), offset
// the count of the higher bins; the block gathers its bin's list into
// shared memory, sorts it (bitonic, descending) and writes it there.  A bin
// of more than kOrderCap ids is cut, from its highest values down, into
// windows of at most kOrderCap ids, found by histograms of kSub sub-ranges
// of its list (refined while the top sub-range alone is too large), each
// gathered and sorted in turn; a single value with more than kOrderCap ids
// is written as a run.  The blocks write the zero padding and the two
// totals, and the last block to finish reading the counters sets them back
// to zero for the next step, so nothing is cleared between steps.  Integer
// sums are order-free and the stored ids are sorted, so the triple is
// bit-identical to the plain version's (count_step_v2_plain).  The numpy
// models of both kernels are in tests/test_torch_v2_lookup.py: change both
// together.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_stage.cuh"

namespace {

constexpr int kSlots = 16;        // keys a bucket
constexpr int kSlotBits = 4;      // a hit id is (bucket << kSlotBits | slot) + 1
constexpr int kSectorSlots = 4;   // keys a 32-byte sector
constexpr int kSectors = kSlots / kSectorSlots;
constexpr int kWindows = 4;       // windows a lane hashes before it queues any
constexpr int kPerLane = 2;       // lookups a lane has in flight
constexpr int kMinBlocks = 3;     // resident blocks an SM (__launch_bounds__)
constexpr int kQueue = 256;       // the ring of queued hashes (a power of two)
constexpr int kHits = 256;        // hit ids a warp holds before it appends them
constexpr int kQueueBytes = kQueue * 8 + kHits * 4;
constexpr int kBins = 128;        // bins of the ordering stage
constexpr int kOrderThreads = 512;
constexpr int kOrderCap = 8192;   // ids a block sorts in shared memory at once
constexpr int kSub = 1024;        // sub-ranges of a bin's refinement histogram
constexpr int kScanLoads = 4;     // 16-byte loads of the id list a thread has in flight

static_assert(kQueue >= 2 * 32 * kWindows, "a hashing round must fit the ring");

struct HitTable {
    const int64_t* __restrict__ keys;  // sector (b, p) at keys + b * bucket_stride + p * plane_stride
    long bucket_stride;
    long plane_stride;
    const int32_t* __restrict__ vals;  // [n_buckets, 16], n_kmers where empty
    uint64_t bucket_mask;
    int n_kmers;
    int bin_shift;                     // an id's bin: (id - 1) >> bin_shift
    int32_t* __restrict__ ids;         // [kBins, stride]: bin b's stored hit ids from b stride on
    unsigned long long stride;
    unsigned long long cap;
    unsigned long long* __restrict__ totals;  // [n_found, n_valid]
    unsigned int* __restrict__ bins;          // [kBins] stored ids a bin

    __device__ __forceinline__ uint64_t bucket(uint64_t h) const { return h & bucket_mask; }

    __device__ __forceinline__ const ulonglong2* sector(uint64_t bucket, int p) const {
        return reinterpret_cast<const ulonglong2*>(keys + bucket * bucket_stride
                                                   + p * plane_stride);
    }

    // The all-ones hash matched slot m of sector p of its bucket (the last):
    // the lowest slot from m on in the sector whose key is all ones and
    // whose val is not n_kmers (not empty), or -1.
    __device__ __noinline__ int real_all_ones(uint64_t bucket, int p, int m) const {
        const int64_t* key = keys + bucket * bucket_stride + p * plane_stride;
        const int32_t* val = vals + bucket * kSlots + kSectorSlots * p;
        for (int j = m; j < kSectorSlots; ++j)
            if (key[j] == -1 && val[j] != n_kmers) return j;
        return -1;
    }
};

// A lookup's state after a sector.
constexpr int kGoOn = -2;  // not decided: read the next sector
constexpr int kMiss = -1;

// Sector p of h's bucket, keys a.x a.y b.x b.y: the slot of the lowest one
// equal to h (and not empty), else kMiss if the bucket ends here, else
// kGoOn.  A bucket ends at the last sector, or, but for the last bucket, at
// a sector whose last key is all ones (empty).  In the last bucket a key of
// all ones may be a real one, so a lookup there reads on until it finds h.
__device__ __forceinline__ int sector_result(const HitTable& table, const ulonglong2& a,
                                             const ulonglong2& b, uint64_t h, uint64_t bucket,
                                             int p) {
    int m = a.x == h ? 0 : a.y == h ? 1 : b.x == h ? 2 : b.y == h ? 3 : -1;
    if (m >= 0 && h == ~0ULL) m = table.real_all_ones(bucket, p, m);
    if (m >= 0) return kSectorSlots * p + m;
    const bool ends = b.y == ~0ULL && bucket != table.bucket_mask;
    return ends || p == kSectors - 1 ? kMiss : kGoOn;
}

// Append a warp's n held hit ids (the first cap hits of the batch are
// stored, whichever warp finds them; one atomic on n_found), each to its
// bin's list (one atomic a bin the lanes of a round share).
__device__ __forceinline__ void append_hits(const HitTable& table, const int32_t* held, int n,
                                            int lane) {
    __syncwarp();  // every lane's ids are in
    unsigned long long base = 0;
    if (lane == 0 && n > 0) base = atomicAdd(&table.totals[0], static_cast<unsigned long long>(n));
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    const unsigned below = (1u << lane) - 1;
    for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const bool store = j < n && base + j < table.cap;
        const int32_t id = store ? held[j] : 0;
        const unsigned bin = store ? static_cast<unsigned>(id - 1) >> table.bin_shift : ~0u;
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
        const int leader = __ffs(peers) - 1;
        unsigned at = 0;
        if (store && lane == leader) at = atomicAdd(&table.bins[bin], __popc(peers));
        at = __shfl_sync(0xFFFFFFFFu, at, leader);
        if (store) table.ids[bin * table.stride + at + __popc(peers & below)] = id;
    }
    __syncwarp();  // every lane has read its entries
}

// A warp's hit ids not yet appended: `held` in shared memory, n of them
// (the same in every lane), appended when it may not hold another 32.
struct Held {
    int32_t* ids;
    int n;

    __device__ __forceinline__ void add(const HitTable& table, int id, int lane,
                                        unsigned below) {
        if (n > kHits - 32) {
            append_hits(table, ids, n, lane);
            n = 0;
        }
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, id != 0);
        if (id) ids[n + __popc(ballot & below)] = id;
        n += __popc(ballot);
    }
};

// A lane's kPerLane lookups in flight: slot r holds a hash and the sector
// p of its bucket loaded into a, b (p = -1: the slot is free).
struct Lookups {
    uint64_t h[kPerLane];
    int p[kPerLane];
    ulonglong2 a[kPerLane], b[kPerLane];

    __device__ __forceinline__ bool live() const {
        bool any = false;
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) any |= p[r] >= 0;
        return any;
    }

    // Compare every live slot's loaded sector: a decided lookup frees its
    // slot (its hit to `held`), the others move on to their next sector.
    __device__ __forceinline__ void resolve(const HitTable& table, Held& held, int lane,
                                            unsigned below) {
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
            int id = 0;
            if (p[r] >= 0) {
                const uint64_t bucket = table.bucket(h[r]);
                const int res = sector_result(table, a[r], b[r], h[r], bucket, p[r]);
                if (res >= 0) id = static_cast<int>((bucket << kSlotBits) | res) + 1;
                p[r] = res == kGoOn ? p[r] + 1 : -1;
            }
            held.add(table, id, lane, below);
        }
    }

    // Fill the free slots from the ring [head, tail), then load every live
    // slot's sector: they arrive while the warp hashes its next windows.
    __device__ __forceinline__ void issue(const HitTable& table, const uint64_t* queue,
                                          unsigned& head, unsigned tail, unsigned below) {
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
            const bool free_slot = p[r] < 0;
            const unsigned want = __ballot_sync(0xFFFFFFFFu, free_slot);
            const unsigned avail = tail - head;
            const unsigned rank = __popc(want & below);
            if (free_slot && rank < avail) {
                h[r] = queue[(head + rank) & (kQueue - 1)];
                p[r] = 0;
            }
            head += min(static_cast<unsigned>(__popc(want)), avail);
        }
#pragma unroll
        for (int r = 0; r < kPerLane; ++r) {
            if (p[r] >= 0) {
                const ulonglong2* s = table.sector(table.bucket(h[r]), p[r]);
                a[r] = s[0];
                b[r] = s[1];
            }
        }
    }
};

__global__ void __launch_bounds__(kStageRows * 32, kMinBlocks)
bucket_hits_kernel(PackedBatch in, int k, HitTable table) {
    extern __shared__ uint64_t stage_smem[];
    __shared__ unsigned long long block_valid;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int stride = ntsm_stage_bytes(in.L) + kQueueBytes;
    WindowStage st = WindowStage::at(stage_smem, warp, stride, in.L);
    uint8_t* own = reinterpret_cast<uint8_t*>(stage_smem) + warp * stride + ntsm_stage_bytes(in.L);
    uint64_t* queue = reinterpret_cast<uint64_t*>(own);
    Held held{reinterpret_cast<int32_t*>(own + kQueue * 8), 0};
    const unsigned below = (1u << lane) - 1;  // lanes before this one
    const uint64_t mask = ntsm_kmer_mask(k);
    const uint32_t kmask = ntsm_good_mask(k);
    if (threadIdx.x == 0) block_valid = 0;
    __syncthreads();
    int n_valid = 0;
    unsigned head = 0, tail = 0;  // the ring [head, tail): the same in every lane
    Lookups look;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
        look.h[r] = 0;
        look.p[r] = -1;
        look.a[r] = look.b[r] = make_ulonglong2(0, 0);
    }
    ntsm_stage_rows(st, in, k, lane, static_cast<long>(blockIdx.x) * kStageRows + warp,
                    static_cast<long>(gridDim.x) * kStageRows,
                    [&](long, int w_begin, int w_end) {
        for (int w0 = w_begin + lane; w0 - lane < w_end; w0 += 32 * kWindows) {
            // the sectors loaded last round are in: compare them, then load
            // the next ones, which arrive while this round hashes
            do {
                __syncwarp();  // every lane's pushes are in
                look.resolve(table, held, lane, below);
                look.issue(table, queue, head, tail, below);
            } while (tail - head > static_cast<unsigned>(kQueue - 32 * kWindows));
            uint64_t h[kWindows];
            bool ok[kWindows];
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                const int w = w0 + 32 * u;
                ok[u] = w < w_end && st.valid(w, kmask);
                if (ok[u]) h[u] = st.hash(w, k, mask);
            }
            __syncwarp();  // every lane has read its ring entries
#pragma unroll
            for (int u = 0; u < kWindows; ++u) {
                n_valid += ok[u];
                const unsigned ballot = __ballot_sync(0xFFFFFFFFu, ok[u]);
                if (ok[u]) queue[(tail + __popc(ballot & below)) & (kQueue - 1)] = h[u];
                tail += __popc(ballot);
            }
        }
    });
    for (;;) {
        __syncwarp();
        look.resolve(table, held, lane, below);
        if (tail == head && !__any_sync(0xFFFFFFFFu, look.live())) break;
        look.issue(table, queue, head, tail, below);
    }
    append_hits(table, held.ids, held.n, lane);
    // n_valid: a warp sum, one shared atomic a warp, one global atomic a block
    n_valid = __reduce_add_sync(0xFFFFFFFFu, n_valid);
    if (lane == 0) atomicAdd(&block_valid, static_cast<unsigned long long>(n_valid));
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(&table.totals[1], block_valid);
}

// ---- the ordering stage ----

struct Order {
    const int32_t* __restrict__ ids;  // [kBins, stride]: bin b's stored ids from b stride on
    unsigned long long stride;
    int32_t* __restrict__ top;        // [cap] out: the stored ids descending, then zeros
    long long* __restrict__ out;      // [2] out: n_found, n_valid
    unsigned long long* __restrict__ totals;  // the lookup's counters, set back to zero here
    unsigned int* __restrict__ bins;
    unsigned int* __restrict__ done;  // blocks that have read the counters
    unsigned long long cap;
    int bin_shift;
    unsigned long long n_values;      // n_buckets * 16: an id - 1 is below it
};

// Call fn(v) for the value v = id - 1 of each of the n ids of a bin's list
// (16-byte aligned), each thread a share, 16-byte loads.
template <class Fn>
__device__ __forceinline__ void scan_ids(const int32_t* ids, int n, Fn fn) {
    const int n4 = n / 4;
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
        const int4 x = ids4[i];
        fn(static_cast<unsigned>(x.x - 1));
        fn(static_cast<unsigned>(x.y - 1));
        fn(static_cast<unsigned>(x.z - 1));
        fn(static_cast<unsigned>(x.w - 1));
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
        fn(static_cast<unsigned>(ids[i] - 1));
}

// Sort buf[0, n) descending (n <= kOrderCap), bitonic on the next power of
// two, padded with zeros, which every id exceeds.
__device__ __forceinline__ void sort_desc(int32_t* buf, int n) {
    int P = 1;
    while (P < n) P <<= 1;
    for (int i = n + threadIdx.x; i < P; i += blockDim.x) buf[i] = 0;
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
        for (int j = size >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
                const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
                const int hi = lo + j;
                const int32_t x = buf[lo], y = buf[hi];
                if ((lo & size) == 0 ? x < y : x > y) {
                    buf[lo] = y;
                    buf[hi] = x;
                }
            }
            __syncthreads();
        }
    }
}

__global__ void __launch_bounds__(kOrderThreads) order_hits_kernel(Order o) {
    __shared__ int32_t buf[kOrderCap];
    __shared__ unsigned int sub[kSub];
    __shared__ unsigned int s_bins[kBins];
    __shared__ unsigned long long s_found, s_valid;
    __shared__ unsigned long long w_lo_s;  // a window's lowest value, its count, single
    __shared__ unsigned int w_n_s, gathered;
    __shared__ bool w_single_s, w_found_s;
    const int bin = blockIdx.x;
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_bins[i] = o.bins[i];
    if (threadIdx.x == 0) {
        s_found = o.totals[0];
        s_valid = o.totals[1];
    }
    __syncthreads();
    // every block has read the counters: the last one sets them to zero
    if (threadIdx.x == 0) {
        if (atomicAdd(o.done, 1u) == gridDim.x - 1) {
            for (int i = 0; i < kBins; ++i) o.bins[i] = 0;
            o.totals[0] = o.totals[1] = 0;
            *o.done = 0;
        }
        if (bin == 0) {
            o.out[0] = static_cast<long long>(s_found);
            o.out[1] = static_cast<long long>(s_valid);
        }
    }
    const int n = static_cast<int>(s_found < o.cap ? s_found : o.cap);
    for (long i = n + static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < static_cast<long>(o.cap); i += static_cast<long>(gridDim.x) * blockDim.x)
        o.top[i] = 0;
    const int count = static_cast<int>(s_bins[bin]);  // the bin's list
    const int32_t* list = o.ids + bin * o.stride;
    unsigned int remaining = count;
    if (remaining == 0) return;  // block-uniform
    unsigned long long cursor = 0;
    for (int i = bin + 1; i < kBins; ++i) cursor += s_bins[i];
    const unsigned long long lo = static_cast<unsigned long long>(bin) << o.bin_shift;
    unsigned long long a_hi = static_cast<unsigned long long>(bin + 1) << o.bin_shift;
    if (a_hi > o.n_values) a_hi = o.n_values;
    while (remaining > 0 && a_hi > lo) {  // the values [lo, a_hi) hold `remaining` ids
        unsigned long long w_lo = lo;
        unsigned int w_n = remaining;
        bool single = false;
        if (remaining > kOrderCap) {
            // the highest window of [lo, a_hi) with at most kOrderCap ids,
            // or its highest value alone if that holds more
            unsigned long long base = lo;
            for (;;) {
                const unsigned long long width = a_hi - base;
                const unsigned long long step = (width + kSub - 1) / kSub;
                for (int i = threadIdx.x; i < kSub; i += blockDim.x) sub[i] = 0;
                __syncthreads();
                scan_ids(list, count, [&](unsigned v) {
                    if (v >= base && v < a_hi) atomicAdd(&sub[(v - base) / step], 1u);
                });
                __syncthreads();
                if (threadIdx.x == 0) {
                    const int top_j = static_cast<int>((width - 1) / step);
                    unsigned int acc = 0;
                    int j = top_j;
                    while (j >= 0 && acc + sub[j] <= kOrderCap) acc += sub[j--];
                    w_found_s = j < top_j || step == 1;
                    if (j < top_j) {
                        w_lo_s = base + static_cast<unsigned long long>(j + 1) * step;
                        w_n_s = acc;
                        w_single_s = false;
                    } else if (step == 1) {
                        w_lo_s = a_hi - 1;
                        w_n_s = sub[top_j];
                        w_single_s = true;
                    } else {
                        w_lo_s = base + static_cast<unsigned long long>(top_j) * step;
                    }
                }
                __syncthreads();
                if (w_found_s) break;
                base = w_lo_s;
                __syncthreads();  // every thread has read w_lo_s
            }
            w_lo = w_lo_s;
            w_n = w_n_s;
            single = w_single_s;
            __syncthreads();  // every thread has read the window
        }
        if (single) {
            for (unsigned int i = threadIdx.x; i < w_n; i += blockDim.x)
                o.top[cursor + i] = static_cast<int32_t>(w_lo + 1);
        } else if (w_n > 0) {
            if (threadIdx.x == 0) gathered = 0;
            __syncthreads();
            const unsigned lane = threadIdx.x & 31, below = (1u << lane) - 1;
            // a warp's matches of one load slot take one shared atomic
            auto gather = [&](unsigned v, bool in) {
                const unsigned ballot = __ballot_sync(0xFFFFFFFFu, in);
                if (ballot == 0) return;  // most slots: no id of this window
                unsigned at = 0;
                if (lane == 0) at = atomicAdd(&gathered, __popc(ballot));
                at = __shfl_sync(0xFFFFFFFFu, at, 0);
                if (in) buf[at + __popc(ballot & below)] = static_cast<int32_t>(v + 1);
            };
            const int n4 = count / 4;
            const int4* ids4 = reinterpret_cast<const int4*>(list);
            // whole warps, for the ballots; kScanLoads loads in flight a thread
            for (int i0 = 0; i0 < n4; i0 += kScanLoads * blockDim.x) {
                int4 x[kScanLoads];
#pragma unroll
                for (int u = 0; u < kScanLoads; ++u) {
                    const int i = i0 + u * blockDim.x + threadIdx.x;
                    x[u] = i < n4 ? ids4[i] : make_int4(0, 0, 0, 0);
                }
#pragma unroll
                for (int u = 0; u < kScanLoads; ++u) {
                    const bool real = i0 + u * static_cast<int>(blockDim.x) + threadIdx.x < n4;
                    const unsigned vs[4] = {static_cast<unsigned>(x[u].x - 1),
                                            static_cast<unsigned>(x[u].y - 1),
                                            static_cast<unsigned>(x[u].z - 1),
                                            static_cast<unsigned>(x[u].w - 1)};
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        gather(vs[c], real && vs[c] >= w_lo && vs[c] < a_hi);
                }
            }
            if (threadIdx.x < 32) {
                const int i = 4 * n4 + threadIdx.x;  // at most 3 left
                const unsigned v = i < count ? static_cast<unsigned>(list[i] - 1) : 0u;
                gather(v, i < count && v >= w_lo && v < a_hi);
            }
            __syncthreads();
            sort_desc(buf, static_cast<int>(w_n));
            for (unsigned int i = threadIdx.x; i < w_n; i += blockDim.x)
                o.top[cursor + i] = buf[i];
            __syncthreads();  // buf is free for the next window
        }
        cursor += w_n;
        remaining -= w_n;
        a_hi = w_lo;
    }
}

// The bin of an id: (id - 1) >> shift puts the n_buckets * 16 ids in at
// most kBins bins.
int bin_shift(long n_buckets) {
    int bits = kSlotBits;
    while ((1L << (bits - kSlotBits)) < n_buckets) ++bits;
    int bin_bits = 0;
    while ((1 << bin_bits) < kBins) ++bin_bits;
    return bits > bin_bits ? bits - bin_bits : 0;
}

// The stride of the bins' lists in `ids`: cap rounded up to 16 bytes.
unsigned long long list_stride(long cap) {
    return (static_cast<unsigned long long>(cap) + 3) & ~3ULL;
}

}  // namespace

// The lookup: keys as sectors (bucket_stride, plane_stride), vals
// [n_buckets, 16]; ids [kBins, cap rounded up to a multiple of 4] int32
// scratch (ntsm_v2_bins); counters (ntsm_v2_counter_bytes):
// totals [2] u64, bins [kBins] u32, the done count u32, zero before the
// first step and set back to zero by each ntsm_v2_order.
extern "C" int ntsm_v2_lookup(const void* packed, long packed_pitch, const void* vbits,
                              long vbits_pitch, int B, int L, int k, const void* keys,
                              long bucket_stride, long plane_stride, const void* vals,
                              long n_buckets, int n_kmers, void* ids, long cap, void* counters,
                              void* stream) {
    StageLaunch launch = ntsm_stage_launch(B, L, kQueueBytes);
    // one resident wave: each warp then stages many pieces, and its lookups
    // overlap the hashing of its next pieces (a warp a piece left the
    // lookups at its end with their latency exposed)
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_hits_kernel,
                                                      kStageRows * 32, launch.smem) != cudaSuccess
        || per_sm < 1)
        per_sm = 1;
    const unsigned wave = static_cast<unsigned>(ntsm_sm_count() * per_sm);
    if (launch.grid > wave) launch.grid = wave;
    auto* totals = static_cast<unsigned long long*>(counters);
    const HitTable table{static_cast<const int64_t*>(keys), bucket_stride, plane_stride,
                         static_cast<const int32_t*>(vals), static_cast<uint64_t>(n_buckets - 1),
                         n_kmers, bin_shift(n_buckets), static_cast<int32_t*>(ids),
                         list_stride(cap), static_cast<unsigned long long>(cap), totals,
                         reinterpret_cast<unsigned int*>(totals + 2)};
    bucket_hits_kernel<<<launch.grid, kStageRows * 32, launch.smem,
                         static_cast<cudaStream_t>(stream)>>>(
        ntsm_packed_batch(packed, packed_pitch, vbits, vbits_pitch, B, L), k, table);
    return static_cast<int>(cudaGetLastError());
}

// The ordering stage: top [cap] int32 and out [2] int64 (n_found, n_valid)
// from the lookup's ids and counters.
extern "C" int ntsm_v2_order(const void* ids, long cap, void* counters, long n_buckets,
                             void* top, void* out, void* stream) {
    auto* totals = static_cast<unsigned long long*>(counters);
    auto* bins = reinterpret_cast<unsigned int*>(totals + 2);
    const Order o{static_cast<const int32_t*>(ids), list_stride(cap), static_cast<int32_t*>(top),
                  static_cast<long long*>(out), totals, bins, bins + kBins,
                  static_cast<unsigned long long>(cap), bin_shift(n_buckets),
                  static_cast<unsigned long long>(n_buckets) * kSlots};
    order_hits_kernel<<<kBins, kOrderThreads, 0, static_cast<cudaStream_t>(stream)>>>(o);
    return static_cast<int>(cudaGetLastError());
}

// Bytes of the counters the two kernels share.
extern "C" int ntsm_v2_counter_bytes() { return 16 + 4 * kBins + 4; }

// The bins of the ordering stage: the rows of the ids scratch.
extern "C" int ntsm_v2_bins() { return kBins; }
