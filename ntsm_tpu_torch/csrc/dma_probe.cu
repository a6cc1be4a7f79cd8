// The DMA probe experiment P3: fetch one 512-B fingerprint row per index
// through a ring of asynchronous copies, and XOR-reduce the rows.
//
// Replaces the Pallas kernel scripts/exp_dma_probe.py:kernel (via probe and
// run): a depth-S ring of pltpu.make_async_copy row fetches from the v3
// fingerprint plane seen as [65536, 128] u32 rows (64 buckets' 8-byte rows
// in each 512-B row), 4096 indices a launch, 512 launches under a lax.scan.
// Its question, how fast explicit asynchronous copies gather random rows,
// is the one the count steps face on their random table rows.
//
// Every indexed row is fetched, once an index.  An XOR of only the rows
// with an odd index count gives the same 512 B at the table's bound, but it
// answers another question; this program exists to time the gather.
//
// On Hopper one CUDA block is one of the script's launches (4096
// indices), and the block's ring has `depth` 512-B shared-memory slots, so
// that `depth` rows are in flight a block.  The 512 launches are 512
// blocks of four warps, all resident at once (4 on 116 SMs and 3 on 16 of
// the 132).  Slot s belongs to warp s % kWarps, and row i goes to slot
// i % depth, so warp c fetches and reads the rows of its slots c, c + 4,
// ..., in order; a warp with no slot (depth < 4) idles.  Each warp runs its
// own ring of asynchronous copies (cp.async, the Ampere form of the TPU's
// make_async_copy): a lane copies 16 B of a row, the warp commits one group
// a row, waits until its oldest group has landed (cp.async.wait_group with
// its slot count less one pending), XORs its lane's 16 B into a 4 x u32
// register accumulator, and refills the slot with the row its slot count
// later.  Each lane reads only the bytes it copied itself, so no barrier
// guards a slot: the warp's group order is its ring.  The slot count is a
// compile-time constant of the warp's loop (one instance for each count,
// 1-16: wait_group takes an immediate; a chain of tests around one loop
// took 0.178 ms at depth 64 against 0.149).  The indices come 32 at a time
// with one load a lane, the next 32 already in flight.  At the
// end the warps' accumulators are XORed through shared memory into 128
// u32, and each block atomicXors them into out, which the wrapper zeroed:
// XOR is associative and commutative, so the result is exact whatever the
// order.
//
// Why not the bulk-copy engine (cp.async.bulk into mbarrier-tracked slots,
// behind TMA): a warp-specialised ring of it, a producer warp issuing 32
// rows at a time in parallel and per-slot empty barriers in place of a
// block barrier a row, took 0.405 ms at depth 64 (NVIDIA H100 80GB HBM3,
// 700 W), as much on sequential indices as on random ones, against 0.149
// ms for this ring in the same run (PERF.md): each 512-B bulk copy has a
// fixed cost that an SM pays in series.
//
// What bounds it on the H100: the indices (8 MB at the script's shape), the
// rows they touch (all 65,536 rows, 32 MiB) and 512 B out, at 3.35 TB/s;
// the XOR is 128 32-bit operations a row.  The 32 MiB plane fits in the
// 50 MB L2, so after the first touch each row comes from L2, and the floor
// of "every row fetched" is the L2's rate for 1.07 GB of 512-B rows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // u32 lanes a row: 512 B, 16 B a lane of a warp
constexpr int kRowBytes = kLanes * 4;
constexpr int kWarps = 4;
constexpr int kMaxSlots = 16;  // a warp's slots at the largest depth, 64

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // at most N newest groups pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp c's ring of its S slots, c + kWarps k for k < S, over its n_rows
// rows: its row k is row k / S * depth + c + kWarps * (k % S) of the block
// and goes to the slot of k % S.  Returns the XOR of the rows' 16 B at lane.
template <int S>
__device__ __forceinline__ uint4 warp_ring(const uint4* __restrict__ fp, const int* __restrict__ my,
                                           int n_rows, int depth, int c, int lane, uint4* ring) {
    auto load_idx = [&](int q) {  // lane l: the index of row 32 q + l
        const int k = 32 * q + lane;
        return k < n_rows ? __ldg(my + k / S * depth + c + kWarps * (k % S)) : 0;
    };
    int cur = load_idx(0);
    int nxt = load_idx(1);
#pragma unroll
    for (int k = 0; k < S; ++k) {  // S <= 16: all in the first 32
        const int r = __shfl_sync(0xffffffffu, cur, k);
        if (k < n_rows)
            cp_async16(ring + (c + kWarps * k) * 32 + lane, fp + static_cast<long>(r) * 32 + lane);
        cp_async_commit();  // an empty group past the end keeps the count
    }
    uint4 acc = make_uint4(0, 0, 0, 0);
    for (int k = 0; k < n_rows; ++k) {
        if (k % 32 == 0 && k > 0) {
            cur = nxt;
            nxt = load_idx(k / 32 + 1);
        }
        cp_async_wait<S - 1>();  // row k has landed
        uint4* slot = ring + (c + kWarps * (k % S)) * 32 + lane;
        const uint4 v = *slot;
        acc.x ^= v.x;
        acc.y ^= v.y;
        acc.z ^= v.z;
        acc.w ^= v.w;
        const int kn = k + S;  // the row that refills the slot
        const int r = __shfl_sync(0xffffffffu, kn / 32 == k / 32 ? cur : nxt, kn % 32);
        if (kn < n_rows) cp_async16(slot, fp + static_cast<long>(r) * 32 + lane);
        cp_async_commit();
    }
    return acc;
}

// warp_ring<n_slots>: the slot count a compile-time constant, n_slots in [1, S]
template <int S>
__device__ __forceinline__ uint4 ring_of(int n_slots, const uint4* __restrict__ fp,
                                         const int* __restrict__ my, int n_rows, int depth,
                                         int c, int lane, uint4* ring) {
    if constexpr (S > 1) {
        if (n_slots < S) return ring_of<S - 1>(n_slots, fp, my, n_rows, depth, c, lane, ring);
    }
    return warp_ring<S>(fp, my, n_rows, depth, c, lane, ring);
}

// blockDim.x == 32 * kWarps; dynamic shared memory: the depth slots.
__global__ void __launch_bounds__(32 * kWarps)
dma_probe_kernel(const uint4* __restrict__ fp, const int* __restrict__ idx, int n_idx,
                 int depth, uint32_t* __restrict__ out) {
    extern __shared__ __align__(128) uint4 ring[];  // [depth][32]: lane l holds u32 4l..4l+3
    __shared__ uint4 red[kWarps][32];
    const int c = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int* my = idx + static_cast<long>(blockIdx.x) * n_idx;

    // warp c's slots c, c + kWarps, ... < depth, and its rows: n_slots of
    // each round of depth rows, then those of the last, partial round
    const int n_slots = depth > c ? (depth - c + kWarps - 1) / kWarps : 0;
    const int rem = n_idx % depth;
    const int n_rows =
        n_idx / depth * n_slots + (rem > c ? (rem - c + kWarps - 1) / kWarps : 0);
    red[c][lane] = n_rows > 0
                       ? ring_of<kMaxSlots>(n_slots, fp, my, n_rows, depth, c, lane, ring)
                       : make_uint4(0, 0, 0, 0);
    __syncthreads();
    if (threadIdx.x < kLanes) {
        uint32_t x = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) x ^= reinterpret_cast<const uint32_t*>(red[w])[threadIdx.x];
        atomicXor(out + threadIdx.x, x);
    }
}

}  // namespace

extern "C" int ntsm_dma_probe(const void* fp, const void* idx, int n_launch,
                              int n_idx, int depth, void* out, void* stream) {
    const size_t smem = static_cast<size_t>(depth) * kRowBytes;
    dma_probe_kernel<<<n_launch, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(fp), static_cast<const int*>(idx), n_idx, depth,
        static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
