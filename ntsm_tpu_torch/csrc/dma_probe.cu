// The DMA probe experiment P3: fetch one 512-B fingerprint row per index
// through a ring of asynchronous copies, and XOR-reduce the rows.
//
// Replaces the Pallas kernel scripts/exp_dma_probe.py:kernel (via probe and
// run): a depth-S ring of pltpu.make_async_copy row fetches from the v3
// fingerprint plane seen as [65536, 128] u32 rows (64 buckets' 8-byte rows
// in each 512-B row), 4096 indices a launch, 512 launches under a lax.scan.
// Its question, how fast explicit asynchronous copies gather random rows,
// is the one the probe kernel (probe_count.cu) faces on its fp plane.
//
// On Hopper one CUDA block is one of the script's launches: 4096 indices,
// 128 threads (one a u32 lane of the row), a ring of `depth` 512-B
// shared-memory slots, each with an mbarrier.  One elected thread issues a
// bulk asynchronous copy (cp.async.bulk ... mbarrier::complete_tx::bytes,
// the copy engine behind TMA) of row idx[i] into slot i % depth; every
// thread waits on that slot's barrier (parity flips each time the slot is
// reused), XORs its lane into a register, and the block synchronises before
// the elected thread re-issues the slot for row i + depth (the
// write-after-read hazard of slot reuse).  Each block finally atomicXors its
// [128] into out, which the wrapper zeroed: XOR is associative and
// commutative, so the result is exact whatever the order.
//
// What bounds it on the H100: the indices (8 MB at the script's shape), the
// rows they touch (all 65,536 rows, 32 MiB) and 512 B out, at 3.35 TB/s;
// the XOR is 128 32-bit operations a row.  The 32 MiB plane fits in the
// 50 MB L2, so after the first touch each row comes from L2.  What the ring
// measures is how many 512-B copies one thread issuing them, and one
// __syncthreads a row, can keep in flight per SM at a given depth.
// cp.async.bulk and the mbarrier expect-tx operations exist from sm_90 on
// (the library is built for sm_90a).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;        // u32 lanes a row: 512 B
constexpr int kRowBytes = kLanes * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    return ok != 0;
}

// Arm the slot's barrier for one row and start the row's copy into it.
__device__ __forceinline__ void issue_row(const uint32_t* row, uint32_t* slot,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(kRowBytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
        "l"(row), "r"(kRowBytes), "r"(smem_addr(bar))
        : "memory");
}

// blockDim.x == kLanes; dynamic shared memory: depth rows, then depth barriers.
__global__ void dma_probe_kernel(const uint32_t* __restrict__ fp,
                                 const int* __restrict__ idx, int n_idx,
                                 int depth, uint32_t* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + depth * kRowBytes);
    const int* my = idx + static_cast<long>(blockIdx.x) * n_idx;
    const int lane = threadIdx.x;
    const bool leader = lane == 0;

    if (leader) {
        for (int s = 0; s < depth; ++s) mbar_init(bars + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (leader) {
        for (int i = 0; i < depth && i < n_idx; ++i)
            issue_row(fp + static_cast<long>(__ldg(my + i)) * kLanes,
                      ring + i * kLanes, bars + i);
    }

    uint32_t acc = 0;
    for (int i = 0; i < n_idx; ++i) {
        const int s = i % depth;
        const unsigned parity = static_cast<unsigned>(i / depth) & 1u;
        while (!mbar_try_wait(bars + s, parity)) {
        }
        acc ^= ring[s * kLanes + lane];
        __syncthreads();  // every lane has read slot s before it is refilled
        if (leader && i + depth < n_idx)
            issue_row(fp + static_cast<long>(__ldg(my + i + depth)) * kLanes,
                      ring + s * kLanes, bars + s);
    }
    atomicXor(out + lane, acc);
}

}  // namespace

extern "C" int ntsm_dma_probe(const void* fp, const void* idx, int n_launch,
                              int n_idx, int depth, void* out, void* stream) {
    const size_t smem = static_cast<size_t>(depth) * (kRowBytes + sizeof(uint64_t));
    dma_probe_kernel<<<n_launch, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(fp), static_cast<const int*>(idx), n_idx, depth,
        static_cast<uint32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
