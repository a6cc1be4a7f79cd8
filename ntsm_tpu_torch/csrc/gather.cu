// The gather experiments P1 and P2: four gather forms from a table that
// fits in the H100's 50 MB L2, and the launch floor they are read against.
//
// Replaces the Pallas kernels of scripts/exp_pallas_gather.py (P1: kernel,
// a 1-D gather tbl[idx]; kernel2, take_along_axis(axis=0)) and
// scripts/exp_pallas_gather2.py (P2: try_kernel's bodies kA/kB, axis 0;
// kC, axis 1; kD, a row gather t[idx1d]).  Those asked which gathers Mosaic
// lowers from a VMEM table; here each entry point is the function the Pallas
// body computes, written the way Hopper gathers:
//
//   ntsm_gather_1d     out[i]    = tbl[idx[i]]            kernel
//   ntsm_take_axis0    out[r, c] = tbl[idx[r, c], c]      kernel2, kA, kB
//   ntsm_take_axis1    out[r, m] = tbl[r, idx[r, m]]      kC
//   ntsm_row_gather    out[r, :] = tbl[idx[r], :]         kD
//   ntsm_launch_floor  an empty kernel, 1 block of 32 threads
//
// Values are 32-bit (u32 carried as int32 bit patterns).  An index out of
// range is the caller's fault, as on the TPU: the wrappers
// (ntsm_tpu_torch/experiments/gather.py) check dtypes, shapes, contiguity
// and device only.  Every entry point takes any size (empty, ragged) and
// any 4-B aligned idx: a kernel picks its 16-B path where the pointers and
// widths allow it, and its scalar path elsewhere.
//
// What bounds them on the H100: the bytes of the indices and the output
// (4 B an element) and the table elements the indices touch, at 3.35 TB/s:
// 1.6-1.7 us at the scripts' 524,288-element shapes, 0.1 us at P2's B and D
// (PERF.md).  Beside that, the floor of one timed launch: an empty kernel
// takes 4.7-5.1 us under utils/timing.py:device_ms and 1.7-1.9 us a launch
// among 64 back to back (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The
// scripts' tables (2-4 MB) stay in L2, so what a launch adds above the
// floor is the L2 traffic of its gathers: a random 4-B gather costs a 32-B
// sector, 8 sequential ones share one.  So:
//
// * gather_1d and take_axis0 are one kernel (gather_1d is C = 1 without a
//   column): a thread owns 4 consecutive elements, one 16-B idx load, 4
//   independent table loads in flight, one 16-B store; one resident wave of
//   256-thread blocks walks the elements in a grid-stride loop (a launch
//   under one such block an SM takes blocks of 64, to spread its loads), and
//   the column of take_axis0 is carried from pass to pass with an add and a
//   compare, never a division an element.  Offsets are 32-bit where the
//   table and the loop fit, 64-bit elsewhere.  At the scripts' random
//   indices this runs as the earlier design did (one index a thread, two
//   waves, a 64-bit i % C an element): 9.4-9.9 us against 9.4-10.1, 4.7-5.0
//   us above the floor, where the same kernel takes 6.1 us on sequential
//   indices and the earlier one 6.7-6.8.  The random sectors, one a gather,
//   bound both designs, not the loads in flight.
// * take_axis1: one warp a row.  The warp loads its first 16-B index group,
//   copies row r into its own slice of shared memory with 16-B loads, then
//   __syncwarp (no block barrier) and gathers from there: the random reads
//   never leave the SM, and the row comes from the warp index (no e / M).
//   6.0-6.1 us against the earlier design's 7.0-7.4 (8 rows a block behind
//   two block barriers, an e / M an element).
// * row_gather (one warp a row, 16-B lanes) sits within 1 us of the floor
//   at the script's 256 rows and keeps its first design.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmallThreads = 64;  // a gather_cols block when 256 would leave SMs idle
constexpr int kPer = 4;            // elements a thread owns in gather_cols
constexpr int kAxis1Warps = kThreads / 32;  // rows a take_axis1 block holds at a time

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int done() { return static_cast<int>(cudaGetLastError()); }

// Blocks of one resident wave of `kernel` with `smem` bytes of dynamic
// shared memory a block, never more than `items` threads need, and at
// least 1 (so that an empty launch is still a launch).
template <typename K>
unsigned int wave(K kernel, long items, size_t smem) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
            cudaSuccess || per_sm < 1)
        per_sm = 1;
    long blocks = (items + kThreads - 1) / kThreads;
    const long cap = static_cast<long>(ntsm_sm_count()) * per_sm;
    if (blocks > cap) blocks = cap;
    return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

// out[e] = tbl[idx[e] * C + e % C] for e in [0, n): take_axis0 on a [T, C]
// table, and gather_1d when !kCols (C = 1, no column).  A thread owns the
// kPer elements from e, e a multiple of kPer, then e + stride, ... (blocks
// of up to kThreads).  kVec: idx and out 16-B aligned and C % 4 == 0, so
// the 4 are one 16-B word of idx and of out and lie in one row.  I is int
// where n + stride and T * C fit, else long.
template <typename I, bool kVec, bool kCols>
__global__ void __launch_bounds__(kThreads)
    gather_cols_kernel(const int* __restrict__ tbl, I C, const int* __restrict__ idx, I n,
                       int* __restrict__ out) {
    const I threads = static_cast<I>(blockDim.x);
    const I stride = static_cast<I>(gridDim.x) * threads * kPer;
    I e = (static_cast<I>(blockIdx.x) * threads + static_cast<I>(threadIdx.x)) * kPer;
    I c = 0, dc = 0;  // the column of e, and what a pass adds to it
    if (kCols) {
        c = e % C;
        dc = stride % C;
    }
    for (; e + kPer <= n; e += stride) {
        int i[kPer];
        if (kVec) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(idx + e));
            i[0] = v.x, i[1] = v.y, i[2] = v.z, i[3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < kPer; ++k) i[k] = __ldg(idx + e + k);
        }
        int o[kPer];
        I col = c;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            o[k] = __ldg(tbl + (kCols ? static_cast<I>(i[k]) * C + col : static_cast<I>(i[k])));
            if (kCols && ++col == C) col = 0;
        }
        if (kVec) {
            *reinterpret_cast<int4*>(out + e) = make_int4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int k = 0; k < kPer; ++k) out[e + k] = o[k];
        }
        if (kCols) {
            c += dc;
            if (c >= C) c -= C;
        }
    }
    // the ragged end: the one thread whose pass reached the last n % kPer
    for (int k = 0; e + k < n; ++k) {
        out[e + k] = __ldg(tbl + (kCols ? static_cast<I>(__ldg(idx + e + k)) * C + c
                                        : static_cast<I>(__ldg(idx + e + k))));
        if (kCols && ++c == C) c = 0;
    }
}

// One resident wave of 256-thread blocks; a launch of fewer threads than
// that a block an SM takes blocks of 64, which spread its loads over 4x the
// SMs (P2 B, 8,192 threads: 2.5 us a launch among 64 back to back, against
// 2.8 in 32 blocks of 256; PERF.md).
template <typename I, bool kVec, bool kCols>
void launch_cols_kernel(const int* tbl, long C, const int* idx, long n, int* out,
                        cudaStream_t stream) {
    const auto kernel = gather_cols_kernel<I, kVec, kCols>;
    const long items = (n + kPer - 1) / kPer;
    if (items < static_cast<long>(ntsm_sm_count()) * kThreads) {
        const long blocks = (items + kSmallThreads - 1) / kSmallThreads;
        kernel<<<static_cast<unsigned int>(blocks < 1 ? 1 : blocks), kSmallThreads, 0, stream>>>(
            tbl, static_cast<I>(C), idx, static_cast<I>(n), out);
    } else {
        kernel<<<wave(kernel, items, 0), kThreads, 0, stream>>>(
            tbl, static_cast<I>(C), idx, static_cast<I>(n), out);
    }
}

template <typename I, bool kCols>
int launch_cols(const int* tbl, long C, const int* idx, long n, int* out, cudaStream_t stream) {
    if ((!kCols || C % 4 == 0) && aligned16(idx) && aligned16(out))
        launch_cols_kernel<I, true, kCols>(tbl, C, idx, n, out, stream);
    else
        launch_cols_kernel<I, false, kCols>(tbl, C, idx, n, out, stream);
    return done();
}

// Whether a gather_cols launch over n elements of a table of `tbl_elems`
// can run on 32-bit offsets: n plus one pass (at most the SMs' 2,048
// threads each, kPer elements a thread) and every table offset below 2^31.
bool fits_int(long n, long tbl_elems) {
    const long pass = static_cast<long>(ntsm_sm_count()) * 2048 * kPer;
    return n + pass + kPer <= INT_MAX && tbl_elems <= INT_MAX;
}

// out[r, m] = tbl[r, idx[r, m]], tbl [R, C], idx and out [R, M].  Warp w of
// a block owns row r = blockIdx.x * kAxis1Warps + w, then r + the grid's
// warps, ...; its slice of shared memory holds that row.  kVecRow: C % 4
// == 0 and tbl 16-B aligned (16-B row copies); kVecIdx: M % 4 == 0 and idx
// and out 16-B aligned (16-B index loads and stores).
template <bool kVecRow, bool kVecIdx>
__global__ void __launch_bounds__(kThreads)
    take_axis1_kernel(const int* __restrict__ tbl, int C, const int* __restrict__ idx, int R,
                      int M, int* __restrict__ out) {
    extern __shared__ int4 smem[];
    const int lane = threadIdx.x & 31;
    int* row = reinterpret_cast<int*>(smem) + (threadIdx.x >> 5) * C;
    const int G = kVecIdx ? M / 4 : M;  // index groups a row
    const long warps = static_cast<long>(gridDim.x) * kAxis1Warps;
    for (long r = static_cast<long>(blockIdx.x) * kAxis1Warps + (threadIdx.x >> 5); r < R;
         r += warps) {
        const int* src = tbl + r * C;
        const int* irow = idx + r * M;
        int* orow = out + r * M;
        // the lane's first index group, in flight while the row is copied
        int4 first = make_int4(0, 0, 0, 0);
        if (lane < G) {
            if (kVecIdx)
                first = __ldg(reinterpret_cast<const int4*>(irow) + lane);
            else
                first.x = __ldg(irow + lane);
        }
        if (kVecRow) {
            for (int j = lane; j < C / 4; j += 32)
                reinterpret_cast<int4*>(row)[j] = __ldg(reinterpret_cast<const int4*>(src) + j);
        } else {
            for (int j = lane; j < C; j += 32) row[j] = __ldg(src + j);
        }
        __syncwarp();
        if (kVecIdx) {
            int4* o4 = reinterpret_cast<int4*>(orow);
            if (lane < G)
                o4[lane] = make_int4(row[first.x], row[first.y], row[first.z], row[first.w]);
            for (int g = lane + 32; g < G; g += 32) {
                const int4 i = __ldg(reinterpret_cast<const int4*>(irow) + g);
                o4[g] = make_int4(row[i.x], row[i.y], row[i.z], row[i.w]);
            }
        } else {
            if (lane < G) orow[lane] = row[first.x];
            for (int g = lane + 32; g < G; g += 32) orow[g] = row[__ldg(irow + g)];
        }
        __syncwarp();  // the row is overwritten by the warp's next one
    }
}

template <bool kVecRow, bool kVecIdx>
int launch_axis1(const int* tbl, int C, const int* idx, int R, int M, int* out,
                 cudaStream_t stream) {
    const auto kernel = take_axis1_kernel<kVecRow, kVecIdx>;
    const size_t smem = static_cast<size_t>(kAxis1Warps) * C * sizeof(int);
    kernel<<<wave(kernel, static_cast<long>(R) * 32, smem), kThreads, smem, stream>>>(
        tbl, C, idx, R, M, out);
    return done();
}

// One warp a row: lane l copies 16-B words l, l + 32, ... of row idx[r].
// C is a multiple of 4 and both tables are 16-B aligned (the wrapper checks).
__global__ void row_gather_kernel(const int4* __restrict__ tbl, int C4,
                                  const int* __restrict__ idx, int R,
                                  int4* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long warps = static_cast<long>(gridDim.x) * (blockDim.x / 32);
    for (long r = (blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x) / 32;
         r < R; r += warps) {
        const int4* src = tbl + static_cast<long>(__ldg(idx + r)) * C4;
        int4* dst = out + r * C4;
        for (int c = lane; c < C4; c += 32) dst[c] = __ldg(src + c);
    }
}

// The launch floor: a kernel that does nothing, to time what one launch
// costs apart from any work.
__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int ntsm_launch_floor(void* stream) {
    launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return done();
}

extern "C" int ntsm_gather_1d(const void* tbl, const void* idx, long n,
                              void* out, void* stream) {
    auto t = static_cast<const int*>(tbl);
    auto i = static_cast<const int*>(idx);
    auto o = static_cast<int*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    // an index is an int: any table offset fits 32 bits
    return fits_int(n, 0) ? launch_cols<int, false>(t, 1, i, n, o, s)
                          : launch_cols<long, false>(t, 1, i, n, o, s);
}

extern "C" int ntsm_take_axis0(const void* tbl, long T, int C, const void* idx, long n,
                               void* out, void* stream) {
    auto t = static_cast<const int*>(tbl);
    auto i = static_cast<const int*>(idx);
    auto o = static_cast<int*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (C < 1) return launch_cols<int, false>(t, 1, i, 0, o, s);  // no columns: n is 0
    return fits_int(n, T * C) ? launch_cols<int, true>(t, C, i, n, o, s)
                              : launch_cols<long, true>(t, C, i, n, o, s);
}

extern "C" int ntsm_take_axis1(const void* tbl, int C, const void* idx, int R,
                               int M, void* out, void* stream) {
    auto t = static_cast<const int*>(tbl);
    auto i = static_cast<const int*>(idx);
    auto o = static_cast<int*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const bool vec_row = C % 4 == 0 && aligned16(tbl);
    const bool vec_idx = M % 4 == 0 && aligned16(idx) && aligned16(out);
    if (vec_row)
        return vec_idx ? launch_axis1<true, true>(t, C, i, R, M, o, s)
                       : launch_axis1<true, false>(t, C, i, R, M, o, s);
    return vec_idx ? launch_axis1<false, true>(t, C, i, R, M, o, s)
                   : launch_axis1<false, false>(t, C, i, R, M, o, s);
}

extern "C" int ntsm_row_gather(const void* tbl, int C, const void* idx, int R,
                               void* out, void* stream) {
    row_gather_kernel<<<ntsm_grid(static_cast<long>(R) * 32, kThreads), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(tbl), C / 4, static_cast<const int*>(idx), R,
        static_cast<int4*>(out));
    return done();
}
