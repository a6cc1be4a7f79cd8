// The quantize of the eval -p projection on the card: for rows [r0, r1) of
// the [N, Lp] int32 allele count planes that the device engine uploads
// (eval/rect.py:device_planes), the quantized, centered f64 values
//
//   ca = a > mc ? a : 0,  cb = b > mc ? b : 0,  den = ca + cb
//   vals[r, j] = den == 0 ? 0.0 : q(ca / den) - norm[j]
//   q(g) = (g - 0.25) < 0 ? 0 : (g - 0.75) < 0 ? 0.5 : 1
//
// as one contiguous [m, L] f64 block: the arithmetic of the host's one-sweep
// quantize (native/exact_pairs.cpp:ntsm_quantize_vals), bit for bit.  Each
// f64 operation is rounded to nearest by name (__dadd_rn, __ddiv_rn,
// __dsub_rn), so that no build flag can contract or approximate it; the
// host then multiplies the block by the rotation in f64 BLAS, as it did, so
// the PCA cloud stays what the host projection gives (eval/project_kernel.py).
//
// It replaces no TPU kernel: the JAX package quantizes on the host as well.
// What bounds it on the H100 is bytes: two int32 planes read and one f64
// block written, 16 B a site, 197 MB for a 128-row block of the 96,287
// human sites, 0.059 ms at 3.35 TB/s; the centers (0.77 MB) stay in L2 and
// the division is ~20 f64 instructions a site, far from the f64 peak.  So
// the design is all about the stream of bytes:
//
// * a thread takes a group of 4 sites of one row: one 16-B load from each
//   plane (rows start 16-B aligned: the pitch is a multiple of 4 sites, and
//   the group never passes the row's padding), the 4 centers as two 16-B
//   loads, and the 4 values out as 16-B stores.  A row of the block starts
//   on an odd f64 where r * L is odd; that row's groups store 8, 16 and 8 B
//   instead.  The row's last group, past L, stores what lies in the row.
// * one resident wave of 256-thread blocks walks the groups in a grid-stride
//   loop; a thread carries its (row, group) from pass to pass with an add
//   and a compare, never a division a group.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One site, in ntsm_quantize_vals' order of operations.
__device__ __forceinline__ double quantize(int a, int b, double mc, double center) {
    const double av = static_cast<double>(a);
    const double bv = static_cast<double>(b);
    const double ca = av > mc ? av : 0.0;
    const double cb = bv > mc ? bv : 0.0;
    const double den = __dadd_rn(ca, cb);
    if (den == 0.0) return 0.0;  // a missing site stays exactly 0.0, not 0 - center
    const double g = __ddiv_rn(ca, den);
    const double q = __dsub_rn(g, 0.25) < 0.0 ? 0.0 : __dsub_rn(g, 0.75) < 0.0 ? 0.5 : 1.0;
    return __dsub_rn(q, center);
}

// a, b: row 0 of the block in the planes (row r at a + r * pitch); vals:
// [m, L] f64.  groups = ceil(L / 4) a row.
__global__ void __launch_bounds__(kThreads)
    project_quantize_kernel(const int* __restrict__ a, const int* __restrict__ b, long pitch,
                            long m, long L, const double* __restrict__ norm, double mc,
                            double* __restrict__ vals) {
    const long groups = (L + 3) / 4;
    const long items = m * groups;
    const long stride = static_cast<long>(gridDim.x) * blockDim.x;
    long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= items) return;
    long r = t / groups, g = t - r * groups;  // once; then carried
    const long dr = stride / groups, dg = stride - dr * groups;
    for (; t < items; t += stride) {
        const long j = 4 * g;
        const int4 av = __ldg(reinterpret_cast<const int4*>(a + r * pitch + j));
        const int4 bv = __ldg(reinterpret_cast<const int4*>(b + r * pitch + j));
        double* out = vals + r * L + j;
        if (j + 4 <= L) {
            const double2 n01 = __ldg(reinterpret_cast<const double2*>(norm + j));
            const double2 n23 = __ldg(reinterpret_cast<const double2*>(norm + j + 2));
            const double v0 = quantize(av.x, bv.x, mc, n01.x);
            const double v1 = quantize(av.y, bv.y, mc, n01.y);
            const double v2 = quantize(av.z, bv.z, mc, n23.x);
            const double v3 = quantize(av.w, bv.w, mc, n23.y);
            if (((r * L) & 1) == 0) {
                reinterpret_cast<double2*>(out)[0] = make_double2(v0, v1);
                reinterpret_cast<double2*>(out)[1] = make_double2(v2, v3);
            } else {
                out[0] = v0;
                *reinterpret_cast<double2*>(out + 1) = make_double2(v1, v2);
                out[3] = v3;
            }
        } else {
            const int ax[4] = {av.x, av.y, av.z, av.w};
            const int bx[4] = {bv.x, bv.y, bv.z, bv.w};
            for (long k = 0; j + k < L; ++k) out[k] = quantize(ax[k], bx[k], mc, __ldg(norm + j + k));
        }
        g += dg;
        r += dr;
        if (g >= groups) {
            g -= groups;
            ++r;
        }
    }
}

}  // namespace

// a, b: row r0 of the [N, pitch] int32 planes (16-B aligned, pitch a
// multiple of 4); norm: [L] f64 centers (16-B aligned); vals: [m, L] f64
// out (16-B aligned).  Launches on `stream`; returns cudaGetLastError().
extern "C" int ntsm_project_quantize(const void* a, const void* b, long pitch, long m, long L,
                                     const void* norm, double mc, void* vals, void* stream) {
    const long items = m * ((L + 3) / 4);
    if (items <= 0) return static_cast<int>(cudaGetLastError());
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, project_quantize_kernel, kThreads,
                                                      0) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    long blocks = (items + kThreads - 1) / kThreads;
    const long cap = static_cast<long>(ntsm_sm_count()) * per_sm;
    if (blocks > cap) blocks = cap;
    project_quantize_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a), static_cast<const int*>(b), pitch, m, L,
        static_cast<const double*>(norm), mc, static_cast<double*>(vals));
    return static_cast<int>(cudaGetLastError());
}
