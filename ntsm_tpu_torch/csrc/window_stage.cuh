// The window stage of the count path: the canonical k-mer hash and validity
// of every window of a read batch, laid out for Hopper, from either upload:
//
//   PackedBatch, the v3 engine's 2-bit packed rows: what
//       ntsm_tpu/count/pallas_kernel.py:_window_hash_kernel_packed computes;
//       K1 (window_hash.cu: ntsm_window_hash) and the fused count step
//       (hash_probe_count.cu: ntsm_count_step) stage it;
//   CodeBatch, the v1 engine's unpacked u8 codes with row lengths: what
//       ntsm_tpu/count/pallas_kernel.py:_window_hash_kernel computes; K2
//       (window_hash.cu: ntsm_window_hash_codes) and the fused v1 count step
//       (hash_bucket_count.cu: ntsm_count_step_v1) stage it.
//
// Both decoders fill the same words, so the piece cut and the window
// extraction below are one code for the four kernels.
//
// A row of L bases is cut into pieces: piece t holds bases [s, s + n), s =
// t * kPieceWindows, and serves windows [s, s + kPieceWindows) (the last
// piece: [s, W), W = L - k + 1), with n = kStageBases = kPieceWindows + 32
// >= kPieceWindows + k - 1 (the last piece: the rest of the row, L - s <=
// kStageBases).  A row of at most kStageBases bases, as the engine's 256,
// is one piece.  The pieces of all rows are the work items: each warp
// stages one in its slice of shared memory, then reads every window of it
// from there, so the shared memory a warp needs and the number of warps a
// batch fills do not depend on L.  A CodeBatch that clips to its rows'
// lengths (the v1 step) stages a piece only as far as its read and serves
// only the windows inside it, and skips a piece with none.  The stage of a
// piece, n rounded up to a multiple of 8 (the bases past n zero and bad):
//
//   fw   [2 NW] u32  its bases in order, 2 bits each, base s + 16i + j at
//        bits 31 - 2j .. 30 - 2j of word i (as fw = (fw << 2) | c builds a
//        k-mer);
//   rc   [2 NW] u32  its reverse complement the same way: position q holds
//        3 - base (s + n - 1 - q);
//   good [NW] u32  bit j of word i: base s + 32i + j is a real A/C/G/T
//        inside the read;
//   NW = ceil(n / 32) + 1; the words past the piece are zero.
//
// The decode reads the row's bytes from global memory in chunks of 8
// bases: chunk c of the piece, bases m = s + 8c .. m + 7, is 16 bits of fw,
// 16 bits of rc (at chunk n/8 - 1 - c) and 8 good bits.
//   PackedBatch (kernel_v2.pack_batch's block layout: Q = L/4 packed bytes,
//       base p at byte p % Q, bit pair p / Q; then E = L/8 validity bytes,
//       base p at byte p % E, bit p / E; L % 8 == 0): m = iE + j (one
//       division); when E % 8 == 0 and the rows are 8-byte aligned, as in
//       the engine's upload at L % 64 == 0, two 8-byte loads, else 16 byte
//       loads.
//   CodeBatch (one byte a base, 0..3 a base, > 3 not one): the chunk's 8
//       bytes, one 8-byte load when the rows are 8-byte aligned (base
//       pointer and pitch) and the chunk lies inside the bases read, else a
//       byte load each (a row's tail when L % 8 != 0); a base is good when
//       its code is <= 3 and it lies before the row's length.
// Either way the loads are coalesced across the warp's lanes.  Window w is
// then three words of fw at (w - s) / 16 funnel-shifted by 2 ((w - s) %
// 16), top 2k bits; the same of rc at position n - (w - s) - k; and k good
// bits at w - s, all ones.  A few dozen instructions a window, where
// walking k bases for every window costs ~20 instructions a base.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kPieceWindows = 2048;              // windows a piece serves
constexpr int kStageBases = kPieceWindows + 32;  // bases a piece holds (k <= 32)
constexpr int kStageRows = 8;                    // warps (pieces in flight) a block

__host__ __device__ __forceinline__ int ntsm_stage_words(int n) { return (n + 31) / 32 + 1; }

// Shared-memory bytes of one warp's stage for rows of L bases (at most
// 1,320, so kStageRows stages and 2 KB a warp of the kernel's own fit the
// default 48 KB).
__host__ __device__ __forceinline__ int ntsm_stage_bytes(int L) {
    const int nw = ntsm_stage_words(L < kStageBases ? L : kStageBases);
    return 16 * nw + ((4 * nw + 7) & ~7);
}

// Pieces of a row of L bases (L - s <= kStageBases for the last one).
__host__ __device__ __forceinline__ int ntsm_stage_pieces(int L) {
    return L <= kStageBases ? 1 : (L - 32 + kPieceWindows - 1) / kPieceWindows;
}

// The rows of a packed batch: row b's packed bytes at packed + b * packed_pitch,
// its validity bytes at vbits + b * vbits_pitch.
struct PackedBatch {
    const uint8_t* packed;
    long packed_pitch;
    const uint8_t* vbits;
    long vbits_pitch;
    int B;
    int L;
    int pieces;        // ntsm_stage_pieces(L)
    bool runs;         // E % 8 == 0 and both rows 8-byte aligned: a chunk is two 8-byte loads
    uint64_t e_magic;  // ceil(2^64 / E): m / E = umulhi(m, e_magic) for m E < 2^64
                       // (E = 1 wraps it to 0, and there m is always 0)

    // The decode of one row's chunks.
    struct Row {
        const uint8_t* prow;
        const uint8_t* vrow;
        int E;
        bool runs;
        uint64_t e_magic;

        // Bases m .. m + 7: f and r 16 bits each, g 8 good bits.
        __device__ __forceinline__ void chunk(unsigned m, unsigned& f, unsigned& r,
                                              unsigned& g) const {
            // base m + t = i E + j: packed byte j + (i & 1) E, bit pair
            // i >> 1; validity byte j, bit i
            int i = static_cast<int>(__umul64hi(m, e_magic));
            int j = static_cast<int>(m) - i * E;
            f = r = g = 0;
            if (runs) {  // j .. j + 7 in one 8-byte-aligned run, i fixed
                const uint64_t P =
                    __ldg(reinterpret_cast<const unsigned long long*>(prow + j + (i & 1) * E))
                    >> (2 * (i >> 1));
                const uint64_t G =
                    __ldg(reinterpret_cast<const unsigned long long*>(vrow + j)) >> i;
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    const unsigned code = static_cast<unsigned>(P >> (8 * t)) & 3u;
                    f = (f << 2) | code;
                    r |= (3u ^ code) << (2 * t);
                }
                g = static_cast<unsigned>(((G & 0x0101010101010101ULL) * 0x0102040810204080ULL)
                                          >> 56);
            } else {
#pragma unroll
                for (int t = 0; t < 8; ++t) {
                    const unsigned code = (__ldg(prow + j + (i & 1) * E) >> (2 * (i >> 1))) & 3u;
                    f = (f << 2) | code;
                    r |= (3u ^ code) << (2 * t);
                    g |= ((__ldg(vrow + j) >> i) & 1u) << t;
                    if (++j == E) {
                        j = 0;
                        ++i;
                    }
                }
            }
        }
    };

    __device__ __forceinline__ Row row(long b, int, int) const {
        return Row{packed + b * packed_pitch, vbits + b * vbits_pitch, L / 8, runs, e_magic};
    }

    // Every piece is staged whole.
    __device__ __forceinline__ bool clip(long, int, int, int&, int&) const { return true; }
};

inline PackedBatch ntsm_packed_batch(const void* packed, long packed_pitch, const void* vbits,
                                     long vbits_pitch, int B, int L) {
    const auto p = reinterpret_cast<uintptr_t>(packed), v = reinterpret_cast<uintptr_t>(vbits);
    const uint64_t E = static_cast<uint64_t>(L / 8);
    const bool runs = E % 8 == 0 && (p | v | packed_pitch | vbits_pitch) % 8 == 0;
    return PackedBatch{static_cast<const uint8_t*>(packed), packed_pitch,
                       static_cast<const uint8_t*>(vbits), vbits_pitch, B, L,
                       ntsm_stage_pieces(L), runs, ~0ULL / E + 1};
}

// The rows of a code batch: row b's L code bytes at codes + b * pitch, its
// read's length at lengths[b] (a pad row has length 0).
struct CodeBatch {
    const uint8_t* codes;
    long pitch;
    const int32_t* lengths;
    int B;
    int L;
    int pieces;   // ntsm_stage_pieces(L)
    bool runs;    // codes and pitch 8-byte aligned: a whole chunk is one 8-byte load
    bool clip_reads;  // stage a piece only as far as its read, serve only its windows

    // The decode of one row's chunks: the bases before `end` are read,
    // those before min(len, end) are inside the read.
    struct Row {
        const uint8_t* row;
        int len;
        int end;
        bool runs;

        __device__ __forceinline__ void chunk(unsigned m, unsigned& f, unsigned& r,
                                              unsigned& g) const {
            const int left = min(len, end) - static_cast<int>(m);  // bases inside from m on
            uint64_t x = 0;
            if (runs && static_cast<int>(m) + 8 <= end) {
                x = __ldg(reinterpret_cast<const unsigned long long*>(row + m));
            } else {
#pragma unroll
                for (int t = 0; t < 8; ++t)
                    if (static_cast<int>(m) + t < end)
                        x |= static_cast<uint64_t>(__ldg(row + m + t)) << (8 * t);
            }
            f = r = g = 0;
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                const unsigned v = static_cast<unsigned>(x >> (8 * t)) & 0xFFu;
                const unsigned code = v & 3u;
                f = (f << 2) | code;
                r |= (3u ^ code) << (2 * t);
                g |= static_cast<unsigned>(v <= 3u) << t;
            }
            g &= left >= 8 ? 0xFFu : left <= 0 ? 0u : (1u << left) - 1;
        }
    };

    // Bases [s, s + n) of row b are read.
    __device__ __forceinline__ Row row(long b, int s, int n) const {
        return Row{codes + b * pitch, lengths[b], s + n, runs};
    }

    // With clip_reads, the piece at s staging n bases and serving windows
    // [s, w_end) is cut to its read: n to the bases before the read's
    // length, w_end to the windows inside it; false when none is.
    __device__ __forceinline__ bool clip(long b, int s, int k, int& n, int& w_end) const {
        if (!clip_reads) return true;
        const int len = lengths[b];
        n = min(n, len - s);
        w_end = min(w_end, len - k + 1);
        return w_end > s;
    }
};

inline CodeBatch ntsm_code_batch(const void* codes, long pitch, const void* lengths, int B,
                                 int L, bool clip_reads) {
    const bool runs = (reinterpret_cast<uintptr_t>(codes) | pitch) % 8 == 0;
    return CodeBatch{static_cast<const uint8_t*>(codes), pitch,
                     static_cast<const int32_t*>(lengths), B, L, ntsm_stage_pieces(L), runs,
                     clip_reads};
}

// The launch of a stage kernel: kStageRows warps a block, each with its
// stage and `extra` bytes of the kernel's own; enough blocks for every
// piece of the batch, at most 32 an SM.
struct StageLaunch {
    int smem;       // dynamic shared memory bytes a block
    unsigned grid;  // blocks
};

inline StageLaunch ntsm_stage_launch(int B, int L, int extra = 0) {
    return StageLaunch{kStageRows * (ntsm_stage_bytes(L) + extra),
                       ntsm_grid(static_cast<long>(B) * ntsm_stage_pieces(L), kStageRows)};
}

// 2k bits of a word array from 2-bit position pos on: the k bases
// pos .. pos + k - 1, the first one most significant.  Reads words pos / 16
// .. pos / 16 + 2; a funnel shift takes a shift of 0 (a 32-bit shift by 32
// would be undefined).
__device__ __forceinline__ uint64_t ntsm_take_2k(const uint32_t* words, int pos, int k) {
    const int a = pos >> 4, t = 2 * (pos & 15);
    const uint32_t w0 = words[a], w1 = words[a + 1], w2 = words[a + 2];
    const uint64_t x = (static_cast<uint64_t>(__funnelshift_l(w1, w0, t)) << 32)
                       | __funnelshift_l(w2, w1, t);
    return x >> (64 - 2 * k);
}

struct WindowStage {
    uint32_t* fw;
    uint32_t* rc;
    uint32_t* good;
    int s;  // the staged piece: bases [s, s + n) of its row
    int n;

    // The stage of warp `warp` in a block's dynamic shared memory, whose
    // warps' slices are `stride` bytes apart (ntsm_stage_bytes and any
    // bytes of the kernel's own after it).
    static __device__ __forceinline__ WindowStage at(void* smem, int warp, int stride, int L) {
        const int nw = ntsm_stage_words(L < kStageBases ? L : kStageBases);
        uint8_t* base = static_cast<uint8_t*>(smem) + warp * stride;
        return WindowStage{reinterpret_cast<uint32_t*>(base),
                           reinterpret_cast<uint32_t*>(base + 8 * nw),
                           reinterpret_cast<uint32_t*>(base + 16 * nw), 0, 0};
    }

    // Stage bases [s0, s0 + n0) of row b (s0 a multiple of 8; n0 rounded up
    // to one, the bases past n0 zero and bad).  The whole warp calls this,
    // and may read the piece's windows when it returns.
    template <class Batch>
    __device__ __forceinline__ void load(const Batch& in, long b, int s0, int n0, int lane) {
        s = s0;
        n = (n0 + 7) & ~7;
        const int nc = n / 8;
        const typename Batch::Row row = in.row(b, s0, n0);
        uint16_t* fw16 = reinterpret_cast<uint16_t*>(fw);
        uint16_t* rc16 = reinterpret_cast<uint16_t*>(rc);
        uint8_t* good8 = reinterpret_cast<uint8_t*>(good);
        const int slots = 4 * ntsm_stage_words(n);
        __syncwarp();  // every lane is done with the last piece's windows
        for (int c = lane; c < slots; c += 32) {
            if (c >= nc) {  // past the piece: zero
                fw16[c ^ 1] = 0;
                rc16[c ^ 1] = 0;
                good8[c] = 0;
                continue;
            }
            unsigned f, r, g;
            row.chunk(static_cast<unsigned>(s + 8 * c), f, r, g);
            fw16[c ^ 1] = static_cast<uint16_t>(f);
            rc16[(nc - 1 - c) ^ 1] = static_cast<uint16_t>(r);
            good8[c] = static_cast<uint8_t>(g);
        }
        __syncwarp();
    }

    // Window w of the row (s <= w <= s + n - k): whether its k bases are
    // all good, and the hash of its canonical k-mer.
    __device__ __forceinline__ bool valid(int w, uint32_t kmask) const {
        const int x = w - s;
        const uint32_t g = __funnelshift_r(good[x >> 5], good[(x >> 5) + 1], x & 31);
        return (g & kmask) == kmask;
    }

    __device__ __forceinline__ uint64_t hash(int w, int k, uint64_t mask) const {
        const int x = w - s;
        const uint64_t f = ntsm_take_2k(fw, x, k);
        const uint64_t r = ntsm_take_2k(rc, n - x - k, k);
        return ntsm_hash64(f < r ? f : r, mask);
    }
};

// Every piece first, first + stride, ... of the batch's B x pieces through
// one warp's stage: body(b, w_begin, w_end) reads windows [w_begin, w_end)
// of row b (a piece the batch clips to nothing is skipped).
template <class Batch, class Body>
__device__ __forceinline__ void ntsm_stage_rows(WindowStage& st, const Batch& in, int k,
                                                int lane, long first, long stride, Body body) {
    const int W = in.L - k + 1;
    const long items = static_cast<long>(in.B) * in.pieces;
    for (long item = first; item < items; item += stride) {
        const long b = in.pieces == 1 ? item : item / in.pieces;
        const int t = static_cast<int>(item - b * in.pieces);
        const int s = t * kPieceWindows;
        const bool last = t == in.pieces - 1;
        int n = last ? in.L - s : kStageBases;
        int w_end = last ? W : s + kPieceWindows;
        if (!in.clip(b, s, k, n, w_end)) continue;
        st.load(in, b, s, n, lane);
        body(b, s, w_end);
    }
}

// The masks of k: the hash's 2k bits, the k good bits.
__host__ __device__ __forceinline__ uint64_t ntsm_kmer_mask(int k) {
    return k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
}

__host__ __device__ __forceinline__ uint32_t ntsm_good_mask(int k) {
    return k == 32 ? ~0u : ((1u << k) - 1);
}
