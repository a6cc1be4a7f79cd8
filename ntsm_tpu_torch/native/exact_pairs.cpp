// Copy of ntsm_tpu/native/exact_pairs.cpp, the port's own so that it builds no source of the JAX package.
// Vectorized host pair scorer for the exact (f64) eval engine.
//
// The reference scores each sample pair with a sequential O(sites) loop
// (computeLogLikelihood + calcRelatedness, src/CompareCounts.hpp:968-1099,
// 1144-1196).  The pure-Python exact engine replicates that per pair at
// ~45 pairs/s on this 1-core host; numpy's elementwise broadcast path
// measured ~30M site-cells/s — far below what the AVX-512 units can do.
// This kernel computes, for a block of (i, j) pairs, everything the
// output row needs, in two auto-vectorizable passes over the site axis:
//
//   pass 1 (int8):  the eight genotype tallies from the class planes
//                   (n, ibs0, sharedHet, sharedHom, het1/2, hom1/2)
//   pass 2 (f64):   sumLogPJoint and sumLogPSingle1+2 with the exact
//                   per-site arithmetic of the Python oracle (masked
//                   where-then-divide; see eval/exact.py:joint_sum)
//
// Per-site f64 values are bit-identical to the Python loop; only the
// order of the final summation differs (sequential here, numpy pairwise
// there) — a <=1 ulp effect that the fixed 6-decimal output formatting
// absorbs (verified by byte-parity fuzz tests, tests/test_exact_native.py).

#include <algorithm>
#include <cstdint>
#include <vector>
#include <cstring>

namespace {

// one pair's integer tallies; L-site loop over uint8 class planes.
// cls encoding matches eval/model.py: 0=UNKNOWN 1=HET 2=HOM_AT 3=HOM_CG
inline void tally_pair(const uint8_t* c1, const uint8_t* c2, long L,
                       int64_t* out /* [8] */) {
  long n = 0, ibs0 = 0, shet = 0, shom = 0, h1 = 0, o1 = 0, h2 = 0, o2 = 0;
  for (long s = 0; s < L; ++s) {
    int a = c1[s], b = c2[s];
    int v = (a != 0) & (b != 0);
    int het1 = (a == 1), het2 = (b == 1);
    int hat1 = (a == 2), hat2 = (b == 2);
    int hcg1 = (a == 3), hcg2 = (b == 3);
    n += v;
    shet += v & het1 & het2;
    shom += v & ((hat1 & hat2) | (hcg1 & hcg2));
    ibs0 += v & ((hat1 & hcg2) | (hcg1 & hat2));
    h1 += v & het1;
    h2 += v & het2;
    o1 += v & (hat1 | hcg1);
    o2 += v & (hat2 | hcg2);
  }
  out[0] = n;
  out[1] = ibs0;
  out[2] = shet;
  out[3] = shom;
  out[4] = h1;
  out[5] = h2;
  out[6] = o1;
  out[7] = o2;
}

// one pair's f64 sums: joint = sumLogPJoint over valid sites, ss = the
// (s_single1 + s_single2) sum over the same sites.  Branchless so the
// compiler can use masked vector blends + vdivpd.
inline void sums_pair(const double* a1, const double* b1, const double* a2,
                      const double* b2, const double* s1, const double* s2,
                      long L, double mc, double* joint_out, double* ss_out) {
  double js = 0.0, ss = 0.0;
  for (long s = 0; s < L; ++s) {
    double av = a1[s], bv = b1[s], aw = a2[s], bw = b2[s];
    // pair validity: each sample covered on at least one allele
    bool v = ((av > mc) | (bv > mc)) & ((aw > mc) | (bw > mc));
    double m = v ? 1.0 : 0.0;
    double aa = av + aw, bb = bv + bw;
    double den = aa + bb;
    double dsafe = den > 0.0 ? den : 1.0;  // valid implies den > 0
    double fa = aa > mc ? aa / dsafe : 0.0;
    double fb = bb > mc ? bb / dsafe : 0.0;
    js += m * (aa * fa + bb * fb);
    ss += m * (s1[s] + s2[s]);
  }
  *joint_out = js;
  *ss_out = ss;
}

}  // namespace

extern "C" {

// A/B: [N, L] f64 max-count planes (allele AT / CG); CLS: [N, L] u8 class
// planes; S: [N, L] f64 s_single plane; ii/jj: [P] pair indices.
// Outputs: joint [P], ss [P] (s1+s2 sums), tallies [P, 8] int64 in the
// order (n, ibs0, sharedHets, sharedHoms, hets1, hets2, homs1, homs2).
void ntsm_exact_pairs(const double* A, const double* B, const uint8_t* CLS,
                      const double* S, long N, long L, double mc,
                      const int32_t* ii, const int32_t* jj, long P,
                      double* joint, double* ss, int64_t* tallies) {
  (void)N;
  for (long p = 0; p < P; ++p) {
    const long i = ii[p], j = jj[p];
    tally_pair(CLS + i * L, CLS + j * L, L, tallies + p * 8);
    sums_pair(A + i * L, B + i * L, A + j * L, B + j * L, S + i * L,
              S + j * L, L, mc, joint + p, ss + p);
  }
}

}  // extern "C"

extern "C" {

// Exact-engine PCA projection accumulator with the reference's exact
// type semantics (CompareCounts.hpp:173-210 + std::inner_product):
// vals are double (the q - center long-double subtraction rounded once
// on store), rot entries are long double (strtold), and the running
// accumulator is DOUBLE, re-rounded after every (double x long double)
// product-add — numpy's all-long-double matmul with one final cast
// differs in the last f64 ulp at cohort scale.
// vals: [n, L] f64 row block; rotT: [L, dim] long double; out: [n, dim].
void ntsm_project_exact(const double* vals, const long double* rotT,
                        long n, long L, long dim, double* out) {
  // j-outer with a per-component double accumulator row: each acc[d]
  // sees the same per-step rounding sequence as the reference's
  // inner_product over ascending j, and rotT rows load contiguously
  std::vector<double> acc(static_cast<size_t>(dim));
  for (long i = 0; i < n; ++i) {
    const double* v = vals + i * L;
    std::fill(acc.begin(), acc.end(), 0.0);
    for (long j = 0; j < L; ++j) {
      const double vj = v[j];
      const long double* r = rotT + j * dim;
      for (long d = 0; d < dim; ++d) {
        acc[d] = acc[d] + vj * r[d];
      }
    }
    for (long d = 0; d < dim; ++d) out[i * dim + d] = acc[d];
  }
}

}  // extern "C"

extern "C" {

// One-sweep genotype quantization for the fast (f64) PCA projection:
// vals[i,j] = quantize(counts) - norm[j] with the exact arithmetic of
// eval/pca.py:_project_rows' numpy passes (g = f64(ca)/f64(den), the
// reference's 0.25/0.75 sign tests, exact 0.0 for missing sites) — one
// read+write pass instead of ~19 full-width numpy passes (the numpy
// form moves ~1.9 GB per 128-row block and is the -p load's largest
// host term).  dsize selects the count dtype: 1=u8, 2=u16, 4=i32,
// 8=i64.  ctypes releases the GIL for the call, so the parse thread
// keeps running while a block quantizes.
// apitch/bpitch: row strides in ELEMENTS (the eval wire hands [m, :L]
// column views of [m, Lp] planes, so pitch >= L).
void ntsm_quantize_vals(const void* a, const void* b, int dsize, long m,
                        long L, long apitch, long bpitch,
                        const double* norm, double mc, double* vals) {
  for (long i = 0; i < m; ++i) {
    const uint8_t* a8 = static_cast<const uint8_t*>(a) + i * apitch * dsize;
    const uint8_t* b8 = static_cast<const uint8_t*>(b) + i * bpitch * dsize;
    double* v = vals + i * L;
    for (long j = 0; j < L; ++j) {
      double av, bv;
      switch (dsize) {
        case 1: av = a8[j]; bv = b8[j]; break;
        case 2: av = reinterpret_cast<const uint16_t*>(a8)[j];
                bv = reinterpret_cast<const uint16_t*>(b8)[j]; break;
        case 4: av = reinterpret_cast<const int32_t*>(a8)[j];
                bv = reinterpret_cast<const int32_t*>(b8)[j]; break;
        default: av = static_cast<double>(
                     reinterpret_cast<const int64_t*>(a8)[j]);
                 bv = static_cast<double>(
                     reinterpret_cast<const int64_t*>(b8)[j]);
      }
      double ca = av > mc ? av : 0.0;
      double cb = bv > mc ? bv : 0.0;
      double den = ca + cb;
      if (den == 0.0) {
        v[j] = 0.0;  // missing sites stay EXACTLY 0.0 (not 0 - center)
      } else {
        double g = ca / den;
        double q = (g - 0.25) < 0.0 ? 0.0 : (g - 0.75) < 0.0 ? 0.5 : 1.0;
        v[j] = q - norm[j];
      }
    }
  }
}

}  // extern "C"
