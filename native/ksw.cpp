// Host-side Smith-Waterman DP kernels (C++), exact ksw_* semantics.
//
// Native versions of the three DP routines in lariat_tpu/align/ksw.py (the
// reference's C hot loops #2/#3 and mate-rescue SW). Used by the worker
// processes; the batched JAX versions in lariat_tpu/ops cover the device path.
// Semantics are asserted equal to the Python reference by the existing ksw
// test suite (the Python wrappers dispatch here when the library is built).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

namespace {

constexpr int32_t NEG = -0x40000000;

inline int32_t score_sub(int q, int t, int match_sc, int mismatch_sc,
                         int n_sc) {
  if (q >= 4 || t >= 4) return n_sc;
  return q == t ? match_sc : mismatch_sc;
}

}  // namespace

extern "C" {

// ksw_extend2. out: [score, qle, tle, gtle, gscore, max_off].
void ksw_extend_one(const uint8_t* query, int qlen, const uint8_t* target,
                    int tlen, int o_del, int e_del, int o_ins, int e_ins,
                    int w, int end_bonus, int zdrop, int h0, int match_sc,
                    int mismatch_sc, int n_sc, int32_t* out) {
  if (qlen == 0) {
    out[0] = h0; out[1] = 0; out[2] = 0; out[3] = 0; out[4] = h0; out[5] = 0;
    return;
  }
  int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  int max_sc = match_sc;
  int max_ins = (int)(((double)qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0);
  if (max_ins < 1) max_ins = 1;
  int max_del = (int)(((double)qlen * max_sc + end_bonus - o_del) / e_del + 1.0);
  if (max_del < 1) max_del = 1;
  w = std::min(w, std::min(max_ins, max_del));
  std::vector<int32_t> eh_h(qlen + 2, 0), eh_e(qlen + 2, 0);
  eh_h[0] = h0;
  eh_h[1] = h0 > oe_ins ? h0 - oe_ins : 0;
  for (int j = 2; j <= qlen && eh_h[j - 1] > e_ins; ++j)
    eh_h[j] = eh_h[j - 1] - e_ins;
  int32_t max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1,
          max_off = 0;
  for (int i = 0; i < tlen; ++i) {
    int beg = i > w ? i - w : 0;
    int end = std::min(i + w + 1, qlen);
    if (beg >= end) {
      if (beg == qlen && gscore < 0) { max_ie = i; gscore = 0; }
      break;
    }
    int32_t f = 0, m = 0, mj = -1, h1;
    if (beg == 0) {
      h1 = h0 - (o_del + e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    } else {
      h1 = 0;
    }
    int tc = target[i];
    for (int j = beg; j < end; ++j) {
      int32_t M = eh_h[j], e = eh_e[j];
      eh_h[j] = h1;
      M = M ? M + score_sub(query[j], tc, match_sc, mismatch_sc, n_sc) : 0;
      int32_t h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (m <= h) { mj = j; m = h; }
      int32_t t = M - oe_del;
      t = t > 0 ? t : 0;
      e -= e_del;
      e = e > t ? e : t;
      eh_e[j] = e;
      t = M - oe_ins;
      t = t > 0 ? t : 0;
      f -= e_ins;
      f = f > t ? f : t;
    }
    eh_h[end] = h1;
    eh_e[end] = 0;
    if (end == qlen && gscore < h1) { max_ie = i; gscore = h1; }
    if (m == 0) break;
    if (m > max_score) {
      max_score = m; max_i = i; max_j = mj;
      if (std::abs(mj - i) > max_off) max_off = std::abs(mj - i);
    } else if (zdrop > 0) {
      if (i - max_i > mj - max_j) {
        if (max_score - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop) break;
      } else {
        if (max_score - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop) break;
      }
    }
  }
  out[0] = max_score; out[1] = max_j + 1; out[2] = max_i + 1;
  out[3] = max_ie + 1; out[4] = gscore; out[5] = max_off;
}

// ksw_global2 with traceback. cigar_out holds (op, len) int32 pairs; returns
// number of ops, or -1 if cigar_cap exceeded. score written to *score_out.
// Ops: 0=M, 1=I, 2=D.
// Traceback is only defined for w >= |qlen - tlen| (band covers the end
// cell); all engine call sites guarantee this (_infer_bw). For narrower
// bands upstream bwa reads uninitialized malloc memory in the walk; here the
// walk reads zero/neighbor bytes instead (score is still exact).
// Traceback over a filled direction matrix (z, tlen x n_col). Shared by the
// scalar and 8-lane SIMD global kernels — the SIMD kernel produces z bytes
// bit-identical to the scalar fill, so the walk (and thus the CIGAR) is
// identical by construction.
static int32_t ksw_global_traceback(const uint8_t* z, int n_col, int qlen,
                                    int tlen, int w, int32_t* cigar_out,
                                    int32_t cigar_cap) {
  int n_ops = 0;
  auto push = [&](int op, int ln) -> bool {
    if (n_ops && cigar_out[2 * (n_ops - 1)] == op) {
      cigar_out[2 * (n_ops - 1) + 1] += ln;
      return true;
    }
    if (n_ops >= cigar_cap) return false;
    cigar_out[2 * n_ops] = op;
    cigar_out[2 * n_ops + 1] = ln;
    ++n_ops;
    return true;
  };
  int which = 0, i = tlen - 1;
  int k = std::min(i + w + 1, qlen) - 1;
  while (i >= 0 && k >= 0) {
    int beg = i > w ? i - w : 0;
    which = (z[(size_t)i * n_col + (k - beg)] >> (which << 1)) & 3;
    bool ok;
    if (which == 0) { ok = push(0, 1); --i; --k; }
    else if (which == 1) { ok = push(2, 1); --i; }
    else { ok = push(1, 1); --k; }
    if (!ok) return -1;
  }
  if (i >= 0 && !push(2, i + 1)) return -1;
  if (k >= 0 && !push(1, k + 1)) return -1;
  // reverse op pairs
  for (int a = 0, b = n_ops - 1; a < b; ++a, --b) {
    std::swap(cigar_out[2 * a], cigar_out[2 * b]);
    std::swap(cigar_out[2 * a + 1], cigar_out[2 * b + 1]);
  }
  return n_ops;
}

int32_t ksw_global_one(const uint8_t* query, int qlen, const uint8_t* target,
                       int tlen, int o_del, int e_del, int o_ins, int e_ins,
                       int w, int match_sc, int mismatch_sc, int n_sc,
                       int32_t* score_out, int32_t* cigar_out,
                       int32_t cigar_cap) {
  if (qlen == 0 || tlen == 0) { *score_out = NEG; return 0; }
  int gapoe_del = o_del + e_del, gapoe_ins = o_ins + e_ins;
  int n_col = std::min(qlen, 2 * w + 1);
  std::vector<uint8_t> z((size_t)tlen * n_col, 0);
  std::vector<int32_t> eh_h(qlen + 2, NEG), eh_e(qlen + 2, NEG);
  eh_h[0] = 0;
  for (int j = 1; j <= qlen && j <= w; ++j) eh_h[j] = -(o_ins + e_ins * j);
  for (int i = 0; i < tlen; ++i) {
    int beg = i > w ? i - w : 0;
    int end = std::min(i + w + 1, qlen);
    if (beg >= end) break;
    int32_t f = NEG, h1 = beg == 0 ? -(o_del + e_del * (i + 1)) : NEG;
    uint8_t* zi = &z[(size_t)i * n_col];
    int tc = target[i];
    for (int j = beg; j < end; ++j) {
      int32_t M = eh_h[j], e = eh_e[j];
      eh_h[j] = h1;
      M += score_sub(query[j], tc, match_sc, mismatch_sc, n_sc);
      uint8_t d = M >= e ? 0 : 1;
      int32_t h = M >= e ? M : e;
      d = h >= f ? d : 2;
      h = h >= f ? h : f;
      h1 = h;
      int32_t t = M - gapoe_del;
      e -= e_del;
      if (e > t) d |= 1 << 2; else e = t;
      eh_e[j] = e;
      t = M - gapoe_ins;
      f -= e_ins;
      if (f > t) d |= 2 << 4; else f = t;
      zi[j - beg] = d;
    }
    eh_h[end] = h1;
    eh_e[end] = NEG;
  }
  *score_out = eh_h[qlen];
  return ksw_global_traceback(z.data(), n_col, qlen, tlen, w, cigar_out,
                              cigar_cap);
}

#ifdef __SSE2__
// 8-lane inter-task banded global DP fill (int16). All 8 tasks share
// (qlen, tlen, w), so every lane has the same band geometry and the scalar
// recurrence vectorizes across tasks with no per-lane control flow. The
// direction bytes are produced bit-identically to ksw_global_one's fill
// (same comparisons, same bit layout), so running the shared traceback over
// each lane's z yields the identical CIGAR. Sentinel: the scalar kernel's
// NEG (-2^30) class becomes -28000 in int16; every comparison in the
// recurrence depends only on (class, delta-from-sentinel), and deltas decay
// by at most ~20 per cell chain, so no int16 overflow and identical
// outcomes as long as real scores stay under ~16000 (caller guards
// qlen*match). Requires w >= |qlen - tlen| (caller guards) so the final
// cell is real-class and lane scores equal the scalar's.
// z8: 8 lane matrices of tlen*n_col bytes each, caller-zeroed.
extern "C" void ksw_global_fill8(const uint8_t* q8, const uint8_t* t8,
                                 int qlen, int tlen, int o_del, int e_del,
                                 int o_ins, int e_ins, int w, int match_sc,
                                 int mismatch_sc, int n_sc,
                                 int32_t* scores8, uint8_t* z8) {
  const int16_t NEG16 = -28000;
  const int n_col = std::min(qlen, 2 * w + 1);
  const int gapoe_del = o_del + e_del, gapoe_ins = o_ins + e_ins;
  std::vector<__m128i> qv(qlen), tv(tlen), eh_h(qlen + 2), eh_e(qlen + 2),
      drow(n_col);
  for (int j = 0; j < qlen; ++j) {
    int16_t* p = (int16_t*)&qv[j];
    for (int l = 0; l < 8; ++l) p[l] = q8[(size_t)l * qlen + j];
  }
  for (int i = 0; i < tlen; ++i) {
    int16_t* p = (int16_t*)&tv[i];
    for (int l = 0; l < 8; ++l) p[l] = t8[(size_t)l * tlen + i];
  }
  const __m128i vneg = _mm_set1_epi16(NEG16);
  for (int j = 0; j < qlen + 2; ++j) {
    eh_h[j] = vneg;
    eh_e[j] = vneg;
  }
  eh_h[0] = _mm_setzero_si128();
  for (int j = 1; j <= qlen && j <= w; ++j)
    eh_h[j] = _mm_set1_epi16((int16_t)(-(o_ins + e_ins * j)));
  const __m128i vmatch = _mm_set1_epi16((int16_t)match_sc);
  const __m128i vmis = _mm_set1_epi16((int16_t)mismatch_sc);
  const __m128i vn = _mm_set1_epi16((int16_t)n_sc);
  const __m128i v3 = _mm_set1_epi16(3);
  const __m128i v1 = _mm_set1_epi16(1);
  const __m128i v2 = _mm_set1_epi16(2);
  const __m128i v4 = _mm_set1_epi16(4);
  const __m128i v32 = _mm_set1_epi16(32);
  const __m128i vgoe_d = _mm_set1_epi16((int16_t)gapoe_del);
  const __m128i ve_d = _mm_set1_epi16((int16_t)e_del);
  const __m128i vgoe_i = _mm_set1_epi16((int16_t)gapoe_ins);
  const __m128i ve_i = _mm_set1_epi16((int16_t)e_ins);
  for (int i = 0; i < tlen; ++i) {
    int beg = i > w ? i - w : 0;
    int end = std::min(i + w + 1, qlen);
    if (beg >= end) break;
    __m128i f = vneg;
    __m128i h1 = beg == 0
        ? _mm_set1_epi16((int16_t)(-(o_del + e_del * (i + 1)))) : vneg;
    const __m128i vt = tv[i];
    const __m128i t_is_n = _mm_cmpgt_epi16(vt, v3);
    for (int j = beg; j < end; ++j) {
      __m128i M = eh_h[j], e = eh_e[j];
      eh_h[j] = h1;
      __m128i vq = qv[j];
      __m128i eq = _mm_cmpeq_epi16(vq, vt);
      __m128i isn = _mm_or_si128(_mm_cmpgt_epi16(vq, v3), t_is_n);
      __m128i sub = _mm_or_si128(_mm_and_si128(eq, vmatch),
                                 _mm_andnot_si128(eq, vmis));
      sub = _mm_or_si128(_mm_and_si128(isn, vn),
                         _mm_andnot_si128(isn, sub));
      M = _mm_add_epi16(M, sub);
      __m128i m_lt_e = _mm_cmpgt_epi16(e, M);
      __m128i d = _mm_and_si128(m_lt_e, v1);
      __m128i h = _mm_max_epi16(M, e);
      __m128i h_lt_f = _mm_cmpgt_epi16(f, h);
      d = _mm_or_si128(_mm_andnot_si128(h_lt_f, d),
                       _mm_and_si128(h_lt_f, v2));
      h = _mm_max_epi16(h, f);
      h1 = h;
      __m128i t1 = _mm_sub_epi16(M, vgoe_d);
      e = _mm_sub_epi16(e, ve_d);
      d = _mm_or_si128(d, _mm_and_si128(_mm_cmpgt_epi16(e, t1), v4));
      e = _mm_max_epi16(e, t1);
      eh_e[j] = e;
      __m128i t2 = _mm_sub_epi16(M, vgoe_i);
      f = _mm_sub_epi16(f, ve_i);
      d = _mm_or_si128(d, _mm_and_si128(_mm_cmpgt_epi16(f, t2), v32));
      f = _mm_max_epi16(f, t2);
      drow[j - beg] = d;
    }
    eh_h[end] = h1;
    eh_e[end] = vneg;
    // scatter the row's direction vectors into the 8 per-lane z matrices:
    // 8x8 int16 transpose per block, then pack to bytes (d <= 63)
    const int row_n = end - beg;
    int jb = 0;
    for (; jb + 8 <= row_n; jb += 8) {
      __m128i r0 = drow[jb], r1 = drow[jb + 1], r2 = drow[jb + 2],
              r3 = drow[jb + 3], r4 = drow[jb + 4], r5 = drow[jb + 5],
              r6 = drow[jb + 6], r7 = drow[jb + 7];
      __m128i a0 = _mm_unpacklo_epi16(r0, r1), a1 = _mm_unpackhi_epi16(r0, r1);
      __m128i a2 = _mm_unpacklo_epi16(r2, r3), a3 = _mm_unpackhi_epi16(r2, r3);
      __m128i a4 = _mm_unpacklo_epi16(r4, r5), a5 = _mm_unpackhi_epi16(r4, r5);
      __m128i a6 = _mm_unpacklo_epi16(r6, r7), a7 = _mm_unpackhi_epi16(r6, r7);
      __m128i b0 = _mm_unpacklo_epi32(a0, a2), b1 = _mm_unpackhi_epi32(a0, a2);
      __m128i b2 = _mm_unpacklo_epi32(a1, a3), b3 = _mm_unpackhi_epi32(a1, a3);
      __m128i b4 = _mm_unpacklo_epi32(a4, a6), b5 = _mm_unpackhi_epi32(a4, a6);
      __m128i b6 = _mm_unpacklo_epi32(a5, a7), b7 = _mm_unpackhi_epi32(a5, a7);
      __m128i lanes[8] = {
          _mm_unpacklo_epi64(b0, b4), _mm_unpackhi_epi64(b0, b4),
          _mm_unpacklo_epi64(b1, b5), _mm_unpackhi_epi64(b1, b5),
          _mm_unpacklo_epi64(b2, b6), _mm_unpackhi_epi64(b2, b6),
          _mm_unpacklo_epi64(b3, b7), _mm_unpackhi_epi64(b3, b7)};
      for (int l = 0; l < 8; ++l) {
        _mm_storel_epi64(
            (__m128i*)(z8 + ((size_t)l * tlen + i) * n_col + jb),
            _mm_packus_epi16(lanes[l], lanes[l]));
      }
    }
    for (; jb < row_n; ++jb) {
      const int16_t* dv = (const int16_t*)&drow[jb];
      for (int l = 0; l < 8; ++l)
        z8[((size_t)l * tlen + i) * n_col + jb] = (uint8_t)dv[l];
    }
  }
  const int16_t* hv = (const int16_t*)&eh_h[qlen];
  for (int l = 0; l < 8; ++l) scores8[l] = hv[l];
}

// C-ABI traceback over one lane's z matrix (for tests and align1.cpp).
extern "C" int32_t ksw_global_traceback_z(const uint8_t* z, int n_col,
                                          int qlen, int tlen, int w,
                                          int32_t* cigar_out,
                                          int32_t cigar_cap) {
  return ksw_global_traceback(z, n_col, qlen, tlen, w, cigar_out, cigar_cap);
}

// Striped (Farrar) local SW, 16x uint8 lanes. Bit-exact vs the scalar core
// under the same two exactness fixes as the int16 kernel below (E re-opened
// from F-raised H in the lazy-F fixup; padded lanes masked out of row
// maxima). Works in the unsigned domain: H/E/F are stored as their true
// values (local SW floors at 0, so no bias on state), only the substitution
// profile carries bias B = -min(sub); `subs_epu8` supplies every max(.,0).
// Pad lanes occupy the highest stripe lanes (largest j), so their F can
// only shift further up and never reaches a real lane — the fixup break
// test is therefore masked to real lanes, which is exact and avoids
// pad-driven extra fixup sweeps. Returns false when the uint8 range is
// unsafe (any reachable H + match + B could touch 255).
static bool local_core_sse_u8(const uint8_t* query, int qlen,
                              const uint8_t* target, int tlen, int o_del,
                              int e_del, int o_ins, int e_ins, int minsc,
                              int endsc, int match_sc, int mismatch_sc,
                              int n_sc, int32_t* out) {
  const int B = std::max(0, -std::min(mismatch_sc, n_sc));
  if (qlen < 2 || match_sc <= 0) return false;
  if ((int64_t)qlen * match_sc + match_sc + B > 254) return false;
  if (o_del + e_del > 254 || o_ins + e_ins > 254 || B + match_sc > 254)
    return false;
  const int nseg = (qlen + 15) / 16;
  std::vector<__m128i> prof(5 * nseg), E(nseg), H0(nseg), H1(nseg),
      mask(nseg), best(nseg);
  for (int t = 0; t < 5; ++t) {
    uint8_t* p = (uint8_t*)&prof[t * nseg];
    for (int s = 0; s < nseg; ++s)
      for (int l = 0; l < 16; ++l) {
        int j = s + l * nseg;
        p[s * 16 + l] = j < qlen
            ? (uint8_t)(score_sub(query[j], t, match_sc, mismatch_sc, n_sc)
                        + B)
            : 0;
      }
  }
  for (int s = 0; s < nseg; ++s) {
    uint8_t* m = (uint8_t*)&mask[s];
    for (int l = 0; l < 16; ++l)
      m[l] = (s + l * nseg) < qlen ? 0xFF : 0;
    E[s] = _mm_setzero_si128();
    H0[s] = _mm_setzero_si128();
  }
  const __m128i zero = _mm_setzero_si128();
  const __m128i vbias = _mm_set1_epi8((char)B);
  const __m128i voe_del = _mm_set1_epi8((char)(o_del + e_del));
  const __m128i ve_del = _mm_set1_epi8((char)e_del);
  const __m128i voe_ins = _mm_set1_epi8((char)(o_ins + e_ins));
  const __m128i ve_ins = _mm_set1_epi8((char)e_ins);
  int32_t gmax = 0, te = -1;
  bool have_best = false;
  std::vector<std::pair<int32_t, int32_t>> col_bests;
  for (int i = 0; i < tlen; ++i) {
    const __m128i* P = &prof[(size_t)target[i] * nseg];
    __m128i vF = zero;
    __m128i vH = _mm_slli_si128(H0[nseg - 1], 1);  // diag, 0 at lane 0
    __m128i vmax = zero;
    for (int s = 0; s < nseg; ++s) {
      // max(diag + sub, 0) via saturating add of biased profile then
      // saturating un-bias; exact because diag+sub+B <= 254 by the guard.
      __m128i h = _mm_subs_epu8(_mm_adds_epu8(vH, P[s]), vbias);
      h = _mm_max_epu8(h, E[s]);
      h = _mm_max_epu8(h, vF);
      vmax = _mm_max_epu8(vmax, _mm_and_si128(h, mask[s]));
      H1[s] = h;
      E[s] = _mm_max_epu8(_mm_subs_epu8(E[s], ve_del),
                          _mm_subs_epu8(h, voe_del));
      vF = _mm_max_epu8(_mm_subs_epu8(vF, ve_ins),
                        _mm_subs_epu8(h, voe_ins));
      vH = H0[s];
    }
    // lazy-F fixup across the lane wrap (exact: E re-opened from raised H)
    vF = _mm_slli_si128(vF, 1);
    for (int k = 0; k < 16; ++k) {
      int s = 0;
      for (; s < nseg; ++s) {
        __m128i h = _mm_max_epu8(H1[s], vF);
        H1[s] = h;
        vmax = _mm_max_epu8(vmax, _mm_and_si128(h, mask[s]));
        E[s] = _mm_max_epu8(E[s], _mm_subs_epu8(h, voe_del));
        __m128i thr = _mm_subs_epu8(h, voe_ins);
        vF = _mm_subs_epu8(vF, ve_ins);
        // continue only while vF > thr in some REAL lane (pad F never
        // reaches a real lane; see header comment)
        __m128i adv = _mm_and_si128(_mm_subs_epu8(vF, thr), mask[s]);
        if (_mm_movemask_epi8(_mm_cmpeq_epi8(adv, zero)) == 0xFFFF) {
          s = -1;
          break;
        }
      }
      if (s == -1) break;
      vF = _mm_slli_si128(vF, 1);
    }
    // horizontal max of vmax (uint8)
    __m128i t1 = _mm_max_epu8(vmax, _mm_srli_si128(vmax, 8));
    t1 = _mm_max_epu8(t1, _mm_srli_si128(t1, 4));
    t1 = _mm_max_epu8(t1, _mm_srli_si128(t1, 2));
    t1 = _mm_max_epu8(t1, _mm_srli_si128(t1, 1));
    int32_t col_max = _mm_extract_epi16(t1, 0) & 0xFF;
    std::swap(H0, H1);
    if (col_max >= minsc) {
      if (col_bests.empty() || col_bests.back().second + 1 != i)
        col_bests.push_back({col_max, i});
      else if (col_bests.back().first < col_max)
        col_bests.back() = {col_max, i};
    }
    if (col_max > gmax) {
      gmax = col_max;
      te = i;
      best = H0;
      have_best = true;
      if (gmax >= endsc) break;
    }
  }
  if (te < 0 || !have_best) {
    out[0] = 0; out[1] = -1; out[2] = -1; out[3] = -1; out[4] = -1;
    return true;
  }
  // unstripe the saved best row; qe = FIRST position achieving the max
  int32_t qe = 0, qbest = -1;
  for (int j = 0; j < qlen; ++j) {
    int s = j % nseg, l = j / nseg;
    int32_t v = ((const uint8_t*)&best[s])[l];
    if (v > qbest) { qbest = v; qe = j; }
  }
  int32_t score2 = -1, te2 = -1;
  int radius = (gmax + match_sc - 1) / match_sc;
  for (auto& cb : col_bests) {
    if ((cb.second < te - radius || cb.second > te + radius)
        && cb.first > score2) {
      score2 = cb.first;
      te2 = cb.second;
    }
  }
  out[0] = gmax; out[1] = te; out[2] = qe; out[3] = score2; out[4] = te2;
  return true;
}

// Striped (Farrar) local SW, 8x int16 lanes. Bit-exact vs the scalar core:
// the lazy-F fixup also re-opens E from F-raised H cells (plain Farrar/ksw
// omit that and underestimate I->D transitions), and padded lanes are
// masked out of the row maxima. Returns false when int16 range is unsafe.
static bool local_core_sse(const uint8_t* query, int qlen,
                           const uint8_t* target, int tlen, int o_del,
                           int e_del, int o_ins, int e_ins, int minsc,
                           int endsc, int match_sc, int mismatch_sc,
                           int n_sc, int32_t* out) {
  if ((int64_t)qlen * match_sc > 30000 || qlen < 2) return false;
  const int nseg = (qlen + 7) / 8;
  const int16_t PAD = -30000;
  std::vector<__m128i> prof(5 * nseg), E(nseg), H0(nseg), H1(nseg),
      mask(nseg), best(nseg);
  for (int t = 0; t < 5; ++t) {
    int16_t* p = (int16_t*)&prof[t * nseg];
    for (int s = 0; s < nseg; ++s)
      for (int l = 0; l < 8; ++l) {
        int j = s + l * nseg;
        p[s * 8 + l] = j < qlen
            ? (int16_t)score_sub(query[j], t, match_sc, mismatch_sc, n_sc)
            : PAD;
      }
  }
  for (int s = 0; s < nseg; ++s) {
    int16_t* m = (int16_t*)&mask[s];
    for (int l = 0; l < 8; ++l)
      m[l] = (s + l * nseg) < qlen ? (int16_t)-1 : 0;
    E[s] = _mm_setzero_si128();
    H0[s] = _mm_setzero_si128();
  }
  const __m128i zero = _mm_setzero_si128();
  const __m128i voe_del = _mm_set1_epi16((int16_t)(o_del + e_del));
  const __m128i ve_del = _mm_set1_epi16((int16_t)e_del);
  const __m128i voe_ins = _mm_set1_epi16((int16_t)(o_ins + e_ins));
  const __m128i ve_ins = _mm_set1_epi16((int16_t)e_ins);
  int32_t gmax = 0, te = -1;
  bool have_best = false;
  std::vector<std::pair<int32_t, int32_t>> col_bests;
  for (int i = 0; i < tlen; ++i) {
    const __m128i* P = &prof[(size_t)target[i] * nseg];
    __m128i vF = zero;
    __m128i vH = _mm_slli_si128(H0[nseg - 1], 2);  // diag, 0 at lane 0
    __m128i vmax = zero;
    for (int s = 0; s < nseg; ++s) {
      __m128i h = _mm_adds_epi16(vH, P[s]);
      h = _mm_max_epi16(h, E[s]);
      h = _mm_max_epi16(h, vF);
      h = _mm_max_epi16(h, zero);
      vmax = _mm_max_epi16(vmax, _mm_and_si128(h, mask[s]));
      H1[s] = h;
      __m128i hd = _mm_subs_epi16(h, voe_del);
      E[s] = _mm_max_epi16(_mm_max_epi16(_mm_subs_epi16(E[s], ve_del), hd),
                           zero);
      __m128i hi = _mm_subs_epi16(h, voe_ins);
      vF = _mm_max_epi16(_mm_max_epi16(_mm_subs_epi16(vF, ve_ins), hi),
                         zero);
      vH = H0[s];
    }
    // lazy-F fixup across the lane wrap (exact: E re-opened from raised H)
    vF = _mm_slli_si128(vF, 2);
    for (int k = 0; k < 8; ++k) {
      int s = 0;
      for (; s < nseg; ++s) {
        __m128i h = _mm_max_epi16(H1[s], vF);
        H1[s] = h;
        vmax = _mm_max_epi16(vmax, _mm_and_si128(h, mask[s]));
        E[s] = _mm_max_epi16(E[s], _mm_subs_epi16(h, voe_del));
        __m128i thr =
            _mm_max_epi16(_mm_subs_epi16(h, voe_ins), zero);
        vF = _mm_subs_epi16(vF, ve_ins);
        if (!_mm_movemask_epi8(_mm_cmpgt_epi16(vF, thr))) { s = -1; break; }
      }
      if (s == -1) break;
      vF = _mm_slli_si128(vF, 2);
    }
    // horizontal max of vmax
    __m128i t1 = _mm_max_epi16(vmax, _mm_srli_si128(vmax, 8));
    t1 = _mm_max_epi16(t1, _mm_srli_si128(t1, 4));
    t1 = _mm_max_epi16(t1, _mm_srli_si128(t1, 2));
    int32_t col_max = (int16_t)_mm_extract_epi16(t1, 0);
    std::swap(H0, H1);
    if (col_max >= minsc) {
      if (col_bests.empty() || col_bests.back().second + 1 != i)
        col_bests.push_back({col_max, i});
      else if (col_bests.back().first < col_max)
        col_bests.back() = {col_max, i};
    }
    if (col_max > gmax) {
      gmax = col_max;
      te = i;
      best = H0;
      have_best = true;
      if (gmax >= endsc) break;
    }
  }
  if (te < 0 || !have_best) {
    out[0] = 0; out[1] = -1; out[2] = -1; out[3] = -1; out[4] = -1;
    return true;
  }
  // unstripe the saved best row; qe = FIRST position achieving the max
  int32_t qe = 0, qbest = -0x8000;
  for (int j = 0; j < qlen; ++j) {
    int s = j % nseg, l = j / nseg;
    int16_t v = ((const int16_t*)&best[s])[l];
    if (v > qbest) { qbest = v; qe = j; }
  }
  int32_t score2 = -1, te2 = -1;
  int radius = (gmax + match_sc - 1) / match_sc;
  for (auto& cb : col_bests) {
    if ((cb.second < te - radius || cb.second > te + radius)
        && cb.first > score2) {
      score2 = cb.first;
      te2 = cb.second;
    }
  }
  out[0] = gmax; out[1] = te; out[2] = qe; out[3] = score2; out[4] = te2;
  return true;
}
#endif  // __SSE2__

// ksw local SW, one direction: fills [score, te, qe, score2, te2].
static void local_core(const uint8_t* query, int qlen, const uint8_t* target,
                       int tlen, int o_del, int e_del, int o_ins, int e_ins,
                       int minsc, int endsc, int match_sc, int mismatch_sc,
                       int n_sc, int32_t* out) {
#ifdef __SSE2__
  if (local_core_sse_u8(query, qlen, target, tlen, o_del, e_del, o_ins,
                        e_ins, minsc, endsc, match_sc, mismatch_sc, n_sc,
                        out))
    return;
  if (local_core_sse(query, qlen, target, tlen, o_del, e_del, o_ins, e_ins,
                     minsc, endsc, match_sc, mismatch_sc, n_sc, out))
    return;
#endif
  int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  std::vector<int32_t> H_prev(qlen, 0), E(qlen, 0), H(qlen, 0);
  int32_t gmax = 0, te = -1;
  std::vector<int32_t> best_col;
  // merged consecutive-column maxima: (max, col)
  std::vector<std::pair<int32_t, int32_t>> col_bests;
  for (int i = 0; i < tlen; ++i) {
    int tc = target[i];
    int32_t f = 0;
    int32_t col_max = 0;
    for (int j = 0; j < qlen; ++j) {
      int32_t diag = j > 0 ? H_prev[j - 1] : 0;
      int32_t M = diag + score_sub(query[j], tc, match_sc, mismatch_sc, n_sc);
      int32_t h0v = std::max({M, E[j], 0});
      // F from final H of previous cells (dominance: scan over h0 works
      // only if F itself propagates; do the exact per-cell chain instead)
      int32_t h = std::max(h0v, f);
      int32_t t = h - oe_ins;   // NOTE: ksw local opens gaps from final h
      f = std::max(f - e_ins, t > 0 ? t : 0);
      if (f < 0) f = 0;
      E[j] = std::max({E[j] - e_del, h - oe_del, 0});
      H[j] = h;
      if (h > col_max) col_max = h;
    }
    std::swap(H_prev, H);
    if (col_max >= minsc) {
      if (col_bests.empty() || col_bests.back().second + 1 != i)
        col_bests.push_back({col_max, i});
      else if (col_bests.back().first < col_max)
        col_bests.back() = {col_max, i};
    }
    if (col_max > gmax) {
      gmax = col_max;
      te = i;
      best_col = H_prev;
      if (gmax >= endsc) break;
    }
  }
  if (te < 0) { out[0] = 0; out[1] = -1; out[2] = -1; out[3] = -1; out[4] = -1;
                return; }
  int32_t qe = 0;
  for (int j = 1; j < qlen; ++j)
    if (best_col[j] > best_col[qe]) qe = j;
  int32_t score2 = -1, te2 = -1;
  int radius = (gmax + match_sc - 1) / match_sc;
  for (auto& cb : col_bests) {
    if ((cb.second < te - radius || cb.second > te + radius)
        && cb.first > score2) {
      score2 = cb.first;
      te2 = cb.second;
    }
  }
  out[0] = gmax; out[1] = te; out[2] = qe; out[3] = score2; out[4] = te2;
}

#ifdef __SSE2__
// Inter-task 16-lane uint8 forward local SW: 16 same-shape (qlen, tlen)
// tasks, one per byte lane. The mate-rescue forward pass never early-breaks
// (endsc = 1<<30), every lane is real (no pad masking), and the per-row
// column max / first-max column index ride in-vector (strict-increase
// update replicates the scalar's first-max tie rule exactly). Per-lane
// gmax/te/col_bests bookkeeping is scalar per row from the extracted
// 16-byte row summaries. Output rows match local_core's contract
// [score, te, qe, score2, te2]. Caller guards the uint8 range.
static void local_fwd16_u8(const uint8_t* const* queries, int qlen,
                           const uint8_t* const* targets, int tlen,
                           int o_del, int e_del, int o_ins, int e_ins,
                           int minsc, int match_sc, int mismatch_sc,
                           int n_sc, int32_t out[16][5]) {
  const int B = std::max(0, -std::min(mismatch_sc, n_sc));
  std::vector<__m128i> qv(qlen), tv(tlen), Hp(qlen), Hc(qlen), E(qlen);
  for (int j = 0; j < qlen; ++j) {
    uint8_t* p = (uint8_t*)&qv[j];
    for (int l = 0; l < 16; ++l) p[l] = queries[l][j];
  }
  for (int i = 0; i < tlen; ++i) {
    uint8_t* p = (uint8_t*)&tv[i];
    for (int l = 0; l < 16; ++l) p[l] = targets[l][i];
  }
  const __m128i zero = _mm_setzero_si128();
  for (int j = 0; j < qlen; ++j) {
    Hp[j] = zero;
    E[j] = zero;
  }
  const __m128i vB = _mm_set1_epi8((char)B);
  const __m128i vpm = _mm_set1_epi8((char)(match_sc + B));
  const __m128i vpmm = _mm_set1_epi8((char)(mismatch_sc + B));
  const __m128i vpn = _mm_set1_epi8((char)(n_sc + B));
  const __m128i v3 = _mm_set1_epi8(3);
  const __m128i voe_del = _mm_set1_epi8((char)(o_del + e_del));
  const __m128i ve_del = _mm_set1_epi8((char)e_del);
  const __m128i voe_ins = _mm_set1_epi8((char)(o_ins + e_ins));
  const __m128i ve_ins = _mm_set1_epi8((char)e_ins);
  struct Lane {
    int32_t gmax = 0, te = -1, qe = 0;
    std::vector<std::pair<int32_t, int32_t>> col_bests;
  };
  std::vector<Lane> lanes(16);
  alignas(16) uint8_t cm[16], cq[16];
  for (int i = 0; i < tlen; ++i) {
    __m128i f = zero, colmax = zero, col_qe = zero;
    const __m128i vt = tv[i];
    const __m128i t_is_n = _mm_cmpgt_epi8(vt, v3);
    for (int j = 0; j < qlen; ++j) {
      __m128i diag = j ? Hp[j - 1] : zero;
      __m128i vq = qv[j];
      __m128i eq = _mm_cmpeq_epi8(vq, vt);
      __m128i isn = _mm_or_si128(_mm_cmpgt_epi8(vq, v3), t_is_n);
      __m128i prof = _mm_or_si128(_mm_and_si128(eq, vpm),
                                  _mm_andnot_si128(eq, vpmm));
      prof = _mm_or_si128(_mm_and_si128(isn, vpn),
                          _mm_andnot_si128(isn, prof));
      __m128i M = _mm_subs_epu8(_mm_adds_epu8(diag, prof), vB);
      __m128i h = _mm_max_epu8(M, E[j]);
      h = _mm_max_epu8(h, f);
      __m128i nm = _mm_max_epu8(colmax, h);
      __m128i same = _mm_cmpeq_epi8(nm, colmax);  // 0xFF where no increase
      col_qe = _mm_or_si128(_mm_and_si128(same, col_qe),
                            _mm_andnot_si128(same, _mm_set1_epi8((char)j)));
      colmax = nm;
      f = _mm_max_epu8(_mm_subs_epu8(f, ve_ins), _mm_subs_epu8(h, voe_ins));
      E[j] = _mm_max_epu8(_mm_subs_epu8(E[j], ve_del),
                          _mm_subs_epu8(h, voe_del));
      Hc[j] = h;
    }
    std::swap(Hp, Hc);
    _mm_store_si128((__m128i*)cm, colmax);
    _mm_store_si128((__m128i*)cq, col_qe);
    for (int l = 0; l < 16; ++l) {
      int32_t col_max = cm[l];
      Lane& L = lanes[l];
      if (col_max >= minsc) {
        if (L.col_bests.empty() || L.col_bests.back().second + 1 != i)
          L.col_bests.push_back({col_max, i});
        else if (L.col_bests.back().first < col_max)
          L.col_bests.back() = {col_max, i};
      }
      if (col_max > L.gmax) {
        L.gmax = col_max;
        L.te = i;
        L.qe = cq[l];
      }
    }
  }
  for (int l = 0; l < 16; ++l) {
    Lane& L = lanes[l];
    if (L.te < 0) {
      out[l][0] = 0; out[l][1] = -1; out[l][2] = -1; out[l][3] = -1;
      out[l][4] = -1;
      continue;
    }
    int32_t score2 = -1, te2 = -1;
    int radius = (L.gmax + match_sc - 1) / match_sc;
    for (auto& cb : L.col_bests) {
      if ((cb.second < L.te - radius || cb.second > L.te + radius)
          && cb.first > score2) {
        score2 = cb.first;
        te2 = cb.second;
      }
    }
    out[l][0] = L.gmax; out[l][1] = L.te; out[l][2] = L.qe;
    out[l][3] = score2; out[l][4] = te2;
  }
}
#endif  // __SSE2__

// Finish one task given its forward-pass result (reverse pass for start
// coordinates) — the tail of ksw_local_one.
static void local_finish_from_fwd(const uint8_t* query, int qlen,
                                  const uint8_t* target, int tlen,
                                  int o_del, int e_del, int o_ins, int e_ins,
                                  int minsc, int match_sc, int mismatch_sc,
                                  int n_sc, const int32_t fwd[5],
                                  int32_t* out) {
  (void)qlen; (void)tlen;
  int32_t score = fwd[0], te = fwd[1], qe = fwd[2];
  if (te < 0 || score < minsc) {
    out[0] = score; out[1] = -1; out[2] = -1; out[3] = -1; out[4] = -1;
    out[5] = fwd[3]; out[6] = fwd[4];
    return;
  }
  std::vector<uint8_t> rq(qe + 1), rt(te + 1);
  for (int j = 0; j <= qe; ++j) rq[j] = query[qe - j];
  for (int i = 0; i <= te; ++i) rt[i] = target[te - i];
  int32_t rev[5];
  local_core(rq.data(), qe + 1, rt.data(), te + 1, o_del, e_del, o_ins,
             e_ins, 1 << 30, score, match_sc, mismatch_sc, n_sc, rev);
  out[0] = score;
  out[1] = qe - rev[2];
  out[2] = qe;
  out[3] = te - rev[1];
  out[4] = te;
  out[5] = fwd[3];
  out[6] = fwd[4];
}

// Full local alignment (XSUBO|XSTART): [score, qb, qe, tb, te, score2, te2].
void ksw_local_one(const uint8_t* query, int qlen, const uint8_t* target,
                   int tlen, int o_del, int e_del, int o_ins, int e_ins,
                   int minsc, int match_sc, int mismatch_sc, int n_sc,
                   int32_t* out) {
  if (qlen == 0 || tlen == 0) {
    out[0] = 0; out[1] = -1; out[2] = -1; out[3] = -1; out[4] = -1;
    out[5] = -1; out[6] = -1;
    return;
  }
  int32_t fwd[5];
  local_core(query, qlen, target, tlen, o_del, e_del, o_ins, e_ins, minsc,
             1 << 30, match_sc, mismatch_sc, n_sc, fwd);
  local_finish_from_fwd(query, qlen, target, tlen, o_del, e_del, o_ins,
                        e_ins, minsc, match_sc, mismatch_sc, n_sc, fwd, out);
}

// Batched ksw_local_one: one FFI call for a whole barcode's mate-rescue
// DPs (per-call ctypes packing costs ~50 us; rescue runs ~1 DP per pair).
// queries/targets are concatenated code arrays delimited by q_off/t_off
// (n+1 entries each); out is (n, 7) int32 rows in ksw_local_one layout.
void ksw_local_batch(const uint8_t* queries, const int64_t* q_off,
                     const uint8_t* targets, const int64_t* t_off,
                     int64_t n, int o_del, int e_del, int o_ins, int e_ins,
                     int minsc, int match_sc, int mismatch_sc, int n_sc,
                     int32_t* out) {
#ifdef __SSE2__
  // Mate-rescue batches are overwhelmingly one (qlen, tlen) shape (the
  // pestat window), so run the forward pass 16 same-shape tasks at a time;
  // the reverse start-coordinate pass (diverse (qe, te) shapes, early
  // endsc break) stays per-task. Bit-identical to the sequential loop.
  const int B = std::max(0, -std::min(mismatch_sc, n_sc));
  std::unordered_map<uint64_t, std::vector<int64_t>> groups;
  std::vector<bool> done(n, false);
  for (int64_t i = 0; i < n; ++i) {
    int64_t ql = q_off[i + 1] - q_off[i], tl = t_off[i + 1] - t_off[i];
    if (ql >= 2 && tl >= 1 && ql <= 255
        && ql * match_sc + match_sc + B <= 254
        && o_del + e_del <= 254 && o_ins + e_ins <= 254 && match_sc > 0)
      groups[(uint64_t)ql << 32 | (uint64_t)tl].push_back(i);
  }
  const uint8_t* qp[16];
  const uint8_t* tp[16];
  int32_t fwd[16][5];
  for (auto& kv : groups) {
    const std::vector<int64_t>& idxs = kv.second;
    int qlen = (int)(kv.first >> 32), tlen = (int)(kv.first & 0xFFFFFFFF);
    for (size_t c0 = 0; c0 < idxs.size(); c0 += 16) {
      int nreal = (int)std::min<size_t>(16, idxs.size() - c0);
      if (nreal < 4) break;  // tail cheaper per-task
      for (int l = 0; l < 16; ++l) {
        int64_t i = idxs[c0 + (l < nreal ? l : 0)];
        qp[l] = queries + q_off[i];
        tp[l] = targets + t_off[i];
      }
      local_fwd16_u8(qp, qlen, tp, tlen, o_del, e_del, o_ins, e_ins, minsc,
                     match_sc, mismatch_sc, n_sc, fwd);
      for (int l = 0; l < nreal; ++l) {
        int64_t i = idxs[c0 + l];
        local_finish_from_fwd(qp[l], qlen, tp[l], tlen, o_del, e_del, o_ins,
                              e_ins, minsc, match_sc, mismatch_sc, n_sc,
                              fwd[l], out + i * 7);
        done[i] = true;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (done[i]) continue;
    ksw_local_one(queries + q_off[i],
                  static_cast<int>(q_off[i + 1] - q_off[i]),
                  targets + t_off[i],
                  static_cast<int>(t_off[i + 1] - t_off[i]),
                  o_del, e_del, o_ins, e_ins, minsc, match_sc, mismatch_sc,
                  n_sc, out + i * 7);
  }
#else
  for (int64_t i = 0; i < n; ++i) {
    ksw_local_one(queries + q_off[i],
                  static_cast<int>(q_off[i + 1] - q_off[i]),
                  targets + t_off[i],
                  static_cast<int>(t_off[i + 1] - t_off[i]),
                  o_del, e_del, o_ins, e_ins, minsc, match_sc, mismatch_sc,
                  n_sc, out + i * 7);
  }
#endif
}

// Finish a device-side traceback walk: ops (B, S) uint8 in walk order
// (255 = end), plus final i/k cursors for the off-matrix tails. RLE-merge,
// append tails, reverse — identical to the z-matrix walkers' output.
void ksw_cigar_from_ops_batch(const uint8_t* ops, int64_t B, int64_t S,
                              const int32_t* i_fin, const int32_t* k_fin,
                              int32_t* cigars, int64_t cap_pairs,
                              int32_t* n_ops_out) {
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* ob = ops + b * S;
    int32_t* out = cigars + b * 2 * cap_pairs;
    int n = 0;
    auto push = [&](int op, int ln) {
      if (n && out[2 * (n - 1)] == op) {
        out[2 * (n - 1) + 1] += ln;
      } else if (n < cap_pairs) {
        out[2 * n] = op;
        out[2 * n + 1] = ln;
        ++n;
      }
    };
    for (int64_t s = 0; s < S && ob[s] != 255; ++s) push(ob[s], 1);
    if (i_fin[b] >= 0) push(2, i_fin[b] + 1);
    if (k_fin[b] >= 0) push(1, k_fin[b] + 1);
    for (int a = 0, c = n - 1; a < c; ++a, --c) {
      std::swap(out[2 * a], out[2 * c]);
      std::swap(out[2 * a + 1], out[2 * c + 1]);
    }
    n_ops_out[b] = n;
  }
}

// Bit-packed variant: ops arrive 4-per-byte (two bits each, LSB-first);
// op value 3 is the end-of-walk marker (the raw path's 255 & 3). Same RLE +
// reverse + residual-D/I finish as ksw_cigar_from_ops_batch.
void ksw_cigar_from_ops_packed_batch(const uint8_t* packed, int64_t B,
                                     int64_t S, const int32_t* i_fin,
                                     const int32_t* k_fin, int32_t* cigars,
                                     int64_t cap_pairs, int32_t* n_ops_out) {
  int64_t PS = (S + 3) / 4;
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* ob = packed + b * PS;
    int32_t* out = cigars + b * 2 * cap_pairs;
    int n = 0;
    auto push = [&](int op, int ln) {
      if (n && out[2 * (n - 1)] == op) {
        out[2 * (n - 1) + 1] += ln;
      } else if (n < cap_pairs) {
        out[2 * n] = op;
        out[2 * n + 1] = ln;
        ++n;
      }
    };
    for (int64_t s = 0; s < S; ++s) {
      int op = (ob[s >> 2] >> ((s & 3) << 1)) & 3;
      if (op == 3) break;
      push(op, 1);
    }
    if (i_fin[b] >= 0) push(2, i_fin[b] + 1);
    if (k_fin[b] >= 0) push(1, k_fin[b] + 1);
    for (int a = 0, c = n - 1; a < c; ++a, --c) {
      std::swap(out[2 * a], out[2 * c]);
      std::swap(out[2 * a + 1], out[2 * c + 1]);
    }
    n_ops_out[b] = n;
  }
}

}  // extern "C"
