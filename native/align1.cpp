// mem_align1_core in C++: chain -> filter -> extend -> dedup/patch.
//
// Native port of lariat_tpu/align/{chaining,extension}.py (which are the
// executable reference; the existing Python path is kept and the two are
// asserted bit-identical by tests/fuzz). Consumes the SMEM intervals +
// SA-dereferenced positions that fm_collect_seeds_batch / fm_sa_lookup_batch
// (seed.cpp) produce, and emits mem_alnreg_t-equivalent regions.
//
// Reference behavior consumed via gobwa/gobwa.go:181-187 (mem_align1_core).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {
void ksw_extend_one(const uint8_t* query, int qlen, const uint8_t* target,
                    int tlen, int o_del, int e_del, int o_ins, int e_ins,
                    int w, int end_bonus, int zdrop, int h0, int match_sc,
                    int mismatch_sc, int n_sc, int32_t* out);
int32_t ksw_global_one(const uint8_t* query, int qlen, const uint8_t* target,
                       int tlen, int o_del, int e_del, int o_ins, int e_ins,
                       int w, int match_sc, int mismatch_sc, int n_sc,
                       int32_t* score_out, int32_t* cigar_out,
                       int32_t cigar_cap);
#ifdef __SSE2__
void ksw_global_fill8(const uint8_t* q8, const uint8_t* t8, int qlen,
                      int tlen, int o_del, int e_del, int o_ins, int e_ins,
                      int w, int match_sc, int mismatch_sc, int n_sc,
                      int32_t* scores8, uint8_t* z8);
int32_t ksw_global_traceback_z(const uint8_t* z, int n_col, int qlen,
                               int tlen, int w, int32_t* cigar_out,
                               int32_t cigar_cap);
#endif
}

namespace {

constexpr int MAX_BAND_TRY = 2;
constexpr double PATCH_MAX_R_BW = 0.15;
constexpr double PATCH_MIN_SC_RATIO = 0.90;

inline int score_sub_pub(uint8_t q, uint8_t t, int match_sc, int mismatch_sc,
                         int n_sc) {
  if (q >= 4 || t >= 4) return n_sc;
  return q == t ? match_sc : mismatch_sc;
}

struct Opt {
  int match, mismatch, n_sc;
  int o_del, e_del, o_ins, e_ins;
  int pen_clip5, pen_clip3, zdrop;
  int64_t band_width, max_chain_gap, max_occ;
  int64_t min_seed_len, min_chain_weight, max_chain_extend;
  double mask_level, mask_level_redun, drop_ratio;
};

struct Seed {
  int64_t rbeg, qbeg, len, score;
};

struct Chain {
  int64_t pos;
  int rid;
  std::vector<Seed> seeds;
  int64_t w = 0;
  int kept = 0;
  int first = -1;
};

struct Reg {
  int64_t rb = 0, re = 0, qb = 0, qe = 0;
  int rid = -1;
  int64_t score = -1, truesc = -1, sub = 0, csub = 0;
  int64_t seedcov = 0, w = 0, seedlen0 = 0, n_comp = 1;
};

struct Genome {
  const uint8_t* pac;
  int64_t l_pac;
  const int64_t* contig_offs;  // sorted start offsets
  int64_t n_contigs;

  inline uint8_t code(int64_t i) const {
    return (pac[i >> 2] >> ((3 - (i & 3)) * 2)) & 3;
  }
  // fetch_fmd: codes of the doubled text [start, end), no strand crossing
  void fetch(int64_t start, int64_t end, std::vector<uint8_t>& out) const {
    int64_t seq_len = 2 * l_pac;
    start = std::max<int64_t>(start, 0);
    end = std::min(end, seq_len);
    out.clear();
    if (end <= start) return;
    if (end <= l_pac) {
      out.resize(end - start);
      for (int64_t i = start; i < end; ++i) out[i - start] = code(i);
    } else if (start >= l_pac) {
      int64_t fb = seq_len - end, fe = seq_len - start;
      out.resize(fe - fb);
      for (int64_t i = fb; i < fe; ++i)
        out[fe - 1 - i] = 3 - code(i);
    }  // crossing: empty (unreachable from the engine flow)
  }
  int pos_to_contig(int64_t pos) const {
    if (n_contigs == 1) return 0;
    // last contig with offset <= pos
    const int64_t* it =
        std::upper_bound(contig_offs, contig_offs + n_contigs, pos);
    return (int)(it - contig_offs) - 1;
  }
  // bns_intv2rid
  int intv2rid(int64_t rb, int64_t re) const {
    int64_t seq_len = 2 * l_pac, b, e;
    if (re <= l_pac) {
      b = rb; e = re;
    } else if (rb >= l_pac) {
      b = seq_len - re; e = seq_len - rb;
    } else {
      return -1;
    }
    if (n_contigs == 1) return 0;
    int rid_b = pos_to_contig(b);
    int rid_e = e > b ? pos_to_contig(e - 1) : rid_b;
    return rid_b == rid_e ? rid_b : -1;
  }
};

inline int64_t cal_max_gap(const Opt& o, int64_t qlen) {
  int64_t l_del = (int64_t)((double)(qlen * o.match - o.o_del) / o.e_del + 1.0);
  int64_t l_ins = (int64_t)((double)(qlen * o.match - o.o_ins) / o.e_ins + 1.0);
  int64_t l = std::max(std::max(l_del, l_ins), (int64_t)1);
  return std::min(l, o.band_width * 2);
}

// mem_chain over precomputed mems (n,5)=[x0,x1,s,qb,qe] + rbegs in
// enumerate_occurrences order; also computes frac_rep.
void chain_seeds(const Genome& g, const Opt& o, int64_t l_query,
                 const int64_t* mems, int64_t n_mems, const int64_t* rbegs,
                 int64_t n_rbegs, std::vector<Chain>& chains,
                 double* frac_rep) {
  // frac_rep
  int64_t l_rep = 0, b = 0, e = 0;
  for (int64_t m = 0; m < n_mems; ++m) {
    int64_t s = mems[m * 5 + 2], qb = mems[m * 5 + 3], qe = mems[m * 5 + 4];
    if (s <= o.max_occ) continue;
    if (qb > e) {
      l_rep += e - b;
      b = qb; e = qe;
    } else {
      e = std::max(e, qe);
    }
  }
  l_rep += e - b;
  *frac_rep = l_query ? (double)l_rep / (double)l_query : 0.0;

  chains.clear();
  std::vector<int64_t> chain_pos;  // sorted, parallel to chains
  int64_t ri = 0;
  for (int64_t m = 0; m < n_mems && ri < n_rbegs; ++m) {
    int64_t s = mems[m * 5 + 2], qb = mems[m * 5 + 3], qe = mems[m * 5 + 4];
    int64_t step = s > o.max_occ ? s / o.max_occ : 1;
    int64_t count = 0;
    for (int64_t k = 0; k < s && count < o.max_occ && ri < n_rbegs;
         k += step, ++count) {
      int64_t rbeg = rbegs[ri++];
      int64_t slen = qe - qb;
      Seed seed{rbeg, qb, slen, slen};
      int rid = g.intv2rid(rbeg, rbeg + slen);
      if (rid < 0) continue;
      // chain with the largest pos <= rbeg
      int64_t idx = (int64_t)(std::upper_bound(chain_pos.begin(),
                                               chain_pos.end(), rbeg)
                              - chain_pos.begin()) - 1;
      bool merged = false;
      if (idx >= 0) {
        Chain& c = chains[idx];
        const Seed& last = c.seeds.back();
        const Seed& first = c.seeds.front();
        int64_t qend = last.qbeg + last.len, rend = last.rbeg + last.len;
        if (rid == c.rid) {
          if (seed.qbeg >= first.qbeg && seed.qbeg + seed.len <= qend
              && seed.rbeg >= first.rbeg && seed.rbeg + seed.len <= rend) {
            merged = true;  // contained
          } else if (!((last.rbeg < g.l_pac || first.rbeg < g.l_pac)
                       && seed.rbeg >= g.l_pac)) {
            int64_t x = seed.qbeg - last.qbeg;
            int64_t y = seed.rbeg - last.rbeg;
            if (y >= 0 && x - y <= o.band_width && y - x <= o.band_width
                && x - last.len < o.max_chain_gap
                && y - last.len < o.max_chain_gap) {
              c.seeds.push_back(seed);
              merged = true;
            }
          }
        }
      }
      if (!merged) {
        int64_t ins = (int64_t)(std::upper_bound(chain_pos.begin(),
                                                 chain_pos.end(), rbeg)
                                - chain_pos.begin());
        chain_pos.insert(chain_pos.begin() + ins, rbeg);
        Chain nc;
        nc.pos = rbeg;
        nc.rid = rid;
        nc.seeds.push_back(seed);
        chains.insert(chains.begin() + ins, std::move(nc));
      }
    }
  }
}

int64_t chain_weight(const Chain& c) {
  int64_t w = 0, end = 0;
  for (const Seed& s : c.seeds) {
    if (s.qbeg >= end) w += s.len;
    else if (s.qbeg + s.len > end) w += s.qbeg + s.len - end;
    end = std::max(end, s.qbeg + s.len);
  }
  int64_t tmp = w;
  w = 0; end = 0;
  for (const Seed& s : c.seeds) {
    if (s.rbeg >= end) w += s.len;
    else if (s.rbeg + s.len > end) w += s.rbeg + s.len - end;
    end = std::max(end, s.rbeg + s.len);
  }
  return std::min(std::min(w, tmp), (int64_t)((1 << 30) - 1));
}

inline int64_t chn_beg(const Chain& c) { return c.seeds.front().qbeg; }
inline int64_t chn_end(const Chain& c) {
  return c.seeds.back().qbeg + c.seeds.back().len;
}

// mem_chain_flt; keeps Python's stable-sort tie behavior
void filter_chains(const Opt& o, std::vector<Chain>& chains) {
  std::vector<Chain> pool;
  for (Chain& c : chains) {
    c.first = -1;
    c.kept = 0;
    c.w = chain_weight(c);
    if (c.w >= o.min_chain_weight) pool.push_back(std::move(c));
  }
  chains.clear();
  if (pool.empty()) return;
  std::stable_sort(pool.begin(), pool.end(),
                   [](const Chain& a, const Chain& b) { return a.w > b.w; });
  pool[0].kept = 3;
  std::vector<int64_t> kept_idx{0};
  for (int64_t i = 1; i < (int64_t)pool.size(); ++i) {
    bool large_ovlp = false, broke = false;
    for (int64_t j : kept_idx) {
      int64_t b_max = std::max(chn_beg(pool[j]), chn_beg(pool[i]));
      int64_t e_min = std::min(chn_end(pool[j]), chn_end(pool[i]));
      if (e_min > b_max) {
        int64_t li = chn_end(pool[i]) - chn_beg(pool[i]);
        int64_t lj = chn_end(pool[j]) - chn_beg(pool[j]);
        int64_t min_l = std::min(li, lj);
        if ((double)(e_min - b_max) >= (double)min_l * o.mask_level
            && min_l < o.max_chain_gap) {
          large_ovlp = true;
          if (pool[j].first < 0) pool[j].first = (int)i;
          if ((double)pool[i].w < (double)pool[j].w * o.drop_ratio
              && pool[j].w - pool[i].w >= o.min_seed_len * 2) {
            broke = true;
            break;
          }
        }
      }
    }
    if (!broke) {
      kept_idx.push_back(i);
      pool[i].kept = large_ovlp ? 2 : 3;
    }
  }
  for (int64_t j : kept_idx)
    if (pool[j].first >= 0) pool[pool[j].first].kept = 1;
  int64_t k = 0, cut = (int64_t)pool.size();
  for (int64_t i = 0; i < (int64_t)pool.size(); ++i) {
    if (pool[i].kept == 0 || pool[i].kept == 3) continue;
    ++k;
    if (k >= o.max_chain_extend) { cut = i; break; }
  }
  for (int64_t i = cut; i < (int64_t)pool.size(); ++i)
    if (pool[i].kept < 3) pool[i].kept = 0;
  for (Chain& c : pool)
    if (c.kept != 0) chains.push_back(std::move(c));
}

// rmax window + rseq fetch + seed sort order for one chain (the geometry
// that both the sequential and the device-wave paths share)
struct ChainGeom {
  int64_t rmax0 = 0, rmax1 = 0;
  std::vector<uint8_t> rseq;
  std::vector<int64_t> srt;
};

void compute_geom(const Genome& g, const Opt& o, int64_t l_query,
                  const Chain& c, ChainGeom& geom) {
  int64_t l_pac = g.l_pac, seq_len = 2 * l_pac;
  int64_t rmax0 = seq_len, rmax1 = 0;
  for (const Seed& t : c.seeds) {
    int64_t b = t.rbeg - (t.qbeg + cal_max_gap(o, t.qbeg));
    int64_t e = t.rbeg + t.len + (l_query - t.qbeg - t.len)
                + cal_max_gap(o, l_query - t.qbeg - t.len);
    rmax0 = std::min(rmax0, b);
    rmax1 = std::max(rmax1, e);
  }
  rmax0 = std::max<int64_t>(rmax0, 0);
  rmax1 = std::min(rmax1, seq_len);
  if (rmax0 < l_pac && l_pac < rmax1) {
    if (c.seeds[0].rbeg < l_pac) rmax1 = l_pac;
    else rmax0 = l_pac;
  }
  geom.rmax0 = rmax0;
  geom.rmax1 = rmax1;
  g.fetch(rmax0, rmax1, geom.rseq);
  int64_t n = (int64_t)c.seeds.size();
  geom.srt.resize(n);
  for (int64_t i = 0; i < n; ++i) geom.srt[i] = i;
  std::sort(geom.srt.begin(), geom.srt.end(), [&](int64_t a, int64_t b) {
    if (c.seeds[a].score != c.seeds[b].score)
      return c.seeds[a].score > c.seeds[b].score;
    return a > b;
  });
}

// mem_chain2aln control flow with pluggable extension providers: LeftFn /
// RightFn fill eo[6] = {score, qle, tle, gtle, gscore, max_off} and the
// final band aw — either by running the ksw ladder inline (sequential path)
// or by looking up results computed in batched device waves (session path).
// Extension RESULTS depend only on (seed, window) inputs, never on the
// skip/conflict decisions, so the two schedules are bit-identical.
template <class LeftFn, class RightFn>
void chain2aln_core(const Genome& g, const Opt& o, const uint8_t* q,
                    int64_t l_query, const Chain& c, const ChainGeom& geom,
                    std::vector<Reg>& regs, LeftFn left_ext,
                    RightFn right_ext) {
  if (c.seeds.empty()) return;
  int64_t rmax0 = geom.rmax0;
  const std::vector<int64_t>& srt = geom.srt;
  int64_t n = (int64_t)c.seeds.size();
  std::vector<char> skipped(n, 0);
  int32_t eo[6];
  for (int64_t si = 0; si < n; ++si) {
    const Seed& s = c.seeds[srt[si]];
    const Reg* hit = nullptr;
    for (const Reg& p : regs) {
      if (s.rbeg < p.rb || s.rbeg + s.len > p.re || s.qbeg < p.qb
          || s.qbeg + s.len > p.qe)
        continue;
      if ((double)(s.len - p.seedlen0) > 0.1 * (double)l_query) continue;
      int64_t qd = s.qbeg - p.qb, rd = s.rbeg - p.rb;
      int64_t w = std::min(cal_max_gap(o, std::min(qd, rd)), p.w);
      if (qd - rd < w && rd - qd < w) { hit = &p; break; }
      qd = p.qe - (s.qbeg + s.len);
      rd = p.re - (s.rbeg + s.len);
      w = std::min(cal_max_gap(o, std::min(qd, rd)), p.w);
      if (qd - rd < w && rd - qd < w) { hit = &p; break; }
    }
    if (hit) {
      bool conflict = false;
      for (int64_t sj = 0; sj < si; ++sj) {
        int64_t j_idx = srt[sj];
        if (skipped[j_idx]) continue;
        const Seed& t = c.seeds[j_idx];
        if ((double)t.len < (double)s.len * 0.95) continue;
        if (s.qbeg <= t.qbeg && s.qbeg + s.len - t.qbeg >= s.len / 4
            && t.qbeg - s.qbeg != t.rbeg - s.rbeg) { conflict = true; break; }
        if (t.qbeg <= s.qbeg && t.qbeg + t.len - s.qbeg >= s.len / 4
            && s.qbeg - t.qbeg != s.rbeg - t.rbeg) { conflict = true; break; }
      }
      if (!conflict) {
        skipped[srt[si]] = 1;
        continue;
      }
    }
    Reg a;
    a.w = o.band_width;
    a.rid = c.rid;
    int64_t aw0 = o.band_width, aw1 = o.band_width;
    if (s.qbeg) {
      left_ext(srt[si], s, eo, &aw0);
      a.score = eo[0];
      if (eo[4] <= 0 || eo[4] <= a.score - o.pen_clip5) {
        a.qb = s.qbeg - eo[1];
        a.rb = s.rbeg - eo[2];
        a.truesc = a.score;
      } else {
        a.qb = 0;
        a.rb = s.rbeg - eo[3];
        a.truesc = eo[4];
      }
    } else {
      a.score = a.truesc = s.len * o.match;
      a.qb = 0;
      a.rb = s.rbeg;
    }
    if (s.qbeg + s.len != l_query) {
      int64_t sc0 = a.score;
      int64_t qe = s.qbeg + s.len;
      int64_t re_off = s.rbeg + s.len - rmax0;
      right_ext(srt[si], s, sc0, eo, &aw1);
      a.score = eo[0];
      if (eo[4] <= 0 || eo[4] <= a.score - o.pen_clip3) {
        a.qe = qe + eo[1];
        a.re = rmax0 + re_off + eo[2];
        a.truesc += a.score - sc0;
      } else {
        a.qe = l_query;
        a.re = rmax0 + re_off + eo[3];
        a.truesc += eo[4] - sc0;
      }
    } else {
      a.qe = l_query;
      a.re = s.rbeg + s.len;
    }
    a.seedcov = 0;
    for (const Seed& t : c.seeds)
      if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe && t.rbeg >= a.rb
          && t.rbeg + t.len <= a.re)
        a.seedcov += t.len;
    a.w = std::max(aw0, aw1);
    a.seedlen0 = s.len;
    regs.push_back(a);
  }
}

// sequential mem_chain2aln: providers run the ksw band ladder inline
void chain2aln(const Genome& g, const Opt& o, const uint8_t* q,
               int64_t l_query, const Chain& c, double frac_rep_unused,
               std::vector<Reg>& regs, std::vector<uint8_t>& rseq_scratch,
               std::vector<uint8_t>& buf1, std::vector<uint8_t>& buf2) {
  (void)frac_rep_unused;
  (void)rseq_scratch;
  if (c.seeds.empty()) return;
  ChainGeom geom;
  compute_geom(g, o, l_query, c, geom);
  auto left = [&](int64_t, const Seed& s, int32_t* eo, int64_t* aw) {
    buf1.assign(q, q + s.qbeg);
    std::reverse(buf1.begin(), buf1.end());
    int64_t tmp = s.rbeg - geom.rmax0;
    buf2.assign(geom.rseq.begin(), geom.rseq.begin() + tmp);
    std::reverse(buf2.begin(), buf2.end());
    int64_t prev = -1;
    for (int i = 0; i < MAX_BAND_TRY; ++i) {
      *aw = o.band_width << i;
      ksw_extend_one(buf1.data(), (int)buf1.size(), buf2.data(),
                     (int)buf2.size(), o.o_del, o.e_del, o.o_ins, o.e_ins,
                     (int)*aw, o.pen_clip5, o.zdrop,
                     (int)(s.len * o.match), o.match, o.mismatch, o.n_sc, eo);
      if (eo[0] == prev || eo[5] < (*aw >> 1) + (*aw >> 2)) break;
      prev = eo[0];
    }
  };
  auto right = [&](int64_t, const Seed& s, int64_t sc0, int32_t* eo,
                   int64_t* aw) {
    int64_t qe = s.qbeg + s.len;
    int64_t re_off = s.rbeg + s.len - geom.rmax0;
    int64_t prev = -1;
    for (int i = 0; i < MAX_BAND_TRY; ++i) {
      *aw = o.band_width << i;
      ksw_extend_one(q + qe, (int)(l_query - qe), geom.rseq.data() + re_off,
                     (int)((int64_t)geom.rseq.size() - re_off), o.o_del,
                     o.e_del, o.o_ins, o.e_ins, (int)*aw, o.pen_clip3,
                     o.zdrop, (int)sc0, o.match, o.mismatch, o.n_sc, eo);
      if (eo[0] == prev || eo[5] < (*aw >> 1) + (*aw >> 2)) break;
      prev = eo[0];
    }
  };
  chain2aln_core(g, o, q, l_query, c, geom, regs, left, right);
}

// mem_patch_reg; returns true + (w, score) when mergeable
bool patch_reg(const Genome& g, const Opt& o, const uint8_t* q,
               const Reg& a, const Reg& b, int64_t* w_out, int64_t* sc_out,
               std::vector<uint8_t>& rseq) {
  if (a.rb < g.l_pac && g.l_pac <= b.rb) return false;
  if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return false;
  int64_t w = std::llabs((a.re - b.rb) - (a.qe - b.qb));
  double r = std::fabs((double)(a.re - b.rb) / (double)(b.re - a.rb)
                       - (double)(a.qe - b.qb) / (double)(b.qe - a.qb));
  if (a.re < b.rb || a.qe < b.qb) {
    if (w > o.band_width * 2 || r >= PATCH_MAX_R_BW) return false;
  } else if (w > o.band_width * 4 || r >= PATCH_MAX_R_BW * 2) {
    return false;
  }
  w += std::max(a.w, b.w);
  w = std::min(w, o.band_width * 4);
  g.fetch(a.rb, b.re, rseq);
  int32_t score = 0;
  ksw_global_one(q + a.qb, (int)(b.qe - a.qb), rseq.data(),
                 (int)rseq.size(), o.o_del, o.e_del, o.o_ins, o.e_ins,
                 (int)w, o.match, o.mismatch, o.n_sc, &score, nullptr, 0);
  int64_t q_s = (int64_t)((double)(b.qe - a.qb)
                          / (double)((b.re - a.rb) + (b.qe - a.qb))
                          * (double)(a.score + b.score) + 0.499);
  int64_t r_s = (int64_t)((double)(b.re - a.rb)
                          / (double)((b.re - a.rb) + (b.qe - a.qb))
                          * (double)(a.score + b.score) + 0.499);
  if ((double)score / (double)std::max(q_s, r_s) < PATCH_MIN_SC_RATIO)
    return false;
  *w_out = w;
  *sc_out = score;
  return true;
}

// mem_sort_dedup_patch
void sort_dedup_patch(const Genome& g, const Opt& o, const uint8_t* q,
                      std::vector<Reg>& regs, std::vector<uint8_t>& rseq) {
  if (regs.size() <= 1) return;
  std::stable_sort(regs.begin(), regs.end(),
                   [](const Reg& x, const Reg& y) { return x.re < y.re; });
  for (Reg& p : regs) p.n_comp = 1;
  for (int64_t i = 1; i < (int64_t)regs.size(); ++i) {
    Reg& p = regs[i];
    if (p.rid != regs[i - 1].rid
        || p.rb >= regs[i - 1].re + o.max_chain_gap)
      continue;
    int64_t j = i - 1;
    while (j >= 0 && p.rid == regs[j].rid
           && p.rb < regs[j].re + o.max_chain_gap) {
      Reg& qreg = regs[j];
      if (qreg.qe == qreg.qb) { --j; continue; }
      int64_t or_ = qreg.re - p.rb;
      int64_t oq = qreg.qb < p.qb ? qreg.qe - p.qb : p.qe - qreg.qb;
      int64_t mr = std::min(qreg.re - qreg.rb, p.re - p.rb);
      int64_t mq = std::min(qreg.qe - qreg.qb, p.qe - p.qb);
      if ((double)or_ > o.mask_level_redun * (double)mr
          && (double)oq > o.mask_level_redun * (double)mq) {
        if (p.score < qreg.score) {
          p.qe = p.qb;
          break;
        } else {
          qreg.qe = qreg.qb;
        }
      } else if (qreg.rb < p.rb) {
        int64_t w, score;
        if (patch_reg(g, o, q, qreg, p, &w, &score, rseq)) {
          p.n_comp += qreg.n_comp + 1;
          p.seedcov = std::max(p.seedcov, qreg.seedcov);
          p.sub = std::max(p.sub, qreg.sub);
          p.csub = std::max(p.csub, qreg.csub);
          p.qb = qreg.qb;
          p.rb = qreg.rb;
          p.truesc = p.score = score;
          p.w = w;
          qreg.qb = qreg.qe;
        }
      }
      --j;
    }
  }
  regs.erase(std::remove_if(regs.begin(), regs.end(),
                            [](const Reg& p) { return p.qe <= p.qb; }),
             regs.end());
  std::stable_sort(regs.begin(), regs.end(), [](const Reg& x, const Reg& y) {
    if (x.score != y.score) return x.score > y.score;
    if (x.rb != y.rb) return x.rb < y.rb;
    return x.qb < y.qb;
  });
  for (int64_t i = 1; i < (int64_t)regs.size(); ++i)
    if (regs[i].score == regs[i - 1].score && regs[i].rb == regs[i - 1].rb
        && regs[i].qb == regs[i - 1].qb)
      regs[i].qe = regs[i].qb;
  regs.erase(std::remove_if(regs.begin(), regs.end(),
                            [](const Reg& p) { return p.qe <= p.qb; }),
             regs.end());
}

}  // namespace

extern "C" {

// Full per-read candidate generation for a batch of reads sharing one FM
// index. mems_flat rows are [x0, x1, s, qb, qe] (fm_collect_seeds_batch
// layout); rbegs in enumerate_occurrences order. Output rows are 14 doubles:
// [rb, re, qb, qe, rid, score, truesc, sub, csub, seedcov, w, seedlen0,
//  n_comp, frac_rep]. Returns total regions, or -1 if cap exceeded.
int64_t mem_align1_batch(
    const uint8_t* pac, int64_t l_pac, const int64_t* contig_offs,
    int64_t n_contigs, const uint8_t* reads_flat,
    const int64_t* read_offsets, int64_t n_reads, const int64_t* mems_flat,
    const int64_t* mem_offsets, const int64_t* rbegs_flat,
    const int64_t* rbeg_offsets, const int64_t* oi, const double* od,
    double* out, int64_t cap, int64_t* counts, int64_t* offs) {
  Genome g{pac, l_pac, contig_offs, n_contigs};
  Opt o;
  o.match = (int)oi[0];
  o.mismatch = (int)oi[1];   // already negative
  o.n_sc = (int)oi[2];
  o.o_del = (int)oi[3];
  o.e_del = (int)oi[4];
  o.o_ins = (int)oi[5];
  o.e_ins = (int)oi[6];
  o.pen_clip5 = (int)oi[7];
  o.pen_clip3 = (int)oi[8];
  o.zdrop = (int)oi[9];
  o.band_width = oi[10];
  o.max_chain_gap = oi[11];
  o.max_occ = oi[12];
  o.min_seed_len = oi[13];
  o.min_chain_weight = oi[14];
  o.max_chain_extend = oi[15];
  o.mask_level = od[0];
  o.mask_level_redun = od[1];
  o.drop_ratio = od[2];

  int64_t total = 0;
  std::vector<Chain> chains;
  std::vector<Reg> regs;
  std::vector<uint8_t> rseq, buf1, buf2;
  for (int64_t r = 0; r < n_reads; ++r) {
    const uint8_t* q = reads_flat + read_offsets[r];
    int64_t l_query = read_offsets[r + 1] - read_offsets[r];
    const int64_t* mems = mems_flat + mem_offsets[r] * 5;
    int64_t n_mems = mem_offsets[r + 1] - mem_offsets[r];
    const int64_t* rbegs = rbegs_flat + rbeg_offsets[r];
    int64_t n_rbegs = rbeg_offsets[r + 1] - rbeg_offsets[r];
    offs[r] = total;
    counts[r] = 0;
    if (l_query == 0) continue;
    double frac_rep = 0.0;
    chain_seeds(g, o, l_query, mems, n_mems, rbegs, n_rbegs, chains,
                &frac_rep);
    filter_chains(o, chains);
    regs.clear();
    for (const Chain& c : chains)
      chain2aln(g, o, q, l_query, c, frac_rep, regs, rseq, buf1, buf2);
    sort_dedup_patch(g, o, q, regs, rseq);
    if (total + (int64_t)regs.size() > cap) return -1;
    for (const Reg& p : regs) {
      double* row = out + total * 14;
      row[0] = (double)p.rb;
      row[1] = (double)p.re;
      row[2] = (double)p.qb;
      row[3] = (double)p.qe;
      row[4] = (double)p.rid;
      row[5] = (double)p.score;
      row[6] = (double)p.truesc;
      row[7] = (double)p.sub;
      row[8] = (double)p.csub;
      row[9] = (double)p.seedcov;
      row[10] = (double)p.w;
      row[11] = (double)p.seedlen0;
      row[12] = (double)p.n_comp;
      row[13] = frac_rep;
      ++total;
    }
    counts[r] = (int64_t)regs.size();
  }
  return total;
}

// mem_reg2aln (final banded global -> CIGAR/NM/position) for a batch of
// tasks. tasks rows are [read_idx, qb, qe, rb, re, truesc, w] int64; meta
// out rows are [pos_global, rid, is_rev, NM, n_cigar, cigar_off]; cigar
// (op, len) int32 pairs go to cigar_out. Returns total cigar pairs or -1
// if cigar_cap exceeded.
int64_t mem_reg2aln_batch(
    const uint8_t* pac, int64_t l_pac, const int64_t* contig_offs,
    int64_t n_contigs, const uint8_t* reads_flat,
    const int64_t* read_offsets, const int64_t* tasks, int64_t n_tasks,
    const int64_t* oi, const double* od, int64_t* meta_out,
    int32_t* cigar_out, int64_t cigar_cap) {
  (void)od;
  Genome g{pac, l_pac, contig_offs, n_contigs};
  int match = (int)oi[0], mismatch = (int)oi[1], n_sc = (int)oi[2];
  int o_del = (int)oi[3], e_del = (int)oi[4];
  int o_ins = (int)oi[5], e_ins = (int)oi[6];
  int64_t band_width = oi[10];
  int64_t seq_len = 2 * l_pac;

  auto infer_bw = [&](int64_t l1, int64_t l2, int64_t score, int q_pen,
                      int r_pen) -> int64_t {
    if (l1 == l2 && l1 * match - score < (int64_t)(q_pen + r_pen - match) << 1)
      return 0;
    int64_t w = (int64_t)((double)(std::min(l1, l2) * match - score - q_pen)
                          / r_pen + 2.0);
    return std::max(w, (int64_t)std::llabs(l1 - l2));
  };

  // Pass 1: per-task precompute — band, oriented query/reference buffers,
  // path classification. Hoisting the fetch out of the band ladder is
  // behavior-identical (rb/re never change across ladder rounds).
  struct Pre {
    int64_t w2 = 0;                  // post-reg_w-clamp band (pre ladder cap)
    std::vector<uint8_t> rseq, qbuf;
    bool degenerate = true;
    // cached first-ladder-round DP result from the 8-lane SIMD fill
    bool cached = false, have1 = false;
    int32_t score1 = 0;
    std::vector<int32_t> cig1;
  };
  std::vector<Pre> pre(n_tasks);
  // groups of SIMD-eligible first rounds keyed by identical (lq, tlen, w2)
  std::unordered_map<uint64_t, std::vector<int64_t>> groups;
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* tk = tasks + t * 7;
    int64_t ridx = tk[0], qb = tk[1], qe = tk[2], rb = tk[3], re = tk[4];
    int64_t truesc = tk[5], reg_w = tk[6];
    const uint8_t* read = reads_flat + read_offsets[ridx];
    int64_t l_query = qe - qb;
    Pre& p = pre[t];
    int64_t w2 = std::max(
        infer_bw(l_query, re - rb, truesc, o_del, e_del),
        infer_bw(l_query, re - rb, truesc, o_ins, e_ins));
    if (w2 > band_width) w2 = std::min(w2, reg_w);
    p.w2 = w2;
    p.degenerate = (l_query <= 0 || rb >= re || (rb < l_pac && l_pac < re));
    if (p.degenerate) continue;
    g.fetch(rb, re, p.rseq);
    p.qbuf.assign(read + qb, read + qe);
    if (rb >= l_pac) {
      std::reverse(p.qbuf.begin(), p.qbuf.end());
      std::reverse(p.rseq.begin(), p.rseq.end());
    }
#ifdef __SSE2__
    int64_t w_eff = std::min(w2, band_width << 2);
    int64_t tl = (int64_t)p.rseq.size();
    bool fast = (l_query == re - rb && w_eff == 0);
    if (!fast && tl > 0 && l_query > 0 && tl == re - rb
        && w_eff >= std::llabs(l_query - tl)
        && l_query < 4000 && tl < 4000 && l_query * match < 12000
        && o_del + e_del < 200 && o_ins + e_ins < 200 && w_eff < 30000) {
      uint64_t key = ((uint64_t)l_query << 40) | ((uint64_t)tl << 16)
                     | (uint64_t)w_eff;
      groups[key].push_back(t);
    }
#endif
  }
#ifdef __SSE2__
  // Pass 2: run the first ladder round for each shape group, 8 tasks per
  // SIMD fill; partial chunks pad by replicating the first lane (padding
  // lanes' outputs are discarded). Chunks under 3 real tasks fall back to
  // the scalar kernel in pass 3.
  {
    std::vector<uint8_t> q8, t8, z8;
    int32_t sc8[8];
    for (auto& kv : groups) {
      const std::vector<int64_t>& idxs = kv.second;
      int64_t lq = (int64_t)(kv.first >> 40);
      int64_t tl = (int64_t)((kv.first >> 16) & 0xFFFFFF);
      int64_t w_eff = (int64_t)(kv.first & 0xFFFF);
      int n_col = (int)std::min<int64_t>(lq, 2 * w_eff + 1);
      for (size_t c0 = 0; c0 < idxs.size(); c0 += 8) {
        int nreal = (int)std::min<size_t>(8, idxs.size() - c0);
        if (nreal < 3) break;  // tail handled scalar in pass 3
        q8.assign((size_t)8 * lq, 0);
        t8.assign((size_t)8 * tl, 0);
        for (int l = 0; l < 8; ++l) {
          const Pre& p = pre[idxs[c0 + (l < nreal ? l : 0)]];
          std::copy(p.qbuf.begin(), p.qbuf.end(), q8.begin() + (size_t)l * lq);
          std::copy(p.rseq.begin(), p.rseq.end(), t8.begin() + (size_t)l * tl);
        }
        z8.assign((size_t)8 * tl * n_col, 0);
        ksw_global_fill8(q8.data(), t8.data(), (int)lq, (int)tl, o_del,
                         e_del, o_ins, e_ins, (int)w_eff, match, mismatch,
                         n_sc, sc8, z8.data());
        for (int l = 0; l < nreal; ++l) {
          Pre& p = pre[idxs[c0 + l]];
          p.cig1.resize(2 * (size_t)(lq + tl + 2));
          int32_t n_ops = ksw_global_traceback_z(
              z8.data() + (size_t)l * tl * n_col, n_col, (int)lq, (int)tl,
              (int)w_eff, p.cig1.data(), (int32_t)(p.cig1.size() / 2));
          if (n_ops > 0) {
            p.cig1.resize(2 * (size_t)n_ops);
            p.have1 = true;
          } else {
            p.cig1.clear();
            p.have1 = false;
          }
          p.score1 = sc8[l];
          p.cached = true;
        }
      }
    }
  }
#endif
  std::vector<int32_t> cig;
  int64_t cig_total = 0;
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* tk = tasks + t * 7;
    int64_t ridx = tk[0], qb = tk[1], qe = tk[2], rb = tk[3], re = tk[4];
    int64_t truesc = tk[5];
    int64_t l_full = read_offsets[ridx + 1] - read_offsets[ridx];
    int64_t l_query = qe - qb;
    int64_t* m = meta_out + t * 6;
    Pre& p = pre[t];
    const std::vector<uint8_t>& rseq = p.rseq;
    const std::vector<uint8_t>& qbuf = p.qbuf;

    int64_t w2 = p.w2;
    int64_t last_sc = -((int64_t)1 << 30);
    int i = 0;
    int64_t NM = -1;
    bool have_cigar = false;
    bool first_round = true;
    cig.clear();
    while (true) {
      w2 = std::min(w2, band_width << 2);
      // _gen_cigar
      int64_t score = 0;
      NM = -1;
      have_cigar = false;
      cig.clear();
      if (!p.degenerate) {
        if (first_round && p.cached) {
          score = p.score1;
          have_cigar = p.have1;
          cig = p.cig1;
        } else if (l_query == re - rb && w2 == 0) {
          for (int64_t k = 0; k < l_query; ++k)
            score += score_sub_pub(qbuf[k], rseq[k], match, mismatch, n_sc);
          cig.push_back(0);
          cig.push_back((int32_t)l_query);
          have_cigar = true;
        } else {
          int32_t sc32 = 0;
          cig.resize(2 * (size_t)(l_query + (int64_t)rseq.size() + 2));
          int32_t n_ops = ksw_global_one(
              qbuf.data(), (int)l_query, rseq.data(), (int)rseq.size(),
              o_del, e_del, o_ins, e_ins, (int)w2, match, mismatch, n_sc,
              &sc32, cig.data(), (int32_t)(cig.size() / 2));
          score = sc32;
          if (n_ops >= 0 && n_ops > 0) {
            cig.resize(2 * (size_t)n_ops);
            have_cigar = true;
          } else {
            cig.clear();
          }
        }
        if (have_cigar) {
          int64_t n_mm = 0, n_gap = 0, x = 0, y = 0;
          int64_t n_ops = (int64_t)cig.size() / 2;
          for (int64_t k = 0; k < n_ops; ++k) {
            int op = cig[2 * k], ln = cig[2 * k + 1];
            if (op == 0) {
              for (int64_t u = 0; u < ln; ++u)
                if (qbuf[x + u] != rseq[y + u]) ++n_mm;
              x += ln;
              y += ln;
            } else if (op == 2) {
              if (k > 0 && k < n_ops - 1) n_gap += ln;
              y += ln;
            } else if (op == 1) {
              x += ln;
              n_gap += ln;
            }
          }
          NM = n_mm + n_gap;
        }
      }
      first_round = false;
      if (score == last_sc || w2 == band_width << 2) break;
      last_sc = score;
      w2 <<= 1;
      ++i;
      if (!(i < 3 && score < truesc - match)) break;
    }
    // position + D squeeze + clips
    int64_t dpos = rb < l_pac ? rb : re - 1;
    bool is_rev = dpos >= l_pac;
    int64_t pos = is_rev ? seq_len - 1 - dpos : dpos;
    if (!cig.empty()) {
      if (cig[0] == 2) {
        pos += cig[1];
        cig.erase(cig.begin(), cig.begin() + 2);
      } else if (cig[cig.size() - 2] == 2) {
        cig.resize(cig.size() - 2);
      }
    }
    if (qb != 0 || qe != l_full) {
      int64_t clip5 = is_rev ? l_full - qe : qb;
      int64_t clip3 = is_rev ? qb : l_full - qe;
      if (clip5 > 0) {
        cig.insert(cig.begin(), (int32_t)clip5);
        cig.insert(cig.begin(), 3);
      }
      if (clip3 > 0) {
        cig.push_back(3);
        cig.push_back((int32_t)clip3);
      }
    }
    int rid = g.pos_to_contig(pos);
    int64_t n_pairs = (int64_t)cig.size() / 2;
    if (cig_total + n_pairs > cigar_cap) return -1;
    for (size_t k = 0; k < cig.size(); ++k)
      cigar_out[cig_total * 2 + k] = cig[k];
    m[0] = pos;
    m[1] = rid;
    m[2] = is_rev ? 1 : 0;
    m[3] = NM;
    m[4] = n_pairs;
    m[5] = cig_total;
    cig_total += n_pairs;
  }
  return cig_total;
}

// GetAlignments' CIGAR walk (lariat.go:1552-1704 semantics, mirrored from
// rfa/candidates.py): count matches/indels/soft-clips and collect mismatch
// loci by comparing the contig-fetched ASCII reference slice against the
// raw read bytes. tasks rows (int64): [cigar_off, n_cigar_pairs, ref_off,
// ref_len, read_off, read_len, ref_start, ref_end, reversed]. stats out
// rows (int64 x6): [matches, indels, indel_length, soft_clipped,
// soft_clipped_length, n_mismatch]; mismatch (loc, read_loc) int64 pairs
// appended to mm_out (per-task offset in stats via running total order).
// Returns total mismatch pairs, -1 if mm_cap exceeded, -2 on the
// cigar-longer-than-read invariant breach (caller raises).
int64_t mismatch_walk_batch(const int32_t* cigars, const uint8_t* refs,
                            const uint8_t* reads, const int64_t* tasks,
                            int64_t n_tasks, int64_t* stats_out,
                            int64_t* mm_off_out, int64_t* mm_out,
                            int64_t mm_cap) {
  int64_t total = 0;
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* tk = tasks + t * 9;
    const int32_t* cig = cigars + tk[0];
    int64_t n_pairs = tk[1];
    const uint8_t* ref = refs + tk[2];
    int64_t ref_len = tk[3];
    const uint8_t* read = reads + tk[4];
    int64_t read_len = tk[5];
    int64_t ref_start = tk[6], ref_end = tk[7];
    bool rev = tk[8] != 0;
    int64_t matches = 0, indels = 0, indel_len = 0, sc = 0, sc_len = 0;
    int64_t ref_off = 0, read_off = 0, n_mm = 0;
    mm_off_out[t] = total;
    for (int64_t kk = 0; kk < n_pairs; ++kk) {
      // ops walked in reverse order on the reverse strand
      int64_t k = rev ? n_pairs - 1 - kk : kk;
      int op = cig[2 * k], ln = cig[2 * k + 1];
      if (op == 0) {
        matches += ln;
        int64_t n_ref = std::min((int64_t)ln,
                                 std::max(ref_len - ref_off, (int64_t)0));
        if (read_off + n_ref > read_len) return -2;
        for (int64_t m = 0; m < n_ref; ++m) {
          if (ref[ref_off + m] != read[read_off + m]) {
            if (total + n_mm >= mm_cap) return -1;
            int64_t loc = rev ? ref_end - (ref_off + m)
                              : ref_off + ref_start + m;
            mm_out[2 * (total + n_mm)] = loc;
            mm_out[2 * (total + n_mm) + 1] = read_off + m;
            ++n_mm;
          }
        }
        ref_off += ln;
        read_off += ln;
      } else if (op == 1) {
        ++indels;
        indel_len += ln;
        read_off += ln;
      } else if (op == 2) {
        ++indels;
        indel_len += ln;
        ref_off += ln;
      } else if (op == 3) {
        ++sc;
        sc_len += ln;
        read_off += ln;
      }
    }
    int64_t* st = stats_out + t * 6;
    st[0] = matches;
    st[1] = indels;
    st[2] = indel_len;
    st[3] = sc;
    st[4] = sc_len;
    st[5] = n_mm;
    total += n_mm;
  }
  return total;
}

// mismatch_walk_batch variant that fetches reference windows itself from
// the unpacked base-codes cache (codes 0..3 over [0, l_pac)) instead of
// receiving pre-extracted ref bytes — removes tens of thousands of
// per-candidate Python get_seq calls from the hot worker path.
// tasks rows (int64 x9): [cig_off, n_pairs, gstart, gend, read_off,
// read_len, ref_start, ref_end, rev] where gstart/gend are the
// already-clamped GLOBAL fetch window (fmindex.get_seq semantics) and
// ref_start/ref_end stay contig-local for mismatch-locus arithmetic.
int64_t mismatch_walk_fetch_batch(const int32_t* cigars, const uint8_t* codes,
                                  const uint8_t* reads, const int64_t* tasks,
                                  int64_t n_tasks, int64_t* stats_out,
                                  int64_t* mm_off_out, int64_t* mm_out,
                                  int64_t mm_cap) {
  static const uint8_t FWD[4] = {'A', 'C', 'G', 'T'};
  static const uint8_t RC[4] = {'T', 'G', 'C', 'A'};
  int64_t total = 0;
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* tk = tasks + t * 9;
    const int32_t* cig = cigars + tk[0];
    int64_t n_pairs = tk[1];
    int64_t gstart = tk[2], gend = tk[3];
    int64_t ref_len = gend > gstart ? gend - gstart : 0;
    const uint8_t* read = reads + tk[4];
    int64_t read_len = tk[5];
    int64_t ref_start = tk[6], ref_end = tk[7];
    bool rev = tk[8] != 0;
    int64_t matches = 0, indels = 0, indel_len = 0, sc = 0, sc_len = 0;
    int64_t ref_off = 0, read_off = 0, n_mm = 0;
    mm_off_out[t] = total;
    for (int64_t kk = 0; kk < n_pairs; ++kk) {
      int64_t k = rev ? n_pairs - 1 - kk : kk;
      int op = cig[2 * k], ln = cig[2 * k + 1];
      if (op == 0) {
        matches += ln;
        int64_t n_ref = std::min((int64_t)ln,
                                 std::max(ref_len - ref_off, (int64_t)0));
        if (read_off + n_ref > read_len) return -2;
        for (int64_t m = 0; m < n_ref; ++m) {
          int64_t ri = ref_off + m;
          uint8_t rb = rev ? RC[codes[gend - 1 - ri] & 3]
                           : FWD[codes[gstart + ri] & 3];
          if (rb != read[read_off + m]) {
            if (total + n_mm >= mm_cap) return -1;
            int64_t loc = rev ? ref_end - ri : ri + ref_start;
            mm_out[2 * (total + n_mm)] = loc;
            mm_out[2 * (total + n_mm) + 1] = read_off + m;
            ++n_mm;
          }
        }
        ref_off += ln;
        read_off += ln;
      } else if (op == 1) {
        ++indels;
        indel_len += ln;
        read_off += ln;
      } else if (op == 2) {
        ++indels;
        indel_len += ln;
        ref_off += ln;
      } else if (op == 3) {
        ++sc;
        sc_len += ln;
        read_off += ln;
      }
    }
    int64_t* st = stats_out + t * 6;
    st[0] = matches;
    st[1] = indels;
    st[2] = indel_len;
    st[3] = sc;
    st[4] = sc_len;
    st[5] = n_mm;
    total += n_mm;
  }
  return total;
}

// Vectorized Go-style PRNG seeding chain for utils/gorand.py: out[i][k] =
// seeds[i] * powers[k] mod (2^31 - 1). The constant modulus lets the
// compiler strength-reduce the division (numpy's uint64 % cannot).
void gorand_chain_batch(const int64_t* seeds, int64_t n,
                        const uint64_t* powers, int64_t n_pow,
                        uint64_t* out) {
  constexpr uint64_t M = 0x7FFFFFFFULL;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t s = (uint64_t)seeds[i];
    uint64_t* row = out + i * n_pow;
    for (int64_t k = 0; k < n_pow; ++k)
      row[k] = (s * powers[k]) % M;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Two-phase mem_align1 session: the chain/filter/skip/dedup control flow runs
// here (C++), while every banded-SW extension is exported as one entry of a
// batched DEVICE wave (ops/sw_batch.extend_batch computes them; the caller
// feeds the results back). This replaces the Python per-seed replay that made
// device priming lose end-to-end (VERDICT r1 item 1): extension RESULTS
// depend only on (seed, window) inputs — never on skip decisions — so waves
// can run speculatively for every seed and the sequential control flow
// replays bit-identically from cached results.
//
// Protocol (ctypes):
//   h = a1s_start(...)            -> fills wave_info[3] = {n_tasks, maxq, maxt}
//   while wave_info[0] > 0:
//       a1s_fill(h, bufs...)      -> caller runs the device extend kernel
//       a1s_feed(h, results...)   -> refills wave_info (ladder retries, then
//                                    the right-extension wave, then 0)
//   a1s_finish(h, out...)         -> mem_align1_batch-format regions
//   a1s_free(h)

namespace {

struct SeedExt {
  int32_t l_eo[6] = {0, 0, 0, 0, 0, 0};
  int32_t r_eo[6] = {0, 0, 0, 0, 0, 0};
  int64_t aw0 = 0, aw1 = 0;
  int64_t prev_l = -1, prev_r = -1;  // ladder break uses prev = -1, matching
                                     // the sequential path above
  int lvl_l = 0, lvl_r = 0;
  int64_t sc0 = 0;                   // h0 entering the right ladder
};

struct SessChain {
  Chain chain;
  ChainGeom geom;
  std::vector<SeedExt> ext;
};

struct SessRead {
  int64_t q_off = 0, l_query = 0;
  double frac_rep = 0.0;
  std::vector<SessChain> chains;
};

struct Task {
  int32_t read, chain, seed;
  uint8_t side;  // 0 = left, 1 = right
};

struct Session {
  Genome g;                             // pac not owned; caller keeps alive
  Opt o;
  std::vector<int64_t> contig_offs;
  std::vector<uint8_t> reads;           // flat read codes (owned copy)
  std::vector<SessRead> rd;
  std::vector<Task> wave;
  int phase = 0;                        // 0 = left ladders, 1 = right ladders

  const uint8_t* q_of(const Task& t) const {
    return reads.data() + rd[t.read].q_off;
  }
  void task_dims(const Task& t, int64_t* ql, int64_t* tl) const {
    const SessChain& sc = rd[t.read].chains[t.chain];
    const Seed& s = sc.chain.seeds[t.seed];
    if (t.side == 0) {
      *ql = s.qbeg;
      *tl = s.rbeg - sc.geom.rmax0;
    } else {
      *ql = rd[t.read].l_query - (s.qbeg + s.len);
      *tl = (int64_t)sc.geom.rseq.size() - (s.rbeg + s.len - sc.geom.rmax0);
    }
  }
  void wave_info(int64_t* info) const {
    int64_t maxq = 0, maxt = 0;
    for (const Task& t : wave) {
      int64_t ql, tl;
      task_dims(t, &ql, &tl);
      maxq = std::max(maxq, ql);
      maxt = std::max(maxt, tl);
    }
    info[0] = (int64_t)wave.size();
    info[1] = maxq;
    info[2] = maxt;
    info[3] = phase;  // 0: left wave (end bonus pen_clip5); 1: right
                      // (pen_clip3) — waves never mix sides
  }
  void emit_right() {
    phase = 1;
    for (int32_t r = 0; r < (int32_t)rd.size(); ++r) {
      for (int32_t ci = 0; ci < (int32_t)rd[r].chains.size(); ++ci) {
        SessChain& sc = rd[r].chains[ci];
        for (int32_t si = 0; si < (int32_t)sc.chain.seeds.size(); ++si) {
          const Seed& s = sc.chain.seeds[si];
          if (s.qbeg + s.len == rd[r].l_query) continue;
          SeedExt& e = sc.ext[si];
          // sc0: the left outcome's LOCAL max (score branch), or the pure
          // seed score when there was no left segment — exactly what the
          // sequential flow feeds ksw as h0
          e.sc0 = s.qbeg ? e.l_eo[0] : s.len * o.match;
          wave.push_back(Task{r, ci, si, 1});
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* a1s_start(
    const uint8_t* pac, int64_t l_pac, const int64_t* contig_offs,
    int64_t n_contigs, const uint8_t* reads_flat,
    const int64_t* read_offsets, int64_t n_reads, const int64_t* mems_flat,
    const int64_t* mem_offsets, const int64_t* rbegs_flat,
    const int64_t* rbeg_offsets, const int64_t* oi, const double* od,
    int64_t* wave_info) {
  Session* S = new Session();
  S->contig_offs.assign(contig_offs, contig_offs + n_contigs);
  S->g = Genome{pac, l_pac, S->contig_offs.data(), n_contigs};
  Opt& o = S->o;
  o.match = (int)oi[0];
  o.mismatch = (int)oi[1];
  o.n_sc = (int)oi[2];
  o.o_del = (int)oi[3];
  o.e_del = (int)oi[4];
  o.o_ins = (int)oi[5];
  o.e_ins = (int)oi[6];
  o.pen_clip5 = (int)oi[7];
  o.pen_clip3 = (int)oi[8];
  o.zdrop = (int)oi[9];
  o.band_width = oi[10];
  o.max_chain_gap = oi[11];
  o.max_occ = oi[12];
  o.min_seed_len = oi[13];
  o.min_chain_weight = oi[14];
  o.max_chain_extend = oi[15];
  o.mask_level = od[0];
  o.mask_level_redun = od[1];
  o.drop_ratio = od[2];

  S->reads.assign(reads_flat, reads_flat + read_offsets[n_reads]);
  S->rd.resize(n_reads);
  std::vector<Chain> chains;
  for (int64_t r = 0; r < n_reads; ++r) {
    SessRead& sr = S->rd[r];
    sr.q_off = read_offsets[r];
    sr.l_query = read_offsets[r + 1] - read_offsets[r];
    if (sr.l_query == 0) continue;
    const int64_t* mems = mems_flat + mem_offsets[r] * 5;
    int64_t n_mems = mem_offsets[r + 1] - mem_offsets[r];
    const int64_t* rbegs = rbegs_flat + rbeg_offsets[r];
    int64_t n_rbegs = rbeg_offsets[r + 1] - rbeg_offsets[r];
    chain_seeds(S->g, o, sr.l_query, mems, n_mems, rbegs, n_rbegs, chains,
                &sr.frac_rep);
    filter_chains(o, chains);
    sr.chains.resize(chains.size());
    for (size_t ci = 0; ci < chains.size(); ++ci) {
      SessChain& sc = sr.chains[ci];
      sc.chain = std::move(chains[ci]);
      compute_geom(S->g, o, sr.l_query, sc.chain, sc.geom);
      sc.ext.resize(sc.chain.seeds.size());
      // speculative LEFT wave for every seed with a left segment
      for (int32_t si = 0; si < (int32_t)sc.chain.seeds.size(); ++si)
        if (sc.chain.seeds[si].qbeg)
          S->wave.push_back(Task{(int32_t)r, (int32_t)ci, si, 0});
    }
  }
  if (S->wave.empty()) S->emit_right();
  S->wave_info(wave_info);
  return S;
}

// Fill the current wave's padded task buffers. qbuf/tbuf are (n, qstride) /
// (n, tstride) uint8, caller-zeroed; h0/w/qlen/tlen are int32[n].
void a1s_fill(void* h, uint8_t* qbuf, int64_t qstride, uint8_t* tbuf,
              int64_t tstride, int32_t* qlen, int32_t* tlen, int32_t* h0,
              int32_t* w) {
  Session* S = (Session*)h;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    const Task& t = S->wave[i];
    const SessChain& sc = S->rd[t.read].chains[t.chain];
    const Seed& s = sc.chain.seeds[t.seed];
    const SeedExt& e = sc.ext[t.seed];
    const uint8_t* q = S->q_of(t);
    int64_t ql, tl;
    S->task_dims(t, &ql, &tl);
    qlen[i] = (int32_t)ql;
    tlen[i] = (int32_t)tl;
    if (t.side == 0) {
      for (int64_t k = 0; k < ql; ++k)           // reversed query prefix
        qbuf[i * qstride + k] = q[s.qbeg - 1 - k];
      int64_t off = s.rbeg - sc.geom.rmax0;
      for (int64_t k = 0; k < tl; ++k)           // reversed target prefix
        tbuf[i * tstride + k] = sc.geom.rseq[off - 1 - k];
      h0[i] = (int32_t)(s.len * S->o.match);
      w[i] = (int32_t)(S->o.band_width << e.lvl_l);
    } else {
      int64_t qe = s.qbeg + s.len;
      for (int64_t k = 0; k < ql; ++k)
        qbuf[i * qstride + k] = q[qe + k];
      int64_t off = s.rbeg + s.len - sc.geom.rmax0;
      for (int64_t k = 0; k < tl; ++k)
        tbuf[i * tstride + k] = sc.geom.rseq[off + k];
      h0[i] = (int32_t)e.sc0;
      w[i] = (int32_t)(S->o.band_width << e.lvl_r);
    }
  }
}

// Descriptor variant of a1s_fill: instead of materializing the (reversed)
// query/target byte buffers, emit per-task slice descriptors the device
// reconstructs from HBM-resident reads + 2-bit pac (ops/resident.py):
//   query[k]  = read[qstart + k*qdir],  k in [0, qlen)
//   target[k] = fmd_code(tstart + k*tdir)
// ~48 B/task upload instead of ~3 KB.
void a1s_fill_desc(void* h, int32_t* rid, int64_t* qstart, int32_t* qdir,
                   int32_t* qlen, int64_t* tstart, int32_t* tdir,
                   int32_t* tlen, int32_t* h0, int32_t* w) {
  Session* S = (Session*)h;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    const Task& t = S->wave[i];
    const SessChain& sc = S->rd[t.read].chains[t.chain];
    const Seed& s = sc.chain.seeds[t.seed];
    const SeedExt& e = sc.ext[t.seed];
    int64_t ql, tl;
    S->task_dims(t, &ql, &tl);
    rid[i] = t.read;
    qlen[i] = (int32_t)ql;
    tlen[i] = (int32_t)tl;
    if (t.side == 0) {
      qstart[i] = s.qbeg - 1;
      qdir[i] = -1;
      tstart[i] = s.rbeg - 1;
      tdir[i] = -1;
      h0[i] = (int32_t)(s.len * S->o.match);
      w[i] = (int32_t)(S->o.band_width << e.lvl_l);
    } else {
      qstart[i] = s.qbeg + s.len;
      qdir[i] = 1;
      tstart[i] = s.rbeg + s.len;
      tdir[i] = 1;
      h0[i] = (int32_t)e.sc0;
      w[i] = (int32_t)(S->o.band_width << e.lvl_r);
    }
  }
}

// Feed the device results for the current wave; computes the next wave
// (ladder escalations, then the right wave) and refills wave_info.
void a1s_feed(void* h, const int32_t* score, const int32_t* qle,
              const int32_t* tle, const int32_t* gtle, const int32_t* gscore,
              const int32_t* moff, int64_t* wave_info) {
  Session* S = (Session*)h;
  std::vector<Task> next;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    const Task& t = S->wave[i];
    SessChain& sc = S->rd[t.read].chains[t.chain];
    SeedExt& e = sc.ext[t.seed];
    int32_t eo[6] = {score[i], qle[i], tle[i], gtle[i], gscore[i], moff[i]};
    if (t.side == 0) {
      for (int k = 0; k < 6; ++k) e.l_eo[k] = eo[k];
      int64_t aw = S->o.band_width << e.lvl_l;
      e.aw0 = aw;
      if (!(eo[0] == e.prev_l || eo[5] < (aw >> 1) + (aw >> 2))
          && e.lvl_l + 1 < MAX_BAND_TRY) {
        e.prev_l = eo[0];
        e.lvl_l += 1;
        next.push_back(t);
      }
    } else {
      for (int k = 0; k < 6; ++k) e.r_eo[k] = eo[k];
      int64_t aw = S->o.band_width << e.lvl_r;
      e.aw1 = aw;
      if (!(eo[0] == e.prev_r || eo[5] < (aw >> 1) + (aw >> 2))
          && e.lvl_r + 1 < MAX_BAND_TRY) {
        e.prev_r = eo[0];
        e.lvl_r += 1;
        next.push_back(t);
      }
    }
  }
  S->wave = std::move(next);
  if (S->wave.empty() && S->phase == 0) S->emit_right();
  S->wave_info(wave_info);
}

// Replay the sequential control flow from the cached wave results and emit
// mem_align1_batch-format rows. Idempotent (retry with a larger cap on -1).
int64_t a1s_finish(void* h, double* out, int64_t cap, int64_t* counts,
                   int64_t* offs) {
  Session* S = (Session*)h;
  const Opt& o = S->o;
  int64_t total = 0;
  std::vector<Reg> regs;
  std::vector<uint8_t> rseq;
  for (int64_t r = 0; r < (int64_t)S->rd.size(); ++r) {
    SessRead& sr = S->rd[r];
    offs[r] = total;
    counts[r] = 0;
    if (sr.l_query == 0) continue;
    const uint8_t* q = S->reads.data() + sr.q_off;
    regs.clear();
    for (SessChain& sc : sr.chains) {
      auto left = [&](int64_t si, const Seed&, int32_t* eo, int64_t* aw) {
        const SeedExt& e = sc.ext[si];
        for (int k = 0; k < 6; ++k) eo[k] = e.l_eo[k];
        *aw = e.aw0;
      };
      auto right = [&](int64_t si, const Seed&, int64_t, int32_t* eo,
                       int64_t* aw) {
        const SeedExt& e = sc.ext[si];
        for (int k = 0; k < 6; ++k) eo[k] = e.r_eo[k];
        *aw = e.aw1;
      };
      chain2aln_core(S->g, o, q, sr.l_query, sc.chain, sc.geom, regs, left,
                     right);
    }
    sort_dedup_patch(S->g, o, q, regs, rseq);
    if (total + (int64_t)regs.size() > cap) return -1;
    for (const Reg& p : regs) {
      double* row = out + total * 14;
      row[0] = (double)p.rb;
      row[1] = (double)p.re;
      row[2] = (double)p.qb;
      row[3] = (double)p.qe;
      row[4] = (double)p.rid;
      row[5] = (double)p.score;
      row[6] = (double)p.truesc;
      row[7] = (double)p.sub;
      row[8] = (double)p.csub;
      row[9] = (double)p.seedcov;
      row[10] = (double)p.w;
      row[11] = (double)p.seedlen0;
      row[12] = (double)p.n_comp;
      row[13] = sr.frac_rep;
      ++total;
    }
    counts[r] = (int64_t)regs.size();
  }
  return total;
}

void a1s_free(void* h) { delete (Session*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Two-phase mem_reg2aln session: the w2 band ladder + NM/clip finishing run
// here; the banded global DP + traceback run as device waves
// (ops/sw_global_batch: global_batch + on-device traceback; the caller feeds
// back scores and RLE'd cigars from ksw_cigar_from_ops_packed_batch). Bit-identical to mem_reg2aln_batch
// (fuzz-asserted): the DP inputs (qbuf, rseq, w2) never depend on other
// tasks, only the ladder schedule changes.

namespace {

struct R2Task {
  int64_t qb = 0, qe = 0, rb = 0, re = 0, truesc = 0;
  int64_t l_full = 0, ridx = 0;
  std::vector<uint8_t> qbuf, rseq;   // oriented once (reversed when rb>=l_pac)
  int64_t w2 = 0, last_sc = -((int64_t)1 << 30);
  int iter = 0;
  int64_t score = 0;
  std::vector<int32_t> cig;
  bool have_cigar = false, degenerate = false, shortcut = false;
};

struct R2Session {
  Genome g;
  std::vector<int64_t> contig_offs;
  int match, mismatch, n_sc, o_del, e_del, o_ins, e_ins;
  int64_t band_width;
  std::vector<R2Task> tasks;
  std::vector<int64_t> wave;   // indices of tasks awaiting device results

  // ladder break conditions given the just-computed score; returns true
  // when the task is final (mirrors mem_reg2aln_batch's while loop tail)
  bool advance(R2Task& t) {
    if (t.score == t.last_sc || t.w2 == band_width << 2) return true;
    t.last_sc = t.score;
    t.w2 <<= 1;
    ++t.iter;
    return !(t.iter < 3 && t.score < t.truesc - match);
  }

  // score the no-DP / degenerate variants synchronously; returns true when
  // the task never needs the device
  bool sync_gen(R2Task& t) {
    t.w2 = std::min(t.w2, band_width << 2);
    if (t.degenerate) {
      t.score = 0;
      t.have_cigar = false;
      t.cig.clear();
      return true;
    }
    if (t.shortcut && t.w2 == 0) {
      int64_t l_query = t.qe - t.qb;
      t.score = 0;
      for (int64_t k = 0; k < l_query; ++k)
        t.score += score_sub_pub(t.qbuf[k], t.rseq[k], match, mismatch, n_sc);
      t.cig.assign({0, (int32_t)l_query});
      t.have_cigar = true;
      return true;
    }
    return false;
  }

  void run_sync(R2Task& t) {
    // degenerate / shortcut ladders terminate without device work
    while (true) {
      sync_gen(t);
      if (advance(t)) break;
    }
  }

  void wave_info(int64_t* info) const {
    int64_t maxq = 0, maxt = 0;
    for (int64_t ti : wave) {
      maxq = std::max(maxq, (int64_t)tasks[ti].qbuf.size());
      maxt = std::max(maxt, (int64_t)tasks[ti].rseq.size());
    }
    info[0] = (int64_t)wave.size();
    info[1] = maxq;
    info[2] = maxt;
  }
};

}  // namespace

extern "C" {

void* r2s_start(const uint8_t* pac, int64_t l_pac, const int64_t* contig_offs,
                int64_t n_contigs, const uint8_t* reads_flat,
                const int64_t* read_offsets, const int64_t* task_rows,
                int64_t n_tasks, const int64_t* oi, int64_t* wave_info) {
  R2Session* S = new R2Session();
  S->contig_offs.assign(contig_offs, contig_offs + n_contigs);
  S->g = Genome{pac, l_pac, S->contig_offs.data(), n_contigs};
  S->match = (int)oi[0];
  S->mismatch = (int)oi[1];
  S->n_sc = (int)oi[2];
  S->o_del = (int)oi[3];
  S->e_del = (int)oi[4];
  S->o_ins = (int)oi[5];
  S->e_ins = (int)oi[6];
  S->band_width = oi[10];

  auto infer_bw = [&](int64_t l1, int64_t l2, int64_t score, int q_pen,
                      int r_pen) -> int64_t {
    if (l1 == l2
        && l1 * S->match - score < (int64_t)(q_pen + r_pen - S->match) << 1)
      return 0;
    int64_t w = (int64_t)((double)(std::min(l1, l2) * S->match - score - q_pen)
                          / r_pen + 2.0);
    return std::max(w, (int64_t)std::llabs(l1 - l2));
  };

  S->tasks.resize(n_tasks);
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* tk = task_rows + t * 7;
    R2Task& T = S->tasks[t];
    int64_t ridx = tk[0];
    T.ridx = ridx;
    T.qb = tk[1];
    T.qe = tk[2];
    T.rb = tk[3];
    T.re = tk[4];
    T.truesc = tk[5];
    int64_t reg_w = tk[6];
    const uint8_t* read = reads_flat + read_offsets[ridx];
    T.l_full = read_offsets[ridx + 1] - read_offsets[ridx];
    int64_t l_query = T.qe - T.qb;
    T.w2 = std::max(infer_bw(l_query, T.re - T.rb, T.truesc, S->o_del,
                             S->e_del),
                    infer_bw(l_query, T.re - T.rb, T.truesc, S->o_ins,
                             S->e_ins));
    if (T.w2 > S->band_width) T.w2 = std::min(T.w2, reg_w);
    T.degenerate = (l_query <= 0 || T.rb >= T.re
                    || (T.rb < l_pac && l_pac < T.re));
    if (!T.degenerate) {
      S->g.fetch(T.rb, T.re, T.rseq);
      T.qbuf.assign(read + T.qb, read + T.qe);
      if (T.rb >= l_pac) {
        std::reverse(T.qbuf.begin(), T.qbuf.end());
        std::reverse(T.rseq.begin(), T.rseq.end());
      }
      T.shortcut = (l_query == T.re - T.rb);
    }
    T.w2 = std::min(T.w2, S->band_width << 2);
    if (T.degenerate || (T.shortcut && T.w2 == 0)) {
      S->run_sync(T);
    } else {
      S->wave.push_back(t);
    }
  }
  S->wave_info(wave_info);
  return S;
}

void r2s_fill(void* h, uint8_t* qbuf, int64_t qstride, uint8_t* tbuf,
              int64_t tstride, int32_t* qlen, int32_t* tlen, int32_t* w) {
  R2Session* S = (R2Session*)h;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    const R2Task& T = S->tasks[S->wave[i]];
    qlen[i] = (int32_t)T.qbuf.size();
    tlen[i] = (int32_t)T.rseq.size();
    w[i] = (int32_t)T.w2;
    std::copy(T.qbuf.begin(), T.qbuf.end(), qbuf + i * qstride);
    std::copy(T.rseq.begin(), T.rseq.end(), tbuf + i * tstride);
  }
}

// Descriptor variant of r2s_fill (see a1s_fill_desc): query is a plain
// read slice and target a doubled-text window, both reversed together
// when the region sits on the reverse strand (rb >= l_pac) — expressed
// as direction flags the device gather applies.
void r2s_fill_desc(void* h, int32_t* rid, int64_t* qstart, int32_t* qdir,
                   int32_t* qlen, int64_t* tstart, int32_t* tdir,
                   int32_t* tlen, int32_t* w) {
  R2Session* S = (R2Session*)h;
  int64_t l_pac = S->g.l_pac;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    const R2Task& T = S->tasks[S->wave[i]];
    rid[i] = (int32_t)T.ridx;
    qlen[i] = (int32_t)(T.qe - T.qb);
    tlen[i] = (int32_t)(T.re - T.rb);
    w[i] = (int32_t)T.w2;
    if (T.rb >= l_pac) {
      qstart[i] = T.qe - 1;
      qdir[i] = -1;
      tstart[i] = T.re - 1;
      tdir[i] = -1;
    } else {
      qstart[i] = T.qb;
      qdir[i] = 1;
      tstart[i] = T.rb;
      tdir[i] = 1;
    }
  }
}

// scores int32[n]; cig int32 (n, 2*cap) op/len pairs; nops int32[n]
void r2s_feed(void* h, const int32_t* score, const int32_t* cig,
              int64_t cig_cap, const int32_t* nops, int64_t* wave_info) {
  R2Session* S = (R2Session*)h;
  std::vector<int64_t> next;
  for (size_t i = 0; i < S->wave.size(); ++i) {
    R2Task& T = S->tasks[S->wave[i]];
    T.score = score[i];
    int32_t n = nops[i];
    if (n > 0) {
      T.cig.assign(cig + i * 2 * cig_cap, cig + i * 2 * cig_cap + 2 * n);
      T.have_cigar = true;
    } else {
      T.cig.clear();
      T.have_cigar = false;
    }
    if (!S->advance(T)) {
      // stays a device task (degenerate/shortcut never enter the wave, and
      // escalation keeps w2 > 0); clamp like the sequential loop top
      T.w2 = std::min(T.w2, S->band_width << 2);
      next.push_back(S->wave[i]);
    }
  }
  S->wave = std::move(next);
  S->wave_info(wave_info);
}

int64_t r2s_finish(void* h, int64_t* meta_out, int32_t* cigar_out,
                   int64_t cigar_cap) {
  R2Session* S = (R2Session*)h;
  int64_t l_pac = S->g.l_pac, seq_len = 2 * l_pac;
  int64_t cig_total = 0;
  std::vector<int32_t> cig;
  for (size_t t = 0; t < S->tasks.size(); ++t) {
    R2Task& T = S->tasks[t];
    int64_t* m = meta_out + t * 6;
    // NM walk over the final cigar
    int64_t NM = -1;
    if (T.have_cigar) {
      int64_t n_mm = 0, n_gap = 0, x = 0, y = 0;
      int64_t n_ops = (int64_t)T.cig.size() / 2;
      for (int64_t k = 0; k < n_ops; ++k) {
        int op = T.cig[2 * k], ln = T.cig[2 * k + 1];
        if (op == 0) {
          for (int64_t u = 0; u < ln; ++u)
            if (T.qbuf[x + u] != T.rseq[y + u]) ++n_mm;
          x += ln;
          y += ln;
        } else if (op == 2) {
          if (k > 0 && k < n_ops - 1) n_gap += ln;
          y += ln;
        } else if (op == 1) {
          x += ln;
          n_gap += ln;
        }
      }
      NM = n_mm + n_gap;
    }
    cig = T.cig;
    int64_t dpos = T.rb < l_pac ? T.rb : T.re - 1;
    bool is_rev = dpos >= l_pac;
    int64_t pos = is_rev ? seq_len - 1 - dpos : dpos;
    if (!cig.empty()) {
      if (cig[0] == 2) {
        pos += cig[1];
        cig.erase(cig.begin(), cig.begin() + 2);
      } else if (cig[cig.size() - 2] == 2) {
        cig.resize(cig.size() - 2);
      }
    }
    if (T.qb != 0 || T.qe != T.l_full) {
      int64_t clip5 = is_rev ? T.l_full - T.qe : T.qb;
      int64_t clip3 = is_rev ? T.qb : T.l_full - T.qe;
      if (clip5 > 0) {
        cig.insert(cig.begin(), (int32_t)clip5);
        cig.insert(cig.begin(), 3);
      }
      if (clip3 > 0) {
        cig.push_back(3);
        cig.push_back((int32_t)clip3);
      }
    }
    int rid = S->g.pos_to_contig(pos);
    int64_t n_pairs = (int64_t)cig.size() / 2;
    if (cig_total + n_pairs > cigar_cap) return -1;
    for (size_t k = 0; k < cig.size(); ++k)
      cigar_out[cig_total * 2 + k] = cig[k];
    m[0] = pos;
    m[1] = rid;
    m[2] = is_rev ? 1 : 0;
    m[3] = NM;
    m[4] = n_pairs;
    m[5] = cig_total;
    cig_total += n_pairs;
  }
  return cig_total;
}

void r2s_free(void* h) { delete (R2Session*)h; }

}  // extern "C"
