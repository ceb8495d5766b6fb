// SMEM seeding + SA lookup over the FMD index (native hot path).
//
// C++ implementation of the three-round seeding strategy and the sampled-SA
// dereference consumed by the chaining stage — the host-side equivalents of
// the reference's C hot loops #1 (SMEM seeding inside mem_align1_core) and
// the bwt_sa walks (SURVEY.md section 3.2). Operates directly on the numpy
// index arrays via a view struct; exposed through a C ABI for ctypes.
// Multithreaded across reads.

#include <algorithm>
#include <coroutine>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int OCC_INTERVAL = 128;
constexpr int WORDS_PER_BLOCK = OCC_INTERVAL / 16;

struct FMView {
  const uint32_t* bwt_words;   // (n_blocks * 8)
  const int64_t* occ_ckpt;     // (n_blocks + 1, 4)
  const int64_t* L2;           // (5,)
  const int64_t* sa_samples;   // (n_sa,)
  int64_t primary;
  int64_t seq_len;
  int64_t sa_intv;
};

struct Intv {
  int64_t x0, x1, s;
  int32_t qb, qe;
};

inline int64_t occ_one(const FMView& fm, int64_t k, int c) {
  if (k == fm.seq_len) return fm.L2[c + 1] - fm.L2[c];
  if (k < 0) return 0;
  if (k >= fm.primary) --k;
  int64_t pos = k + 1;
  int64_t blk = pos / OCC_INTERVAL;
  int rem = static_cast<int>(pos % OCC_INTERVAL);
  int64_t cnt = fm.occ_ckpt[blk * 4 + c];
  const uint32_t* w = fm.bwt_words + blk * WORDS_PER_BLOCK;
  const uint64_t pat64 = 0x5555555555555555ull * static_cast<uint64_t>(c);
  int full = rem / 16;
  int i = 0;
  for (; i + 2 <= full; i += 2) {
    uint64_t x;
    std::memcpy(&x, w + i, 8);
    uint64_t y = x ^ pat64;
    cnt += __builtin_popcountll(~(y | (y >> 1)) & 0x5555555555555555ull);
  }
  uint32_t pat = 0x55555555u * static_cast<uint32_t>(c);
  if (i < full) {
    uint32_t y = w[i] ^ pat;
    cnt += __builtin_popcount(~(y | (y >> 1)) & 0x55555555u);
  }
  int tail = rem % 16;
  if (tail) {
    uint32_t y = w[full] ^ pat;
    uint32_t m = ~(y | (y >> 1)) & 0x55555555u;
    uint32_t keep = (0xFFFFFFFFu >> (32 - 2 * tail)) << (32 - 2 * tail);
    cnt += __builtin_popcount(m & keep);
  }
  return cnt;
}

inline void occ_four(const FMView& fm, int64_t k, int64_t out[4]) {
  if (k == fm.seq_len) {
    for (int c = 0; c < 4; ++c) out[c] = fm.L2[c + 1] - fm.L2[c];
    return;
  }
  if (k < 0) {
    for (int c = 0; c < 4; ++c) out[c] = 0;
    return;
  }
  if (k >= fm.primary) --k;
  int64_t pos = k + 1;
  int64_t blk = pos / OCC_INTERVAL;
  int rem = static_cast<int>(pos % OCC_INTERVAL);
  const uint32_t* w = fm.bwt_words + blk * WORDS_PER_BLOCK;
  for (int c = 0; c < 4; ++c) out[c] = fm.occ_ckpt[blk * 4 + c];
  // Bit-plane counting: a = low bits, b = high bits of each 2-bit code, so
  // code 3 = a&b, code 2 = b&~a, code 1 = a&~b; code 0 falls out as
  // rem - c1 - c2 - c3 (every base in the block is one of the four codes).
  // 3 popcounts per u64 (32 bases) vs 4 xor/or/shift/popcount chains per
  // u32 — the seeding hot path is compute-bound on this, not DRAM-bound.
  int full = rem / 16;
  int64_t c1 = 0, c2 = 0, c3 = 0;
  int i = 0;
  for (; i + 2 <= full; i += 2) {
    uint64_t x;
    std::memcpy(&x, w + i, 8);
    uint64_t a = x & 0x5555555555555555ull;
    uint64_t b = (x >> 1) & 0x5555555555555555ull;
    uint64_t ab = a & b;
    c3 += __builtin_popcountll(ab);
    c2 += __builtin_popcountll(b ^ ab);
    c1 += __builtin_popcountll(a ^ ab);
  }
  if (i < full) {
    uint32_t x = w[i];
    uint32_t a = x & 0x55555555u;
    uint32_t b = (x >> 1) & 0x55555555u;
    uint32_t ab = a & b;
    c3 += __builtin_popcount(ab);
    c2 += __builtin_popcount(b ^ ab);
    c1 += __builtin_popcount(a ^ ab);
  }
  int tail = rem % 16;
  if (tail) {
    // keep the first `tail` bases = the top 2*tail bits, on low-bit lanes
    uint32_t keep = ((0xFFFFFFFFu >> (32 - 2 * tail)) << (32 - 2 * tail))
                    & 0x55555555u;
    uint32_t x = w[full];
    uint32_t a = x & keep;
    uint32_t b = (x >> 1) & keep;
    uint32_t ab = a & b;
    c3 += __builtin_popcount(ab);
    c2 += __builtin_popcount(b ^ ab);
    c1 += __builtin_popcount(a ^ ab);
  }
  out[0] += rem - c1 - c2 - c3;
  out[1] += c1;
  out[2] += c2;
  out[3] += c3;
}

// bwt_extend: bidirectional extension producing intervals for all 4 codes.
inline void bwt_extend(const FMView& fm, const Intv& ik, Intv ok[4],
                       bool is_back) {
  int64_t qpos = is_back ? ik.x0 : ik.x1;
  int64_t tk[4], tl[4];
  occ_four(fm, qpos - 1, tk);
  occ_four(fm, qpos - 1 + ik.s, tl);
  int64_t sizes[4], starts[4];
  for (int c = 0; c < 4; ++c) {
    sizes[c] = tl[c] - tk[c];
    starts[c] = fm.L2[c] + 1 + tk[c];
  }
  int64_t crosses =
      (qpos <= fm.primary && qpos + ik.s - 1 >= fm.primary) ? 1 : 0;
  int64_t other_base = is_back ? ik.x1 : ik.x0;
  int64_t other[4];
  other[3] = other_base + crosses;
  other[2] = other[3] + sizes[3];
  other[1] = other[2] + sizes[2];
  other[0] = other[1] + sizes[1];
  for (int c = 0; c < 4; ++c) {
    if (is_back) {
      ok[c].x0 = starts[c];
      ok[c].x1 = other[c];
    } else {
      ok[c].x0 = other[c];
      ok[c].x1 = starts[c];
    }
    ok[c].s = sizes[c];
  }
}

inline void set_intv(const FMView& fm, int c, Intv& ik) {
  ik.x0 = fm.L2[c] + 1;
  ik.x1 = fm.L2[3 - c] + 1;
  ik.s = fm.L2[c + 1] - fm.L2[c];
}

// bwt_smem1a: all SMEMs covering position x. Returns the next scan position.
int smem1a(const FMView& fm, const uint8_t* q, int len, int x,
           int64_t min_intv, uint64_t max_intv, std::vector<Intv>& mems,
           std::vector<Intv>& prev, std::vector<Intv>& curr) {
  mems.clear();
  if (q[x] > 3) return x + 1;
  if (min_intv < 1) min_intv = 1;
  Intv ik, ok[4];
  set_intv(fm, q[x], ik);
  ik.qe = x + 1;
  curr.clear();
  int i;
  for (i = x + 1; i < len; ++i) {
    if (max_intv && static_cast<uint64_t>(ik.s) < max_intv) {
      curr.push_back(ik);
      break;
    } else if (q[i] < 4) {
      int c = 3 - q[i];
      bwt_extend(fm, ik, ok, false);
      if (ok[c].s != ik.s) {
        curr.push_back(ik);
        if (ok[c].s < min_intv) break;
      }
      ok[c].qe = i + 1;
      ik = ok[c];
    } else {
      curr.push_back(ik);
      break;
    }
  }
  if (i == len) curr.push_back(ik);
  std::reverse(curr.begin(), curr.end());
  int ret = curr[0].qe;
  std::swap(prev, curr);

  for (i = x - 1; i >= -1; --i) {
    int c = (i < 0 || q[i] > 3) ? -1 : q[i];
    curr.clear();
    for (size_t j = 0; j < prev.size(); ++j) {
      const Intv& p = prev[j];
      bool did_ext = false;
      if (c >= 0 && static_cast<uint64_t>(p.s) >= max_intv) {
        bwt_extend(fm, p, ok, true);
        did_ext = true;
      }
      if (c < 0 || static_cast<uint64_t>(p.s) < max_intv ||
          (did_ext && ok[c].s < min_intv)) {
        if (curr.empty()) {
          if (mems.empty() || i + 1 < mems.back().qb) {
            Intv m = p;
            m.qb = i + 1;
            mems.push_back(m);
          }
        }
      } else if (curr.empty() || ok[c].s != curr.back().s) {
        ok[c].qe = p.qe;
        curr.push_back(ok[c]);
      }
    }
    if (curr.empty()) break;
    std::swap(prev, curr);
  }
  std::reverse(mems.begin(), mems.end());
  return ret;
}

// bwt_seed_strategy1: LAST-like forward-greedy third-round seeding.
int seed_strategy1(const FMView& fm, const uint8_t* q, int len, int x,
                   int min_len, int64_t max_intv, Intv* mem, bool* found) {
  *found = false;
  if (q[x] > 3) return x + 1;
  Intv ik, ok[4];
  set_intv(fm, q[x], ik);
  for (int i = x + 1; i < len; ++i) {
    if (q[i] < 4) {
      int c = 3 - q[i];
      bwt_extend(fm, ik, ok, false);
      if (ok[c].s < max_intv && i - x >= min_len) {
        *mem = ok[c];
        mem->qb = x;
        mem->qe = i + 1;
        *found = true;
        return i + 1;
      }
      ik = ok[c];
    } else {
      return i + 1;
    }
  }
  return len;
}

// mem_collect_intv: three seeding passes + (qb, qe) sort.
void collect_intv(const FMView& fm, const uint8_t* q, int len,
                  int min_seed_len, double split_factor, int split_width,
                  int64_t max_mem_intv, std::vector<Intv>& mems) {
  mems.clear();
  std::vector<Intv> m1, tmp_prev, tmp_curr;
  int split_len = static_cast<int>(min_seed_len * split_factor + 0.499);
  int x = 0;
  while (x < len) {
    if (q[x] < 4) {
      x = smem1a(fm, q, len, x, 1, 0, m1, tmp_prev, tmp_curr);
      for (const Intv& p : m1)
        if (p.qe - p.qb >= min_seed_len) mems.push_back(p);
    } else {
      ++x;
    }
  }
  size_t old_n = mems.size();
  for (size_t k = 0; k < old_n; ++k) {
    Intv p = mems[k];
    if (p.qe - p.qb < split_len || p.s > split_width) continue;
    smem1a(fm, q, len, (p.qb + p.qe) >> 1, p.s + 1, 0, m1, tmp_prev,
           tmp_curr);
    for (const Intv& m : m1)
      if (m.qe - m.qb >= min_seed_len) mems.push_back(m);
  }
  if (max_mem_intv > 0) {
    x = 0;
    while (x < len) {
      if (q[x] < 4) {
        Intv m;
        bool found;
        x = seed_strategy1(fm, q, len, x, min_seed_len, max_mem_intv, &m,
                           &found);
        if (found && m.s > 0) mems.push_back(m);
      } else {
        ++x;
      }
    }
  }
  std::stable_sort(mems.begin(), mems.end(),
                   [](const Intv& a, const Intv& b) {
                     return a.qb != b.qb ? a.qb < b.qb : a.qe < b.qe;
                   });
}

// ---------------------------------------------------------------------------
// Interleaved seeding. At genome scale every bwt_extend is 2 occ_four calls
// = up to 4 DRAM cache-line misses, and the per-read extension chain is
// strictly serial, so a single read walks at DRAM latency.
// collect_intv_co is collect_intv rewritten as a
// C++20 coroutine that issues prefetches for the next bwt_extend's lines and
// suspends; a round-robin scheduler keeps W reads' chains in flight so the
// misses overlap. The algorithm per read is UNCHANGED (same statements, same
// order); only the cross-read interleaving differs, so output is
// bit-identical to collect_intv (asserted by tests/test_seeding.py and the
// smem-device parity suite). Set LARIAT_NO_INTERLEAVED_SEED=1 to force the
// sequential walker.

struct SeedTask {
  struct promise_type {
    SeedTask get_return_object() {
      return SeedTask{
          std::coroutine_handle<promise_type>::from_promise(*this)};
    }
    std::suspend_always initial_suspend() noexcept { return {}; }
    std::suspend_always final_suspend() noexcept { return {}; }
    void return_void() {}
    void unhandled_exception() { std::terminate(); }
  };
  std::coroutine_handle<promise_type> h;
};

// Prefetch the occ checkpoint + bwt word lines occ_four(k) will read. Both
// 32-byte regions are 32-byte aligned, so each stays within one cache line.
inline void occ4_prefetch(const FMView& fm, int64_t k) {
  if (k < 0 || k == fm.seq_len) return;
  if (k >= fm.primary) --k;
  int64_t blk = (k + 1) / OCC_INTERVAL;
  __builtin_prefetch(fm.bwt_words + blk * WORDS_PER_BLOCK);
  __builtin_prefetch(fm.occ_ckpt + blk * 4);
}

inline void extend_prefetch(const FMView& fm, const Intv& ik, bool is_back) {
  int64_t qpos = is_back ? ik.x0 : ik.x1;
  occ4_prefetch(fm, qpos - 1);
  occ4_prefetch(fm, qpos - 1 + ik.s);
}

// collect_intv as a coroutine: rounds 1+2 run the inlined smem1a body via a
// unified job loop (round 1 scans x forward; round 2 re-seeds qualifying
// round-1 SMEMs in order, both with max_intv == 0 as in collect_intv), then
// round 3 inlines seed_strategy1. Suspension points: one per serial forward
// extension; one per backward row (that row's extends are independent, so
// they are all prefetched together).
SeedTask collect_intv_co(const FMView& fm, const uint8_t* q, int len,
                         int min_seed_len, double split_factor,
                         int split_width, int64_t max_mem_intv,
                         std::vector<Intv>* mems_out, std::vector<Intv>* m1,
                         std::vector<Intv>* prev, std::vector<Intv>* curr) {
  std::vector<Intv>& mems = *mems_out;
  mems.clear();
  int split_len = static_cast<int>(min_seed_len * split_factor + 0.499);
  int x = 0;
  size_t r2_k = 0, old_n = 0;
  bool round2 = false;
  Intv ik, ok[4];
  while (true) {
    int start;
    int64_t min_intv;
    if (!round2) {
      if (x >= len) {
        round2 = true;
        old_n = mems.size();
        continue;
      }
      if (q[x] > 3) {
        ++x;
        continue;
      }
      start = x;
      min_intv = 1;
    } else {
      while (r2_k < old_n) {
        const Intv& p = mems[r2_k];
        if (p.qe - p.qb >= split_len && p.s <= split_width) break;
        ++r2_k;
      }
      if (r2_k >= old_n) break;
      const Intv& p = mems[r2_k];
      start = (p.qb + p.qe) >> 1;
      min_intv = p.s + 1;
      ++r2_k;
    }
    // --- smem1a(fm, q, len, start, min_intv, /*max_intv=*/0, ...) ---
    m1->clear();
    set_intv(fm, q[start], ik);
    ik.qe = start + 1;
    curr->clear();
    int i;
    for (i = start + 1; i < len; ++i) {
      if (q[i] < 4) {
        int c = 3 - q[i];
        extend_prefetch(fm, ik, false);
        co_await std::suspend_always{};
        bwt_extend(fm, ik, ok, false);
        if (ok[c].s != ik.s) {
          curr->push_back(ik);
          if (ok[c].s < min_intv) break;
        }
        ok[c].qe = i + 1;
        ik = ok[c];
      } else {
        curr->push_back(ik);
        break;
      }
    }
    if (i == len) curr->push_back(ik);
    std::reverse(curr->begin(), curr->end());
    int ret = (*curr)[0].qe;
    std::swap(*prev, *curr);
    for (i = start - 1; i >= -1; --i) {
      int c = (i < 0 || q[i] > 3) ? -1 : q[i];
      curr->clear();
      if (c >= 0 && !prev->empty()) {
        for (const Intv& p : *prev) extend_prefetch(fm, p, true);
        co_await std::suspend_always{};
      }
      for (size_t j = 0; j < prev->size(); ++j) {
        const Intv& p = (*prev)[j];
        bool did_ext = false;
        if (c >= 0) {  // max_intv == 0: p.s >= max_intv always holds
          bwt_extend(fm, p, ok, true);
          did_ext = true;
        }
        if (c < 0 || (did_ext && ok[c].s < min_intv)) {
          if (curr->empty()) {
            if (m1->empty() || i + 1 < m1->back().qb) {
              Intv m = p;
              m.qb = i + 1;
              m1->push_back(m);
            }
          }
        } else if (curr->empty() || ok[c].s != curr->back().s) {
          ok[c].qe = p.qe;
          curr->push_back(ok[c]);
        }
      }
      if (curr->empty()) break;
      std::swap(*prev, *curr);
    }
    std::reverse(m1->begin(), m1->end());
    // --- end smem1a ---
    if (!round2) {
      x = ret;
      for (const Intv& p : *m1)
        if (p.qe - p.qb >= min_seed_len) mems.push_back(p);
    } else {
      for (const Intv& m : *m1)
        if (m.qe - m.qb >= min_seed_len) mems.push_back(m);
    }
  }
  if (max_mem_intv > 0) {
    x = 0;
    while (x < len) {
      if (q[x] > 3) {
        ++x;
        continue;
      }
      // --- seed_strategy1(fm, q, len, x, min_seed_len, max_mem_intv) ---
      set_intv(fm, q[x], ik);
      bool found = false;
      Intv m{};
      int i, next_x = len;
      for (i = x + 1; i < len; ++i) {
        if (q[i] < 4) {
          int c = 3 - q[i];
          extend_prefetch(fm, ik, false);
          co_await std::suspend_always{};
          bwt_extend(fm, ik, ok, false);
          if (ok[c].s < max_mem_intv && i - x >= min_seed_len) {
            m = ok[c];
            m.qb = x;
            m.qe = i + 1;
            found = true;
            next_x = i + 1;
            break;
          }
          ik = ok[c];
        } else {
          next_x = i + 1;
          break;
        }
      }
      if (found && m.s > 0) mems.push_back(m);
      x = next_x;
    }
  }
  std::stable_sort(mems.begin(), mems.end(),
                   [](const Intv& a, const Intv& b) {
                     return a.qb != b.qb ? a.qb < b.qb : a.qe < b.qe;
                   });
  co_return;
}

// Run collect_intv over reads r0, r0+stride, ... with W coroutine lanes
// interleaved round-robin. Per-read output identical to collect_intv.
void collect_intv_interleaved(const FMView& fm, const uint8_t* reads,
                              const int64_t* offsets, int64_t n_reads,
                              int64_t r0, int64_t stride, int min_seed_len,
                              double split_factor, int split_width,
                              int64_t max_mem_intv,
                              std::vector<std::vector<Intv>>& per_read) {
  constexpr int W_MAX = 64;
  int W = 32;
  if (const char* e = std::getenv("LARIAT_SEED_LANES")) {
    W = std::max(1, std::min(W_MAX, atoi(e)));
  }
  struct LaneBufs {
    std::vector<Intv> m1, prev, curr;
  };
  static thread_local LaneBufs bufs[W_MAX];
  std::coroutine_handle<SeedTask::promise_type> lanes[W_MAX];
  int active = 0;
  int64_t r = r0;
  auto start_next = [&](int slot) -> bool {
    while (r < n_reads) {
      int64_t cur = r;
      r += stride;
      int len = static_cast<int>(offsets[cur + 1] - offsets[cur]);
      if (len <= 0) continue;
      lanes[slot] = collect_intv_co(fm, reads + offsets[cur], len,
                                    min_seed_len, split_factor, split_width,
                                    max_mem_intv, &per_read[cur],
                                    &bufs[slot].m1, &bufs[slot].prev,
                                    &bufs[slot].curr)
                        .h;
      return true;
    }
    return false;
  };
  while (active < W && start_next(active)) ++active;
  while (active > 0) {
    for (int s = 0; s < active;) {
      lanes[s].resume();
      if (lanes[s].done()) {
        lanes[s].destroy();
        if (start_next(s)) {
          ++s;  // fresh lane runs on the next sweep
        } else {
          lanes[s] = lanes[--active];
        }
      } else {
        ++s;
      }
    }
  }
}

inline int bwt_code_at(const FMView& fm, int64_t k) {
  int64_t kx = k > fm.primary ? k - 1 : k;
  uint32_t word = fm.bwt_words[kx >> 4];
  int shift = (15 - static_cast<int>(kx & 15)) * 2;
  return (word >> shift) & 3;
}

int64_t sa_lookup(const FMView& fm, int64_t k) {
  int64_t steps = 0;
  while (k % fm.sa_intv != 0) {
    ++steps;
    if (k == fm.primary) {
      k = 0;
    } else {
      int c = bwt_code_at(fm, k);
      k = fm.L2[c] + occ_one(fm, k, c);
    }
  }
  return fm.sa_samples[k / fm.sa_intv] + steps;
}

// Issue prefetches for the cache lines the next LF step (or the final
// sa_samples read) at row k will touch. At genome scale every step is a
// DRAM miss into the multi-GB BWT/occ arrays, so a single in-order walk is
// latency-bound; the interleaved walker
// below keeps many independent walks in flight so those misses overlap.
inline void sa_prefetch(const FMView& fm, int64_t k) {
  if (k % fm.sa_intv == 0) {
    __builtin_prefetch(fm.sa_samples + k / fm.sa_intv);
    return;
  }
  if (k == fm.primary) return;
  int64_t kk = k;
  if (kk >= fm.primary) --kk;
  int64_t blk = (kk + 1) / OCC_INTERVAL;
  // covers both bwt_code_at's word (kx>>4 lies in [blk*8, blk*8+8)) and
  // occ_one's popcount words; occ checkpoint row is a separate line
  __builtin_prefetch(fm.bwt_words + blk * WORDS_PER_BLOCK);
  __builtin_prefetch(fm.occ_ckpt + blk * 4);
}

// Dereference rows[0..n) into out[0..n) with W walks interleaved. Result is
// bit-identical to calling sa_lookup per row (each walk is independent and
// deterministic; only the interleaving order differs).
void sa_lookup_interleaved(const FMView& fm, const int64_t* rows, int64_t n,
                           int64_t* out) {
  constexpr int W = 64;
  if (n < W * 2) {
    for (int64_t i = 0; i < n; ++i) out[i] = sa_lookup(fm, rows[i]);
    return;
  }
  struct Lane {
    int64_t k, steps, idx;
  };
  Lane lanes[W];
  int active = 0;
  int64_t next = 0;
  while (active < W && next < n) {
    lanes[active] = {rows[next], 0, next};
    sa_prefetch(fm, lanes[active].k);
    ++active;
    ++next;
  }
  while (active > 0) {
    for (int i = 0; i < active;) {
      Lane& L = lanes[i];
      if (L.k % fm.sa_intv == 0) {
        out[L.idx] = fm.sa_samples[L.k / fm.sa_intv] + L.steps;
        if (next < n) {
          L = {rows[next], 0, next};
          ++next;
          sa_prefetch(fm, L.k);
          ++i;
        } else {
          L = lanes[--active];  // swapped-in lane was already prefetched
        }
      } else {
        ++L.steps;
        if (L.k == fm.primary) {
          L.k = 0;
        } else {
          int c = bwt_code_at(fm, L.k);
          L.k = fm.L2[c] + occ_one(fm, L.k, c);
        }
        sa_prefetch(fm, L.k);
        ++i;
      }
    }
  }
}

}  // namespace

extern "C" {

// Seed a batch of reads. reads: concatenated codes; offsets[i]..offsets[i+1]
// delimit read i (n_reads+1 entries). Results go to out (cap_out Intv slots
// as 5 int64 each: x0, x1, s, qb, qe) with out_counts[i] per read and
// out_offsets[i] giving read i's slot start. Returns total seeds or -1 if
// capacity exceeded.
int64_t fm_collect_seeds_batch(
    const uint32_t* bwt_words, const int64_t* occ_ckpt, const int64_t* L2,
    const int64_t* sa_samples, int64_t primary, int64_t seq_len,
    int64_t sa_intv, const uint8_t* reads, const int64_t* offsets,
    int64_t n_reads, int min_seed_len, double split_factor, int split_width,
    int64_t max_mem_intv, int64_t* out, int64_t cap_out, int64_t* out_counts,
    int64_t* out_offsets, int n_threads) {
  FMView fm{bwt_words, occ_ckpt, L2, sa_samples, primary, seq_len, sa_intv};
  std::vector<std::vector<Intv>> per_read(n_reads);
  // Coroutine interleaving is opt-in: on this build host (260 MB L3, ~60 ns
  // effective latency) the sequential walk is already compute-bound at
  // ~50 ns/extend and the coroutine overhead loses ~10%; on hosts where the
  // FM arrays live in DRAM the interleaved walker overlaps the per-read
  // pointer chases. Set LARIAT_SEED_LANES=<W> to enable (parity is
  // bit-identical either way; tests cover both).
  const bool interleave = std::getenv("LARIAT_SEED_LANES") != nullptr &&
                          std::getenv("LARIAT_NO_INTERLEAVED_SEED") == nullptr;
  auto run_range = [&](int t, int workers) {
    if (interleave) {
      collect_intv_interleaved(fm, reads, offsets, n_reads, t, workers,
                               min_seed_len, split_factor, split_width,
                               max_mem_intv, per_read);
      return;
    }
    for (int64_t r = t; r < n_reads; r += workers) {
      const uint8_t* q = reads + offsets[r];
      int len = static_cast<int>(offsets[r + 1] - offsets[r]);
      if (len > 0)
        collect_intv(fm, q, len, min_seed_len, split_factor, split_width,
                     max_mem_intv, per_read[r]);
    }
  };
  int workers = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_threads, n_reads)));
  if (n_reads < 64 || workers == 1) {
    run_range(0, 1);  // thread spawn overhead dominates tiny batches
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < workers; ++t)
      threads.emplace_back(run_range, t, workers);
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    out_offsets[r] = total;
    out_counts[r] = static_cast<int64_t>(per_read[r].size());
    if (total + out_counts[r] > cap_out) return -1;
    for (const Intv& m : per_read[r]) {
      int64_t* o = out + total * 5;
      o[0] = m.x0;
      o[1] = m.x1;
      o[2] = m.s;
      o[3] = m.qb;
      o[4] = m.qe;
      ++total;
    }
  }
  return total;
}

// Seeds + SA-dereferenced occurrences in one call: runs
// fm_collect_seeds_batch, then walks mem_chain's occurrence schedule
// (step-sampled above max_occ) dereferencing each SA row. rbegs go to
// rb_out with rb_counts/rb_offsets per read; returns total occurrences,
// -1 if a capacity is exceeded (mems output is filled first, identically
// to fm_collect_seeds_batch, whose return lands in *n_mems_out).
int64_t fm_collect_seeds_rbegs_batch(
    const uint32_t* bwt_words, const int64_t* occ_ckpt, const int64_t* L2,
    const int64_t* sa_samples, int64_t primary, int64_t seq_len,
    int64_t sa_intv, const uint8_t* reads, const int64_t* offsets,
    int64_t n_reads, int min_seed_len, double split_factor, int split_width,
    int64_t max_mem_intv, int64_t max_occ, int64_t* out, int64_t cap_out,
    int64_t* out_counts, int64_t* out_offsets, int64_t* rb_out,
    int64_t cap_rb, int64_t* rb_counts, int64_t* rb_offsets,
    int64_t* n_mems_out, int n_threads) {
  int64_t n_mems = fm_collect_seeds_batch(
      bwt_words, occ_ckpt, L2, sa_samples, primary, seq_len, sa_intv, reads,
      offsets, n_reads, min_seed_len, split_factor, split_width,
      max_mem_intv, out, cap_out, out_counts, out_offsets, n_threads);
  *n_mems_out = n_mems;
  if (n_mems < 0) return -1;
  FMView fm{bwt_words, occ_ckpt, L2, sa_samples, primary, seq_len, sa_intv};
  // build the occurrence row schedule (enumerate_occurrences order)
  std::vector<int64_t> rows;
  rows.reserve(std::min<int64_t>(cap_rb, n_mems * 4));
  int64_t total = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    rb_offsets[r] = total;
    const int64_t* mems = out + out_offsets[r] * 5;
    for (int64_t m = 0; m < out_counts[r]; ++m) {
      int64_t x0 = mems[m * 5], s = mems[m * 5 + 2];
      int64_t step = s > max_occ ? s / max_occ : 1;
      int64_t count = 0;
      for (int64_t k = 0; k < s && count < max_occ; k += step, ++count) {
        if (total >= cap_rb) return -1;
        rows.push_back(x0 + k);
        ++total;
      }
    }
    rb_counts[r] = total - rb_offsets[r];
  }
  int workers = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_threads, total)));
  if (total < 1024 || workers == 1) {
    sa_lookup_interleaved(fm, rows.data(), total, rb_out);
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (total + workers - 1) / workers;
    for (int t = 0; t < workers; ++t)
      threads.emplace_back([&, t]() {
        int64_t lo = t * chunk, hi = std::min<int64_t>(total, lo + chunk);
        if (lo < hi)
          sa_lookup_interleaved(fm, rows.data() + lo, hi - lo, rb_out + lo);
      });
    for (auto& th : threads) th.join();
  }
  return total;
}

// Batched sampled-SA dereference.
void fm_sa_lookup_batch(const uint32_t* bwt_words, const int64_t* occ_ckpt,
                        const int64_t* L2, const int64_t* sa_samples,
                        int64_t primary, int64_t seq_len, int64_t sa_intv,
                        const int64_t* rows, int64_t n, int64_t* out,
                        int n_threads) {
  FMView fm{bwt_words, occ_ckpt, L2, sa_samples, primary, seq_len, sa_intv};
  int workers = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_threads, n)));
  if (n < 1024 || workers == 1) {
    sa_lookup_interleaved(fm, rows, n, out);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + workers - 1) / workers;
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&, t]() {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      if (lo < hi) sa_lookup_interleaved(fm, rows + lo, hi - lo, out + lo);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
