// Fused pair-map + bucket-stream host build (the stage-2 prologue).
//
// Replaces the numpy build_pairs/_bucket_stream pipeline (ops/overlap.py;
// build_map semantics, reference src/shmr_utils.c:295-404).  The numpy
// version walks the 18M-entry index five times with one-core u64
// arithmetic (counts searchsorted 19 s + adjacency 9 s + flips 10 s +
// stream lexsort 11 s at 250 Mb scale); here it is three threaded linear
// passes:
//
//   pair_scan_c  — per-entry MC-count binary search -> keep bitmap +
//                  candidate-pair count (threaded, slice-local prev-kept
//                  resolved by back-scan)
//   pair_fill_c  — emit oriented records: forward block then reverse
//                  block in candidate order (exactly the numpy
//                  concatenate layout, so the stable (key0, key1) sort
//                  that follows produces byte-identical arrays)
//   bucket_stream_scan_c / bucket_stream_fill_c — run-length bucket
//                  detection over the sorted keys + per-bucket stable
//                  descending-position stream (identical to
//                  lexsort((-pos, bid)) because lexsort is stable and
//                  buckets are already contiguous)
//
// Semantic notes mirrored from the Python (asserted byte-identical in
// tests/test_overlap.py):
//  * the first eligible entry uses count < mc_upper (strict), subsequent
//    entries <= mc_upper; everything before the first strict hit is
//    dropped (reference scan loop, src/shmr_utils.c:316-330)
//  * pair distance is computed in u64, truncated to u32, compared
//    unsigned (the numpy `dist.astype(np.uint32) >= min_dist`)
//  * reverse-orientation coordinate flip: rpos = rlen - pos + span - 1
//    with pos pre-incremented (src/shmr_utils.c:377-395)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kU32 = 0xFFFFFFFFull;
constexpr uint64_t kU28 = 0xFFFFFFFull;

inline uint32_t mc_lookup(const uint64_t *mc_hash, const uint32_t *mc_count,
                          int64_t m, uint64_t h) {
  // branch-free-ish binary search (numpy searchsorted equivalent)
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (mc_hash[mid] < h)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < m && mc_hash[lo] == h) return mc_count[lo];
  return 0;
}

inline uint64_t flip_y(uint64_t yv, uint64_t xv, const int64_t *rl) {
  const uint64_t span = xv & 0xFFull;
  const uint64_t rid = yv >> 32;
  const uint64_t pos = ((yv & kU32) >> 1) + 1;
  const uint64_t rpos = (uint64_t)rl[rid] - pos + span - 1;
  return ((yv & 0xFFFFFFFF00000001ull) | ((rpos << 1) & kU32)) ^ 1ull;
}

int n_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? (int)hc : 2;
}

// candidate predicate on two consecutive KEPT entries j < i
inline bool is_cand(const uint64_t *y, int64_t j, int64_t i,
                    uint32_t min_dist) {
  const uint64_t b0 = y[j], b1 = y[i];
  if ((b0 >> 32) != (b1 >> 32)) return false;
  const uint32_t dist = (uint32_t)(((b1 >> 1) & kU28) - ((b0 >> 1) & kU28));
  return dist >= min_dist;
}

}  // namespace

extern "C" {

// Pass 1: fill keep[i] (0/1) and return the number of candidate pairs.
// keep is an n-byte caller scratch that pair_fill_c consumes.
int64_t pair_scan_c(const uint64_t *x, const uint64_t *y, int64_t n,
                    const uint64_t *mc_hash, const uint32_t *mc_count,
                    int64_t m, uint32_t mc_lower, uint32_t mc_upper,
                    uint32_t min_dist, uint8_t *keep) {
  if (n < 2) return 0;
  const int nt = n_threads();

  // eligibility bitmap + first strict-upper hit (threaded)
  std::atomic<int64_t> first_ok{n};
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) {
    ths.emplace_back([&, t] {
      const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t local_first = n;
      for (int64_t i = lo; i < hi; i++) {
        const uint32_t c = mc_lookup(mc_hash, mc_count, m, x[i] >> 8);
        keep[i] = (c >= mc_lower && c <= mc_upper) ? 1 : 0;
        if (local_first == n && c >= mc_lower && c < mc_upper) local_first = i;
      }
      // atomic min
      int64_t cur = first_ok.load();
      while (local_first < cur &&
             !first_ok.compare_exchange_weak(cur, local_first)) {
      }
    });
  }
  for (auto &t : ths) t.join();
  const int64_t s = first_ok.load();
  if (s >= n) return 0;
  std::memset(keep, 0, (size_t)s);
  keep[s] = 1;

  // count candidate pairs (consecutive kept entries passing the gate)
  std::vector<int64_t> counts(nt, 0);
  ths.clear();
  for (int t = 0; t < nt; t++) {
    ths.emplace_back([&, t] {
      const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      // previous kept entry at or before lo-1
      int64_t prev = lo - 1;
      while (prev >= 0 && !keep[prev]) prev--;
      int64_t c = 0;
      for (int64_t i = lo; i < hi; i++) {
        if (!keep[i]) continue;
        if (prev >= 0 && is_cand(y, prev, i, min_dist)) c++;
        prev = i;
      }
      counts[t] = c;
    });
  }
  for (auto &t : ths) t.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Pass 2: emit the oriented records.  Layout matches the numpy
// concatenate: key0[0:nf] forward candidates (hash-shard of the LEADING
// key == ck), then key0[nf:nf+nr] reverse candidates (shard of the
// TRAILING key).  With total_chunk == 1 both blocks hold every candidate.
// Returns the total number of records written (nf + nr).
int64_t pair_fill_c(const uint64_t *x, const uint64_t *y, int64_t n,
                    const uint8_t *keep, const int64_t *rl,
                    uint32_t min_dist, uint64_t total_chunk, uint64_t ck,
                    uint64_t *key0, uint64_t *key1, uint64_t *y0,
                    uint64_t *y1, uint8_t *dir) {
  if (n < 2) return 0;
  const int nt = n_threads();
  const uint64_t tc = total_chunk ? total_chunk : 1;

  // per-slice forward/reverse counts, then exclusive offsets
  std::vector<int64_t> nf(nt, 0), nr(nt, 0);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) {
    ths.emplace_back([&, t] {
      const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t prev = lo - 1;
      while (prev >= 0 && !keep[prev]) prev--;
      int64_t f = 0, r = 0;
      for (int64_t i = lo; i < hi; i++) {
        if (!keep[i]) continue;
        if (prev >= 0 && is_cand(y, prev, i, min_dist)) {
          if (((x[prev] >> 8) % tc) == ck) f++;
          if (((x[i] >> 8) % tc) == ck) r++;
        }
        prev = i;
      }
      nf[t] = f;
      nr[t] = r;
    });
  }
  for (auto &t : ths) t.join();
  int64_t nf_total = 0, nr_total = 0;
  std::vector<int64_t> f_off(nt), r_off(nt);
  for (int t = 0; t < nt; t++) {
    f_off[t] = nf_total;
    nf_total += nf[t];
  }
  for (int t = 0; t < nt; t++) {
    r_off[t] = nf_total + nr_total;
    nr_total += nr[t];
  }

  ths.clear();
  for (int t = 0; t < nt; t++) {
    ths.emplace_back([&, t] {
      const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
      int64_t prev = lo - 1;
      while (prev >= 0 && !keep[prev]) prev--;
      int64_t f = f_off[t], r = r_off[t];
      for (int64_t i = lo; i < hi; i++) {
        if (!keep[i]) continue;
        if (prev >= 0 && is_cand(y, prev, i, min_dist)) {
          if (((x[prev] >> 8) % tc) == ck) {
            key0[f] = x[prev];
            key1[f] = x[i];
            y0[f] = y[prev];
            y1[f] = y[i];
            dir[f] = 0;
            f++;
          }
          if (((x[i] >> 8) % tc) == ck) {
            key0[r] = x[i];
            key1[r] = x[prev];
            y0[r] = flip_y(y[i], x[i], rl);
            y1[r] = flip_y(y[prev], x[prev], rl);
            dir[r] = 1;
            r++;
          }
        }
        prev = i;
      }
    });
  }
  for (auto &t : ths) t.join();
  return nf_total + nr_total;
}

// Threaded stable sort of (y, x) by y — the mesh-index seam's
// rid-order restore (parallel/sharded_index.py::build_index_mesh used a
// one-core numpy argsort here).  Same 2-thread sampled-pivot scheme as
// sort_pairs_c.
void sort_by_y_c(uint64_t *y, uint64_t *x, int64_t n) {
  if (n <= 1) return;
  struct Rec {
    uint64_t k;
    int64_t row;
  };
  std::vector<Rec> recs((size_t)n);
  for (int64_t i = 0; i < n; i++) recs[i] = {y[i], i};
  auto less = [](const Rec &a, const Rec &b) {
    if (a.k != b.k) return a.k < b.k;
    return a.row < b.row;  // stability
  };
  const int kS = 257;
  std::vector<uint64_t> smp;
  smp.reserve(kS);
  for (int i = 0; i < kS; i++)
    smp.push_back(y[(size_t)((__int128)i * (n - 1) / (kS - 1))]);
  std::nth_element(smp.begin(), smp.begin() + kS / 2, smp.end());
  const uint64_t pivot = smp[kS / 2];
  auto *mid = std::partition(recs.data(), recs.data() + n,
                             [&](const Rec &r) { return r.k < pivot; });
  std::thread t([&] { std::sort(recs.data(), mid, less); });
  std::sort(mid, recs.data() + n, less);
  t.join();
  std::vector<uint64_t> tmp((size_t)n);
  for (uint64_t *arr : {y, x}) {
    std::thread p([&] {
      for (int64_t i = 0; i < n / 2; i++) tmp[i] = arr[recs[i].row];
    });
    for (int64_t i = n / 2; i < n; i++) tmp[i] = arr[recs[i].row];
    p.join();
    std::memcpy(arr, tmp.data(), (size_t)n * sizeof(uint64_t));
  }
}

// Stream pass 1: over the (key0, key1)-sorted records find bucket runs,
// count eligible buckets (2 < size <= ovlp_upper) and their total record
// count.  out[0] = n_stream records, out[1] = n_eligible buckets.
void bucket_stream_scan_c(const uint64_t *key0, const uint64_t *key1,
                          int64_t n, int64_t ovlp_upper, int64_t *out) {
  int64_t n_stream = 0, n_buckets = 0;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; i++) {
    if (i == n || key0[i] != key0[start] || key1[i] != key1[start]) {
      const int64_t sz = i - start;
      if (sz > 2 && sz <= ovlp_upper) {
        n_stream += sz;
        n_buckets++;
      }
      start = i;
    }
  }
  out[0] = n_stream;
  out[1] = n_buckets;
}

// Stream pass 2: fill (ys, dirs, pos, bstart, bend).  Within each bucket
// records are ordered by stable descending position — identical to
// numpy lexsort((-pos, bid)) over the flattened eligible buckets.
void bucket_stream_fill_c(const uint64_t *key0, const uint64_t *key1,
                          const uint64_t *y0, const uint8_t *dir, int64_t n,
                          int64_t ovlp_upper, uint64_t *ys, uint8_t *dirs,
                          int64_t *pos, int64_t *bstart, int64_t *bend) {
  // collect eligible bucket (start, size) pairs serially (cheap: one
  // linear compare pass), then fill buckets on all threads
  std::vector<int64_t> starts, sizes;
  starts.reserve(1 << 20);
  sizes.reserve(1 << 20);
  int64_t start = 0;
  for (int64_t i = 1; i <= n; i++) {
    if (i == n || key0[i] != key0[start] || key1[i] != key1[start]) {
      const int64_t sz = i - start;
      if (sz > 2 && sz <= ovlp_upper) {
        starts.push_back(start);
        sizes.push_back(sz);
      }
      start = i;
    }
  }
  const int64_t nb = (int64_t)starts.size();
  // exclusive prefix of sizes = output offsets + bstart/bend
  std::vector<int64_t> off((size_t)nb + 1);
  off[0] = 0;
  for (int64_t b = 0; b < nb; b++) off[b + 1] = off[b] + sizes[b];
  const int nt = n_threads();
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) {
    ths.emplace_back([&, t] {
      const int64_t blo = nb * t / nt, bhi = nb * (t + 1) / nt;
      std::vector<int32_t> order;
      for (int64_t b = blo; b < bhi; b++) {
        const int64_t s0 = starts[b], sz = sizes[b], o = off[b];
        bstart[b] = o;
        bend[b] = o + sz;
        order.resize((size_t)sz);
        for (int32_t k = 0; k < sz; k++) order[k] = k;
        std::stable_sort(order.begin(), order.end(),
                         [&](int32_t a, int32_t c) {
                           const int64_t pa = (int64_t)((y0[s0 + a] & kU32) >> 1);
                           const int64_t pc = (int64_t)((y0[s0 + c] & kU32) >> 1);
                           return pa > pc;
                         });
        for (int64_t k = 0; k < sz; k++) {
          const int64_t src = s0 + order[k];
          ys[o + k] = y0[src];
          dirs[o + k] = dir[src];
          pos[o + k] = (int64_t)((y0[src] & kU32) >> 1);
        }
      }
    });
  }
  for (auto &t : ths) t.join();
}

}  // extern "C"
