// Threaded (key0, key1) sort for the oriented pair map.
//
// build_pairs (ops/overlap.py; build_map semantics, reference
// src/shmr_utils.c:295-404) ends with a lexicographic sort of five
// parallel arrays by (key0, key1).  numpy's lexsort costs ~12-15 s at
// 14.9M rows (140 Mb scale) and runs on one core; this pass packs
// (k0, k1, row) into 24-byte records, partitions by a sampled median of
// k0, sorts both halves on concurrent threads, and applies the
// permutation to all five arrays.  Order is exactly numpy's
// lexsort((key1, key0)) with ties broken by original row (std::sort over
// distinct row ids makes the comparator a strict weak order; tie rows
// compare by `row`, reproducing a stable sort).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Rec {
  uint64_t k0, k1;
  int64_t row;
};

inline bool rec_less(const Rec &a, const Rec &b) {
  if (a.k0 != b.k0) return a.k0 < b.k0;
  if (a.k1 != b.k1) return a.k1 < b.k1;
  return a.row < b.row;  // stability
}

template <class T>
void permute(const T *src, T *dst, const Rec *recs, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; i++) dst[i] = src[recs[i].row];
}

}  // namespace

extern "C" {

void sort_pairs_c(uint64_t *k0, uint64_t *k1, uint64_t *y0, uint64_t *y1,
                  uint8_t *dir, int64_t n) {
  if (n <= 1) return;
  std::vector<Rec> recs((size_t)n);
  for (int64_t i = 0; i < n; i++) recs[i] = {k0[i], k1[i], i};

  // median-of-samples pivot on k0 for a 2-thread split
  const int kSamples = 257;
  std::vector<uint64_t> smp;
  smp.reserve(kSamples);
  for (int i = 0; i < kSamples; i++)
    smp.push_back(k0[(size_t)((__int128)i * (n - 1) / (kSamples - 1))]);
  std::nth_element(smp.begin(), smp.begin() + kSamples / 2, smp.end());
  const uint64_t pivot = smp[kSamples / 2];

  auto *mid = std::partition(recs.data(), recs.data() + n,
                             [&](const Rec &r) { return r.k0 < pivot; });
  std::thread t([&] { std::sort(recs.data(), mid, rec_less); });
  std::sort(mid, recs.data() + n, rec_less);
  t.join();

  const int64_t half = (int64_t)(mid - recs.data());
  // the pivot partition is not a total order boundary for equal-k0 runs
  // crossing it only when pivot appears on both sides; partition puts all
  // k0 == pivot in the upper half, so halves are disjoint and ordered.
  (void)half;

  // apply the permutation (two threads, scratch one array at a time)
  {
    std::vector<uint64_t> tmp((size_t)n);
    for (uint64_t *arr : {k0, k1, y0, y1}) {
      std::thread p1([&] { permute(arr, tmp.data(), recs.data(), 0, n / 2); });
      permute(arr, tmp.data(), recs.data(), n / 2, n);
      p1.join();
      std::memcpy(arr, tmp.data(), (size_t)n * sizeof(uint64_t));
    }
  }
  std::vector<uint8_t> tmp8((size_t)n);
  permute(dir, tmp8.data(), recs.data(), 0, n);
  std::memcpy(dir, tmp8.data(), (size_t)n);
}

}  // extern "C"
