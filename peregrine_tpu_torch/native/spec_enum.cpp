// Speculative alignment-request enumeration in C++.
//
// Walks the bucket stream in exact replay order (bucket ascending, anchor
// index descending, candidate ascending — the order overlap_replay.cpp
// visits pairs) and emits, for every rid pair, its first `per_pair`
// candidate occurrences as device-alignment requests, with exact duplicate
// requests (same endpoints, emitted from different buckets) removed.
// This replaces the vectorized-numpy enumeration in
// ops/overlap.overlap_chunk_device (which cost ~9 s host time per E. coli
// chunk in lexsorts and repeats); semantics equivalence is asserted in
// tests/test_overlap_device.py.
//
// Reference semantics being speculated on: the global rid-pair dedup that
// lets shmr_overlap align each read pair once (src/shmr_overlap.c:101-107).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct KeyPair {
  uint64_t a, b;
  bool operator==(const KeyPair &o) const { return a == o.a && b == o.b; }
};

struct KeyPairHash {
  size_t operator()(const KeyPair &k) const {
    uint64_t h = k.a * 0x9E3779B97F4A7C15ull;
    h ^= k.b + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

#pragma pack(push, 1)
// parsed on the Python side with ops/overlap.SPEC_REQ_DTYPE (20 bytes)
struct SpecReq {
  uint32_t rid0, rid1;
  int32_t pos0, pos1;  // anchor positions, already +1'd (replay convention)
  uint8_t strand0, strand1;
  uint16_t _pad;  // explicit pad keeps the numpy dtype aligned-free
};
#pragma pack(pop)

// ys/dirs/pos: the replay-ordered bucket stream (bucket-major, descending
// position within bucket); buckets are [bstart[i], bend[i]).
void spec_enum_c(const uint64_t *ys, const uint8_t *dirs, const int64_t *pos,
                 const int64_t *bstart, const int64_t *bend,
                 int64_t n_buckets, int32_t window, int32_t per_pair,
                 SpecReq **out_reqs, int64_t *n_out) {
  const int64_t n_entries = n_buckets ? bend[n_buckets - 1] : 0;
  std::unordered_map<uint64_t, int32_t> pair_seen;
  std::unordered_set<KeyPair, KeyPairHash> req_seen;
  pair_seen.reserve((size_t)(n_entries * 2));
  req_seen.reserve((size_t)n_entries);
  std::vector<SpecReq> out;
  out.reserve((size_t)n_entries);

  for (int64_t bi = 0; bi < n_buckets; bi++) {
    const int64_t s = bstart[bi], e = bend[bi];
    const int64_t n = e - s;
    for (int64_t ai = n - 2; ai >= 0; ai--) {
      const uint64_t y0 = ys[s + ai];
      const uint32_t rid0 = (uint32_t)(y0 >> 32);
      const int64_t lim = ai + window < n ? ai + window : n - 1;
      for (int64_t ci = ai + 1; ci <= lim; ci++) {
        const uint64_t y1 = ys[s + ci];
        const uint32_t rid1 = (uint32_t)(y1 >> 32);
        if (rid0 == rid1) continue;
        const uint64_t ridp = rid0 < rid1
                                  ? ((uint64_t)rid0 << 32) | rid1
                                  : ((uint64_t)rid1 << 32) | rid0;
        int32_t &cnt = pair_seen[ridp];
        if (cnt >= per_pair) continue;
        cnt++;
        const int32_t p0 = (int32_t)pos[s + ai] + 1;
        const int32_t p1 = (int32_t)pos[s + ci] + 1;
        const uint8_t s0 = dirs[s + ai], s1 = dirs[s + ci];
        const KeyPair key{((uint64_t)rid0 << 33) | ((uint64_t)p0 << 1) | s0,
                          ((uint64_t)rid1 << 33) | ((uint64_t)p1 << 1) | s1};
        if (!req_seen.insert(key).second) continue;
        out.push_back(SpecReq{rid0, rid1, p0, p1, s0, s1, 0});
      }
    }
  }

  *n_out = (int64_t)out.size();
  *out_reqs = (SpecReq *)std::malloc(out.size() * sizeof(SpecReq));
  std::memcpy(*out_reqs, out.data(), out.size() * sizeof(SpecReq));
}

void free_spec_reqs_c(SpecReq **r) {
  std::free(*r);
  *r = nullptr;
}

}  // extern "C"
