// Sequential overlap accept loop (the replay) in C++.
//
// Mirrors ops/overlap.overlap_chunk's per-bucket walk exactly (which in
// turn mirrors the reference shimmer_to_overlap, src/shmr_overlap.c:52-180):
// anchors in descending-position order, up to bestn extensions per anchor,
// containment kills, global rid-pair dedup.  Alignments come from a
// speculative result cache (unordered keys, CacheMap hash lookup,
// duplicate keys first-wins) with the
// banded O(ND) kernel (dw_align.cpp ovlp_match_c) as the miss fallback —
// no Python in the loop.  The Python overlap_chunk stays as the semantic
// reference; equivalence is asserted in tests/test_overlap.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

typedef int32_t coor;

struct OvlpMatch {
  coor m_size, dist;
  coor q_bgn, q_end;
  coor t_bgn, t_end;
  coor t_m_end, q_m_end;
};

void ovlp_match_c(const uint8_t *q, coor q_len, uint8_t q_strand,
                  const uint8_t *t, coor t_len, uint8_t t_strand,
                  coor band_tolerance, OvlpMatch *out);

#pragma pack(push, 1)
// matches ops/overlap.OVLP_DTYPE exactly (numpy packed struct, 59 bytes)
struct OvlpRec {
  uint64_t y0, y1;
  uint32_t rl0, rl1;
  uint8_t strand0, strand1, ovlp_type;
  int32_t m_size, dist;
  int32_t q_bgn, q_end, t_bgn, t_end;
  int32_t t_m_end, q_m_end;
};
#pragma pack(pop)

}  // extern "C"

namespace {

// Flat linear-probe hash maps: the std::unordered_map over ~6M rid pairs
// and the per-candidate binary search over the sorted cache keys were the
// dominant costs of a replay pass (~13 s at Drosophila scale per pass,
// and the iterative dedup runs several passes).
inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

struct PairMap {  // u64 rid-pair -> u8 state
  std::vector<uint64_t> keys;
  std::vector<uint8_t> vals;
  uint64_t mask = 0;
  size_t n = 0;
  static constexpr uint64_t kEmpty = ~0ULL;

  void init(size_t expect) {
    size_t s = 1024;
    while (s < expect * 2) s <<= 1;
    keys.assign(s, kEmpty);
    vals.assign(s, 0);
    mask = s - 1;
    n = 0;
  }
  void grow() {
    std::vector<uint64_t> ok(std::move(keys));
    std::vector<uint8_t> ov(std::move(vals));
    keys.assign(ok.size() * 2, kEmpty);
    vals.assign(ok.size() * 2, 0);
    mask = keys.size() - 1;
    n = 0;
    for (size_t i = 0; i < ok.size(); i++)
      if (ok[i] != kEmpty) put(ok[i], ov[i]);
  }
  // returns pointer to value if present, else nullptr
  uint8_t *find(uint64_t k) {
    uint64_t i = mix64(k) & mask;
    while (keys[i] != kEmpty) {
      if (keys[i] == k) return &vals[i];
      i = (i + 1) & mask;
    }
    return nullptr;
  }
  void put(uint64_t k, uint8_t v) {
    if ((n + 1) * 2 > keys.size()) grow();
    uint64_t i = mix64(k) & mask;
    while (keys[i] != kEmpty) {
      if (keys[i] == k) { vals[i] = v; return; }
      i = (i + 1) & mask;
    }
    keys[i] = k;
    vals[i] = v;
    n++;
  }
};

struct CacheMap {  // (u64, u64) key pair -> int32 row index
  std::vector<uint64_t> ka, kb;
  std::vector<int64_t> row;
  uint64_t mask = 0;
  static constexpr uint64_t kEmpty = ~0ULL;

  void init(const uint64_t *a, const uint64_t *b, int64_t n) {
    size_t s = 1024;
    while ((int64_t)s < n * 2) s <<= 1;
    ka.assign(s, kEmpty);
    kb.assign(s, 0);
    row.assign(s, -1);
    mask = s - 1;
    for (int64_t i = 0; i < n; i++) {
      uint64_t h = (mix64(a[i]) ^ (mix64(b[i]) * 0x9e3779b97f4a7c15ULL))
                   & mask;
      while (ka[h] != kEmpty) {
        if (ka[h] == a[i] && kb[h] == b[i]) break;  // dup key: keep first
        h = (h + 1) & mask;
      }
      if (ka[h] == kEmpty) {
        ka[h] = a[i];
        kb[h] = b[i];
        row[h] = i;
      }
    }
  }
  int64_t find(uint64_t a, uint64_t b) const {
    if (mask == 0) return -1;
    uint64_t h = (mix64(a) ^ (mix64(b) * 0x9e3779b97f4a7c15ULL)) & mask;
    while (ka[h] != kEmpty) {
      if (ka[h] == a && kb[h] == b) return row[h];
      h = (h + 1) & mask;
    }
    return -1;
  }
};

constexpr int kOverlap = 0, kContains = 1, kContained = 2;
// collect-mode only: pair's alignment was harvested as a miss request;
// optimistically assumed to be an accepted OVERLAP for the rest of the
// pass (the majority outcome), which keeps the pass's bestn dynamics close
// to the true replay's.  A pair whose cached alignment already failed the
// accept test in this pass is not assumed so (see collect_rejecters):
// such pairs fail again at many later anchors (tandem arrays, diverged
// copies), and marking one pending at each round's first new anchor left
// the rest of its chain, one anchor a round, to the exact final pass
constexpr int kPending = 3;

}  // namespace

extern "C" {

#pragma pack(push, 1)
// matches native SPEC_REQ_DTYPE (20-byte packed request rows)
struct SpecReq {
  uint32_t rid0, rid1;
  int32_t pos0, pos1;
  uint8_t s0, s1;
  uint16_t pad;
};
#pragma pack(pop)

// One hash shard's replay.  ys/dirs/pos are the bucket stream already
// sorted (bucket-major, descending position within bucket) by the caller;
// buckets are [bstart[i], bend[i]).  Returns a malloc'd OvlpRec array.
//
// collect mode (miss_reqs != nullptr): a cache miss is RECORDED as a
// request instead of aligning inline (and its pair marked kPending) — the
// driver aligns the collected requests in parallel
// and re-runs the replay with the widened cache, iterating until the
// final exact pass (ops.overlap.overlap_all_spec).  The final pass runs
// with miss_reqs == nullptr, where misses align inline, so correctness
// never depends on the collected set.
//
// collect_rejecters (collect mode): a miss whose rid pair has a cached
// result failing the accept test earlier in this pass is collected
// without marking the pair kPending or counting it as an overlap — the
// pass goes on as the exact pass goes on after a rejection, so it also
// collects the pair's later anchors and the candidates a failed slot
// opens.  The rule reads only the stream and the cache, so every rank
// of a sharded harvest collects the same requests.  *n_rejecters counts
// the misses whose pair had such a failing cached anchor, in either
// mode and whether or not the rule is on.
//
// streaming collect (stream_buf != nullptr): the first stream_cap misses
// are written into the caller's buffer as they are discovered, with
// *stream_progress advanced by a release-store after each one — aligner
// threads on the Python side consume [consumed, progress) slices WHILE
// this pass runs, hiding the single-core replay wall under the parallel
// alignment work.  Overflow beyond stream_cap falls back to the malloc'd
// miss_reqs array (aligned after the pass, exactly the non-streamed
// behavior), so the cap only bounds the overlap, never correctness.
void overlap_replay_c(const uint64_t *ys, const uint8_t *dirs,
                      const int64_t *pos, const int64_t *bstart,
                      const int64_t *bend, int64_t n_buckets,
                      const uint8_t *db_data, const int64_t *offsets,
                      const int64_t *lengths, int32_t bestn, int32_t fuzz,
                      int32_t min_aln, int32_t band, const uint64_t *ck_a,
                      const uint64_t *ck_b, const int32_t *cvals,
                      int64_t n_cache, OvlpRec **out_recs, int64_t *n_out,
                      int64_t *n_miss, SpecReq **miss_reqs,
                      SpecReq *stream_buf, int64_t stream_cap,
                      int64_t *stream_progress, int32_t collect_rejecters,
                      int64_t *n_rejecters) {
  CacheMap cache;
  cache.init(ck_a, ck_b, n_cache);
  PairMap rid_pairs;
  rid_pairs.init((size_t)std::max<int64_t>(n_cache, 4096));
  PairMap rejected;  // rid pairs with a failing cached result this pass
  rejected.init(4096);
  int64_t rejecters = 0;
  std::vector<OvlpRec> out;
  std::vector<uint8_t> contained;
  std::vector<SpecReq> collected;
  const bool collect = miss_reqs != nullptr;
  int64_t misses = 0;
  int64_t n_streamed = 0;

  for (int64_t bi = 0; bi < n_buckets; bi++) {
    const int64_t s = bstart[bi], e = bend[bi];
    const int64_t n = e - s;
    contained.assign(n, 0);

    for (int64_t ai = n - 2; ai >= 0; ai--) {
      if (contained[ai]) continue;
      const uint64_t y0 = ys[s + ai];
      const int64_t rid0 = (int64_t)(y0 >> 32);
      const int64_t pos0 = pos[s + ai] + 1;
      const int64_t rlen0 = lengths[rid0];
      const uint8_t strand0 = dirs[s + ai];
      int overlap_count = 0;

      for (int64_t ci = ai + 1; ci < n; ci++) {
        if (overlap_count >= bestn) break;
        if (contained[ci]) continue;
        const uint64_t y1 = ys[s + ci];
        const int64_t rid1 = (int64_t)(y1 >> 32);
        if (rid0 == rid1) continue;
        const uint64_t ridp = rid0 < rid1
                                  ? ((uint64_t)rid0 << 32) | (uint64_t)rid1
                                  : ((uint64_t)rid1 << 32) | (uint64_t)rid0;
        const uint8_t *prev = rid_pairs.find(ridp);
        if (prev) {
          if (*prev == kOverlap || *prev == kPending) overlap_count++;
          continue;
        }
        const int64_t pos1 = pos[s + ci] + 1;
        const int64_t rlen1 = lengths[rid1];
        const uint8_t strand1 = dirs[s + ci];
        const int64_t slen0 = rlen0 - pos0 + pos1;
        const int64_t slen1 = rlen1;

        int32_t dist, q_bgn, q_end, t_bgn, t_end, m_size, q_m_end, t_m_end;
        const uint64_t key_a = ((uint64_t)rid0 << 33) |
                               ((uint64_t)pos0 << 1) | strand0;
        const uint64_t key_b = ((uint64_t)rid1 << 33) |
                               ((uint64_t)pos1 << 1) | strand1;
        const int64_t hit = cache.find(key_a, key_b);
        if (hit >= 0) {
          const int32_t *v = cvals + hit * 8;
          m_size = v[0];
          dist = v[1];
          q_bgn = v[2];
          q_end = v[3];
          t_bgn = v[4];
          t_end = v[5];
          t_m_end = v[6];
          q_m_end = v[7];
        } else if (collect) {
          misses++;
          const bool known = rejected.find(ridp) != nullptr;
          rejecters += known;
          const SpecReq rq{(uint32_t)rid0, (uint32_t)rid1,
                           (int32_t)pos0, (int32_t)pos1, strand0,
                           strand1, 0};
          if (stream_buf != nullptr && n_streamed < stream_cap) {
            stream_buf[n_streamed++] = rq;
            __atomic_store_n(stream_progress, n_streamed, __ATOMIC_RELEASE);
          } else {
            collected.push_back(rq);
          }
          if (known && collect_rejecters) continue;  // as a rejection
          // assumed accepted-OVERLAP for this pass; kPending stops the
          // pair from being re-collected at every later occurrence
          rid_pairs.put(ridp, kPending);
          overlap_count++;
          continue;
        } else {
          misses++;
          rejecters += rejected.find(ridp) != nullptr;
          OvlpMatch m;
          const int64_t qoff = offsets[rid0] + pos0 - pos1;
          ovlp_match_c(db_data + qoff, (coor)(rlen0 - (pos0 - pos1)),
                       strand0, db_data + offsets[rid1], (coor)rlen1,
                       strand1, band, &m);
          dist = m.dist;
          q_bgn = m.q_bgn;
          q_end = m.q_end;
          t_bgn = m.t_bgn;
          t_end = m.t_end;
          m_size = m.m_size;
          q_m_end = m.q_m_end;
          t_m_end = m.t_m_end;
        }

        const bool ok =
            q_bgn < fuzz && t_bgn < fuzz &&
            (std::abs(slen0 - q_end) < fuzz || std::abs(slen1 - t_end) < fuzz)
            && q_end > min_aln && t_end > min_aln;
        if (!ok && hit >= 0) rejected.put(ridp, 1);
        if (ok) {
          uint8_t ovlp_type;
          if (std::abs(rlen0 - (int64_t)(q_end - q_bgn)) < fuzz * 2 ||
              std::abs(rlen1 - (int64_t)(t_end - t_bgn)) < fuzz * 2) {
            if (rlen0 >= rlen1) {
              rid_pairs.put(ridp, kContains);
              ovlp_type = kContains;
              contained[ci] = 1;
            } else {
              rid_pairs.put(ridp, kContained);
              ovlp_type = kContained;
              contained[ai] = 1;
            }
          } else {
            overlap_count++;
            rid_pairs.put(ridp, kOverlap);
            ovlp_type = kOverlap;
          }
          OvlpRec r;
          r.y0 = y0;
          r.y1 = y1;
          r.rl0 = (uint32_t)rlen0;
          r.rl1 = (uint32_t)rlen1;
          r.strand0 = strand0;
          r.strand1 = strand1;
          r.ovlp_type = ovlp_type;
          r.m_size = m_size;
          r.dist = dist;
          r.q_bgn = q_bgn;
          r.q_end = q_end;
          r.t_bgn = t_bgn;
          r.t_end = t_end;
          r.t_m_end = t_m_end;
          r.q_m_end = q_m_end;
          out.push_back(r);
        }
        if (contained[ai]) break;
      }
    }
  }

  *n_out = (int64_t)out.size();
  *n_miss = misses;
  *n_rejecters = rejecters;
  *out_recs = (OvlpRec *)std::malloc(out.size() * sizeof(OvlpRec));
  std::memcpy(*out_recs, out.data(), out.size() * sizeof(OvlpRec));
  if (collect) {
    *miss_reqs = (SpecReq *)std::malloc(collected.size() * sizeof(SpecReq));
    std::memcpy(*miss_reqs, collected.data(),
                collected.size() * sizeof(SpecReq));
  }
}

void free_spec_reqs2_c(SpecReq **r) {
  std::free(*r);
  *r = nullptr;
}

void free_ovlp_recs_c(OvlpRec **r) {
  std::free(*r);
  *r = nullptr;
}

// Align a slice [lo, hi) of speculative requests (spec_enum.cpp layout,
// 20-byte packed rows) into out[i*8..] rows in OvlpMatch field order.
// Called concurrently from Python threads on disjoint slices — ctypes
// releases the GIL for the duration, so host cores scale the speculative
// phase while the sequential replay stays exact (the cross-chunk dedup:
// each rid pair is aligned once globally instead of once per hash chunk,
// reference behavior being per-process RPAIR tables,
// src/shmr_overlap.c:101-107).
void align_spec_c(const uint8_t *reqs, int64_t lo, int64_t hi,
                  const uint8_t *db_data, const int64_t *offsets,
                  const int64_t *lengths, int32_t band, int32_t *out) {
  struct Req {
    uint32_t rid0, rid1;
    int32_t pos0, pos1;
    uint8_t s0, s1;
    uint16_t pad;
  };
  static_assert(sizeof(Req) == 20, "request layout must match SPEC_REQ_DTYPE");
  const Req *r = reinterpret_cast<const Req *>(reqs);
  for (int64_t i = lo; i < hi; i++) {
    const Req &q = r[i];
    const int64_t rlen0 = lengths[q.rid0], rlen1 = lengths[q.rid1];
    const int64_t shift = (int64_t)q.pos0 - q.pos1;
    OvlpMatch m;
    ovlp_match_c(db_data + offsets[q.rid0] + shift, (coor)(rlen0 - shift),
                 q.s0, db_data + offsets[q.rid1], (coor)rlen1, q.s1, band,
                 &m);
    int32_t *o = out + i * 8;
    o[0] = m.m_size;
    o[1] = m.dist;
    o[2] = m.q_bgn;
    o[3] = m.q_end;
    o[4] = m.t_bgn;
    o[5] = m.t_end;
    o[6] = m.t_m_end;
    o[7] = m.q_m_end;
  }
}

}  // extern "C"
