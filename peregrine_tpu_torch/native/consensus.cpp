// Native consensus window: backbone + per-read alignment + tag pileup +
// max-weight-path consensus, one call per template window.
//
// Semantics mirror the reference consensus core (falcon/falcon.c:67-397)
// and its driver loop (py/scripts/pg_asm_cns.py:109-249), and match the
// Python port in ops/consensus.py (cross-checked in tests):
//   * tags: (t_pos, delta, q_base) with predecessor links, built from the
//     gapped alignment strings of the banded O(ND) aligner;
//   * edges counted per (ctag -> ptag); scored count - 0.5*(coverage-1);
//   * DP over ctags in ascending uint64-key order (sentinel p_t_pos = -1
//     wraps high and sorts last within a ctag's predecessors);
//   * backtrack emits bases, lowercased where coverage <= min_cov.
//
// Unlike the reference's khash-of-khash, each tag pair is one packed
// uint64 whose bit layout makes lexicographic (ctag, ptag) order equal
// integer order; pairs are counting-sorted by template position with tiny
// within-bucket sorts, and the DP resolves predecessors by binary search
// inside the (t_pos-1, t_pos) node ranges — no hash maps anywhere.  The
// predecessor of a tag is always at t_pos or t_pos-1 (alignment columns
// advance the template by 0 or 1), so two bits encode its position:
// prel 0 = t_pos-1, 1 = t_pos, 2 = the -1 sentinel (which in the
// reference's uint32 key wraps high and sorts last).

#include <algorithm>
#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

// PG_CNS_PROFILE=1 prints per-phase wall times to stderr.
static double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

extern "C" {

typedef int32_t coor;

struct Alignment {
  coor aln_str_size, dist;
  coor aln_q_s, aln_q_e;
  coor aln_t_s, aln_t_e;
  char *q_aln_str;
  char *t_aln_str;
};

void dw_align_c(const char *q, coor q_len, const char *t, coor t_len,
                coor band_tolerance, int get_aln_str, Alignment *out);
void free_alignment_c(Alignment *a);

struct CnsResult {
  char *seq;
  int32_t len;
};

}  // extern "C"

namespace {

// Base codes preserving ASCII order among the consensus alphabet
// '-'(45) < '.'(46) < 'A'(65) < 'C'(67) < 'G'(71) < 'N'(78) < 'T'(84).
// 'N' IS produced by the 4-bit codec (ambiguous nibbles decode to 'N',
// seqdb.py _BITS2BASE), so it must keep its ASCII rank between G and T
// for tie order to match the Python semantic port.
struct BaseCodeTable {
  uint8_t t[256];
  BaseCodeTable() {
    for (int i = 0; i < 256; i++) t[i] = 7;
    t['-'] = 0; t['.'] = 1; t['A'] = 2; t['C'] = 3;
    t['G'] = 4; t['N'] = 5; t['T'] = 6;
  }
};
static const BaseCodeTable kBaseCode;
inline uint32_t base_code(uint8_t b) { return kBaseCode.t[b]; }
constexpr char kCodeBase[8] = {'-', '.', 'A', 'C', 'G', 'N', 'T', 'N'};

// Packed tag-pair key, low to high bits:
//   p_base:3 | p_delta:8 | prel:2 | base:3 | delta:8 | t_pos:40
// Integer order == the reference's ((t_pos, delta, base), ptag-key) order.
inline uint64_t pack_pair(int64_t t_pos, uint32_t delta, uint8_t base,
                          int64_t p_t_pos, uint32_t p_delta, uint8_t p_base) {
  const uint64_t prel = p_t_pos < 0 ? 2u : (p_t_pos == t_pos ? 1u : 0u);
  return (uint64_t)t_pos << 24 | (uint64_t)(delta & 0xFF) << 16 |
         (uint64_t)base_code(base) << 13 | prel << 11 |
         (uint64_t)(p_delta & 0xFF) << 3 | base_code(p_base);
}

// node id = key >> 13:  base:3 | delta:8 | t_pos:40
constexpr int kNodeShift = 13;

// Accumulate one alignment's packed tag pairs (reference falcon.c:67-122
// plus the leading-deletion skip at falcon.c:304-310).
void add_tags(const char *q_aln, const char *t_aln, coor n, coor s1, coor s2,
              coor t_offset, std::vector<uint64_t> *pairs,
              std::vector<int32_t> *coverage) {
  int64_t i = s1 - 1, j = s2 - 1;
  uint32_t jj = 0, p_jj = 0;
  int64_t p_j = -1;
  uint8_t p_q = '.';
  bool started = false;
  for (coor k = 0; k < n; k++) {
    const char qb = q_aln[k], tb = t_aln[k];
    if (qb != '-') {
      i++;
      jj++;
    }
    if (tb != '-') {
      j++;
      jj = 0;
    }
    if (j + t_offset >= 0 && jj < 255 && p_jj < 255) {
      if (!started && p_q == '-') {
        // leading-deletion columns skipped
      } else {
        started = true;
        pairs->push_back(pack_pair(j + t_offset, jj, (uint8_t)qb,
                                   p_j + t_offset, p_jj, p_q));
        if (jj == 0) (*coverage)[j + t_offset]++;
      }
      p_j = j;
      p_jj = jj;
      p_q = (uint8_t)qb;
    } else {
      break;
    }
  }
}

}  // namespace

extern "C" {

// One consensus window.  read_seqs are ASCII; shifts are template offsets
// (negative: read starts before the window).  Returns the consensus
// sequence (caller frees via free_cns_c).  A coverage-starved window
// (aligned bases < 3x template) returns the lowercased template.
void window_cns_c(const char *ref_seq, int32_t ref_len,
                  const char **read_seqs, const int32_t *read_lens,
                  const int32_t *shifts, int32_t n_reads, int32_t band,
                  int32_t min_cov, CnsResult *out) {
  const bool prof = getenv("PG_CNS_PROFILE") != nullptr;
  double t0 = prof ? now_s() : 0.0;
  std::vector<uint64_t> pairs;
  std::vector<int32_t> coverage(ref_len + 2, 0);
  pairs.reserve((size_t)ref_len * 4);

  Alignment aln;
  // backbone self-alignment (reference pg_asm_cns.py:152-166)
  dw_align_c(ref_seq, ref_len, ref_seq, ref_len, 50, 1, &aln);
  add_tags(aln.q_aln_str, aln.t_aln_str, aln.aln_str_size, aln.aln_q_s,
           aln.aln_t_s, 0, &pairs, &coverage);
  free_alignment_c(&aln);

  int64_t aln_base = 0;
  for (int32_t r = 0; r < n_reads; r++) {
    const int32_t shift = shifts[r];
    const int32_t rl = read_lens[r];
    if (shift < 0) {
      if (-shift >= rl) continue;
      dw_align_c(read_seqs[r] - shift, rl + shift, ref_seq, ref_len, band, 1,
                 &aln);
      if (std::abs(std::abs(aln.aln_q_e - aln.aln_q_s) - (rl + shift)) < 48) {
        add_tags(aln.q_aln_str, aln.t_aln_str, aln.aln_str_size, aln.aln_q_s,
                 aln.aln_t_s, 0, &pairs, &coverage);
        aln_base += std::abs(aln.aln_t_e - aln.aln_t_s);
      }
    } else {
      if (shift >= ref_len) continue;
      dw_align_c(read_seqs[r], rl, ref_seq + shift, ref_len - shift, band, 1,
                 &aln);
      if (std::abs(std::abs(aln.aln_q_e - aln.aln_q_s) - rl) < 48 ||
          std::abs((ref_len - shift) - std::abs(aln.aln_q_e - aln.aln_q_s)) <
              48) {
        add_tags(aln.q_aln_str, aln.t_aln_str, aln.aln_str_size, aln.aln_q_s,
                 aln.aln_t_s, shift, &pairs, &coverage);
        aln_base += std::abs(aln.aln_t_e - aln.aln_t_s);
      }
    }
    free_alignment_c(&aln);
  }

  double t_tags = prof ? now_s() : 0.0;

  if (aln_base < (int64_t)ref_len * 3) {
    out->seq = (char *)std::malloc(ref_len + 1);
    for (int32_t i = 0; i < ref_len; i++)
      out->seq[i] = (char)std::tolower(ref_seq[i]);
    out->seq[ref_len] = 0;
    out->len = ref_len;
    return;
  }

  // counting sort by t_pos (key >> 24), then sort each small bucket.
  // Two-pass, cache-aware: a direct scatter into per-pos buckets touches
  // the whole pairs array (tens of MB) randomly; instead pairs are first
  // partitioned into coarse contiguous t_pos chunks (sequential stream
  // writes, one open cache line per chunk), then exact-placed within the
  // cache-resident chunk.
  const size_t n_pairs = pairs.size();
  const int32_t n_pos = ref_len + 2;
  constexpr int kChunkBits = 12;  // 4096 template positions per chunk
  const int32_t n_chunks = (n_pos >> kChunkBits) + 1;
  std::vector<uint32_t> bucket_start(n_pos + 1, 0);
  for (size_t k = 0; k < n_pairs; k++) bucket_start[(pairs[k] >> 24) + 1]++;
  for (int32_t p = 0; p < n_pos; p++) bucket_start[p + 1] += bucket_start[p];
  std::vector<uint64_t> sorted(n_pairs);
  {
    // chunk regions in `sorted` are the final per-chunk ranges
    std::vector<uint32_t> ccur(n_chunks);
    for (int32_t c = 0; c < n_chunks; c++)
      ccur[c] = bucket_start[std::min(c << kChunkBits, n_pos)];
    for (size_t k = 0; k < n_pairs; k++)
      sorted[ccur[pairs[k] >> (24 + kChunkBits)]++] = pairs[k];
    pairs.clear();
    pairs.shrink_to_fit();
    // exact placement inside each chunk via a scratch buffer
    std::vector<uint64_t> scratch;
    std::vector<uint32_t> cursor;
    for (int32_t c = 0; c < n_chunks; c++) {
      const int32_t p_lo = c << kChunkBits;
      const int32_t p_hi = std::min((c + 1) << kChunkBits, n_pos);
      const uint32_t lo = bucket_start[p_lo], hi = bucket_start[p_hi];
      if (hi == lo) continue;
      scratch.resize(hi - lo);
      cursor.assign(bucket_start.begin() + p_lo, bucket_start.begin() + p_hi);
      for (uint32_t k = lo; k < hi; k++)
        scratch[cursor[(sorted[k] >> 24) - p_lo]++ - lo] = sorted[k];
      std::memcpy(&sorted[lo], scratch.data(), (hi - lo) * sizeof(uint64_t));
    }
  }
  double t_csort = prof ? now_s() : 0.0;
  for (int32_t p = 0; p < n_pos; p++)
    std::sort(sorted.begin() + bucket_start[p],
              sorted.begin() + bucket_start[p + 1]);
  double t_bsort = prof ? now_s() : 0.0;

  // DP over ctags in ascending key order; nodes are appended in that same
  // order, so per-t_pos node ranges replace the reference's hash lookups.
  std::vector<uint64_t> node_ckey;
  std::vector<double> node_score;
  std::vector<int32_t> node_pred;
  node_ckey.reserve(n_pairs / 4);
  node_score.reserve(n_pairs / 4);
  node_pred.reserve(n_pairs / 4);
  std::vector<uint32_t> node_start(n_pos + 1, 0);

  double global_best = 0.0;
  int64_t global_best_node = -1;
  int32_t prev_pos = -1;

  size_t i = 0;
  while (i < n_pairs) {
    const uint64_t ckey = sorted[i] >> kNodeShift;
    const int32_t t_pos = (int32_t)(ckey >> 11);
    if (t_pos != prev_pos) {
      for (int32_t p = prev_pos + 1; p <= t_pos; p++)
        node_start[p] = (uint32_t)node_ckey.size();
      prev_pos = t_pos;
    }
    const size_t ni = node_ckey.size();
    node_ckey.push_back(ckey);
    node_score.push_back(0.0);
    node_pred.push_back(-1);
    bool first = true;

    while (i < n_pairs && (sorted[i] >> kNodeShift) == ckey) {
      const uint64_t key = sorted[i];
      size_t k = i;
      while (k < n_pairs && sorted[k] == key) k++;
      const double score =
          (double)(k - i) - 0.5 * ((double)coverage[t_pos] - 1);

      // resolve predecessor node index
      int32_t pred = -1;
      const uint32_t prel = (uint32_t)(key >> 11) & 3;
      if (prel != 2 && (key & 7) != 1 /* '.' */) {
        const int64_t p_pos = prel == 1 ? t_pos : t_pos - 1;
        const uint64_t pkey =
            (uint64_t)p_pos << 11 | ((key >> 3) & 0xFF) << 3 | (key & 7);
        const uint32_t lo = node_start[p_pos];
        const uint32_t hi = prel == 1 ? (uint32_t)ni : node_start[t_pos];
        auto it = std::lower_bound(node_ckey.begin() + lo,
                                   node_ckey.begin() + hi, pkey);
        if (it != node_ckey.begin() + hi && *it == pkey)
          pred = (int32_t)(it - node_ckey.begin());
      }

      if (first) {
        node_score[ni] = score;
        node_pred[ni] = pred;
        first = false;
      }
      if (pred >= 0) {
        const double new_score = score + node_score[pred];
        if (new_score > node_score[ni]) {
          node_score[ni] = new_score;
          node_pred[ni] = pred;
          if (new_score > global_best) {
            global_best = new_score;
            global_best_node = (int64_t)ni;
          }
        }
      }
      i = k;
    }
  }

  std::vector<char> cns;
  cns.reserve(ref_len + 16);
  if (global_best_node >= 0) {
    int64_t ni = global_best_node;
    while (ni >= 0) {
      const uint64_t ckey = node_ckey[ni];
      const int32_t t_pos = (int32_t)(ckey >> 11);
      const char base = kCodeBase[ckey & 7];
      if (base != '-') {
        cns.push_back(coverage[t_pos] > min_cov ? base
                                                : (char)std::tolower(base));
      }
      ni = node_pred[ni];
    }
    std::reverse(cns.begin(), cns.end());
  }

  out->len = (int32_t)cns.size();
  out->seq = (char *)std::malloc(cns.size() + 1);
  std::memcpy(out->seq, cns.data(), cns.size());
  out->seq[cns.size()] = 0;

  if (prof) {
    double t_end = now_s();
    fprintf(stderr,
            "[cns prof] pairs=%zu tags+align=%.3f csort=%.3f bsort=%.3f "
            "dp+bt=%.3f total=%.3f\n",
            n_pairs, t_tags - t0, t_csort - t_tags, t_bsort - t_csort,
            t_end - t_bsort, t_end - t0);
  }
}

void free_cns_c(CnsResult *r) {
  std::free(r->seq);
  r->seq = nullptr;
}

}  // extern "C"
