// Banded bit-parallel Myers aligner for Hopper (sm_90a): the device
// overlap aligner of the stage-2 backends --device-aligner and
// --hybrid-overlap.
//
//   pg_myers_align <- _myers_core (peregrine_tpu/ops/device_align.py:66),
//                     as myers_batch_db_packed (:216) calls it
//
// The JAX package has no Pallas kernel here: its aligner is one fused
// lax.fori_loop that XLA compiles (ceil(LT/32) column chunks, 32 columns
// each, 8 dependent 32-bit block updates a column).  Written as plain
// PyTorch that loop is millions of tiny launches a batch, so the port
// writes it by hand.
//
// What it computes, per lane (one anchored alignment request): the
// optimal edit distance of the query against the target within a band of
// kNb 32-bit words (256 cells) that slides along the anchor diagonal,
// with the target-end and query-end readouts of _myers_core, and its
// tie rules: best_te takes the first column with the strictly lowest
// score; the query-end scan walks rows bottom, bottom - 1, ... and takes
// the first minimum (ties go to the larger row); the target end wins
// ties with the query end (<=).
//
// Inputs are the packed seqdb planes of ops/dbgather.py (fw: 2-bit codes,
// 4 bases a byte; amb: ambiguity bits, 8 a byte; both after GUARD_BASES
// of zeros) and seven int64 request columns a lane (q_off, q_rstart,
// q_len, q_strand, t_off, t_len, t_strand).  Query base i of a strand-1
// request is the complement of the base at q_rstart + q_len - 1 - i, and
// a target's likewise from t_off; an ambiguous base, or a row at or past
// the length, is code 7, which matches nothing: exactly gather_codes(...,
// fill=7).
//
// Design (simple and right, not yet fast):
//   * one thread per lane; the window's pv/mv words and the query's
//     match masks (PEq, 4 codes x kNb words) stay in registers;
//   * PEq is built from the lane's own query bases read straight from the
//     planes: rows [0, 256) at the start, then one new word (32 rows)
//     each time the window slides; there is no PEq and no code tensor in
//     device memory;
//   * a thread stops at its own t_len: columns past t_len change nothing
//     the readouts use (best_te updates only while j < t_len and the
//     snapshot of _myers_core is taken at t_len - 1, which is then the
//     thread's final state), and rows past q_len are code 7 whatever the
//     pad length, so the result does not depend on the JAX package's pad
//     classes, and one launch takes every lane of a round;
//   * blocks of one warp, so that a round of a thousand lanes already
//     spreads over 32 SMs.
//
// What bounds it: integer operations.  The function needs 13 32-bit
// operations per block update x kNb blocks plus 11 for the column, per
// lane and target column (chip_smoke.py's MYERS_OPS_PER_COLUMN); this
// source's column loop compiles to more (chip_smoke.py --aligner-sass
// counts them).  Bytes are the request columns, the outputs and the
// bases each lane reads, a few hundred bytes a lane.
//
// The extern "C" entry launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNb = 8;            // window words (ops/device_align.py NB)
constexpr int kWb = 32;           // DP cells per word
constexpr int kGuard = 1 << 16;   // GUARD_BASES of ops/dbgather.py
constexpr int kBig = 1 << 30;     // "no score" (BIG of _myers_core)
constexpr int kThreads = 32;      // one warp a block

// One lane's sequence: base i lies at position p0 + dir * i of the seqdb
// (dir -1 and complemented on strand 1); rows at or past len are code 7.
struct Seq {
  long long p0;
  int dir;
  int len;
  int comp;
};

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// The 2-bit code of base i of s (0..3), or 7 for an ambiguous base or a
// row past the length: gather_codes' arithmetic, its clamps included.
__device__ __forceinline__ int code_at(const uint8_t* __restrict__ fw,
                                       const uint8_t* __restrict__ amb,
                                       long long fw_n, long long amb_n,
                                       const Seq& s, int i) {
  if (i >= s.len) return 7;
  const long long q = s.p0 + (long long)s.dir * i + kGuard;
  const int c = (__ldg(fw + clamp_index(q >> 2, fw_n)) >> (2 * (q & 3))) & 3;
  const int a = (__ldg(amb + clamp_index(q >> 3, amb_n)) >> (q & 7)) & 1;
  return a ? 7 : (c ^ s.comp);
}

// Match masks of the 32 query rows [row0, row0 + 32) for codes 0..3.
__device__ __forceinline__ void peq_word(const uint8_t* __restrict__ fw,
                                         const uint8_t* __restrict__ amb,
                                         long long fw_n, long long amb_n,
                                         const Seq& q, int row0,
                                         uint32_t& e0, uint32_t& e1,
                                         uint32_t& e2, uint32_t& e3) {
  e0 = e1 = e2 = e3 = 0;
  for (int i = 0; i < kWb; ++i) {
    const int c = code_at(fw, amb, fw_n, amb_n, q, row0 + i);
    const uint32_t bit = 1u << i;
    e0 |= c == 0 ? bit : 0u;
    e1 |= c == 1 ? bit : 0u;
    e2 |= c == 2 ? bit : 0u;
    e3 |= c == 3 ? bit : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
myers_align_kernel(const uint8_t* __restrict__ fw,
                   const uint8_t* __restrict__ amb, long long fw_n,
                   long long amb_n, const long long* __restrict__ cols,
                   int B, int* __restrict__ dist, int* __restrict__ q_end,
                   int* __restrict__ t_end) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const long long* c = cols + 7LL * lane;
  // int32 casts of the lengths and strands, as myers_batch_db_packed's
  const int q_len = (int)c[2], q_strand = (int)c[3];
  const int t_len = (int)c[5], t_strand = (int)c[6];
  const Seq q{q_strand == 0 ? c[0] : c[1] + q_len - 1,
              q_strand == 0 ? 1 : -1, q_len, q_strand == 0 ? 0 : 3};
  const Seq t{t_strand == 0 ? c[4] : c[4] + t_len - 1,
              t_strand == 0 ? 1 : -1, t_len, t_strand == 0 ? 0 : 3};

  uint32_t pv[kNb], mv[kNb], p0[kNb], p1[kNb], p2[kNb], p3[kNb];
#pragma unroll
  for (int b = 0; b < kNb; ++b) {
    pv[b] = 0xFFFFFFFFu;
    mv[b] = 0;
    peq_word(fw, amb, fw_n, amb_n, q, b * kWb, p0[b], p1[b], p2[b], p3[b]);
  }
  int bot = kNb * kWb;
  int best_te_d = kBig, best_te_j = 0;
  int w0 = 0;   // the window's first word: rows [w0 * 32, (w0 + kNb) * 32)

  const int n_chunks = t_len > 0 ? (t_len + kWb - 1) / kWb : 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // w0 = max(0, chunk - kNb / 2) rises by one word a chunk once it
    // moves: the slide shifts both planes by one word, fills pv with
    // ones and adds 32 to bot.  The window never runs past the JAX
    // package's PEq (nbq words, :82), so dynamic_slice never clamps
    // there and no clamp is mirrored here.
    const int nw0 = chunk - kNb / 2 > 0 ? chunk - kNb / 2 : 0;
    if (nw0 > w0) {
#pragma unroll
      for (int b = 0; b + 1 < kNb; ++b) {
        pv[b] = pv[b + 1];
        mv[b] = mv[b + 1];
        p0[b] = p0[b + 1];
        p1[b] = p1[b + 1];
        p2[b] = p2[b + 1];
        p3[b] = p3[b + 1];
      }
      pv[kNb - 1] = 0xFFFFFFFFu;
      mv[kNb - 1] = 0;
      bot += kWb;
      w0 = nw0;
      peq_word(fw, amb, fw_n, amb_n, q, (w0 + kNb - 1) * kWb, p0[kNb - 1],
               p1[kNb - 1], p2[kNb - 1], p3[kNb - 1]);
    }
    const int bottom_row = (w0 + kNb) * kWb;
    const bool covers_q = bottom_row >= q_len;
    const int j0 = chunk * kWb;
    const int cols_here = t_len - j0 < kWb ? t_len - j0 : kWb;
    for (int u = 0; u < cols_here; ++u) {
      const int j = j0 + u;
      const int tc = code_at(fw, amb, fw_n, amb_n, t, j);
      // the block chain: hin enters the top block as +1 and each block's
      // horizontal delta (+1, 0 or -1) is (hp, hm) with at most one set
      uint32_t hp = 1, hm = 0;
#pragma unroll
      for (int b = 0; b < kNb; ++b) {
        uint32_t e = tc == 0 ? p0[b] : tc == 1 ? p1[b]
                   : tc == 2 ? p2[b] : tc == 3 ? p3[b] : 0u;
        const uint32_t p = pv[b], m = mv[b];
        const uint32_t xv = e | m;
        e |= hm;
        const uint32_t xh = (((e & p) + p) ^ p) | e;
        uint32_t ph = m | ~(xh | p);
        uint32_t mh = p & xh;
        const uint32_t hp_out = ph >> 31, hm_out = mh >> 31;
        ph = (ph << 1) | hp;
        mh = (mh << 1) | hm;
        pv[b] = mh | ~(xv | ph);
        mv[b] = ph & xv;
        hp = hp_out;
        hm = hm_out;
      }
      bot += (int)hp - (int)hm;
      const int d_lq = bot - (bottom_row - q_len);
      if (covers_q && d_lq < best_te_d) {
        best_te_d = d_lq;
        best_te_j = j + 1;
      }
    }
  }

  // query-end readout on the state after column t_len - 1: the score of
  // row bottom - r is bot less the deltas (pv bit - mv bit) of the r
  // window bits from the top; rows outside [0, q_len] do not count
  const int bottom = (w0 + kNb) * kWb;
  int best_qe_d = kBig, best_qe_row = bottom;
  int score = bot;
  if (bottom >= 0 && bottom <= q_len && score < best_qe_d) {
    best_qe_d = score;
    best_qe_row = bottom;
  }
  int row = bottom;
#pragma unroll
  for (int b = kNb - 1; b >= 0; --b) {
    const uint32_t p = pv[b], m = mv[b];
    for (int s = kWb - 1; s >= 0; --s) {
      score -= (int)((p >> s) & 1u) - (int)((m >> s) & 1u);
      --row;
      if (row >= 0 && row <= q_len && score < best_qe_d) {
        best_qe_d = score;
        best_qe_row = row;
      }
    }
  }

  const bool use_te = best_te_d <= best_qe_d;
  dist[lane] = use_te ? best_te_d : best_qe_d;
  q_end[lane] = use_te ? q_len : best_qe_row;
  t_end[lane] = use_te ? best_te_j : t_len;
}

}  // namespace

extern "C" {

int pg_myers_align(const void* fw, const void* amb, long long fw_bytes,
                   long long amb_bytes, const void* cols, int B, int nb,
                   void* dist, void* q_end, void* t_end, void* stream) {
  if (nb != kNb || B < 0 || fw_bytes < 1 || amb_bytes < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  myers_align_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)fw, (const uint8_t*)amb, fw_bytes, amb_bytes,
      (const long long*)cols, B, (int*)dist, (int*)q_end, (int*)t_end);
  return (int)cudaGetLastError();
}

}  // extern "C"
