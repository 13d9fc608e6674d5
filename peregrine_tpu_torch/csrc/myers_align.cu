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
// fill=7), whose byte index clamps to the plane (nothing guards the end
// of the planes, so a read past it gives the last byte again).
//
// What bounds it: integer operations.  The function needs 13 32-bit
// operations per block update x kNb blocks plus 11 for the column, per
// lane and target column (chip_smoke.py's MYERS_OPS_PER_COLUMN); the
// column loop executes a few more (chip_smoke.py --aligner-sass counts
// them).  Bytes are the request columns, the outputs and the bases each
// lane reads, a few hundred bytes a lane.  So the design keeps every
// column's work inside the thread's registers:
//   * one thread per lane; the window's pv/mv words and the query's
//     match planes stay in registers;
//   * bases are read as 32-bit words, 32 at a time (three fw words and
//     two amb words, funnel-shifted to the window's start, since a
//     window starts at any base), and turned into bit planes: bit m of
//     the high plane is the high bit of base m's code, likewise the low
//     plane and the ambiguity plane.  A word that reaches outside a
//     plane is put together from clamped bytes, so no read passes the
//     plane's end and the clamp of gather_codes holds;
//   * the query is held as three planes a window word (high code bit,
//     low code bit, valid: not 7 and inside q_len), 24 words instead of
//     four match masks; a column's code gives two all-ones-or-zeros
//     masks, and a block's match word is (H ~^ m1) & (L ~^ m0) & V, two
//     three-input logic operations;
//   * the target's next 32 bases, and the query's next window word, are
//     loaded one chunk ahead, so their latency hides behind the current
//     chunk's 32 columns; each column takes its code from registers (the
//     planes' top bits, shifted up a column at a time);
//   * a chunk with an ambiguous target base runs a second column loop
//     that masks the match word with the column's validity; all other
//     chunks run the loop without it;
//   * a block passes its horizontal delta to the next as the top bits of
//     its ph and mh words (funnel shifts);
//   * the column loop is unrolled by two, so that the compiler overlaps a
//     column's first block updates with the last ones of the column
//     before (block b of column j waits only for block b - 1 of column j
//     and block b of column j - 1).  That is what a launch too small to
//     fill the card runs on: 1,024 lanes take a fifth less time than
//     with one column a pass.  It costs registers (110 against 96, no
//     spills); held to 96 the overlap goes;
//   * the scores tracked are the score at row q_len, which the window's
//     slide does not change;
//   * a thread stops at its own t_len: columns past t_len change nothing
//     the readouts use (best_te updates only while j < t_len and the
//     snapshot of _myers_core is taken at t_len - 1, which is then the
//     thread's final state), and rows past q_len are code 7 whatever the
//     pad length, so the result does not depend on the JAX package's pad
//     classes, and one launch takes every lane of a round;
//   * lanes run in the order the wrapper gives (longest target first), so
//     a warp's lanes end together and the longest start first; lane i
//     works on request order[i] and writes its outputs there;
//   * blocks of one warp, so that a round of a thousand lanes already
//     spreads over 32 SMs.
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

// A packed plane read as 32-bit words: word k holds the plane's bytes
// [4k - mis, 4k - mis + 4), little-endian; `words` is the 4-byte aligned
// address at or below the plane's first byte, mis the plane's offset
// from it.
struct Plane {
  const uint32_t* words;
  const uint8_t* bytes;
  long long n;   // bytes in the plane
  int mis;
};

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// Word k of a plane; bytes outside the plane read as the clamped byte.
__device__ __forceinline__ uint32_t load_word(const Plane& p, long long k) {
  const long long b0 = 4 * k - p.mis;
  if (b0 >= 0 && b0 + 3 < p.n) return __ldg(p.words + k);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w |= (uint32_t)__ldg(p.bytes + clamp_index(b0 + i, p.n)) << (8 * i);
  return w;
}

// The raw words of 32 bases from plane position P (guard included) up.
struct Raw {
  uint32_t f0, f1, f2, a0, a1;
};

__device__ __forceinline__ Raw load_raw(const Plane& fw, const Plane& amb,
                                        long long P) {
  const long long fb = 2 * P + 8 * fw.mis;   // bit of base P in fw's words
  const long long ab = P + 8 * amb.mis;
  Raw r;
  r.f0 = load_word(fw, fb >> 5);
  r.f1 = load_word(fw, (fb >> 5) + 1);
  r.f2 = load_word(fw, (fb >> 5) + 2);
  r.a0 = load_word(amb, ab >> 5);
  r.a1 = load_word(amb, (ab >> 5) + 1);
  return r;
}

// Gather the even bits of x into its low half and the odd bits into its
// high half (an outer perfect unshuffle).
__device__ __forceinline__ uint32_t unshuffle(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  return x;
}

// 32 bases as bit planes: hi/lo the code bits, am the ambiguity bits.
// Bit m is base P + m; with rev, bit 31 - m; comp complements the codes.
struct Bases {
  uint32_t hi, lo, am;
};

__device__ __forceinline__ Bases decode(const Raw& r, int fw_shift,
                                        int amb_shift, bool rev,
                                        uint32_t comp) {
  const uint32_t a = unshuffle(__funnelshift_r(r.f0, r.f1, fw_shift));
  const uint32_t b = unshuffle(__funnelshift_r(r.f1, r.f2, fw_shift));
  Bases s;
  s.lo = __byte_perm(a, b, 0x5410);
  s.hi = __byte_perm(a, b, 0x7632);
  s.am = __funnelshift_r(r.a0, r.a1, amb_shift);
  if (rev) {
    s.lo = __brev(s.lo);
    s.hi = __brev(s.hi);
    s.am = __brev(s.am);
  }
  s.lo ^= comp;
  s.hi ^= comp;
  return s;
}

// The query's planes of window word rows [row0, row0 + 32): bit i is row
// row0 + i; valid rows are unambiguous and below q_len.
__device__ __forceinline__ void query_word(const Bases& s, int row0,
                                           int q_len, uint32_t& h,
                                           uint32_t& l, uint32_t& v) {
  const int n = q_len - row0;
  const uint32_t rows = n >= kWb ? 0xFFFFFFFFu
                        : n <= 0 ? 0u : (1u << n) - 1u;
  h = s.hi;
  l = s.lo;
  v = rows & ~s.am;
}

// (a ~^ b) & c in one three-input logic operation (LUT 0x82), written
// out so that the match word takes two of them whatever order the
// compiler would pick.
__device__ __forceinline__ uint32_t xnor_and(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x82;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// The chunk's columns [j0, j0 + cols): the target's code planes hold
// column j0 + u at bit 31 - u.  kAmb: mask each match word with the
// column's ambiguity bit.  d is the score at row q_len plus `bias`
// (kBig while the window does not cover row q_len, so that no column
// beats best_d, else 0); the best target end is tracked on it.
template <bool kAmb>
__device__ __forceinline__ void columns(
    uint32_t (&pv)[kNb], uint32_t (&mv)[kNb], const uint32_t (&qh)[kNb],
    const uint32_t (&ql)[kNb], const uint32_t (&qv)[kNb], uint32_t th,
    uint32_t tl, uint32_t ta, int j0, int cols, int& d, int& best_d,
    int& best_j) {
#pragma unroll 2
  for (int jj = j0 + 1; jj <= j0 + cols; ++jj) {
    const uint32_t m1 = (uint32_t)((int32_t)th >> 31);
    const uint32_t m0 = (uint32_t)((int32_t)tl >> 31);
    const uint32_t tv = kAmb ? ~(uint32_t)((int32_t)ta >> 31) : 0u;
    th <<= 1;
    tl <<= 1;
    if (kAmb) ta <<= 1;
    // the block chain: the delta into a block is the top bits of the
    // block above's ph and mh (hin = +1 into the top block)
    uint32_t cp = 0u, cm = 0u;
#pragma unroll
    for (int b = 0; b < kNb; ++b) {
      uint32_t e = xnor_and(qh[b], m1, xnor_and(ql[b], m0, qv[b]));
      if (kAmb) e &= tv;
      const uint32_t p = pv[b], m = mv[b];
      const uint32_t xv = e | m;
      const uint32_t x = b == 0 ? e : e | (cm >> 31);
      const uint32_t xh = (((x & p) + p) ^ p) | x;
      const uint32_t ph = m | ~(xh | p);
      const uint32_t mh = p & xh;
      const uint32_t phs = b == 0 ? ph * 2u + 1u : __funnelshift_l(cp, ph, 1);
      const uint32_t mhs = b == 0 ? mh * 2u : __funnelshift_l(cm, mh, 1);
      pv[b] = mhs | ~(xv | phs);
      mv[b] = phs & xv;
      cp = ph;
      cm = mh;
    }
    d += (int)(cp >> 31) - (int)(cm >> 31);
    if (d < best_d) {
      best_d = d;
      best_j = jj;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
myers_align_kernel(Plane fw, Plane amb, const long long* __restrict__ cols,
                   const long long* __restrict__ order, int B,
                   int* __restrict__ dist, int* __restrict__ q_end,
                   int* __restrict__ t_end) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const long long req = order[lane];
  const long long* c = cols + 7LL * req;
  // int32 casts of the lengths and strands, as myers_batch_db_packed's
  const int q_len = (int)c[2], q_strand = (int)c[3];
  const int t_len = (int)c[5], t_strand = (int)c[6];
  // the plane position of the lowest base of a 32-base word: rows
  // [row0, row0 + 32) at q_lo + q_step * row0, columns likewise
  const long long q_lo = q_strand == 0 ? c[0] + kGuard
                                       : c[1] + q_len - 1 + kGuard - 31;
  const long long q_step = q_strand == 0 ? 1 : -1;
  const long long t_lo = t_strand == 0 ? c[4] + kGuard
                                       : c[4] + t_len - 1 + kGuard - 31;
  const long long t_step = t_strand == 0 ? 1 : -1;
  // a window moves by 32 bases, so its word shifts stay the same
  const int q_fs = (int)((2 * q_lo + 8 * fw.mis) & 31);
  const int q_as = (int)((q_lo + 8 * amb.mis) & 31);
  const int t_fs = (int)((2 * t_lo + 8 * fw.mis) & 31);
  const int t_as = (int)((t_lo + 8 * amb.mis) & 31);
  const bool q_rev = q_strand != 0, t_rev = t_strand == 0;
  const uint32_t q_comp = q_strand == 0 ? 0u : 0xFFFFFFFFu;
  const uint32_t t_comp = t_strand == 0 ? 0u : 0xFFFFFFFFu;

  uint32_t pv[kNb], mv[kNb], qh[kNb], ql[kNb], qv[kNb];
#pragma unroll
  for (int b = 0; b < kNb; ++b) {
    pv[b] = 0xFFFFFFFFu;
    mv[b] = 0;
    const Bases s = decode(load_raw(fw, amb, q_lo + q_step * (b * kWb)),
                           q_fs, q_as, q_rev, q_comp);
    query_word(s, b * kWb, q_len, qh[b], ql[b], qv[b]);
  }
  int w0 = 0;   // the window's first word: rows [w0 * 32, (w0 + kNb) * 32)
  // the score at row q_len (bot - (bottom - q_len)), plus kBig until the
  // window covers row q_len
  int bias = kNb * kWb >= q_len ? 0 : kBig;
  int d = q_len + bias;
  int best_d = kBig, best_j = 0;

  const int n_chunks = t_len > 0 ? (t_len + kWb - 1) / kWb : 0;
  Raw t_raw{}, q_raw{};
  if (n_chunks > 0) t_raw = load_raw(fw, amb, t_lo);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const Bases t = decode(t_raw, t_fs, t_as, t_rev, t_comp);
    // w0 = max(0, chunk - kNb / 2) rises by one word a chunk once it
    // moves: the slide shifts the planes by one word, fills pv with ones
    // and adds 32 to the bottom row and to bot, which leaves d as it is.
    // The window never runs past the JAX package's PEq (nbq words, :82),
    // so dynamic_slice never clamps there and no clamp is mirrored here.
    if (chunk > kNb / 2) {
#pragma unroll
      for (int b = 0; b + 1 < kNb; ++b) {
        pv[b] = pv[b + 1];
        mv[b] = mv[b + 1];
        qh[b] = qh[b + 1];
        ql[b] = ql[b + 1];
        qv[b] = qv[b + 1];
      }
      pv[kNb - 1] = 0xFFFFFFFFu;
      mv[kNb - 1] = 0;
      w0 = chunk - kNb / 2;
      const int row0 = (w0 + kNb - 1) * kWb;
      query_word(decode(q_raw, q_fs, q_as, q_rev, q_comp), row0, q_len,
                 qh[kNb - 1], ql[kNb - 1], qv[kNb - 1]);
    }
    // the next chunk's target bases and window word, a chunk ahead
    if (chunk + 1 < n_chunks) {
      t_raw = load_raw(fw, amb, t_lo + t_step * ((chunk + 1) * kWb));
      if (chunk + 1 > kNb / 2)
        q_raw = load_raw(fw, amb, q_lo + q_step * ((chunk + kNb / 2) * kWb));
    }
    if (bias != 0 && (w0 + kNb) * kWb >= q_len) {
      d -= bias;
      bias = 0;
    }
    const int j0 = chunk * kWb;
    const int cols_here = t_len - j0 < kWb ? t_len - j0 : kWb;
    // the chunk's columns at bits 31, 30, ... of the target's planes
    const uint32_t ta = t.am & (cols_here == kWb ? 0xFFFFFFFFu
                                : ~(0xFFFFFFFFu >> cols_here));
    if (ta == 0u)
      columns<false>(pv, mv, qh, ql, qv, t.hi, t.lo, 0u, j0, cols_here, d,
                     best_d, best_j);
    else
      columns<true>(pv, mv, qh, ql, qv, t.hi, t.lo, t.am, j0, cols_here, d,
                    best_d, best_j);
  }

  // query-end readout on the state after column t_len - 1: the score of
  // row bottom - r is bot less the deltas (pv bit - mv bit) of the r
  // window bits from the top; rows outside [0, q_len] do not count
  const int bottom = (w0 + kNb) * kWb;
  int best_qe_d = kBig, best_qe_row = bottom;
  int score = d - bias + bottom - q_len;   // bot
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

  const bool use_te = best_d <= best_qe_d;
  dist[req] = use_te ? best_d : best_qe_d;
  q_end[req] = use_te ? q_len : best_qe_row;
  t_end[req] = use_te ? best_j : t_len;
}

Plane plane(const void* p, long long n) {
  const uintptr_t a = (uintptr_t)p;
  return Plane{(const uint32_t*)(a & ~(uintptr_t)3), (const uint8_t*)p, n,
               (int)(a & 3)};
}

}  // namespace

extern "C" {

int pg_myers_align(const void* fw, const void* amb, long long fw_bytes,
                   long long amb_bytes, const void* cols, const void* order,
                   int B, int nb, void* dist, void* q_end, void* t_end,
                   void* stream) {
  if (nb != kNb || B < 0 || fw_bytes < 1 || amb_bytes < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  myers_align_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      plane(fw, fw_bytes), plane(amb, amb_bytes), (const long long*)cols,
      (const long long*)order, B, (int*)dist, (int*)q_end, (int*)t_end);
  return (int)cudaGetLastError();
}

}  // extern "C"
