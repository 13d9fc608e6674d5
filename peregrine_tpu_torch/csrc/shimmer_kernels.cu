// SHIMMER index kernels for Hopper (sm_90a): the CUDA C++ port of the four
// Pallas kernels in peregrine_tpu/ops/compact_pallas.py that the default
// index path runs.
//
//   pg_build_stream  <- build_stream  (compact_pallas.py:229, call :243)
//   pg_move_plane    <- move_plane    (compact_pallas.py:112, call :124)
//   pg_emit_mask     <- emit_mask     (compact_pallas.py:331, call :351)
//   pg_reduce_step   <- reduce_step   (compact_pallas.py:451, call :464)
//
// Planes are [B, L] row-major uint32 (the wrappers in ops/kernels.py hand
// over int32 tensors holding the same bits).  Every kernel except
// move_plane runs one thread block per row and walks the row in tiles of
// blockDim columns, carrying each running prefix (count, max) from tile to
// tile, so any L works.  Instead of the TPU kernels' shift distances r,
// the producers write a destination column (the rank among kept entries,
// -1 where dropped) and move_plane scatters by it.
//
// What bounds them: each kernel reads and writes about three to four
// B x L x 4-byte planes once, so device-memory bytes bound them; the
// windowed loops (k, w, r taps per column) re-read neighbours that a
// block fetched moments before, which the L1 cache serves.  These are the
// simple-first versions: 64 rows give 64 blocks on 132 SMs, and
// move_plane is a separate pass over memory (ROADMAP lists fusing it
// into its producers and filling the SMs as the first speed work).
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;           // threads per row block
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kInf = 0xFFFFFFFFu;   // undefined / hole hash

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Inclusive scan of one int per thread over the whole block; *total gets
// the block-wide result.  `scratch` holds kWarps ints of shared memory.
// Every thread of the block must call it.
template <typename Op>
__device__ int block_scan(int v, int identity, Op op, int* scratch,
                          int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int n = __shfl_up_sync(0xFFFFFFFFu, v, off);
    if (lane >= off) v = op(v, n);
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? scratch[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int n = __shfl_up_sync(0xFFFFFFFFu, s, off);
      if (lane >= off) s = op(s, n);
    }
    scratch[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v = op(scratch[warp - 1], v);
  *total = scratch[kWarps - 1];
  __syncthreads();  // scratch is reused by the next call
  return v;
}

// Block-wide unsigned minimum / signed maximum (every thread gets it).
__device__ uint32_t block_min_u32(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  uint32_t r = scratch[0];
  for (int i = 1; i < kWarps; ++i) r = min(r, scratch[i]);
  __syncthreads();
  return r;
}

__device__ int block_max_i32(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = scratch[0];
  for (int i = 1; i < kWarps; ++i) r = max(r, scratch[i]);
  __syncthreads();
  return r;
}

// Invertible minimizer hash (peregrine_tpu/ops/sketch.py:hash64) on 32-bit
// lanes: every step is taken modulo 2^32 and then masked to 2k bits.
__device__ __forceinline__ uint32_t hash32(uint32_t key, uint32_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// Stream-entry build.  Per column t of a read: the forward and reverse-
// complement k-mers ending at t from the codes c[t-k+1..t] & 3 (zeros
// before column 0), the canonical k-mer and its strand, its hash, and
// whether it is defined: valid, not strand-symmetric, and at least k such
// entries since the last ambiguous base.  Emits H (hash or kInf),
// P = t<<2 | strand<<1 | amb, the stream destination of entries that are
// valid-non-symmetric or ambiguous, and the stream count n.
__global__ void __launch_bounds__(kThreads)
build_stream_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ H, uint32_t* __restrict__ P,
                    int32_t* __restrict__ dest, int32_t* __restrict__ n_out,
                    int L, int k) {
  __shared__ int scratch[kWarps];
  const size_t base = (size_t)blockIdx.x * L;
  const uint8_t* c = codes + base;
  const int len = lengths[blockIdx.x];
  const uint32_t mask = k >= 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  int carry_cv = 0, carry_ci = 0, carry_amb = 0;
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool active = t < L;
    const bool inlen = active && t < len;
    const int ct = active ? c[t] : 4;
    const bool valid = inlen && ct < 4;
    const bool amb = inlen && ct >= 4;
    uint32_t fwd = 0, rev = 0;
    if (active) {
      for (int d = 0; d < k && d <= t; ++d) {
        const uint32_t b = c[t - d] & 3u;
        fwd |= b << (2 * d);
        rev |= (b ^ 3u) << (2 * (k - 1 - d));
      }
    }
    fwd &= mask;
    const bool sym = valid && fwd == rev;
    const uint32_t strand = fwd < rev ? 0u : 1u;
    const uint32_t h = hash32(min(fwd, rev), mask);
    const bool vns = valid && !sym;
    const bool inc = vns || amb;
    // one scan carries both counts: vns in the low 16 bits, inc in the
    // high 16 (a tile holds at most kThreads < 2^16 of each)
    int tot;
    const int s = block_scan((vns ? 1 : 0) | ((inc ? 1 : 0) << 16), 0, Sum(),
                             scratch, &tot);
    const int cv = carry_cv + (s & 0xFFFF);
    const int ci = carry_ci + (s >> 16);
    int tot_amb;
    const int at_amb = max(carry_amb,
                           block_scan(amb ? cv : 0, 0, Max(), scratch,
                                      &tot_amb));
    const bool defined = vns && (cv - at_amb) >= k;
    if (active) {
      H[base + t] = defined ? h : kInf;
      P[base + t] = ((uint32_t)t << 2) | (strand << 1) | (amb ? 1u : 0u);
      dest[base + t] = inc ? ci - 1 : -1;
    }
    carry_cv += tot & 0xFFFF;
    carry_ci += tot >> 16;
    carry_amb = max(carry_amb, tot_amb);
  }
  if (threadIdx.x == 0) n_out[blockIdx.x] = carry_ci;
}

// Stable compaction of one plane: out[row, dest[i]] = in[row, i] where
// dest >= 0.  Destinations within a row are distinct, so the scatter is
// race-free; columns at or past the row's count are left as they were.
__global__ void move_plane_kernel(const int32_t* __restrict__ dest,
                                  const uint32_t* __restrict__ in,
                                  uint32_t* __restrict__ out, int L,
                                  size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = dest[i];
  if (d >= 0) out[(i / L) * L + d] = in[i];
}

// Window-minimum emission over a compacted stream (sH, sP, n).  Pass 1:
// the distance to the last ambiguous placeholder, the trailing minimum of
// sH over w, and Ap = that minimum where the window is complete (else 0),
// written to the scratch plane.  Then the final window's minimum and its
// newest (largest) column.  Pass 2: the leading maximum of Ap over w; an
// entry is emitted where it equals its own hash, or where it is the held
// minimum of the final window.  Writes the emitted entries' destinations
// and their count.
__global__ void __launch_bounds__(kThreads)
emit_mask_kernel(const uint32_t* __restrict__ sH,
                 const uint32_t* __restrict__ sP,
                 const int32_t* __restrict__ n_in, uint32_t* Ap,
                 int32_t* __restrict__ dest, int32_t* __restrict__ count,
                 int L, int w, int k) {
  __shared__ int scratch[kWarps];
  const size_t base = (size_t)blockIdx.x * L;
  const uint32_t* h = sH + base;
  const uint32_t* p = sP + base;
  uint32_t* ap = Ap + base;
  const int n = n_in[blockIdx.x];

  int carry_la = -1;
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool in_n = t < n && t < L;
    const bool samb = in_n && (p[t] & 1u);
    int tot;
    const int la = max(carry_la,
                       block_scan(samb ? t : -1, -1, Max(), scratch, &tot));
    carry_la = max(carry_la, tot);
    if (t < L) {
      uint32_t W = kInf;
      for (int d = 0; d < w && d <= t; ++d) W = min(W, h[t - d]);
      const bool complete = in_n && (t - la) >= w + k - 1;
      ap[t] = complete ? W : 0u;
    }
  }
  __syncthreads();  // Ap of the whole row is visible to the block

  // final window: columns [max(0, n - w), n); w < kThreads
  const int lo = max(0, n - w);
  const int col = lo + (int)threadIdx.x;
  const bool in_final = col < n;
  const uint32_t v = in_final ? h[col] : kInf;
  const uint32_t fmin = block_min_u32(v, (uint32_t*)scratch);
  const int t_f = block_max_i32(in_final && v == fmin ? col : -1, scratch);
  const bool has_final = fmin != kInf && t_f >= 0;

  int carry = 0;
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    bool emit = false;
    if (t < n && t < L) {
      uint32_t M = 0;
      for (int d = 0; d < w && t + d < L; ++d) M = max(M, ap[t + d]);
      const uint32_t ht = h[t];
      emit = (ht != kInf && M == ht) || (has_final && t == t_f);
    }
    int tot;
    const int s = block_scan(emit ? 1 : 0, 0, Sum(), scratch, &tot);
    if (t < L) dest[base + t] = emit ? carry + s - 1 : -1;
    carry += tot;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = carry;
}

// The winner at column j of the r-wide trailing window: the least
// (hash, ring slot = column % r), ring slots being distinct in a window.
__device__ __forceinline__ void window_winner(const uint32_t* h,
                                              const uint32_t* p, int j, int r,
                                              uint32_t* bh, uint32_t* bp) {
  uint32_t best_h = h[j], best_s = (uint32_t)(j % r), best_p = p[j];
  for (int d = 1; d < r && d <= j; ++d) {
    const int i = j - d;
    const uint32_t hd = h[i], sd = (uint32_t)(i % r);
    if (hd < best_h || (hd == best_h && sd < best_s)) {
      best_h = hd;
      best_s = sd;
      best_p = p[i];
    }
  }
  *bh = best_h;
  *bp = best_p;
}

// One SHIMMER reduction level over (H, P, n): the window winner at each
// column, emitted where the column is valid (r-1 <= j < n) and the winner
// differs from the previous column's (or that column was not valid).
// Writes the winners' planes, the emitted destinations and the count.
__global__ void __launch_bounds__(kThreads)
reduce_step_kernel(const uint32_t* __restrict__ H,
                   const uint32_t* __restrict__ P,
                   const int32_t* __restrict__ n_in,
                   uint32_t* __restrict__ Ho, uint32_t* __restrict__ Po,
                   int32_t* __restrict__ dest, int32_t* __restrict__ count,
                   int L, int r) {
  __shared__ int scratch[kWarps];
  const size_t base = (size_t)blockIdx.x * L;
  const uint32_t* h = H + base;
  const uint32_t* p = P + base;
  const int n = n_in[blockIdx.x];
  int carry = 0;
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int j = t0 + threadIdx.x;
    bool emit = false;
    if (j < L) {
      uint32_t bh, bp;
      window_winner(h, p, j, r, &bh, &bp);
      Ho[base + j] = bh;
      Po[base + j] = bp;
      const bool valid = j >= r - 1 && j < n;
      if (valid) {
        const bool prev_valid = j >= r && j < n + 1;
        uint32_t ph = 0, pp = 0;
        if (j >= 1) window_winner(h, p, j - 1, r, &ph, &pp);
        emit = bp != pp || !prev_valid;
      }
    }
    int tot;
    const int s = block_scan(emit ? 1 : 0, 0, Sum(), scratch, &tot);
    if (j < L) dest[base + j] = emit ? carry + s - 1 : -1;
    carry += tot;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = carry;
}

}  // namespace

extern "C" {

int pg_build_stream(const void* codes, const void* lengths, void* H, void* P,
                    void* dest, void* n_out, int B, int L, int k,
                    void* stream) {
  build_stream_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (uint32_t*)H,
      (uint32_t*)P, (int32_t*)dest, (int32_t*)n_out, L, k);
  return (int)cudaGetLastError();
}

int pg_move_plane(const void* dest, const void* in, void* out, int B, int L,
                  void* stream) {
  const size_t total = (size_t)B * L;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  move_plane_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dest, (const uint32_t*)in, (uint32_t*)out, L, total);
  return (int)cudaGetLastError();
}

int pg_emit_mask(const void* sH, const void* sP, const void* n_in, void* Ap,
                 void* dest, void* count, int B, int L, int w, int k,
                 void* stream) {
  emit_mask_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sH, (const uint32_t*)sP, (const int32_t*)n_in,
      (uint32_t*)Ap, (int32_t*)dest, (int32_t*)count, L, w, k);
  return (int)cudaGetLastError();
}

int pg_reduce_step(const void* H, const void* P, const void* n_in, void* Ho,
                   void* Po, void* dest, void* count, int B, int L, int r,
                   void* stream) {
  reduce_step_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)H, (const uint32_t*)P, (const int32_t*)n_in,
      (uint32_t*)Ho, (uint32_t*)Po, (int32_t*)dest, (int32_t*)count, L, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
