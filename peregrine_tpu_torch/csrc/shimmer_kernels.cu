// SHIMMER index kernels for Hopper (sm_90a): the CUDA C++ port of the five
// Pallas kernels in peregrine_tpu/ops/compact_pallas.py.
//
//   pg_build_stream   <- build_stream   (compact_pallas.py:230, call :243)
//   pg_move_plane     <- move_plane     (compact_pallas.py:113, call :124)
//   pg_emit_mask      <- emit_mask      (compact_pallas.py:333, call :351)
//   pg_reduce_step    <- reduce_step    (compact_pallas.py:452, call :464)
//                        followed by its two move_plane calls
//   pg_compact_planes <- compact_planes (compact_pallas.py:365, call :391)
//
// and five replace XLA code of the JAX package: the wide (k > 16) route's
// pg_wide_stream (which also does the wide sketch's stream compaction, a
// compact_planes call of the JAX package), pg_wide_emit and pg_reduce_wide
// (see their notes), and stage 1's batch step around the kernels:
//
//   pg_gather_codes   <- peregrine_tpu/ops/dbgather.py:gather_codes (:233)
//   pg_drain_records  <- peregrine_tpu/ops/index.py:_compact_drain (:66)
//                        with ops/sketch.py:assemble_records folded in
//
// and three fuse a stage-1 kernel into its neighbour, the launch and the
// global round trip between them removed, on the k <= 16 main path:
//
//   pg_gather_build_stream <- gather_codes followed by build_stream (:243)
//   pg_reduce_drain        <- the final reduce_step (:464) followed by
//                             _compact_drain with assemble_records
//
// and on the k > 16 path:
//
//   pg_reduce_wide_drain   <- the final reduce_impl level
//                             (peregrine_tpu/ops/reduce.py:26) followed by
//                             _compact_drain
//
// The first four run the packed k <= 16 path on [B, L] row-major uint32
// planes (the wrappers in ops/kernels.py hand over int32 tensors holding
// the same bits); compact_planes serves the wide k > 16 sketch and the
// general reduction on int64 records.  Instead of the TPU kernels' shift
// distances r, build_stream and emit_mask write a destination column (the
// rank among kept entries, -1 where dropped) and move_plane scatters one
// or two planes by it in one launch; reduce_step writes its winners to
// their ranks itself.
//
// Two layouts.  build_stream, emit_mask, reduce_step and compact_planes
// split each row into chunks, one block per chunk, so that B x the chunks
// of a row fill the SMs; a block stages its chunk (and a halo where it
// needs one) in shared memory by cp.async and carries the row-wide
// prefixes it needs (counts, the last ambiguous base) from the chunks
// before it by a decoupled look-back over a zeroed status buffer (no
// fence: each published value is two self-marking 64-bit words).  Each
// launch also zeroes the status of the launch before it, so the wrappers
// alternate two buffers and never launch a memset.  move_plane is one
// thread per four columns.
//
// What bounds them: each kernel reads and writes a few bytes per column
// once, so device-memory bytes bound them (the source note above each
// kernel gives its bytes per column).
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kInf = 0xFFFFFFFFu;   // undefined / hole hash

// The chunked kernels: kChunk columns of one row per block of
// kChunkThreads threads (kPerThread consecutive columns per thread in
// build_stream).  CHUNK in ops/kernels.py must equal kChunk (a CPU test
// reads both).
constexpr int kChunk = 4096;
constexpr int kChunkThreads = 512;
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kPerThread = kChunk / kChunkThreads;
constexpr int kMaxW = 255;               // emit_mask's window, 1..255
constexpr int kMaxK = 16;                // the packed path's k, 1..16
// emit_mask stages the columns [c0 - (w + k - 2), c0 + kChunk + w - 1) of
// a chunk at c0, plus up to 3 words of 16-byte alignment slack.
constexpr int kExt = (kChunk + (kMaxW + kMaxK - 2) + (kMaxW - 1) + 3 + 31) /
                     32 * 32;
// Padding on either side of emit_mask's staged columns: the identity of
// the sliding minimum (kInf) before them and of the maximum (0) after,
// as far as a window reaches, so the doubling passes need no bounds test.
constexpr int kPad = 256;
constexpr int kExtPer = (kExt + kChunkThreads - 1) / kChunkThreads;
// Look-back status: slots of kSlot int32 words.  Slot 0 holds the ticket
// counter; tile t (chunk j of row b, t = b * chunks + j) owns slot t + 1,
// four 64-bit words: the aggregate (x, y) and the inclusive prefix (x, y),
// each word with bit 0 set once written (see to_words).  STATUS_SLOT in
// ops/kernels.py must equal kSlot.
constexpr int kSlot = 8;

// reduce_step: kRChunk columns of one row per block of kRThreads threads,
// column x of the chunk in thread x % kRThreads, register x / kRThreads.
// REDUCE_CHUNK in ops/kernels.py must equal kRChunk.  A block stages the
// columns [c0 - r, c0 + kRChunk) of a chunk at c0 (the window of column
// c0 - 1 too), plus up to 3 words of 16-byte alignment slack.  The draft
// reduces rows of 2,048 and 3,072 columns (the sketch cap of its two read
// buckets): each fits one chunk.  On the H100 fewer columns a thread ran
// faster, even where the further register slots held no column below n,
// and 512 threads faster than 1,024.
constexpr int kRChunk = 3072;
constexpr int kRThreads = kChunkThreads;  // as stage_async strides
constexpr int kRWarps = kRThreads / 32;
constexpr int kRPer = kRChunk / kRThreads;
constexpr int kRSegs = kRPer * kRWarps;   // 32-column segments of a chunk
constexpr int kMaxR = 255;                // reduce_step's window, 2..255
constexpr int kRExt = (kRChunk + kMaxR + 3 + 3) / 4 * 4;
constexpr int kREarly = 512;  // columns staged before n is known
// compact_planes: kCChunk columns of one row per block of kCThreads
// threads, column x of the chunk in thread x % kCThreads, register
// x / kCThreads.  COMPACT_CHUNK in ops/kernels.py must equal kCChunk.
constexpr int kCChunk = 4096;
constexpr int kCThreads = kChunkThreads;  // as stage_async strides
constexpr int kCWarps = kCThreads / 32;
constexpr int kCPer = kCChunk / kCThreads;
constexpr int kCSegs = kCPer * kCWarps;   // 32-column segments of a chunk
constexpr int kCBlocksPerSM = 2;          // at most 64 registers a thread
// move_plane: four consecutive columns per thread.
constexpr int kMoveThreads = 256;

static_assert(kRChunk % kRThreads == 0 && kRSegs <= 32 * 32, "segments");
static_assert(kCChunk % kCThreads == 0 && kCSegs <= 32 * 32, "segments");
static_assert(kMaxR < kRChunk, "a window reaches into one chunk before");
static_assert(kREarly <= kRChunk, "early columns lie in the chunk");
static_assert(kChunk % kChunkThreads == 0, "whole columns per thread");
static_assert(kChunk % 32 == 0, "transpose padding assumes whole warps");
static_assert(2 * kPerThread <= 32 && kExtPer <= 32, "per-thread bit masks");
static_assert(kPad >= kMaxW && kPad % 4 == 0, "pads cover a window");
static_assert(kMaxW < kChunkThreads, "one final-window column per thread");

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Sum64 {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// build_stream's row prefix: valid non-symmetric entries, included
// entries, and the count of valid non-symmetric entries at the last
// ambiguous base (-1: none).  StreamOp(a, b) is a followed by b.
struct Stream {
  int vns, inc, amb;
};
struct StreamOp {
  __device__ Stream operator()(const Stream& a, const Stream& b) const {
    return {a.vns + b.vns, a.inc + b.inc, b.amb >= 0 ? a.vns + b.amb : a.amb};
  }
};

__device__ __forceinline__ int shfl_up(int v, int off) {
  return __shfl_up_sync(0xFFFFFFFFu, v, off);
}
__device__ __forceinline__ Stream shfl_up(const Stream& s, int off) {
  return {shfl_up(s.vns, off), shfl_up(s.inc, off), shfl_up(s.amb, off)};
}

__device__ __forceinline__ int shfl_from(int v, int lane) {
  return __shfl_sync(0xFFFFFFFFu, v, lane);
}
__device__ __forceinline__ long long shfl_from(long long v, int lane) {
  return __shfl_sync(0xFFFFFFFFu, v, lane);
}
__device__ __forceinline__ Stream shfl_from(const Stream& s, int lane) {
  return {shfl_from(s.vns, lane), shfl_from(s.inc, lane),
          shfl_from(s.amb, lane)};
}
__device__ __forceinline__ int shfl_down(int v, int off) {
  return __shfl_down_sync(0xFFFFFFFFu, v, off);
}
__device__ __forceinline__ long long shfl_down(long long v, int off) {
  return __shfl_down_sync(0xFFFFFFFFu, v, off);
}
__device__ __forceinline__ Stream shfl_down(const Stream& s, int off) {
  return {shfl_down(s.vns, off), shfl_down(s.inc, off),
          shfl_down(s.amb, off)};
}

// Exclusive scan of one value per thread over a block of kW warps, for an
// associative op(earlier, later) with identity `id`; *total gets the
// block's aggregate.  `scratch` holds kW values of shared memory.  Every
// thread of the block must call it.
template <int kW, typename T, typename Op>
__device__ T block_scan(T v, T id, Op op, T* scratch, T* total) {
  static_assert(kW <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T n = shfl_up(inc, off);
    if (lane >= off) inc = op(n, inc);
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kW ? scratch[lane] : id;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T n = shfl_up(s, off);
      if (lane >= off) s = op(n, s);
    }
    if (lane < kW) scratch[lane] = s;
  }
  __syncthreads();
  T ex = shfl_up(inc, 1);
  if (lane == 0) ex = id;
  if (warp > 0) ex = op(scratch[warp - 1], ex);
  *total = scratch[kW - 1];
  __syncthreads();  // scratch is reused by the next call
  return ex;
}

// Minimum of a 64-bit key over a block of kChunkThreads threads (every
// thread gets it).
__device__ unsigned long long block_min_u64(unsigned long long v,
                                            unsigned long long* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long r = scratch[0];
  for (int i = 1; i < kChunkWarps; ++i) r = min(r, scratch[i]);
  __syncthreads();
  return r;
}

// --- the decoupled look-back ----------------------------------------------

// A published value as two 64-bit words, each written once and carrying
// bit 0 = written, so a reader that sees both words written has one whole
// publication without any fence: x = vns << 1 | inc << 32 and
// y = (amb + 1) << 1 for a Stream, x = count << 1 for a count (int, or a
// non-negative long long).
__device__ __forceinline__ void to_words(int v, unsigned long long* x,
                                         unsigned long long* y) {
  *x = 1ull | (unsigned long long)(unsigned)v << 1;
  *y = 1ull;
}
__device__ __forceinline__ void to_words(long long v, unsigned long long* x,
                                         unsigned long long* y) {
  *x = 1ull | (unsigned long long)v << 1;
  *y = 1ull;
}
__device__ __forceinline__ void to_words(const Stream& v,
                                         unsigned long long* x,
                                         unsigned long long* y) {
  *x = 1ull | (unsigned long long)(unsigned)v.vns << 1 |
       (unsigned long long)(unsigned)v.inc << 32;
  *y = 1ull | (unsigned long long)(unsigned)(v.amb + 1) << 1;
}
__device__ __forceinline__ void from_words(unsigned long long x,
                                           unsigned long long, int* v) {
  *v = (int)(unsigned)(x >> 1);
}
__device__ __forceinline__ void from_words(unsigned long long x,
                                           unsigned long long, long long* v) {
  *v = (long long)(x >> 1);
}
__device__ __forceinline__ void from_words(unsigned long long x,
                                           unsigned long long y, Stream* v) {
  *v = {(int)((x >> 1) & 0x7FFFFFFFu), (int)(unsigned)(x >> 32),
        (int)(unsigned)(y >> 1) - 1};
}

// The two words of a publication, stored and loaded as one 16-byte
// access (each 8-byte half is read whole, which is all a reader needs).
__device__ __forceinline__ void store_pair(volatile ulonglong2* w,
                                           unsigned long long x,
                                           unsigned long long y) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};\n" ::"l"(w),
               "l"(x), "l"(y)
               : "memory");
}
__device__ __forceinline__ ulonglong2 load_pair(const volatile ulonglong2* w) {
  ulonglong2 r;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(r.x), "=l"(r.y)
               : "l"(w)
               : "memory");
  return r;
}

// A 64-bit load that later memory operations of the thread cannot pass,
// and a 64-bit store that earlier ones cannot follow (device scope).
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void publish_words(volatile ulonglong2* w,
                                              const T& v) {
  unsigned long long x, y;
  to_words(v, &x, &y);
  store_pair(w, x, y);
}

// The block's tile, in the order blocks start: a block only ever waits on
// tiles of lower numbers, which have started, so the look-back cannot
// deadlock whatever order the hardware schedules blocks in.
__device__ __forceinline__ int take_ticket(int* status, int* shared) {
  if (threadIdx.x == 0) *shared = atomicAdd(status, 1);
  __syncthreads();
  return *shared;
}

// Single-pass prefix across the chunks of a row, called by the 32 threads
// of warp 0 of the block holding tile `tile` (chunk j of its row) with the
// chunk's aggregate: publish the aggregate; read the slots of up to 32
// predecessors at once, one per lane, and combine their values back to the
// nearest one that has published its inclusive prefix (window after window
// of 32 if none has); publish this chunk's inclusive prefix; return the
// exclusive one to every lane.  With publish false it only reads: the
// prefix of a tile whose slot another tile publishes.
template <typename T, typename Op>
__device__ T look_back(int* status, int tile, int j, const T& agg,
                       const T& id, Op op, bool publish = true) {
  constexpr int kPairs = kSlot / 4;  // (aggregate, inclusive prefix)
  const int lane = threadIdx.x & 31;
  auto slot = [status](int t) {
    return (volatile ulonglong2*)status + kPairs * (t + 1);
  };
  if (publish && j > 0 && lane == 0) publish_words(slot(tile), agg);
  T excl = id;
  for (int p0 = tile - 1; p0 >= tile - j; p0 -= 32) {
    const int p = p0 - lane;
    const bool in_row = p >= tile - j;
    bool inclusive_here = false;
    T v = id;
    if (in_row) {
      const volatile ulonglong2* s = slot(p);
      for (;;) {
        const ulonglong2 a = load_pair(s), i = load_pair(s + 1);
        if (i.x & i.y & 1u) {
          inclusive_here = true;
          from_words(i.x, i.y, &v);
          break;
        }
        if (a.x & a.y & 1u) {
          from_words(a.x, a.y, &v);
          break;
        }
      }
    }
    __syncwarp();
    const unsigned inclusive = __ballot_sync(0xFFFFFFFFu, inclusive_here);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    if (lane > stop) v = id;
    // combine lanes stop .. 0, the earliest first: a scan towards lane 0
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T n = shfl_down(v, off);
      if (lane + off < 32) v = op(n, v);
    }
    excl = op(shfl_from(v, 0), excl);
    if (inclusive) break;
  }
  if (publish && lane == 0) publish_words(slot(tile) + 1, op(excl, agg));
  return excl;
}

// Zero the first `words` int32 words (a multiple of kSlot) of `stale`,
// the status of the launch before this one on the stream, which has
// ended, so that the launch after this one can take it: the grid's
// threads share the stores and nothing waits on them.  `stale` must not
// be this launch's status.
__device__ __forceinline__ void clear_stale(int* stale, int words) {
  int4* s = reinterpret_cast<int4*>(stale);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < words / 4;
       i += gridDim.x * blockDim.x)
    s[i] = make_int4(0, 0, 0, 0);
}

// --- staging and storing a chunk ------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait for all but the most recent committed group.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying nbytes from global src to shared dst (16-byte aligned) so
// that src[i] lands at dst[off + i], off = the address of src mod 16:
// every whole aligned 16-byte group by cp.async, the bytes of a partial
// first or last group by plain copies (all loads issued before any
// store, so they overlap).  Returns off.  The caller, a block of
// kChunkThreads threads, waits with cp_async_wait_all() and a barrier.
template <int kThreads = kChunkThreads>
__device__ int stage_async(uint8_t* dst, const uint8_t* src, int nbytes) {
  const uintptr_t a = (uintptr_t)src;
  const int off = (int)(a & 15);
  const uintptr_t a0 = a - off;
  const int groups = (off + nbytes + 15) >> 4;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const int lo = 16 * g - off;  // the group's first byte, relative to src
    if (lo >= 0 && lo + 16 <= nbytes) {
      cp_async16(dst + 16 * g, (const void*)(a0 + 16 * g));
    } else {
      uint8_t b[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        b[i] = lo + i >= 0 && lo + i < nbytes ? src[lo + i] : 0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (lo + i >= 0 && lo + i < nbytes) dst[16 * g + i] = b[i];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return off;
}

// Stage bytes [from, to) of src to where the stage_async(dst, src, .)
// that returned off put them (src[i] at dst[off + i]).
__device__ void stage_rest(uint8_t* dst, int off, const uint8_t* src,
                           int from, int to) {
  stage_async(dst + ((off + from) & ~15), src + from, to - from);
}

// Write the chunk's columns [0, ncols) of two planes, thread i holding
// columns i * kPerThread ...: through shared memory (tb, two planes of
// kTransposed words, padded so neither side has bank conflicts) so that
// each warp stores 32 consecutive words.
constexpr int kTransposed = kChunk + kChunk / 32;
__device__ __forceinline__ void store_chunk(uint32_t* out0,
                                            const uint32_t (&v0)[kPerThread],
                                            uint32_t* out1,
                                            const uint32_t (&v1)[kPerThread],
                                            int ncols, uint32_t* tb) {
  __syncthreads();  // tb is free
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int x = threadIdx.x * kPerThread + q;
    if (x < ncols) {
      tb[x + (x >> 5)] = v0[q];
      tb[kTransposed + x + (x >> 5)] = v1[q];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < ncols; x += kChunkThreads) {
    out0[x] = tb[x + (x >> 5)];
    out1[x] = tb[kTransposed + x + (x >> 5)];
  }
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

// Stream-entry build (replaces build_stream, compact_pallas.py:230).  Per
// column t of a read: the forward and reverse-complement k-mers ending at
// t from the codes c[t-k+1..t] & 3 (zeros before column 0), the canonical
// k-mer and its strand, its hash, and whether it is defined: valid, not
// strand-symmetric, and at least k such entries since the last ambiguous
// base.  Emits H (hash or kInf), P = t<<2 | strand<<1 | amb, the stream
// destination of entries that are valid-non-symmetric or ambiguous, and
// the stream count n.
//
// Bound: 13 bytes per column (codes in, H, P, dest out), 4.07 us at
// B=64, L=16,384 on 3.35 TB/s.  Design: one block per chunk of a row
// (B x ceil(L / kChunk) blocks); the chunk's codes and a k-1 halo are
// staged in shared memory by cp.async; each thread rolls the k-mers over
// its kPerThread consecutive columns (k + kPerThread - 1 shared reads
// instead of k per column); one block scan and one decoupled look-back
// carry the three row prefixes (Stream) across chunks, since `defined`
// reaches back to the last ambiguous base however far away; the outputs
// leave through a shared transpose as coalesced stores, P (which needs no
// prefix) while warp 0 waits on the look-back, H and dest after it; the
// hashes, which the chunk's aggregate does not need, are computed in that
// wait too.  Three blocks fit an SM (at most 42 registers a thread), so
// the 384 blocks of a B=64, L=24,576 batch run in one wave on 132 SMs.
// build_stream on one chunk whose codes are staged in shared memory:
// c[t - g0] is column t's code for g0 <= t < c0 + ncols (g0 = the first
// column of the k - 1 halo), len the row's length.  Shared by
// build_stream_kernel, which stages a codes plane, and
// gather_build_stream_kernel, which unpacks the packed seqdb; tb, scratch
// and carried are the caller's shared memory.
__device__ __forceinline__ void build_stream_chunk(
    const uint8_t* c, int g0, int tile, int j, int c0, int ncols,
    size_t base, int len, int* __restrict__ status, uint32_t* __restrict__ H,
    uint32_t* __restrict__ P, int32_t* __restrict__ dest,
    int32_t* __restrict__ n_out, int row, int k, int chunks, uint32_t* tb,
    Stream* scratch, Stream* carried) {
  const uint32_t mask = k >= 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  const int t0 = c0 + threadIdx.x * kPerThread;
  uint32_t fwd = 0, rev = 0;
  if (t0 < c0 + ncols) {
#pragma unroll
    for (int d = 1; d < kMaxK; ++d) {
      if (d < k && d <= t0) {
        const uint32_t b = c[t0 - d - g0] & 3u;
        fwd |= b << (2 * d);
        rev |= (b ^ 3u) << (2 * (k - 1 - d));
      }
    }
    fwd >>= 2;  // the loop below shifts column t0 in
    rev <<= 2;
  }
  uint32_t hv[kPerThread];  // the canonical k-mer, then its hash
  uint32_t bits = 0;        // per column q, bits 2q, 2q + 1: vns, amb
  Stream loc = {0, 0, -1};
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int t = t0 + q;
    hv[q] = kInf;
    if (t < c0 + ncols) {
      const uint32_t ct = c[t - g0];
      const uint32_t b = ct & 3u;
      fwd = ((fwd << 2) | b) & mask;
      rev = (rev >> 2) | ((b ^ 3u) << (2 * (k - 1)));
      const bool inlen = t < len;
      const bool valid = inlen && ct < 4;
      const bool amb = inlen && ct >= 4;
      const bool sym = valid && fwd == rev;
      const uint32_t strand = fwd < rev ? 0u : 1u;
      hv[q] = min(fwd, rev);
      const bool vns = valid && !sym;
      if (amb) loc.amb = loc.vns;
      loc.vns += vns;
      loc.inc += vns || amb;
      bits |= ((vns ? 1u : 0u) | (amb ? 2u : 0u)) << (2 * q);
      // P needs no row prefix: into the transpose buffer's second plane
      const int x = t - c0;
      tb[kTransposed + x + (x >> 5)] =
          ((uint32_t)t << 2) | (strand << 1) | (amb ? 1u : 0u);
    }
  }

  const Stream id = {0, 0, -1};
  Stream agg;
  const Stream ex =
      block_scan<kChunkWarps>(loc, id, StreamOp(), scratch, &agg);
  // warp 0 carries the row prefix while the other warps store P (the scan's
  // barriers ordered its transpose writes before these reads) and hash
  if (threadIdx.x < 32) {
    const Stream cr = look_back(status, tile, j, agg, id, StreamOp());
    if (threadIdx.x == 0) *carried = cr;
  } else {
    for (int x = threadIdx.x - 32; x < ncols; x += kChunkThreads - 32)
      P[base + c0 + x] = tb[kTransposed + x + (x >> 5)];
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) hv[q] = hash32(hv[q], mask);
  __syncthreads();
  const Stream pre = StreamOp()(*carried, ex);

  uint32_t hp[kPerThread], dp[kPerThread];
  int cv = pre.vns, ci = pre.inc, at_amb = max(pre.amb, 0);
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const uint32_t f = bits >> (2 * q);
    const bool vns = f & 1u, amb = f & 2u;
    cv += vns;
    ci += vns || amb;
    if (amb) at_amb = cv;
    const bool defined = vns && (cv - at_amb) >= k;
    hp[q] = defined ? hv[q] : kInf;
    dp[q] = (vns || amb) ? (uint32_t)(ci - 1) : kInf;
  }
  store_chunk(H + base + c0, hp, (uint32_t*)dest + base + c0, dp, ncols, tb);
  if (threadIdx.x == 0 && j == chunks - 1) n_out[row] = carried->inc + agg.inc;
}

__global__ void __launch_bounds__(kChunkThreads, 3)
build_stream_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lengths,
                    int* __restrict__ status, int* __restrict__ stale,
                    int stale_words, uint32_t* __restrict__ H,
                    uint32_t* __restrict__ P, int32_t* __restrict__ dest,
                    int32_t* __restrict__ n_out, int L, int k, int chunks) {
  __shared__ __align__(16) uint8_t cs[kChunk + 32];
  __shared__ uint32_t tb[2 * kTransposed];
  __shared__ Stream scratch[kChunkWarps];
  __shared__ int ticket;
  __shared__ Stream carried;

  const int tile = take_ticket(status, &ticket);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kChunk, ncols = min(kChunk, L - c0);
  const size_t base = (size_t)row * L;
  const int len = lengths[row];
  const int g0 = max(0, c0 - (k - 1));
  const int off = stage_async(cs, codes + base + g0, c0 + ncols - g0);
  cp_async_wait_all();
  __syncthreads();
  build_stream_chunk(cs + off, g0, tile, j, c0, ncols, base, len, status, H,
                     P, dest, n_out, row, k, chunks, tb, scratch, &carried);
}

// Stable compaction of one or two planes by one destination plane
// (replaces move_plane, compact_pallas.py:113, called once per plane):
// out_p[row, dest[i]] = in_p[row, i] where dest >= 0, for in1/out1 too
// unless they are null.  Destinations within a row are distinct, so the
// scatter is race-free; columns at or past the row's count are left as
// they were.
//
// Bound: 4 bytes per column (dest) and 16 per kept entry (two planes in
// and out): 5.0 us for the stream move at B=64, L=16,384 with rows of
// L/2..L on 3.35 TB/s.  Design: dest is read once for both planes (the
// TPU kernel, and the port before, moved each plane in its own launch);
// each thread takes four consecutive columns with one 16-byte load of
// dest where kVec (L % 4 == 0 and 16-byte aligned planes), so a quad
// never crosses a row, and loads a plane's quad, again 16 bytes, only
// where one of its columns is kept (a sector holds 32 bytes, so the
// dropped columns of such a quad cost no extra device-memory traffic);
// one quad per thread gives B x L / 1024 blocks (1,024 at the stream
// shape, 7.8 per SM).
template <bool kVec>
__global__ void __launch_bounds__(kMoveThreads)
move_plane_kernel(const int32_t* __restrict__ dest,
                  const uint32_t* __restrict__ in0,
                  const uint32_t* __restrict__ in1,
                  uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                  int L, size_t total) {
  const size_t i0 = 4 * ((size_t)blockIdx.x * kMoveThreads + threadIdx.x);
  if (i0 >= total) return;
  if (kVec) {
    const int4 d4 = *reinterpret_cast<const int4*>(dest + i0);
    if ((d4.x & d4.y & d4.z & d4.w) < 0) return;  // all four dropped
    const int d[4] = {d4.x, d4.y, d4.z, d4.w};
    const size_t row = i0 - i0 % L;  // the row's column 0
    const uint4 a = *reinterpret_cast<const uint4*>(in0 + i0);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (d[q] >= 0) out0[row + d[q]] = av[q];
    if (in1) {
      const uint4 b = *reinterpret_cast<const uint4*>(in1 + i0);
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d[q] >= 0) out1[row + d[q]] = bv[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t i = i0 + q;
      const int d = i < total ? dest[i] : -1;
      if (d >= 0) {
        const size_t o = i - i % L + d;
        out0[o] = in0[i];
        if (in1) out1[o] = in1[i];
      }
    }
  }
}

// One doubling step of a sliding extremum held in registers: v[q], the
// value at staged column i = threadIdx.x + q * kChunkThreads (i < E),
// takes in src[i + d] (src is padded with the identity on the side that
// d reaches).  The barrier after the reads lets the caller overwrite src.
template <bool kIsMax, typename T, int kN>
__device__ __forceinline__ void combine(T (&v)[kN], const T* src, int E,
                                        int d) {
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const int i = threadIdx.x + q * kChunkThreads;
    if (i < E) v[q] = kIsMax ? max(v[q], src[i + d]) : min(v[q], src[i + d]);
  }
  __syncthreads();
}

// Write the registers' values to their staged columns of dst, then a
// barrier.
template <typename T, int kN>
__device__ __forceinline__ void publish(T* dst, const T (&v)[kN], int E) {
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const int i = threadIdx.x + q * kChunkThreads;
    if (i < E) dst[i] = v[q];
  }
  __syncthreads();
}

// emit_mask's segments: for column-layout register q, warp w holds the 32
// staged columns from q * kChunkThreads + 32 w, and the segments in order
// q * kChunkWarps + w run in column order.
constexpr int kSegs = kExtPer * kChunkWarps;

// Exclusive prefix, in place, of one value per segment (kN of them, an
// int or a Stream) under op (identity id); called by warp 0, which gets
// the total.
template <int kN = kSegs, typename T, typename Op>
__device__ T segment_scan(T* seg, T id, Op op) {
  constexpr int kEach = (kN + 31) / 32;
  const int lane = threadIdx.x & 31;
  T own[kEach], acc = id;
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int x = lane * kEach + e;
    own[e] = x < kN ? seg[x] : id;
    acc = op(acc, own[e]);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T n = shfl_up(acc, off);
    if (lane >= off) acc = op(n, acc);
  }
  const T total = shfl_from(acc, 31);
  T before = shfl_up(acc, 1);
  if (lane == 0) before = id;
#pragma unroll
  for (int e = 0; e < kEach; ++e) {
    const int x = lane * kEach + e;
    if (x < kN) seg[x] = before;
    before = op(before, own[e]);
  }
  return total;
}

// Window-minimum emission over a compacted stream (sH, sP, n) (replaces
// emit_mask, compact_pallas.py:333).  W = the trailing minimum of sH over
// w; Ap = W where the window is complete, else 0; M = the leading maximum
// of Ap over w.  An entry t < n is emitted where M equals its own hash
// (not kInf), or where it is the newest minimum of the final window
// [max(0, n - w), n).  `complete` is a window test: the TPU kernel's
// t - (last ambiguous placeholder at or before t) >= w + k - 1 holds
// exactly when t >= w + k - 2 and no placeholder lies in
// [t - (w + k - 2), t].  Writes the emitted entries' destinations (-1
// elsewhere, and at or past n) and their count.
//
// Bound: 12 bytes per column (sH, sP in for the columns below n, dest out
// for all), 3.76 us at B=64, L=16,384 with full rows on 3.35 TB/s.
// Design: one block per chunk of a row; the chunk's sH and sP with a halo
// of w + k - 2 columns before and w - 1 after, clipped to [0, n), are
// staged in shared memory by cp.async, sP first so that `complete` (warp
// ballots of the placeholder bits and one warp's prefix over the 32-column
// segments) runs while sH arrives; the trailing minimum and the leading
// maximum are log-step sparse tables, each column's value in a register
// and its neighbour read from shared memory (about 2 log2(w) steps of one
// shared load each, where a column used to read 2w taps from device memory
// and round-trip Ap through a scratch plane); the final window lies inside
// the staged columns of the chunks it meets; the emitted entries' ranks
// come from ballots, one warp's prefix over the segments and a decoupled
// look-back, and each warp stores its 32 columns of dest at once.
__global__ void __launch_bounds__(kChunkThreads)
emit_mask_kernel(const uint32_t* __restrict__ sH,
                 const uint32_t* __restrict__ sP,
                 const int32_t* __restrict__ n_in, int* __restrict__ status,
                 int* __restrict__ stale, int stale_words,
                 int32_t* __restrict__ dest, int32_t* __restrict__ count,
                 int L, int w, int k, int chunks) {
  __shared__ __align__(16) uint32_t Hs[kPad + kExt];
  __shared__ __align__(16) uint32_t As[kPad + kExt + kPad];
  __shared__ int seg[kSegs];
  __shared__ unsigned long long red[kChunkWarps];
  __shared__ int shared_int;

  const int tile = take_ticket(status, &shared_int);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kChunk, ncols = min(kChunk, L - c0);
  const size_t base = (size_t)row * L;
  const int n = max(0, min(n_in[row], L));  // a count: never past the row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = max(0, c0 - (w + k - 2));
  uint32_t em[kExtPer];  // ballots of the emitted columns
  int agg = 0;           // the chunk's emitted entries, in warp 0

  if (c0 < n) {  // block-uniform; chunks at or past n emit nothing
    const int E = min(n, c0 + kChunk + w - 1) - g0;
    // sP first: `complete` needs only its placeholder bits, and runs while
    // sH is still arriving
    const int offP = stage_async((uint8_t*)(As + kPad),
                                 (const uint8_t*)(sP + base + g0), 4 * E);
    const int offH = stage_async((uint8_t*)(Hs + kPad),
                                 (const uint8_t*)(sH + base + g0), 4 * E);
    uint32_t* hs = Hs + kPad + offH / 4;  // hs[i], as[i]: column g0 + i
    uint32_t* as = As + kPad + offP / 4;
    for (int i = threadIdx.x; i < kPad + offH / 4; i += kChunkThreads)
      Hs[i] = kInf;
    for (int i = threadIdx.x; i < kPad + offP / 4; i += kChunkThreads)
      As[i] = kInf;
    for (int i = threadIdx.x; i < kPad; i += kChunkThreads) as[E + i] = 0;
    cp_async_wait_one();
    __syncthreads();

    // complete: the last placeholder at or before each column, from a
    // ballot over each warp's 32 columns and a prefix (last) over these
    // segments in column order
    uint32_t amb[kExtPer];
#pragma unroll
    for (int q = 0; q < kExtPer; ++q) {
      const int i = threadIdx.x + q * kChunkThreads;
      amb[q] = __ballot_sync(0xFFFFFFFFu, i < E && (as[i] & 1u));
      if (lane == 0)
        seg[q * kChunkWarps + warp] =
            amb[q] ? i + 31 - __clz(amb[q]) : -1;  // i: the segment's start
    }
    __syncthreads();
    if (warp == 0) segment_scan(seg, -1, Max());
    cp_async_wait_all();
    __syncthreads();
    uint32_t v[kExtPer];
    uint32_t cmask = 0;  // bit q: that column's window is complete
#pragma unroll
    for (int q = 0; q < kExtPer; ++q) {
      const int i = threadIdx.x + q * kChunkThreads;
      if (i < E) {
        v[q] = hs[i];
        const uint32_t upto = amb[q] & (0xFFFFFFFFu >> (31 - lane));
        const int la = upto ? i - lane + 31 - __clz(upto)
                            : seg[q * kChunkWarps + warp];
        const int t_amb = la >= 0 ? g0 + la : -1;
        if (g0 + i - t_amb >= w + k - 1) cmask |= 1u << q;
      }
    }

    // W, the trailing minimum over w: doublings cover jj columns, and a
    // last step overlaps two of them to cover w
    int jj = 1;
    for (; 2 * jj <= w; jj *= 2) {
      if (jj > 1) publish(as, v, E);
      combine<false>(v, jj > 1 ? as : hs, E, -jj);
    }
    if (w > jj) {
      publish(as, v, E);
      combine<false>(v, as, E, jj - w);
    }
    // Ap = W where complete, else 0; M, the leading maximum of Ap over w
#pragma unroll
    for (int q = 0; q < kExtPer; ++q)
      if (!(cmask >> q & 1u)) v[q] = 0;
    publish(as, v, E);
    for (jj = 1; 2 * jj <= w; jj *= 2) {
      if (jj > 1) publish(as, v, E);
      combine<true>(v, as, E, jj);
    }
    if (w > jj) {
      if (jj > 1) publish(as, v, E);
      combine<true>(v, as, E, w - jj);
    }

    // the final window's minimum and its newest column, in the chunks it
    // meets: the least key (hash, ~column)
    bool has_final = false;
    int t_f = -1;
    const int lo_f = max(0, n - w);
    if (c0 + kChunk > lo_f) {  // block-uniform
      const int t = lo_f + (int)threadIdx.x;
      const unsigned long long key =
          t < n ? ((unsigned long long)hs[t - g0] << 32) | (kInf - (uint32_t)t)
                : ~0ull;
      const unsigned long long m = block_min_u64(key, red);
      has_final = (uint32_t)(m >> 32) != kInf;
      t_f = (int)(kInf - (uint32_t)m);
    }

    // emitted columns of the chunk, by ballots in the column layout; their
    // ranks are a prefix over the segments' counts plus a popcount
#pragma unroll
    for (int q = 0; q < kExtPer; ++q) {
      const int i = threadIdx.x + q * kChunkThreads;
      const int t = g0 + i;
      bool e = false;
      if (i < E && t >= c0 && t < c0 + ncols) {
        const uint32_t h = hs[i];
        e = (h != kInf && v[q] == h) || (has_final && t == t_f);
      }
      em[q] = __ballot_sync(0xFFFFFFFFu, e);
      if (lane == 0) seg[q * kChunkWarps + warp] = __popc(em[q]);
    }
    __syncthreads();
    if (warp == 0) agg = segment_scan(seg, 0, Sum());
    __syncthreads();
  }

  if (threadIdx.x < 32) {
    const int c = look_back(status, tile, j, agg, 0, Sum());
    if (threadIdx.x == 0) shared_int = c;
  }
  __syncthreads();
  const int pre = shared_int;
  if (c0 < n) {
#pragma unroll
    for (int q = 0; q < kExtPer; ++q) {
      const int t = g0 + threadIdx.x + q * kChunkThreads;
      if (t >= c0 && t < c0 + ncols)
        dest[base + t] =
            em[q] >> lane & 1u
                ? pre + seg[q * kChunkWarps + warp] +
                      __popc(em[q] & ((1u << lane) - 1u))
                : -1;
    }
  } else {
    for (int x = threadIdx.x; x < ncols; x += kChunkThreads)
      dest[base + c0 + x] = -1;
  }
  if (threadIdx.x == 0 && j == chunks - 1) count[row] = pre + agg;
}

// The winner of the r-wide trailing window at column col, whose hash is
// hs[i]: the least (hash, ring slot = column % r), ring slots being
// distinct in a window.  Returns the winner's index into hs.
__device__ __forceinline__ int window_winner(const uint32_t* hs, int i,
                                             int col, int r) {
  const int s0 = col % r;
  uint32_t best_h = hs[i];
  int best_s = s0, best = i;
  for (int d = 1; d < r; ++d) {
    const uint32_t h = hs[i - d];
    const int s = d > s0 ? s0 - d + r : s0 - d;
    if (h < best_h || (h == best_h && s < best_s)) {
      best_h = h;
      best_s = s;
      best = i - d;
    }
  }
  return best;
}

// reduce_drain's store stage (see reduce_drain_kernel): where the
// records go and where the batch's counts go.
struct DrainArgs {
  const long long* rids;
  const int32_t* c0;
  unsigned long long* cursor;
  ulonglong2* out;
  int32_t* counts_out;
  int k, width;
  long long max_records;
  int max_slots, counts_ld;
};

// reduce_drain's prefix across the tiles of a batch (tile t = chunk j of
// row b, t = b * chunks + j, in ticket order), a segmented sum whose
// segments are rows, each row contributing min(width, its entries)
// records.  A span of tiles holds: s, whether a row starts in it; f, the
// entries before its first row start (all of them where s == 0); o, the
// entries from its last row start on; c, the records of the rows that
// start in it and end before that last row start (0 where s == 0).
// RecordsOp(a, b) is a followed by b; the cursor base enters as tile 0's
// c.  Published as x = f << 1 | o << 26 | s << 51 and y = c << 1 (see
// to_words), so f and o stay below 2^25 (rows of fewer columns).
struct Records {
  int s, f, o;
  long long c;
};
struct RecordsOp {
  int width;
  __device__ Records operator()(const Records& a, const Records& b) const {
    if (!b.s) return {a.s, a.s ? a.f : a.f + b.f, a.s ? a.o + b.f : 0, a.c};
    if (!a.s) return {1, a.f + b.f, b.o, b.c};
    return {1, a.f, b.o, a.c + min(width, a.o + b.f) + b.c};
  }
};

__device__ __forceinline__ Records shfl_down(const Records& v, int off) {
  return {shfl_down(v.s, off), shfl_down(v.f, off), shfl_down(v.o, off),
          __shfl_down_sync(0xFFFFFFFFu, v.c, off)};
}
__device__ __forceinline__ Records shfl_from(const Records& v, int lane) {
  return {shfl_from(v.s, lane), shfl_from(v.f, lane), shfl_from(v.o, lane),
          __shfl_sync(0xFFFFFFFFu, v.c, lane)};
}
__device__ __forceinline__ void to_words(const Records& v,
                                         unsigned long long* x,
                                         unsigned long long* y) {
  *x = 1ull | (unsigned long long)(unsigned)v.f << 1 |
       (unsigned long long)(unsigned)v.o << 26 |
       (unsigned long long)(unsigned)v.s << 51;
  *y = 1ull | (unsigned long long)v.c << 1;
}
__device__ __forceinline__ void from_words(unsigned long long x,
                                           unsigned long long y, Records* v) {
  *v = {(int)(x >> 51 & 1u), (int)(x >> 1 & 0x1FFFFFFu),
        (int)(x >> 26 & 0x1FFFFFFu), (long long)(y >> 1)};
}

// One reduction level over a chunk (see reduce_step_kernel); kDrain adds
// reduce_drain_kernel's store stage in place of the oH, oP, count
// stores.  Each kernel's blocks run it once.
template <bool kDrain>
__device__ __forceinline__ void reduce_level(
    const uint32_t* __restrict__ H, const uint32_t* __restrict__ P,
    const int32_t* __restrict__ n_in, int* __restrict__ status,
    int* __restrict__ stale, int stale_words, uint32_t* __restrict__ oH,
    uint32_t* __restrict__ oP, int32_t* __restrict__ count, int L, int r,
    int chunks, const DrainArgs& d) {
  __shared__ __align__(16) uint32_t Hs[kRExt];
  __shared__ __align__(16) uint32_t Ps[kRExt];
  __shared__ int seg[kRSegs];
  __shared__ uint32_t edge[kRSegs];  // each segment's last winner P
  __shared__ int shared_int;
  __shared__ int ticket;
  __shared__ long long row_base;  // kDrain: the row's first record

  // rows of one chunk need no look-back, and so no ticket, unless the
  // look-back runs across rows (kDrain)
  const int tile = chunks == 1 && !kDrain ? (int)blockIdx.x
                                          : take_ticket(status, &ticket);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kRChunk;
  const size_t base = (size_t)row * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the chunk's first columns are staged while n loads (the draft's rows
  // hold a few hundred entries, so most levels need no second round trip)
  const int g0 = max(0, c0 - r);
  const int early = min(L, c0 + kREarly) - g0;
  const uint8_t* h0 = (const uint8_t*)(H + base + g0);
  const uint8_t* p0 = (const uint8_t*)(P + base + g0);
  const int offH = stage_async((uint8_t*)Hs, h0, 4 * early);
  const int offP = stage_async((uint8_t*)Ps, p0, 4 * early);
  const int n = max(0, min(n_in[row], L));  // a count: never past the row
  unsigned long long rid_hi = 0, cur0 = 0, cur1 = 0;
  if (kDrain) {
    rid_hi = (unsigned long long)d.rids[row] << 32;
    // the cursors, before this tile publishes anything (thread 0 does):
    // the last tile moves them only once it has seen every publication
    if (threadIdx.x == 0) {
      cur1 = load_acquire(d.cursor + 1);
      cur0 = load_acquire(d.cursor);
    }
  }
  // block-uniform: a chunk past n has nothing below n; reduce_step's
  // publishes nothing, reduce_drain's publishes that it holds no entries
  const bool live = c0 < n;
  if (!live) {
    cp_async_wait_all();
    if (!kDrain) {
      if (j == 0 && threadIdx.x == 0) count[row] = 0;
      return;
    }
  }
  const int ncols = live ? min(kRChunk, n - c0) : 0;  // columns below n
  uint32_t wh[kRPer], wp[kRPer], em[kRPer];
#pragma unroll
  for (int q = 0; q < kRPer; ++q) em[q] = 0;
  if (live) {
    const int E = c0 + ncols - g0;
    if (E > early) {  // the rest of the chunk below n
      stage_rest((uint8_t*)Hs, offH, h0, 4 * early, 4 * E);
      stage_rest((uint8_t*)Ps, offP, p0, 4 * early, 4 * E);
    }
    const uint32_t* hs = Hs + offH / 4;  // hs[i], ps[i]: column g0 + i
    const uint32_t* ps = Ps + offP / 4;
    // the registers that hold a column below n (block-uniform)
    const int nq = (ncols + kRThreads - 1) / kRThreads;
    cp_async_wait_all();
    __syncthreads();

    // each column's winner, where its window is whole
    bool full[kRPer];
#pragma unroll
    for (int q = 0; q < kRPer; ++q) {
      const int x = threadIdx.x + q * kRThreads, col = c0 + x;
      full[q] = x < ncols && col >= r - 1;
      wh[q] = wp[q] = 0;
      if (full[q]) {
        const int b = window_winner(hs, col - g0, col, r);
        wh[q] = hs[b];
        wp[q] = ps[b];
      }
      if (q < nq && lane == 31) edge[q * kRWarps + warp] = wp[q];
    }
    // column c0 - 1's winner, the previous one of the chunk's first column
    uint32_t before = 0;
    if (threadIdx.x == 0 && c0 >= r)
      before = ps[window_winner(hs, c0 - 1 - g0, c0 - 1, r)];
    __syncthreads();

    // emitted columns by ballots in segments q * kRWarps + warp, which run
    // in column order
#pragma unroll
    for (int q = 0; q < kRPer; ++q) {
      const int e = q * kRWarps + warp;
      if (q < nq) {
        uint32_t prev = __shfl_up_sync(0xFFFFFFFFu, wp[q], 1);
        if (lane == 0) prev = e > 0 ? edge[e - 1] : before;
        const int col = c0 + threadIdx.x + q * kRThreads;
        em[q] = __ballot_sync(0xFFFFFFFFu,
                              full[q] && (col == r - 1 || wp[q] != prev));
      }
      if (lane == 0) seg[e] = __popc(em[q]);
    }
    __syncthreads();
  }
  if (warp == 0) {
    const int agg = live ? segment_scan<kRSegs>(seg, 0, Sum()) : 0;
    if (kDrain) {
      const RecordsOp op{d.width};
      const Records v = j == 0 ? Records{1, 0, agg, 0} : Records{0, agg, 0, 0};
      // the cursor base, as a row of no entries closed before row 0 (tile
      // 0's thread 0 read it; the others take it from the chain)
      const Records first = {1, 0, 0, (long long)cur0};
      Records ex = look_back(status, tile, tile, tile == 0 ? op(first, v) : v,
                             Records{0, 0, 0, 0}, op);
      if (tile == 0) ex = first;
      if (lane == 0) {
        const int in_row = j == 0 ? 0 : ex.o;  // the row's earlier entries
        shared_int = in_row;
        row_base = j == 0 ? ex.c + min(d.width, ex.o) : ex.c;
        const unsigned long long slot = cur1;
        // the chunk of column n - 1 (chunk 0 where n == 0) has the count
        if (d.counts_out != nullptr && (live ? c0 + ncols == n : j == 0) &&
            slot < (unsigned long long)d.max_slots) {
          d.counts_out[2 * slot * d.counts_ld + row] = d.c0[row];
          d.counts_out[(2 * slot + 1) * d.counts_ld + row] = in_row + agg;
        }
        if (tile == (int)gridDim.x - 1) {  // after its whole look-back
          const Records all = op(ex, v);
          store_release(d.cursor,
                        (unsigned long long)(all.c + min(d.width, all.o)));
          store_release(d.cursor + 1, slot + 1);
        }
      }
    } else {
      const int c =
          chunks == 1 ? 0 : look_back(status, tile, j, agg, 0, Sum());
      if (lane == 0) {
        shared_int = c;
        if (c0 + ncols == n) count[row] = c + agg;  // the chunk of column n-1
      }
    }
  }
  __syncthreads();
  const int pre = shared_int;
  if (kDrain) {
    const long long at0 = row_base;
#pragma unroll
    for (int q = 0; q < kRPer; ++q) {
      if (em[q] >> lane & 1u) {
        const int rank = pre + seg[q * kRWarps + warp] +
                         __popc(em[q] & ((1u << lane) - 1u));
        const long long at = at0 + rank;
        if (rank < d.width && at < d.max_records) {
          ulonglong2 rec;
          rec.x = (unsigned long long)wh[q] << 8 | (unsigned)d.k;
          rec.y = rid_hi | (unsigned long long)(wp[q] >> 2) << 1 |
                  (wp[q] >> 1 & 1u);
          d.out[at] = rec;
        }
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRPer; ++q) {
      if (em[q] >> lane & 1u) {
        const size_t at = base + pre + seg[q * kRWarps + warp] +
                          __popc(em[q] & ((1u << lane) - 1u));
        oH[at] = wh[q];
        oP[at] = wp[q];
      }
    }
  }
}

// One SHIMMER reduction level over (H, P, n), compacted (replaces
// reduce_step, compact_pallas.py:452, and the two move_plane calls that
// followed it): the winner of the r-wide trailing window at each column
// r - 1 <= col < n, emitted where col == r - 1 or its P differs from the
// previous column's winner's; the emitted winners' hashes and P go to
// oH, oP at their rank in the row, and count gets their number.  n is
// clamped to [0, L]; columns at or past it are never written, and their
// values never used (the early staging below may read some).
//
// Bound: 8 bytes per column below n (H, P in), 8 per emitted winner (oH,
// oP out) and 8 per row (n, count): 0.25 MB, 0.07 us, at level 1 of the
// draft (B=64, n ~ 370 of L=2,048) on 3.35 TB/s, so each level is a
// chain of latencies.  Design: one launch per level where there were
// three (the per-column planes and destinations the TPU kernel wrote for
// whole rows went straight to two moves); chunks of kRChunk columns, one
// block each, so a long row (stage 4's contig index: one row of ~10^5
// columns) spreads over the SMs and a chunk past n exits after its ticket;
// where a row fits one chunk, as on the main path, the block takes no
// ticket and publishes nothing; the chunk's first kREarly columns and an
// r-column halo are staged in shared memory by cp.async while n loads,
// the rest of the columns below n after it, so a level of the draft (a
// few hundred entries a row) waits on one round trip to device memory
// before its stores, not two; each column's winner is found once (r
// shared loads), the previous column's comes from the neighbouring lane
// by a shuffle (from shared memory at a warp's first lane); ranks come
// from ballots, popcounts, one warp's prefix over the 32-column segments
// and, across chunks, a decoupled look-back, and each emitted winner is
// stored at its rank; register slots past the chunk's columns below n
// skip the shuffles and ballots.
__global__ void __launch_bounds__(kRThreads)
reduce_step_kernel(const uint32_t* __restrict__ H,
                   const uint32_t* __restrict__ P,
                   const int32_t* __restrict__ n_in, int* __restrict__ status,
                   int* __restrict__ stale, int stale_words,
                   uint32_t* __restrict__ oH, uint32_t* __restrict__ oP,
                   int32_t* __restrict__ count, int L, int r, int chunks) {
  reduce_level<false>(H, P, n_in, status, stale, stale_words, oH, oP, count,
                      L, r, chunks, DrainArgs{});
}

// The final reduction level of stage 1's batch step with the record drain
// as its store stage (replaces reduce_step, compact_pallas.py:452, call
// :464, followed by peregrine_tpu/ops/index.py:_compact_drain (:66) with
// assemble_records, ops/sketch.py:257): the level's emitted winners of
// each row, the first min(count, width) of them, go as (x, y) records,
// x = h << 8 | k and y = rid << 32 | (p >> 2) << 1 | (p >> 1 & 1), to the
// tight stream at the device cursor, in (row, column) order, exactly as
// reduce_step followed by drain_records writes them (writes at or past
// max_records dropped); (c0, count) goes to count slot cursor[1]; the
// last tile advances cursor[0] by the batch's records and cursor[1] by
// one, so the launch has fixed arguments for a CUDA graph.  The level's
// own planes and counts are never written.
//
// Bound: 8 bytes per column below n (H, P in), 16 per record out, 20 per
// row (n, c0, rid in; two count words out): under 0.1 MB at the draft's
// level 2, 0.03 us on 3.35 TB/s, so the launch is a chain of latencies.
// Design: reduce_step_kernel's staging and ranking, unchanged; every
// chunk of every row is one tile of a single decoupled look-back across
// the batch (Records, a segmented sum of the clamped row counts), so each
// tile learns both its row's earlier entries and the records of the rows
// before it and stores its records at their place with no further pass.
// Every tile takes a ticket.  Each tile's thread 0 reads the cursors
// with acquire loads before the tile publishes anything; only tile 0's cursor[0] is used (it enters the
// chain as the base), and the last tile, whose look-back has seen every
// tile's publication, moves both with release stores, so no tile reads
// a cursor that has moved.  Where drain_records re-read the counts, read
// the cursor, re-read (H, P), fenced and took an atomic in a second
// launch, the records leave the registers that ranked them.
__global__ void __launch_bounds__(kRThreads)
reduce_drain_kernel(const uint32_t* __restrict__ H,
                    const uint32_t* __restrict__ P,
                    const int32_t* __restrict__ n_in,
                    const long long* __restrict__ rids,
                    const int32_t* __restrict__ c0, int* __restrict__ status,
                    int* __restrict__ stale, int stale_words,
                    unsigned long long* cursor, ulonglong2* __restrict__ out,
                    int32_t* __restrict__ counts_out, int L, int r, int chunks,
                    int k, int width, long long max_records, int max_slots,
                    int counts_ld) {
  reduce_level<true>(H, P, n_in, status, stale, stale_words, nullptr,
                     nullptr, nullptr, L, r, chunks,
                     DrainArgs{rids, c0, cursor, out, counts_out, k, width,
                               max_records, max_slots, counts_ld});
}

// Up to kMaxPlanes planes of 4- or 8-byte elements compacted by one mask;
// bytes[p] == 0 marks an absent plane.
constexpr int kMaxPlanes = 3;
struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  long long fill[kMaxPlanes];
  int bytes[kMaxPlanes];
};

// A plane's element width as a template argument: 4 or 8 bytes, 0 for an
// absent plane, or kAnyWidth for the width the launch gives (bytes[p]),
// so that the instances the port launches carry no branch per element.
constexpr int kAnyWidth = -1;
template <int kW>
struct Elem {
  using T = unsigned long long;
};
template <>
struct Elem<4> {
  using T = uint32_t;
};
template <>
struct Elem<0> {
  using T = uint32_t;
};

template <int kW>
__device__ __forceinline__ bool plane_present(const Planes& pl, int p) {
  return kW > 0 || (kW == kAnyWidth && pl.bytes[p] != 0);
}
template <int kW>
__device__ __forceinline__ bool plane_wide(const Planes& pl, int p) {
  return kW == 8 || (kW == kAnyWidth && pl.bytes[p] == 8);
}

// Column i of plane p where the column is kept, else the plane's fill.
template <int kW>
__device__ __forceinline__ typename Elem<kW>::T plane_value(const Planes& pl,
                                                            int p, size_t i,
                                                            bool kept) {
  using T = typename Elem<kW>::T;
  if (!plane_present<kW>(pl, p)) return 0;
  if (!kept) return (T)pl.fill[p];
  if (plane_wide<kW>(pl, p))
    return (T) static_cast<const unsigned long long*>(pl.in[p])[i];
  return static_cast<const uint32_t*>(pl.in[p])[i];
}

template <int kW>
__device__ __forceinline__ void plane_store(const Planes& pl, int p,
                                            size_t i,
                                            typename Elem<kW>::T v) {
  if (!plane_present<kW>(pl, p)) return;
  if (plane_wide<kW>(pl, p))
    static_cast<unsigned long long*>(pl.out[p])[i] = v;
  else
    static_cast<uint32_t*>(pl.out[p])[i] = (uint32_t)v;
}

// Stable compaction of up to three planes of a row by one keep mask
// (replaces compact_planes, compact_pallas.py:365): the kept entries go
// to the row front in their order, every column at or past the row's
// count takes the plane's fill (the wide sketch's output and the
// reduction levels return whole rows), and the count is exact.  All
// planes move in one launch; the TPU kernel ran one call per u32 half of
// each plane because its VMEM held one [8, L] working set at a time.
//
// Bound: 1 byte of keep per column, the kept entries of each plane read
// once, and every column of each plane written once (the fills are part
// of the result): about 17 B per column for the wide sketch's sparse
// output (x, y; keep 0.023), 5.4 us at B=64, L=16,384 on 3.35 TB/s, the
// fills nearly all of it, and 41 B per column for a dense compaction of
// three planes (x, y, run; keep 0.98).  Design: one block per chunk of kCChunk
// columns (B x ceil(L / kCChunk) blocks), rows carried across chunks by
// the decoupled look-back (a row of one chunk takes no ticket and
// publishes nothing); the chunk's keep bytes are staged in shared memory
// by cp.async (16 bytes a copy); column x of the chunk lives in thread
// x % kCThreads, register x / kCThreads, so a warp's 32 columns of a
// register are consecutive, their kept ranks come from a ballot and a
// popcount, and one warp's prefix over the 32-column segments gives the
// chunk's; the kept entries are loaded (predicated, coalesced across the
// warp) before the look-back, so their latency overlaps it; a dropped
// column t with d = t - (kept columns before t) dropped columns before it
// writes the fill at column L - 1 - d, which puts the L - count fills on
// [count, L) exactly once without waiting for the count, so every store
// leaves right after the block's own look-back and there is no second
// pass; the chunk of column L - 1 writes the count.  The plane widths are
// template arguments: (8, 8) for the wide sketch's output, and kAnyWidth
// for any other mix.
template <int kW0, int kW1, int kW2>
__global__ void __launch_bounds__(kCThreads, kCBlocksPerSM)
compact_planes_kernel(const uint8_t* __restrict__ keep, Planes pl,
                      int* __restrict__ status, int* __restrict__ stale,
                      int stale_words, int32_t* __restrict__ count, int L,
                      int chunks) {
  __shared__ __align__(16) uint8_t ks[kCChunk + 32];
  __shared__ int seg[kCSegs];
  __shared__ uint32_t ems[kCSegs];  // each segment's ballot of kept columns
  __shared__ int shared_int;

  // rows of one chunk need no look-back, and so no ticket
  const int tile =
      chunks == 1 ? (int)blockIdx.x : take_ticket(status, &shared_int);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kCChunk, ncols = min(kCChunk, L - c0);
  const size_t base = (size_t)row * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = stage_async(ks, keep + base + c0, ncols);
  const uint8_t* kp = ks + off;  // kp[x]: column c0 + x
  cp_async_wait_all();
  __syncthreads();

  // kept columns by ballots in segments q * kCWarps + warp, which run in
  // column order; each kept entry is loaded now, the fill elsewhere
  typename Elem<kW0>::T v0[kCPer];
  typename Elem<kW1>::T v1[kCPer];
  typename Elem<kW2>::T v2[kCPer];
#pragma unroll
  for (int q = 0; q < kCPer; ++q) {
    const int x = threadIdx.x + q * kCThreads;
    const bool kept = x < ncols && kp[x] != 0;
    const uint32_t em = __ballot_sync(0xFFFFFFFFu, kept);
    if (lane == 0) {
      seg[q * kCWarps + warp] = __popc(em);
      ems[q * kCWarps + warp] = em;
    }
    const size_t at = base + c0 + x;
    v0[q] = plane_value<kW0>(pl, 0, at, kept);
    v1[q] = plane_value<kW1>(pl, 1, at, kept);
    v2[q] = plane_value<kW2>(pl, 2, at, kept);
  }
  __syncthreads();
  if (warp == 0) {
    const int agg = segment_scan<kCSegs>(seg, 0, Sum());
    const int c = chunks == 1 ? 0 : look_back(status, tile, j, agg, 0, Sum());
    if (lane == 0) {
      shared_int = c;
      if (j == chunks - 1) count[row] = c + agg;  // the chunk of column L-1
    }
  }
  __syncthreads();
  const int pre = shared_int;
#pragma unroll
  for (int q = 0; q < kCPer; ++q) {
    const int x = threadIdx.x + q * kCThreads;
    if (x < ncols) {
      const int e = q * kCWarps + warp;
      const uint32_t em = ems[e];
      // kept columns of the row before this one
      const int before = pre + seg[e] + __popc(em & ((1u << lane) - 1u));
      const size_t at =
          base + (em >> lane & 1u ? before : L - 1 - (c0 + x - before));
      plane_store<kW0>(pl, 0, at, v0[q]);
      plane_store<kW1>(pl, 1, at, v1[q]);
      plane_store<kW2>(pl, 2, at, v2[q]);
    }
  }
}

// --- the wide route (k > 16) ------------------------------------------------
//
// Three kernels for the code the JAX package leaves to XLA on the wide
// route (peregrine_tpu/ops/sketch.py:_sketch_impl_wide, reduce.py:
// reduce_impl), where a record x = hash << 8 | span needs all 64 bits:
// wide_stream writes the sketch's compacted stream, wide_emit its
// emission set over that stream (compact_planes then compacts the
// emitted records), reduce_wide is a whole reduction level.  Records are
// unsigned long long (the wrappers hand over int64 tensors holding the
// same bits) and every comparison is unsigned.

constexpr int kMaxWideK = 28;  // 56-bit hashes
// wide_stream: kChunk columns of one row per block of kChunkThreads
// threads, column x of the chunk in thread x % kChunkThreads, register
// x / kChunkThreads.  The chunk's codes and a k - 1 halo are packed two
// bits a column into kWPacked 16-bit words (8 columns each) from column
// c0 - kWLead, so that any column's 2k-bit window is one funnel shift of
// two 64-bit words.
constexpr int kWPer = kChunk / kChunkThreads;
constexpr int kWSegs = kWPer * kChunkWarps;  // 32-column segments
constexpr int kWLead = 32;
constexpr int kWPacked = (kWLead + kChunk + 64) / 8;
// wide_emit: kChunk columns of one row per block of kEThreads threads;
// the staged columns [c0 - (w - 1), c0 + kChunk + w - 1) of a chunk at
// c0 are slots 0, 1, ..., kEPer consecutive slots a thread.
constexpr int kEThreads = 256;
constexpr int kEWarps = kEThreads / 32;
constexpr int kEPer = (kChunk + 2 * (kMaxW - 1) + kEThreads - 1) / kEThreads;
constexpr int kESlots = kEPer * kEThreads;
// its dynamic shared memory: the staged keys with a word of alignment
// slack either side, the exchanged runs and a byte a slot
constexpr int kEmitSmem = (2 * kESlots + 2) * 8 + kESlots;
static_assert(kESlots % 32 == 0, "whole words of `complete` bits");
static_assert(32 * kEPer >= kMaxW, "every warp's slots meet a block edge");
static_assert(kESlots >= kChunk + 2 * (kMaxW - 1), "slots hold the halos");
constexpr int kMaxDevices = 64;  // cards whose wide_emit_kernel is sized
// reduce_wide: kWRChunk columns of one row per block of kChunkThreads
// threads (as stage_async strides), column x of the chunk in thread
// x % kChunkThreads, register x / kChunkThreads; a block stages the
// columns [c0 - r, c0 + kWRChunk) of x and y, plus one word of slack,
// the first kWREarly of them before it knows n.  REDUCE_WIDE_CHUNK in
// ops/kernels.py must equal kWRChunk.
constexpr int kWRChunk = 2048;
constexpr int kWRPer = kWRChunk / kChunkThreads;
constexpr int kWRSegs = kWRPer * kChunkWarps;
constexpr int kWRExt = (kWRChunk + kMaxR + 1 + 1) / 2 * 2;
constexpr int kWREarly = 512;  // columns staged before n is known

static_assert(kWPacked % 4 == 0, "whole 64-bit words of packed codes");
static_assert(kWLead >= kMaxWideK - 1, "the packed lead covers the halo");
static_assert(kWPer <= 32 && kEPer <= 32, "per-thread bit masks");
static_assert(kMaxR < kWRChunk && kWRChunk % kChunkThreads == 0, "chunks");
static_assert(kWREarly <= kWRChunk, "early columns lie in the chunk");
static_assert(kWSegs <= 32 * 32 && kWRSegs <= 32 * 32, "segments");

// Invertible minimizer hash (peregrine_tpu/ops/sketch.py:hash64) on
// 64-bit lanes under a mask of at most 56 bits.
__device__ __forceinline__ unsigned long long hash64(unsigned long long key,
                                                     unsigned long long mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// The 32 two-bit groups of v in reverse order (group g moves to 31 - g).
__device__ __forceinline__ unsigned long long reverse_pairs(
    unsigned long long v) {
  v = __brevll(v);
  return ((v >> 1) & 0x5555555555555555ull) |
         ((v & 0x5555555555555555ull) << 1);
}

// Lanes 0 .. lane of a warp.
__device__ __forceinline__ uint32_t lanes_upto(int lane) {
  return 0xFFFFFFFFu >> (31 - lane);
}

// The wide sketch's compacted stream (replaces the XLA code of
// _sketch_impl_wide, peregrine_tpu/ops/sketch.py:371-422, its stream
// compaction at :422 included).  Per column t of a read: the forward and
// reverse-complement k-mers ending at t from the codes c[t-k+1..t] & 3,
// the complement taken before the shift (src/mm_sketch.c:102), so an
// ambiguous base gives 0 bits to fwd and 3 to rev and only columns before
// the row's start give 0 to both; the canonical k-mer, its strand (a tie
// goes to 1) and its 56-bit hash; the run length l, the valid
// non-symmetric entries since the last ambiguous base (a row prefix); the
// records x = hash << 8 | k and y = rid << 32 | (t << 1 & 0xFFFFFFFE) |
// strand where the entry is valid, non-symmetric and l >= k, all ones
// elsewhere, and li = l on valid non-symmetric entries (0 elsewhere).
// The entries kept (valid non-symmetric, or an ambiguous placeholder) are
// written in order to the row front of sx, sy, sl, and their count to n;
// the columns at or past n are not written (nothing reads them: wide_emit
// reads below n, and the output compaction only the emitted entries).
//
// Bound: 1 byte read per column (codes) and 20 written per kept entry
// (sx, sy, sl): 20.3 MB, 6.1 us at B=64, L=16,384 with reads of 0.8-1.0
// L on 3.35 TB/s.  Design: one block per chunk of a row (B x ceil(L /
// kChunk) blocks), the chunk's codes and a k - 1 halo staged in shared
// memory by cp.async and packed two bits a column; a column's window is a
// funnel shift of two packed 64-bit words (the reverse complement is it
// xor the mask; the forward k-mer its two-bit groups reversed), so no
// column walks k codes; a warp's 32 consecutive columns per register, so
// the run length and the kept ranks come from ballots of the valid
// non-symmetric and the ambiguous columns, one warp's prefix over the
// 32-column segments and, across chunks, build_stream's decoupled
// look-back over (valid non-symmetric count, kept count, that count at
// the last ambiguous base): an ATAT... run at even k is all symmetric
// k-mers of any length, so no bounded halo could carry it; the hashes are
// computed while warp 0 waits on the look-back; each warp stores its
// kept columns of a register at consecutive ranks, so every store is
// coalesced, and no column past the count is written (the stream and its
// compaction used to be two launches: 21 bytes a column written, read
// back and 20 written again with the fills).  A row of one chunk takes no
// ticket and publishes nothing; a chunk at or past the read's length keeps
// nothing, writes nothing and publishes nothing, since only chunks past it
// could wait on it; the chunk of the read's last column writes the count
// after its look-back (chunk 0 writes 0 for an empty read).
__global__ void __launch_bounds__(kChunkThreads)
wide_stream_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths,
                   const long long* __restrict__ rids,
                   int* __restrict__ status, int* __restrict__ stale,
                   int stale_words, unsigned long long* __restrict__ sx,
                   unsigned long long* __restrict__ sy,
                   int32_t* __restrict__ sl, int32_t* __restrict__ n_out,
                   int L, int k, int chunks) {
  __shared__ __align__(16) uint8_t cs[kChunk + 48];
  __shared__ __align__(8) uint16_t pk[kWPacked];
  __shared__ Stream seg[kWSegs];
  __shared__ int ticket;
  __shared__ Stream carried;

  const int tile =
      chunks == 1 ? (int)blockIdx.x : take_ticket(status, &ticket);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kChunk, ncols = min(kChunk, L - c0);
  const size_t base = (size_t)row * L;
  const int len = lengths[row];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (c0 >= len) {  // block-uniform: past the read, nothing is kept
    if (j == 0 && threadIdx.x == 0) n_out[row] = 0;
    return;
  }
  const int g0 = max(0, c0 - (k - 1));
  const int off = stage_async(cs, codes + base + g0, c0 + ncols - g0);
  cp_async_wait_all();
  __syncthreads();
  // pk entry e: columns s0 + 8e .. s0 + 8e + 7, two bits each from bit 0;
  // 0 where not staged (columns before the row's start among them)
  const int s0 = c0 - kWLead;
  for (int e = threadIdx.x; e < kWPacked; e += kChunkThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int t = s0 + 8 * e + q;
      if (t >= g0 && t < c0 + ncols) v |= (cs[off + t - g0] & 3u) << (2 * q);
    }
    pk[e] = (uint16_t)v;
  }
  __syncthreads();
  const unsigned long long* pw = reinterpret_cast<const unsigned long long*>(pk);

  const unsigned long long mask = (1ull << (2 * k)) - 1ull;
  unsigned long long hv[kWPer];  // the canonical k-mer, then its hash
  uint32_t vb[kWPer], ab[kWPer];  // ballots: valid non-symmetric, ambiguous
  uint32_t strand = 0;            // bit q: column q's strand
#pragma unroll
  for (int q = 0; q < kWPer; ++q) {
    const int x = threadIdx.x + q * kChunkThreads, t = c0 + x;
    bool vns = false, amb = false;
    hv[q] = 0;
    if (x < ncols) {
      const uint32_t ct = cs[off + t - g0];
      const int bit = 2 * (x + kWLead - (k - 1));  // column t - k + 1
      const int wi = bit >> 6, sh = bit & 63;
      unsigned long long m = pw[wi] >> sh;
      if (sh) m |= pw[wi + 1] << (64 - sh);
      m &= mask;
      const unsigned long long fwd = reverse_pairs(m) >> (64 - 2 * k);
      unsigned long long rev = m ^ mask;
      if (t < k - 1) rev &= ~((1ull << (2 * (k - 1 - t))) - 1ull);
      const bool inlen = t < len;
      amb = inlen && ct >= 4;
      vns = inlen && ct < 4 && fwd != rev;
      if (fwd >= rev) strand |= 1u << q;
      hv[q] = min(fwd, rev);
    }
    vb[q] = __ballot_sync(0xFFFFFFFFu, vns);
    ab[q] = __ballot_sync(0xFFFFFFFFu, amb);
    if (lane == 0) {
      const int last = 31 - __clz(ab[q]);  // the segment's last amb lane
      seg[q * kChunkWarps + warp] =
          Stream{__popc(vb[q]), __popc(vb[q] | ab[q]),
                 ab[q] ? __popc(vb[q] & lanes_upto(last)) : -1};
    }
  }
  __syncthreads();
  const Stream id = {0, 0, -1};
  if (warp == 0) {  // the segments' prefixes, then the row's
    const Stream agg = segment_scan<kWSegs>(seg, id, StreamOp());
    const Stream c =
        chunks == 1 ? id : look_back(status, tile, j, agg, id, StreamOp());
    if (lane == 0) {
      carried = c;
      // the chunk of the read's last column (at most L - 1) has the count
      if (j == (min(len, L) - 1) / kChunk) n_out[row] = c.inc + agg.inc;
    }
  }
#pragma unroll
  for (int q = 0; q < kWPer; ++q) hv[q] = hash64(hv[q], mask);
  __syncthreads();

  const unsigned long long rid = (unsigned long long)rids[row] << 32;
  const uint32_t upto = lanes_upto(lane);
#pragma unroll
  for (int q = 0; q < kWPer; ++q) {
    const int x = threadIdx.x + q * kChunkThreads, t = c0 + x;
    const bool vns = vb[q] >> lane & 1u, amb = ab[q] >> lane & 1u;
    if (vns || amb) {  // kept: columns past ncols or the read are neither
      const Stream pre = StreamOp()(carried, seg[q * kChunkWarps + warp]);
      const int cv = pre.vns + __popc(vb[q] & upto);
      const uint32_t la = ab[q] & upto;
      const int at = la ? pre.vns + __popc(vb[q] & (0xFFFFFFFFu >> __clz(la)))
                        : max(pre.amb, 0);
      const int run = cv - at;
      const bool defined = vns && run >= k;
      const size_t o = base + pre.inc + __popc((vb[q] | ab[q]) & upto) - 1;
      sx[o] = defined ? hv[q] << 8 | (unsigned long long)k : ~0ull;
      sy[o] = defined ? rid | ((unsigned long long)t << 1 & 0xFFFFFFFEull) |
                            (strand >> q & 1u)
                      : ~0ull;
      sl[o] = vns ? run : 0;
    }
  }
}

// Runs within blocks of w slots (van Herk / Gil-Werman), the block edges
// at slot multiples of w: `edges` bit p marks slot p of the thread's
// kEPer consecutive slots, forward (kRev false) where a block starts, so
// v becomes each slot's extremum from its block's first slot, backward
// where one ends, to its block's last slot.  Two halves around a
// barrier, each called for a forward and a backward run at once.
// run_lanes takes the thread's own slots and then the warp's lanes (five
// shuffle steps, each lane combining only lanes inside its block); it
// leaves the warp's value toward the next warp in wv[warp] and whether
// the warp holds an edge in wh[warp], and returns the lane's carry from
// the lanes before it (after it, backward), with *open set where that
// carry still lacks the warps before (after) this one.
template <bool kMax>
__device__ __forceinline__ unsigned long long ext(unsigned long long a,
                                                  unsigned long long b) {
  return kMax ? max(a, b) : min(a, b);
}

template <bool kMax, bool kRev>
__device__ __forceinline__ unsigned long long run_lanes(
    unsigned long long (&v)[kEPer], uint32_t edges, unsigned long long id,
    bool* open, unsigned long long* wv, int* wh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long acc = id;
#pragma unroll
  for (int s = 0; s < kEPer; ++s) {
    const int p = kRev ? kEPer - 1 - s : s;
    acc = edges >> p & 1u ? v[p] : ext<kMax>(acc, v[p]);
    v[p] = acc;
  }
  const uint32_t em = __ballot_sync(0xFFFFFFFFu, edges != 0);
  // the nearest lane at or before (after) this one that holds an edge:
  // the lanes from it to this one are this lane's block's
  const uint32_t before = lanes_upto(lane) >> 1, after = ~lanes_upto(lane);
  int near;
  if (kRev) {
    const uint32_t m = em & (after | 1u << lane);
    near = m ? __ffs(m) - 1 : 31;
  } else {
    const uint32_t m = em & lanes_upto(lane);
    near = m ? 31 - __clz(m) : 0;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long o =
        kRev ? __shfl_down_sync(0xFFFFFFFFu, acc, off)
             : __shfl_up_sync(0xFFFFFFFFu, acc, off);
    if (kRev ? lane + off <= near : lane - off >= near)
      acc = ext<kMax>(acc, o);
  }
  if (lane == (kRev ? 0 : 31)) {
    wv[warp] = acc;
    wh[warp] = em != 0;
  }
  unsigned long long carry = kRev ? __shfl_down_sync(0xFFFFFFFFu, acc, 1)
                                  : __shfl_up_sync(0xFFFFFFFFu, acc, 1);
  if (lane == (kRev ? 31 : 0)) carry = id;
  *open = (em & (kRev ? after : before)) == 0;
  return carry;
}

// The second half, after the barrier: an open lane takes the warps
// before (after) its own back to the nearest one with an edge (one, since
// every warp's slots meet an edge), and the slots before the thread's
// first edge (after its last) take the carry.
template <bool kMax, bool kRev>
__device__ __forceinline__ void run_finish(unsigned long long (&v)[kEPer],
                                           uint32_t edges,
                                           unsigned long long carry,
                                           bool open,
                                           const unsigned long long* wv,
                                           const int* wh) {
  const int warp = threadIdx.x >> 5;
  if (open) {
    for (int u = kRev ? warp + 1 : warp - 1; u >= 0 && u < kEWarps;
         u += kRev ? 1 : -1) {
      carry = ext<kMax>(carry, wv[u]);
      if (wh[u]) break;
    }
  }
  bool live = true;
#pragma unroll
  for (int s = 0; s < kEPer; ++s) {
    const int p = kRev ? kEPer - 1 - s : s;
    live = live && !(edges >> p & 1u);
    if (live) v[p] = ext<kMax>(carry, v[p]);
  }
}

// The wide emission set (replaces the XLA code of _sketch_impl_wide,
// peregrine_tpu/ops/sketch.py:425-441) over the compacted stream (sx,
// sl, n): W = the trailing minimum of sx over w, in unsigned order, all
// ones before column 0; Ap = W where sl >= w + k - 1 (the window is
// complete) and 0 elsewhere; M = the leading maximum of Ap over w, 0 past
// n; an entry t < n is emitted where sx[t] is not all ones and M equals
// it, or where it is the newest minimum of the final window
// [max(0, n - w), n) unless that minimum is all ones.  Columns at or past
// n are not emitted and never read.
//
// Bound: 12 bytes per column below n (sx, sl in) and 1 per column (the
// mask out): 12.3 MB, 3.67 us at B=64, L=16,384 with reads of 0.8-1.0 L
// on 3.35 TB/s.  Design: one block per chunk of a row, no row prefix, so
// no ticket and no status; the chunk's sx with a halo of w - 1 columns
// before and after, clipped to [0, n) and padded with all ones, staged
// in shared memory by cp.async, and its `complete` flags as warp ballots
// in a bitmap; each thread then holds kEPer consecutive staged columns in
// registers.  Both window extrema are van Herk / Gil-Werman runs over
// blocks of w columns: W at t is the minimum of the backward run at
// t - w + 1 and the forward run at t, M at t the maximum of the backward
// run at t and the forward run at t + w - 1, so whatever w is, a block
// takes four runs (each a pass over a thread's registers, five shuffle
// steps across the warp and one warp value from the warp before, the
// forward and the backward run side by side) and two exchanges of one run
// through shared memory: five barriers after the staging, where the
// log-step sparse tables took about 2 log2(w) passes of a shared store, a
// barrier and a shared load a column (15 at w = 80) and two block
// reductions for the final window.  The final window reuses the runs: its
// minimum is W at n - 1 (the forward run there, kept in shared memory,
// with the exchanged backward run) and its newest minimum the one column
// of it that equals the minimum while the minimum over the columns after
// it, the backward run at the next column and the forward run at n - 1,
// does not.  The mask leaves through shared memory as consecutive bytes.
// What holds it is instruction issue, not memory: a 64-bit
// compare-and-select is four instructions, and every column takes
// several of them across the runs; 256 threads of 18 columns (128
// registers, no spill) and 78 KB of shared memory let two blocks share an
// SM, which gained more than the register-bound 512-thread forms did.
__global__ void __launch_bounds__(kEThreads, 2)
wide_emit_kernel(const unsigned long long* __restrict__ sx,
                 const int32_t* __restrict__ sl,
                 const int32_t* __restrict__ n_in, uint8_t* __restrict__ emit,
                 int L, int w, int k, int chunks) {
  // dynamic: the staged keys (slot i, column g0 + i, at as[i]), the
  // exchanged runs (slot i at S[i]) and the mask (fb[i]); kEmitSmem bytes
  extern __shared__ __align__(16) unsigned long long As[];
  unsigned long long* S = As + kESlots + 2;
  uint8_t* fb = reinterpret_cast<uint8_t*>(S + kESlots);
  __shared__ uint32_t cbits[kESlots / 32 + 1];  // bit i: slot i complete
  __shared__ unsigned long long wv[2][kEWarps];
  __shared__ int wh[2][kEWarps];
  __shared__ unsigned long long at_last;  // the forward run at n - 1

  const int row = blockIdx.x / chunks, j = blockIdx.x - row * chunks;
  const int c0 = j * kChunk, ncols = min(kChunk, L - c0);
  const size_t base = (size_t)row * L;
  const int n = max(0, min(n_in[row], L));  // a count: never past the row
  if (c0 >= n) {  // block-uniform: nothing below n
    for (int x = threadIdx.x; x < ncols; x += kEThreads)
      emit[base + c0 + x] = 0;
    return;
  }
  const int g0 = max(0, c0 - (w - 1));
  const int E = min(n, c0 + ncols + w - 1) - g0;  // staged slots
  const int off = stage_async<kEThreads>(
      (uint8_t*)As, (const uint8_t*)(sx + base + g0), 8 * E);
  unsigned long long* as = As + off / 8;
  for (int i = E + (int)threadIdx.x; i < kESlots; i += kEThreads)
    as[i] = ~0ull;  // all ones past the staged slots
  int32_t run[kEPer];  // the run lengths, every load in flight at once
#pragma unroll
  for (int q = 0; q < kEPer; ++q) {
    const int i = threadIdx.x + q * kEThreads;
    run[q] = i < E ? sl[base + g0 + i] : 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kEPer; ++q) {
    const uint32_t b = __ballot_sync(0xFFFFFFFFu, run[q] >= w + k - 1);
    if (lane == 0) cbits[q * kEWarps + warp] = b;
  }
  if (threadIdx.x == 0) cbits[kESlots / 32] = 0;
  cp_async_wait_all();
  __syncthreads();

  // slot i's key, all ones past the staged slots
  auto key = [&](int i) { return as[i]; };
  const int s0 = kEPer * threadIdx.x;  // the thread's first slot
  unsigned long long lo[kEPer], hi[kEPer];
#pragma unroll
  for (int p = 0; p < kEPer; ++p) lo[p] = hi[p] = key(s0 + p);
  // bit p: slot s0 + p opens a block of w (slots 0 mod w), or closes one
  // (w - 1 mod w)
  const int rem = s0 % w;
  uint32_t starts = 0, ends = 0;
  for (int p = rem ? w - rem : 0; p < kEPer; p += w) starts |= 1u << p;
  for (int p = w - 1 - rem; p < kEPer; p += w) ends |= 1u << p;

  // W, the trailing minimum: lo the forward run, hi the backward one
  bool open_f, open_b;
  unsigned long long cf =
      run_lanes<false, false>(lo, starts, ~0ull, &open_f, wv[0], wh[0]);
  unsigned long long cb =
      run_lanes<false, true>(hi, ends, ~0ull, &open_b, wv[1], wh[1]);
  __syncthreads();  // the warp values
  run_finish<false, false>(lo, starts, cf, open_f, wv[0], wh[0]);
  run_finish<false, true>(hi, ends, cb, open_b, wv[1], wh[1]);
  const int e = n - 1 - g0;  // the slot of column n - 1
#pragma unroll
  for (int p = 0; p < kEPer; ++p) {
    S[s0 + p] = hi[p];
    if (s0 + p == e) at_last = lo[p];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kEPer; ++p) {
    const int i = s0 + p;
    if (i >= w - 1) lo[p] = min(lo[p], S[i - w + 1]);
  }
  // the final window [lo_f, n): where it meets the chunk, the staged
  // slots end at e (E = e + 1) and the runs hold all ones after it; its
  // newest minimum goes to the mask now, the rest of it at the end
  const int lo_f = max(0, n - w);
  if (lo_f < c0 + ncols) {  // block-uniform
    const unsigned long long fmin =
        e >= w - 1 ? min(at_last, S[e - w + 1]) : at_last;
    const int e0 = e - e % w;  // the first slot of e's block
#pragma unroll
    for (int p = 0; p < kEPer; ++p) {
      const int i = s0 + p;
      fb[i] = fmin != ~0ull && g0 + i >= lo_f && i <= e && key(i) == fmin &&
              (i == e || min(S[i + 1], e0 > i + 1 ? at_last : ~0ull) != fmin);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kEPer; ++p) fb[s0 + p] = 0;
  }

  // Ap, and M, the leading maximum: hi the backward run, lo the forward
  const uint32_t complete =  // bit p: slot s0 + p's window is complete
      __funnelshift_r(cbits[s0 >> 5], cbits[(s0 >> 5) + 1], s0 & 31);
#pragma unroll
  for (int p = 0; p < kEPer; ++p) {
    if (!(complete >> p & 1u)) lo[p] = 0;
    hi[p] = lo[p];
  }
  cf = run_lanes<true, false>(lo, starts, 0, &open_f, wv[0], wh[0]);
  cb = run_lanes<true, true>(hi, ends, 0, &open_b, wv[1], wh[1]);
  __syncthreads();  // the warp values; the exchanged run is read
  run_finish<true, false>(lo, starts, cf, open_f, wv[0], wh[0]);
  run_finish<true, true>(hi, ends, cb, open_b, wv[1], wh[1]);
#pragma unroll
  for (int p = 0; p < kEPer; ++p) S[s0 + p] = lo[p];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kEPer; ++p) {
    const int i = s0 + p, t = g0 + i;
    if (t >= c0 && t < c0 + ncols) {  // i + w - 1 < kESlots
      const unsigned long long x = key(i);
      if (x != ~0ull && max(hi[p], S[i + w - 1]) == x) fb[i] = 1;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < ncols; x += kEThreads)
    emit[base + c0 + x] = fb[c0 - g0 + x];
}

// The winner of the r-wide trailing window at column col, whose record
// is xs[i]: the least key (x & ~0xFF) | (column % r) in unsigned order,
// ring slots being distinct in a window.  Returns its index into xs.
__device__ __forceinline__ int window_winner64(const unsigned long long* xs,
                                               int i, int col, int r) {
  const int s0 = col % r;
  unsigned long long best = (xs[i] & ~0xFFull) | (unsigned)s0;
  int at = i;
  for (int d = 1; d < r; ++d) {
    const int s = d > s0 ? s0 - d + r : s0 - d;
    const unsigned long long key = (xs[i - d] & ~0xFFull) | (unsigned)s;
    if (key < best) {
      best = key;
      at = i - d;
    }
  }
  return at;
}

// One reduction level on record rows (see reduce_wide_kernel); kDrain
// adds reduce_wide_drain_kernel's store stage in place of the oX, oY,
// count stores and the fills.  Rows are ld >= C elements apart in X and
// Y, C apart in oX and oY.  Each kernel's blocks run it once.  kDrain's
// status holds a slot a tile and then a slot a row.
template <bool kDrain>
__device__ __forceinline__ void reduce_wide_level(
    const unsigned long long* __restrict__ X,
    const unsigned long long* __restrict__ Y,
    const int32_t* __restrict__ n_in, int* __restrict__ status,
    int* __restrict__ stale, int stale_words,
    unsigned long long* __restrict__ oX, unsigned long long* __restrict__ oY,
    int32_t* __restrict__ count, int C, int ld, int r, int chunks,
    const DrainArgs& d) {
  __shared__ __align__(16) unsigned long long Xs[kWRExt];
  __shared__ __align__(16) unsigned long long Ys[kWRExt];
  __shared__ int seg[kWRSegs];
  __shared__ unsigned long long edge[kWRSegs];  // each segment's last y
  __shared__ int shared_int;
  __shared__ int ticket;
  __shared__ long long row_base;  // kDrain: the row's first record

  // rows of one chunk need no look-back, and so no ticket, unless the
  // look-back runs across rows (kDrain)
  const int tile = chunks == 1 && !kDrain ? (int)blockIdx.x
                                          : take_ticket(status, &ticket);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kWRChunk, ncols = min(kWRChunk, C - c0);
  const size_t base = (size_t)row * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a row's first chunk stages its first columns and the r-column halo
  // while n loads (a level holds a few hundred entries a row, so most
  // levels need no second round trip); a later chunk, past n in most
  // rows, stages only what n says lies below it
  const int g0 = max(0, c0 - r);
  const int early = j == 0 ? min(C, c0 + kWREarly) - g0 : 0;
  const uint8_t* x0 = (const uint8_t*)(X + (size_t)row * ld + g0);
  const uint8_t* y0 = (const uint8_t*)(Y + (size_t)row * ld + g0);
  const int offX = stage_async((uint8_t*)Xs, x0, 8 * early);
  const int offY = stage_async((uint8_t*)Ys, y0, 8 * early);
  const int n = max(0, min(n_in[row], C));  // a count: never past the row
  unsigned long long cur0 = 0, cur1 = 0;
  if (kDrain && threadIdx.x == 0) {
    // the cursors, before this tile publishes anything: the last tile
    // moves them only once it has seen every publication
    cur1 = load_acquire(d.cursor + 1);
    cur0 = load_acquire(d.cursor);
  }
  if (!kDrain) {  // the chunk's columns at or past n: all ones there
    for (int t = max(c0, n) + threadIdx.x; t < c0 + ncols;
         t += kChunkThreads) {
      oX[base + t] = ~0ull;
      oY[base + t] = ~0ull;
    }
  }
  // block-uniform: a chunk past n has nothing below n and publishes
  // nothing, but for reduce_wide_drain's chunk 0, which publishes its
  // row's records (none)
  const bool live = c0 < n;
  if (!live) {
    cp_async_wait_all();
    if (!kDrain || j > 0) {
      if (!kDrain && j == 0 && threadIdx.x == 0) count[row] = 0;
      return;
    }
  }
  const int nb = live ? min(kWRChunk, n - c0) : 0;  // columns below n
  unsigned long long wx[kWRPer], wy[kWRPer];
  uint32_t em[kWRPer];
#pragma unroll
  for (int q = 0; q < kWRPer; ++q) em[q] = 0;
  if (live) {
    const int E = c0 + nb - g0;
    if (E > early) {  // the rest of the chunk below n
      stage_rest((uint8_t*)Xs, offX, x0, 8 * early, 8 * E);
      stage_rest((uint8_t*)Ys, offY, y0, 8 * early, 8 * E);
    }
    const unsigned long long* xs = Xs + offX / 8;  // xs[i]: column g0 + i
    const unsigned long long* ys = Ys + offY / 8;
    // the registers that hold a column below n (block-uniform)
    const int nq = (nb + kChunkThreads - 1) / kChunkThreads;
    cp_async_wait_all();
    __syncthreads();

    // each column's winner, where its window is whole
    bool full[kWRPer];
#pragma unroll
    for (int q = 0; q < kWRPer; ++q) {
      const int x = threadIdx.x + q * kChunkThreads, col = c0 + x;
      full[q] = x < nb && col >= r - 1;
      wx[q] = wy[q] = 0;
      if (full[q]) {
        const int b = window_winner64(xs, col - g0, col, r);
        wx[q] = xs[b];
        wy[q] = ys[b];
      }
      if (q < nq && lane == 31) edge[q * kChunkWarps + warp] = wy[q];
    }
    // column c0 - 1's winner, the previous one of the chunk's first column
    unsigned long long before = 0;
    if (threadIdx.x == 0 && c0 >= r)
      before = ys[window_winner64(xs, c0 - 1 - g0, c0 - 1, r)];
    __syncthreads();

    // emitted columns by ballots in segments q * kChunkWarps + warp, which
    // run in column order
#pragma unroll
    for (int q = 0; q < kWRPer; ++q) {
      const int e = q * kChunkWarps + warp;
      if (q < nq) {
        unsigned long long prev = __shfl_up_sync(0xFFFFFFFFu, wy[q], 1);
        if (lane == 0) prev = e > 0 ? edge[e - 1] : before;
        const int col = c0 + threadIdx.x + q * kChunkThreads;
        em[q] = __ballot_sync(0xFFFFFFFFu,
                              full[q] && (col == r - 1 || wy[q] != prev));
      }
      if (lane == 0) seg[e] = __popc(em[q]);
    }
    __syncthreads();
  }
  if (warp == 0) {
    const int agg = live ? segment_scan<kWRSegs>(seg, 0, Sum()) : 0;
    if (kDrain) {
      // the row's entries before this chunk, from the chunks before it
      // (all live); the chunk of column n - 1 (chunk 0 where n == 0) has
      // the row's count, publishes the row's records in the row-level
      // look-back (row slots after the tile slots; row 0's with the
      // cursor base, which its thread 0 read) and gets the records of the
      // rows before it; another chunk of the row only reads that prefix
      const int in_row =
          chunks == 1 ? 0 : look_back(status, tile, j, agg, 0, Sum());
      const bool last = live ? c0 + nb == n : true;
      const long long recs = min(d.width, in_row + agg);
      const int rows = (int)gridDim.x / chunks;
      const long long before = look_back(
          status + kSlot * gridDim.x, row, row,
          row == 0 ? recs + (long long)cur0 : recs, 0LL, Sum64(), last);
      if (lane == 0) {
        shared_int = in_row;
        row_base = row == 0 ? (long long)cur0 : before;
        const unsigned long long slot = cur1;
        if (last && d.counts_out != nullptr &&
            slot < (unsigned long long)d.max_slots) {
          d.counts_out[2 * slot * d.counts_ld + row] = d.c0[row];
          d.counts_out[(2 * slot + 1) * d.counts_ld + row] = in_row + agg;
        }
        if (last && row == rows - 1) {  // after the whole look-back
          store_release(d.cursor,
                        (unsigned long long)(row_base + recs));
          store_release(d.cursor + 1, slot + 1);
        }
      }
    } else {
      const int c =
          chunks == 1 ? 0 : look_back(status, tile, j, agg, 0, Sum());
      if (lane == 0) {
        shared_int = c;
        if (c0 + nb == n) count[row] = c + agg;  // the chunk of column n-1
      }
    }
  }
  __syncthreads();
  const int pre = shared_int;  // emitted columns of the row before the chunk
  if (kDrain) {
    const long long at0 = row_base;
#pragma unroll
    for (int q = 0; q < kWRPer; ++q) {
      if (em[q] >> lane & 1u) {
        const int rank = pre + seg[q * kChunkWarps + warp] +
                         __popc(em[q] & ((1u << lane) - 1u));
        const long long at = at0 + rank;
        if (rank < d.width && at < d.max_records)
          d.out[at] = make_ulonglong2(wx[q], wy[q]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWRPer; ++q) {
      const int x = threadIdx.x + q * kChunkThreads;
      if (x < nb) {
        const int at = pre + seg[q * kChunkWarps + warp] +
                       __popc(em[q] & ((1u << lane) - 1u));
        if (em[q] >> lane & 1u) {
          oX[base + at] = wx[q];
          oY[base + at] = wy[q];
        } else {
          const size_t fill = base + n - 1 - (c0 + x - at);
          oX[fill] = ~0ull;
          oY[fill] = ~0ull;
        }
      }
    }
  }
}

// One reduction level on record rows, compacted (replaces the XLA code of
// reduce_impl, peregrine_tpu/ops/reduce.py:26-61, with its compaction):
// the winner of the r-wide trailing window at each column r - 1 <= col <
// n, emitted where col == r - 1 or its y differs from the previous
// column's winner's; the emitted winners' x and y go to ox, oy at their
// rank in the row, every column from the count to C gets all ones, and
// count gets their number.  n is clamped to [0, C]; the values of x, y at
// or past it are never used (the early staging below may read some).
// The input rows lie ld >= C elements apart, so a level reads the first
// C columns of wider planes (the sketch's, cut to the cap) in place.
//
// Bound: 16 bytes per column below n (x, y in) and 16 per column of the
// output (the emitted winners and the fills): 16.9 MB, 5.0 us at a
// --with-L0-index level (B=64, C=16,384, n ~ 370), where the fills are
// nearly all of it; 2.4 MB, 0.73 us at a capped level (C=2,048).
// Design: reduce_step's, on 64-bit records and with the fills: chunks of
// kWRChunk columns, one block each (a row of one chunk takes no ticket
// and publishes nothing); a row's first kWREarly columns and an r-column
// halo staged in shared memory by cp.async while n loads, the rest of the
// columns below n after it (a later chunk, past n in most rows of a
// level, stages nothing before it knows n), so a level (n ~ 370) waits
// on one round trip to device memory before its stores, not two; each
// column's winner is found once (r shared loads), the previous column's
// comes from the neighbouring lane by a shuffle; ranks come from ballots,
// popcounts, one warp's prefix over the 32-column segments and, across
// chunks, a decoupled look-back; a dropped column t < n with d = t -
// (emitted columns before t) writes all ones at column n - 1 - d, which
// puts the fills on [count, n) exactly once, and a column at or past n
// writes them at its own column (count <= n), so no store waits on the
// row's count; a chunk at or past n publishes nothing.
__global__ void __launch_bounds__(kChunkThreads)
reduce_wide_kernel(const unsigned long long* __restrict__ X,
                   const unsigned long long* __restrict__ Y,
                   const int32_t* __restrict__ n_in, int* __restrict__ status,
                   int* __restrict__ stale, int stale_words,
                   unsigned long long* __restrict__ oX,
                   unsigned long long* __restrict__ oY,
                   int32_t* __restrict__ count, int C, int ld, int r,
                   int chunks) {
  reduce_wide_level<false>(X, Y, n_in, status, stale, stale_words, oX, oY,
                           count, C, ld, r, chunks, DrainArgs{});
}

// The final reduction level of stage 1's k > 16 batch step with the
// record drain as its store stage (replaces reduce_impl,
// peregrine_tpu/ops/reduce.py:26, followed by
// peregrine_tpu/ops/index.py:_compact_drain (:66)): the level's emitted
// winners of each row, the first min(count, width) of them, go as (x, y)
// records to the tight stream at the device cursor, in (row, column)
// order, exactly as reduce_wide followed by drain_records writes them
// (writes at or past max_records dropped); (c0, count) goes to count slot
// cursor[1]; the last row's last live chunk advances cursor[0] by the
// batch's records and cursor[1] by one, so the launch has fixed arguments
// for a CUDA graph.  The level's own planes, fills and counts are never
// written.
//
// Bound: 16 bytes per column below n (x, y in), 16 per record out, 16 per
// row (n, c0 in; two count words out): 0.14 MB, 0.04 us at the k=28
// step's level 2 (B=64, n ~ 120), so the launch is a chain of latencies.
// Design: reduce_wide_kernel's staging and ranking, unchanged, and a
// store stage that places each record at once: every tile takes a
// ticket; a chunk past n (all but chunk 0 of most rows: the level-2 rows
// of an uncapped step have 8 chunks and ~120 entries) exits, publishing
// nothing; a row's live chunks carry its entries across chunks by
// reduce_wide's look-back, and the chunk of column n - 1 publishes the
// row's records, min(count, width), in a second decoupled look-back
// whose slots are rows, so a window of 32 lanes covers 32 rows however
// many chunks a row has (a single chain over every chunk's tile, as
// reduce_drain's, took 14.4 us on an H100 where the rows have 8 chunks,
// against 7.0 us where they have one); each live chunk gets the records
// of the
// rows before it from that look-back and stores its records with no
// further pass.  Each tile's thread 0 reads the cursors with acquire
// loads before the tile publishes anything; only row 0 adds cursor[0] to
// what it publishes, and the last row's last chunk, whose look-back has
// seen every row's publication, moves both cursors with release stores,
// so no tile reads a cursor that has moved.
__global__ void __launch_bounds__(kChunkThreads)
reduce_wide_drain_kernel(const unsigned long long* __restrict__ X,
                         const unsigned long long* __restrict__ Y,
                         const int32_t* __restrict__ n_in,
                         const int32_t* __restrict__ c0,
                         int* __restrict__ status, int* __restrict__ stale,
                         int stale_words, unsigned long long* cursor,
                         ulonglong2* __restrict__ out,
                         int32_t* __restrict__ counts_out, int C, int ld,
                         int r, int chunks, int width, long long max_records,
                         int max_slots, int counts_ld) {
  reduce_wide_level<true>(X, Y, n_in, status, stale, stale_words, nullptr,
                          nullptr, nullptr, C, ld, r, chunks,
                          DrainArgs{nullptr, c0, cursor, out, counts_out, 0,
                                    width, max_records, max_slots,
                                    counts_ld});
}

// --- gather_codes: windows of the packed seqdb as 2-bit codes -------------
//
// Replaces the XLA code of peregrine_tpu/ops/dbgather.py:gather_codes
// (:233, with _gather_bytes :215): [B] windows -> [B, L] uint8 codes, fill
// where a base is ambiguous or past the window's length, strand 1 read
// mirrored and complemented.  Bound: device-memory bytes, 3/8 of a byte
// read and one written a base (1.4 MB, 0.42 us at B=64, L=16,384 on
// 3.35 TB/s).  Design: one thread writes 16 output bases (one 16-byte
// store) from two 32-bit fw words and two amb words funnel-shifted to its
// first base; strand 1 reverses the 2-bit fields of its word.  A word
// that is not whole inside its plane (or a plane that is not 4-byte
// aligned) is put together a byte at a time, each byte index clamped to
// the plane as the plain version clamps it, so a window past the plane's
// end reads its last byte again and nothing after it.
constexpr int kGatherThreads = 256;
constexpr long long kGuardBases = 1 << 16;  // GUARD_BASES in ops/dbgather.py

__device__ __forceinline__ uint32_t plane_word(const uint8_t* __restrict__ p,
                                               long long n, long long wi,
                                               bool aligned) {
  const long long b0 = 4 * wi;
  if (aligned && b0 >= 0 && b0 + 3 < n)
    return __ldg(reinterpret_cast<const uint32_t*>(p) + wi);
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long b = min(max(b0 + i, 0LL), n - 1);
    v |= (uint32_t)__ldg(p + b) << (8 * i);
  }
  return v;
}

__global__ void __launch_bounds__(kGatherThreads)
gather_codes_kernel(const uint8_t* __restrict__ fw, long long n_fw,
                    const uint8_t* __restrict__ amb, long long n_amb,
                    const long long* __restrict__ goff,
                    const long long* __restrict__ lens,
                    const int32_t* __restrict__ strand,
                    uint8_t* __restrict__ out, int B, int L, int fill) {
  const int groups = (L + 15) / 16;
  const long long t = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  if (t >= (long long)B * groups) return;
  const int row = (int)(t / groups);
  const int j0 = (int)(t % groups) * 16;
  const bool rev = strand != nullptr && strand[row] == 1;
  const long long len = lens[row];
  // the 16 bases this thread reads: window columns j0..j0+15 on strand 0,
  // L-16-j0..L-1-j0 (the mirror of its outputs) on strand 1
  const long long q0 = goff[row] + kGuardBases;
  const long long s = rev ? q0 + L - 16 - j0 : q0 + j0;
  const bool fa = ((uintptr_t)fw & 3) == 0, aa = ((uintptr_t)amb & 3) == 0;
  uint32_t c = __funnelshift_r(plane_word(fw, n_fw, s >> 4, fa),
                               plane_word(fw, n_fw, (s >> 4) + 1, fa),
                               2 * (int)(s & 15));
  uint32_t a = __funnelshift_r(plane_word(amb, n_amb, s >> 5, aa),
                               plane_word(amb, n_amb, (s >> 5) + 1, aa),
                               (int)(s & 31)) & 0xFFFFu;
  if (rev) {  // reverse the 16 fields, complement the codes
    c = __brev(c);
    c = ~(((c & 0x55555555u) << 1) | ((c >> 1) & 0x55555555u));
    a = __brev(a) >> 16;
  }
  uint8_t v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = ((a >> i & 1u) || j0 + i >= len) ? (uint8_t)fill
                                            : (uint8_t)(c >> (2 * i) & 3u);
  uint8_t* o = out + (size_t)row * L + j0;
  if (j0 + 16 <= L && ((uintptr_t)o & 15) == 0) {
    uint4 w;
    uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wp[i] = v[4 * i] | v[4 * i + 1] << 8 | v[4 * i + 2] << 16 |
              (uint32_t)v[4 * i + 3] << 24;
    *reinterpret_cast<uint4*>(o) = w;
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (j0 + i < L) o[i] = v[i];
  }
}

// --- gather_build_stream: build_stream from the packed seqdb -------------
//
// build_stream of gather_codes' windows (strand 0, fill 4), in one launch
// (replaces peregrine_tpu/ops/dbgather.py:gather_codes (:233) followed by
// build_stream, compact_pallas.py:230, call :243): the same (H, P, dest,
// n) as build_stream_kernel on the codes plane pg_gather_codes would
// write, with the same look-back.  The window of row b starts at base
// goff[b] + kGuardBases of the packed planes (fw: 4 bases a byte, amb: 8);
// a column is 4 where its amb bit is set or it lies at or past lens[b],
// its 2-bit code elsewhere; a byte index past a plane's end reads its
// last byte (as plane_word clamps), and the planes may be views into
// larger buffers.  lens[b] is cut to 32 bits for build_stream's length,
// as the step's lengths are.
//
// Bound: 0.375 bytes per column in (the packed planes), 12 out (H, P,
// dest) and 20 per row (goff, lens in, n out): 12.98 MB, 3.87 us at B=64,
// L=16,384 on 3.35 TB/s, where the two launches moved 2 bytes a column
// more through the codes plane.  Design: a block stages, by cp.async, the
// bytes of fw and amb that cover its chunk and the k - 1 halo (about
// 1,030 and 515 bytes) in its transpose buffer, which the build does not
// use until its stores, unpacks them into the codes buffer
// build_stream_kernel stages into, and runs build_stream_chunk.
constexpr int kFwStage = (15 + (kChunk + kMaxK - 1 + 3) / 4 + 1 + 15) / 16 * 16;
constexpr int kAmbStage =
    (15 + (kChunk + kMaxK - 1 + 7) / 8 + 1 + 15) / 16 * 16;
static_assert(kFwStage + kAmbStage <= 4 * 2 * kTransposed,
              "the packed bytes fit the transpose buffer");

__global__ void __launch_bounds__(kChunkThreads, 3)
gather_build_stream_kernel(const uint8_t* __restrict__ fw, long long n_fw,
                           const uint8_t* __restrict__ amb, long long n_amb,
                           const long long* __restrict__ goff,
                           const long long* __restrict__ lens,
                           int* __restrict__ status, int* __restrict__ stale,
                           int stale_words, uint32_t* __restrict__ H,
                           uint32_t* __restrict__ P,
                           int32_t* __restrict__ dest,
                           int32_t* __restrict__ n_out, int L, int k,
                           int chunks) {
  __shared__ __align__(16) uint8_t cs[kChunk + 32];
  __shared__ __align__(16) uint32_t tb[2 * kTransposed];
  __shared__ Stream scratch[kChunkWarps];
  __shared__ int ticket;
  __shared__ Stream carried;

  const int tile = take_ticket(status, &ticket);
  clear_stale(stale, stale_words);
  const int row = tile / chunks, j = tile - row * chunks;
  const int c0 = j * kChunk, ncols = min(kChunk, L - c0);
  const long long len = lens[row];
  const int g0 = max(0, c0 - (k - 1));
  const int E = c0 + ncols - g0;                        // staged columns
  const long long q0 = goff[row] + kGuardBases + g0;  // column g0's base
  // the planes' bytes under columns [g0, g0 + E), clamped to the planes
  const long long f_lo = min(max(q0 >> 2, 0LL), n_fw - 1);
  const long long f_hi = min(max((q0 + E - 1) >> 2, 0LL), n_fw - 1);
  const long long a_lo = min(max(q0 >> 3, 0LL), n_amb - 1);
  const long long a_hi = min(max((q0 + E - 1) >> 3, 0LL), n_amb - 1);
  uint8_t* fs = reinterpret_cast<uint8_t*>(tb);
  uint8_t* as = fs + kFwStage;
  const int offF = stage_async(fs, fw + f_lo, (int)(f_hi - f_lo) + 1);
  const int offA = stage_async(as, amb + a_lo, (int)(a_hi - a_lo) + 1);
  // columns at or past `in` are past the length: fill
  const int in = (int)min(max(len - g0, 0LL), (long long)E);
  cp_async_wait_all();
  __syncthreads();
  if (q0 >= 0 && (q0 + E - 1) >> 2 < n_fw && (q0 + E - 1) >> 3 < n_amb) {
    // block-uniform: no byte index to clamp, so 32-bit bit addresses in
    // the staged bytes (column g0's at fq in fs, at aq in as)
    const int fq = 8 * offF + 2 * (int)(q0 & 3);
    const int aq = 8 * offA + (int)(q0 & 7);
    for (int i = threadIdx.x; i < E; i += kChunkThreads) {
      const int x = fq + 2 * i, y = aq + i;
      const uint32_t code = fs[x >> 3] >> (x & 7) & 3u;
      const uint32_t a = as[y >> 3] >> (y & 7) & 1u;
      cs[i] = (a || i >= in) ? 4 : (uint8_t)code;
    }
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < E; i += kChunkThreads) {
      const long long q = q0 + i;
      const long long fb = min(max(q >> 2, 0LL), n_fw - 1);
      const long long ab = min(max(q >> 3, 0LL), n_amb - 1);
      const uint32_t code =
          fs[offF + (int)(fb - f_lo)] >> (2 * (q & 3)) & 3u;
      const uint32_t a = as[offA + (int)(ab - a_lo)] >> (q & 7) & 1u;
      cs[i] = (a || i >= in) ? 4 : (uint8_t)code;
    }
  }
  __syncthreads();  // the codes are in place; tb is free again
  build_stream_chunk(cs, g0, tile, j, c0, ncols, (size_t)row * L, (int)len,
                     status, H, P, dest, n_out, row, k, chunks, tb, scratch,
                     &carried);
}

// --- drain_records: padded rows -> one tight record stream ---------------
//
// Replaces the XLA code of peregrine_tpu/ops/index.py:_compact_drain (:66)
// with assemble_records (peregrine_tpu/ops/sketch.py:257) folded in: the
// valid prefix of each row of a batch's [B, C] planes (row stride ld),
// min(count, C) entries, goes as (x, y) pairs to a tight stream at the
// device cursor plus the exclusive scan of the clamped counts of the rows
// before it, in (row, column) order.  kPacked: (H, P) uint32 planes, with
// x = h << 8 | k and y = rid << 32 | pos << 1 | strand built on the way;
// otherwise int64 (x, y) records, copied.  Writes at or past max_records
// are dropped (the caller sizes the stream for its worst case).  The batch
// also writes (c0, count) into count slot cursor[1] (of max_slots, rows
// counts_ld apart) when counts_out is given; the last block to finish
// advances cursor[0] by the batch's records and cursor[1] by one, so the
// launch has fixed arguments and can be replayed from a CUDA graph.
// cursor[2] counts the blocks done and returns to 0.
//
// Bound: bytes, the kept entries read once (8 or 16 bytes) and written
// once (16 bytes), and 8 bytes a row: 0.61 MB, 0.18 us at the level-0
// stream of --with-L0-index (B=64, ~370 records a row), so the launch is
// a chain of latencies.  Design: one block a row (B = 64 rows fill half
// the SMs in one wave; several rows a block would put their stores on
// fewer SMs and save nothing on the chain); every load a block needs is
// issued at once, before any of them returns: each thread loads its row's
// first kDrainPer columns (below C, whatever the count: they do not
// depend on it), the row's count, and in warp 0 each lane the counts of
// every 32nd row, which the warp sums by shuffles into the records before
// this row and in all, while lane 0 reads the cursor; one barrier, then
// the stores from registers (the columns past kDrainPer * kDrainThreads
// of a longer row in a loop after them).  Thread 0 then counts its block
// done with an acquire-release atomic, ordered after its cursor read; the
// last block moves the cursors from the total its warp already holds.
constexpr int kDrainThreads = 256;
constexpr int kDrainPer = 2;  // columns a thread loads before its count

__device__ __forceinline__ unsigned long long atomic_add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

template <bool kPacked>
__device__ __forceinline__ ulonglong2 drain_record(const void* pa,
                                                   const void* pb, size_t at,
                                                   unsigned long long rid_hi,
                                                   int k) {
  ulonglong2 rec;
  if (kPacked) {
    const uint32_t h = __ldg(static_cast<const uint32_t*>(pa) + at);
    const uint32_t p = __ldg(static_cast<const uint32_t*>(pb) + at);
    rec.x = (unsigned long long)h << 8 | (unsigned)k;
    rec.y = rid_hi | (unsigned long long)(p >> 2) << 1 | (p >> 1 & 1u);
  } else {
    rec.x = __ldg(static_cast<const unsigned long long*>(pa) + at);
    rec.y = __ldg(static_cast<const unsigned long long*>(pb) + at);
  }
  return rec;
}

template <bool kPacked>
__global__ void __launch_bounds__(kDrainThreads)
drain_records_kernel(const void* __restrict__ pa, const void* __restrict__ pb,
                     const long long* __restrict__ rids,
                     const int32_t* __restrict__ count,
                     const int32_t* __restrict__ c0,
                     unsigned long long* cursor,
                     ulonglong2* __restrict__ out,
                     int32_t* __restrict__ counts_out, int B, int C, int ld,
                     int k, long long max_records, int max_slots,
                     int counts_ld) {
  __shared__ long long s_pre;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t r0 = (size_t)row * ld;
  unsigned long long cur0 = 0, slot = 0;
  long long total = 0;
  if (warp == 0) {
    if (lane == 0) {
      cur0 = *(volatile unsigned long long*)cursor;
      slot = *(volatile unsigned long long*)(cursor + 1);
    }
    long long pre = 0;
    for (int i = lane; i < B; i += 32) {
      const long long v = min(max(count[i], 0), C);
      total += v;
      if (i < row) pre += v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(0xFFFFFFFFu, total, off);
      pre += __shfl_xor_sync(0xFFFFFFFFu, pre, off);
    }
    if (lane == 0) s_pre = (long long)cur0 + pre;
  }
  const unsigned long long rid_hi =
      kPacked ? (unsigned long long)rids[row] << 32 : 0;
  const int cnt = count[row], n = min(max(cnt, 0), C);
  const int sketched = threadIdx.x == 0 && counts_out != nullptr ? c0[row] : 0;
  ulonglong2 rec[kDrainPer];
#pragma unroll
  for (int q = 0; q < kDrainPer; ++q) {
    const int j = threadIdx.x + q * kDrainThreads;
    if (j < C) rec[q] = drain_record<kPacked>(pa, pb, r0 + j, rid_hi, k);
  }
  __syncthreads();
  const long long base = s_pre;
#pragma unroll
  for (int q = 0; q < kDrainPer; ++q) {
    const int j = threadIdx.x + q * kDrainThreads;
    if (j < n && base + j < max_records) out[base + j] = rec[q];
  }
  for (int j = threadIdx.x + kDrainPer * kDrainThreads;
       j < n && base + j < max_records; j += kDrainThreads)
    out[base + j] = drain_record<kPacked>(pa, pb, r0 + j, rid_hi, k);
  if (threadIdx.x == 0) {
    if (counts_out != nullptr && slot < (unsigned long long)max_slots) {
      counts_out[(2 * slot) * counts_ld + row] = sketched;
      counts_out[(2 * slot + 1) * counts_ld + row] = cnt;
    }
    // every block reads the cursor before it counts itself done (the
    // release), so the last one (the acquire) may move it
    if (atomic_add_acq_rel(cursor + 2, 1ull) == gridDim.x - 1) {
      cursor[0] = cur0 + (unsigned long long)total;
      cursor[1] = slot + 1;
      cursor[2] = 0;
    }
  }
}

}  // namespace

extern "C" {

int pg_build_stream(const void* codes, const void* lengths, void* status,
                    void* stale, int stale_words, void* H, void* P,
                    void* dest, void* n_out, int B, int L, int k,
                    void* stream) {
  if (k < 1 || k > kMaxK || stale_words % kSlot)
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kChunk - 1) / kChunk;
  build_stream_kernel<<<B * chunks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (int*)status,
      (int*)stale, stale_words, (uint32_t*)H, (uint32_t*)P, (int32_t*)dest,
      (int32_t*)n_out, L, k, chunks);
  return (int)cudaGetLastError();
}

int pg_move_plane(const void* dest, const void* in0, const void* in1,
                  void* out0, void* out1, int B, int L, void* stream) {
  if ((in1 == nullptr) != (out1 == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * L;
  const unsigned blocks =
      (unsigned)((total + 4 * kMoveThreads - 1) / (4 * kMoveThreads));
  const bool vec = L % 4 == 0 &&
                   (((uintptr_t)dest | (uintptr_t)in0 | (uintptr_t)in1) & 15) == 0;
  const auto kernel = vec ? move_plane_kernel<true> : move_plane_kernel<false>;
  kernel<<<blocks, kMoveThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dest, (const uint32_t*)in0, (const uint32_t*)in1,
      (uint32_t*)out0, (uint32_t*)out1, L, total);
  return (int)cudaGetLastError();
}

int pg_emit_mask(const void* sH, const void* sP, const void* n_in,
                 void* status, void* stale, int stale_words, void* dest,
                 void* count, int B, int L, int w, int k, void* stream) {
  if (w < 1 || w > kMaxW || k < 1 || k > kMaxK || stale_words % kSlot)
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kChunk - 1) / kChunk;
  emit_mask_kernel<<<B * chunks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sH, (const uint32_t*)sP, (const int32_t*)n_in,
      (int*)status, (int*)stale, stale_words, (int32_t*)dest, (int32_t*)count,
      L, w, k, chunks);
  return (int)cudaGetLastError();
}

int pg_reduce_step(const void* H, const void* P, const void* n_in,
                   void* status, void* stale, int stale_words, void* oH,
                   void* oP, void* count, int B, int L, int r, void* stream) {
  if (r < 2 || r > kMaxR || stale_words % kSlot)
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kRChunk - 1) / kRChunk;
  reduce_step_kernel<<<B * chunks, kRThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)H, (const uint32_t*)P, (const int32_t*)n_in,
      (int*)status, (int*)stale, stale_words, (uint32_t*)oH, (uint32_t*)oP,
      (int32_t*)count, L, r, chunks);
  return (int)cudaGetLastError();
}

int pg_compact_planes(const void* keep, const void* in0, const void* in1,
                      const void* in2, void* status, void* stale,
                      int stale_words, void* out0, void* out1, void* out2,
                      void* count, long long fill0, long long fill1,
                      long long fill2, int bytes0, int bytes1, int bytes2,
                      int B, int L, void* stream) {
  const Planes pl = {{in0, in1, in2}, {out0, out1, out2},
                     {fill0, fill1, fill2}, {bytes0, bytes1, bytes2}};
  if (stale_words % kSlot || bytes0 == 0) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < kMaxPlanes; ++p) {
    const int b = pl.bytes[p];
    if ((b != 0 && b != 4 && b != 8) || (b == 0) != (pl.in[p] == nullptr) ||
        (b == 0) != (pl.out[p] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  const int chunks = (L + kCChunk - 1) / kCChunk;
  auto kernel = compact_planes_kernel<kAnyWidth, kAnyWidth, kAnyWidth>;
  if (bytes0 == 8 && bytes1 == 8 && bytes2 == 0)
    kernel = compact_planes_kernel<8, 8, 0>;
  kernel<<<B * chunks, kCThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)keep, pl, (int*)status, (int*)stale, stale_words,
      (int32_t*)count, L, chunks);
  return (int)cudaGetLastError();
}

int pg_wide_stream(const void* codes, const void* lengths, const void* rids,
                   void* status, void* stale, int stale_words, void* sx,
                   void* sy, void* sl, void* n, int B, int L, int k,
                   void* stream) {
  if (k < 1 || k > kMaxWideK || stale_words % kSlot)
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kChunk - 1) / kChunk;
  wide_stream_kernel<<<B * chunks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)lengths, (const long long*)rids,
      (int*)status, (int*)stale, stale_words, (unsigned long long*)sx,
      (unsigned long long*)sy, (int32_t*)sl, (int32_t*)n, L, k, chunks);
  return (int)cudaGetLastError();
}

int pg_wide_emit(const void* sx, const void* sl, const void* n_in, void* emit,
                 int B, int L, int w, int k, void* stream) {
  if (w < 1 || w > kMaxW || k < 1 || k > kMaxWideK)
    return (int)cudaErrorInvalidValue;
  // the shared memory past 48 KB, once a device (a launch captured in a
  // CUDA graph is never a device's first)
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wide_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kEmitSmem);
    if (rc != cudaSuccess) return (int)rc;
    sized[dev] = true;
  }
  const int chunks = (L + kChunk - 1) / kChunk;
  wide_emit_kernel<<<B * chunks, kEThreads, kEmitSmem,
                     (cudaStream_t)stream>>>(
      (const unsigned long long*)sx, (const int32_t*)sl, (const int32_t*)n_in,
      (uint8_t*)emit, L, w, k, chunks);
  return (int)cudaGetLastError();
}

int pg_reduce_wide(const void* x, const void* y, const void* n_in,
                   void* status, void* stale, int stale_words, void* ox,
                   void* oy, void* count, int B, int C, int ld, int r,
                   void* stream) {
  if (r < 1 || r > kMaxR || stale_words % kSlot || ld < C)
    return (int)cudaErrorInvalidValue;
  const int chunks = (C + kWRChunk - 1) / kWRChunk;
  reduce_wide_kernel<<<B * chunks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)x, (const unsigned long long*)y,
      (const int32_t*)n_in, (int*)status, (int*)stale, stale_words,
      (unsigned long long*)ox, (unsigned long long*)oy, (int32_t*)count, C, ld,
      r, chunks);
  return (int)cudaGetLastError();
}

int pg_reduce_wide_drain(const void* x, const void* y, const void* n_in,
                         const void* c0, void* status, void* stale,
                         int stale_words, void* cursor, void* out,
                         void* counts_out, int B, int C, int ld, int r,
                         int width, long long max_records, int max_slots,
                         int counts_ld, void* stream) {
  if (r < 1 || r > kMaxR || stale_words % kSlot || C < 1 || C >= (1 << 25) ||
      ld < C || width < 0 || width > C || (counts_out && counts_ld < B) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int chunks = (C + kWRChunk - 1) / kWRChunk;
  reduce_wide_drain_kernel<<<B * chunks, kChunkThreads, 0,
                             (cudaStream_t)stream>>>(
      (const unsigned long long*)x, (const unsigned long long*)y,
      (const int32_t*)n_in, (const int32_t*)c0, (int*)status, (int*)stale,
      stale_words, (unsigned long long*)cursor, (ulonglong2*)out,
      (int32_t*)counts_out, C, ld, r, chunks, width, max_records, max_slots,
      counts_ld);
  return (int)cudaGetLastError();
}

int pg_gather_codes(const void* fw, long long n_fw, const void* amb,
                    long long n_amb, const void* goff, const void* lens,
                    const void* strand, void* out, int B, int L, int fill,
                    void* stream) {
  if (n_fw < 1 || n_amb < 1 || L % 8 || L > kGuardBases)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * ((L + 15) / 16);
  const unsigned blocks =
      (unsigned)((threads + kGatherThreads - 1) / kGatherThreads);
  gather_codes_kernel<<<blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)fw, n_fw, (const uint8_t*)amb, n_amb,
      (const long long*)goff, (const long long*)lens, (const int32_t*)strand,
      (uint8_t*)out, B, L, fill);
  return (int)cudaGetLastError();
}

int pg_gather_build_stream(const void* fw, long long n_fw, const void* amb,
                           long long n_amb, const void* goff,
                           const void* lens, void* status, void* stale,
                           int stale_words, void* H, void* P, void* dest,
                           void* n_out, int B, int L, int k, void* stream) {
  if (k < 1 || k > kMaxK || stale_words % kSlot || n_fw < 1 || n_amb < 1 ||
      L % 8 || L > kGuardBases)
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kChunk - 1) / kChunk;
  gather_build_stream_kernel<<<B * chunks, kChunkThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)fw, n_fw, (const uint8_t*)amb, n_amb,
      (const long long*)goff, (const long long*)lens, (int*)status,
      (int*)stale, stale_words, (uint32_t*)H, (uint32_t*)P, (int32_t*)dest,
      (int32_t*)n_out, L, k, chunks);
  return (int)cudaGetLastError();
}

int pg_reduce_drain(const void* H, const void* P, const void* n_in,
                    const void* rids, const void* c0, void* status,
                    void* stale, int stale_words, void* cursor, void* out,
                    void* counts_out, int B, int L, int r, int k, int width,
                    long long max_records, int max_slots, int counts_ld,
                    void* stream) {
  if (r < 2 || r > kMaxR || stale_words % kSlot || L < 1 || L >= (1 << 25) ||
      width < 0 || width > L || (counts_out && counts_ld < B) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const int chunks = (L + kRChunk - 1) / kRChunk;
  reduce_drain_kernel<<<B * chunks, kRThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)H, (const uint32_t*)P, (const int32_t*)n_in,
      (const long long*)rids, (const int32_t*)c0, (int*)status, (int*)stale,
      stale_words, (unsigned long long*)cursor, (ulonglong2*)out,
      (int32_t*)counts_out, L, r, chunks, k, width, max_records, max_slots,
      counts_ld);
  return (int)cudaGetLastError();
}

int pg_drain_records(const void* a, const void* b, const void* rids,
                     const void* count, const void* c0, void* cursor,
                     void* out, void* counts_out, int B, int C, int ld,
                     int bytes, int k, long long max_records, int max_slots,
                     int counts_ld, void* stream) {
  if ((bytes != 4 && bytes != 8) || C > ld || (bytes == 4 && !rids) ||
      (counts_out && counts_ld < B) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const auto kernel = bytes == 4 ? drain_records_kernel<true>
                                 : drain_records_kernel<false>;
  kernel<<<B, kDrainThreads, 0, (cudaStream_t)stream>>>(
      a, b, (const long long*)rids, (const int32_t*)count,
      (const int32_t*)c0, (unsigned long long*)cursor, (ulonglong2*)out,
      (int32_t*)counts_out, B, C, ld, k, max_records, max_slots, counts_ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
