// SF unpack kernels for Hopper (sm_90a): deterministic segment reduction.
//
// Replaces the Pallas functions of repro/kernels/sf_unpack.py:
//   segment_reduce_sorted   (sf_unpack.py:86)  -> sf_segment_reduce_vec /
//                                                 sf_segment_reduce, one
//                                                 segment per CTA at least
//   segment_reduce_blocked  (sf_unpack.py:154) -> the same, segs_per_cta
//                                                 segments per CTA at least
// Both wrappers send the segments longer than their cut (LONG_SEG in
// kernels/sf_unpack.py) to sf_segment_reduce_long.
//
// out[s, e] = buf[start[s], e] (+) buf[start[s]+1, e] (+) ... over len[s] rows,
// for sum / prod / max / min, starting from the op's identity.
//
// Determinism contract: every output equals the left-to-right fold of its
// segment's rows in buffer order, combine(acc, v) with the earlier operand
// first, bit for bit and on every run; the plain version computes exactly
// that fold.  No atomics anywhere.  max/min propagate NaN as torch.maximum
// does (fmaxf / fminf would drop it) and keep the first NaN with its payload;
// equal values keep the earlier one, which decides +-0.  bf16 and fp16 fold
// in float and round after every step, as their tensor arithmetic does;
// integers wrap.  Only rows < len are read, so the buffer needs no padding.
// Dtypes: float32, float64, bfloat16, float16, int8, uint8, int16, int32,
// int64 (uint16 / uint32 payloads arrive as int16 / int32 views or widened,
// core/ops.py).
//
// Routes (the wrapper picks them from the longest segment, which
// segment_meta reads with the metadata's bounds, and, for the short route,
// from sf_unpack.short_plan, which alone chooses its layout and grid; the
// launchers here take the plan's numbers as they are):
//
// * Short, vector (segment_reduce_vec_kernel): rows of whole 16-byte
//   vectors (row bytes a multiple of 16) with buf and out on 16-byte
//   boundaries.  A lane owns one 16-byte vector of one segment's row (4
//   f32, 8 bf16, 16 int8 elements) and folds each element of it with
//   Num<T>'s own arithmetic, so every element keeps its own sequential
//   fold: the bits are the plain fold's.  Rows of more than 16 vectors: a
//   warp owns a chunk of up to 32 * K vectors of one segment's row (lane l
//   vectors l, l + 32, ... in turn, as sf_pack.cu's wide_gather_kernel);
//   narrower rows: the warp's lanes split into groups of LS (the row's
//   vectors rounded up to a power of two) lanes, one segment a group, so a
//   warp folds 32 / LS segments at once.  Before folding, a lane issues the
//   streaming loads (ld.global.cs: each row is read once) of kShortRows
//   (R) rows of its segment, then folds them in row order; a remainder
//   batch takes the last len % R rows.  The loads do not depend on the
//   fold, so the order of the combines stays the buffer order.  A warp's
//   items (segment group, chunk) are 32-bit numbers with one division an
//   item, none an element; rows advance by 64-bit pointer steps.  A CTA of
//   W warps walks per_cta consecutive items, its warps in turn.  An empty
//   segment writes its identity vector with 16-byte stores (the token
//   lookup's transpose is almost all empty segments: for it that is the
//   whole cost).  One rule fills the card (short_plan, picked from a sweep
//   of K, warps and items a CTA at the paths' shapes on an H100): K, the
//   vectors a lane folds a chunk, grows (1 to 4) as the segments hold
//   fewer rows, so that a lane moves about 4 rows' vectors a chunk, and
//   shrinks while the items would give an SM fewer than 32 warps, so a few
//   very wide segments (a DDP bucket: one segment of grains x 10 M bf16)
//   are spread over thousands of warps along the row; a CTA of 4 warps
//   walks per_cta = 4 * m consecutive items, m the least that moves ~12
//   KB (the almost empty segments of a token transpose then share a CTA,
//   whose launch would otherwise cost more than their stores), at most
//   what keeps 4 CTAs an SM.  segs_per_cta (the tuner's "row" = 1 and
//   "block:SB") is the least number of items a CTA walks, counted in
//   segments where a segment's row is one item: m is at least
//   ceil(ceil(SB / segments an item) / warps).  So "row" and "block:SB"
//   name different launches wherever SB items outweigh the byte target
//   and the card stays full.
// * Short, scalar (segment_reduce_kernel): rows narrower than 16 bytes, not
//   whole vectors, or off a 16-byte boundary (U = 1 rows, FieldBundle's
//   12-byte rows, a view one element in).  One thread owns one (segment,
//   unit element) and walks the segment's rows in buffer order,
//   segs_per_cta segments a CTA; when the segment groups are too few to
//   fill the card the plan cuts the unit into column tiles on blockIdx.y
//   (width elements each): each element keeps its thread and its fold.
// Either short kernel skips each segment longer than the cut, which the
// long route writes in the same call.
// * Long, order-free: integer dtypes under every op, float dtypes under
//   max / min.  The wrapper's plan (sf_unpack.long_plan, built once per
//   segment metadata) cuts each long segment into chunks of kLongChunkRows
//   (C) rows; C is fixed here, so the boundaries depend only on the segment,
//   never on the grid or the card.  Pass 1: a CTA reduces one chunk (and a
//   tile of the unit) into one partial row with coalesced loads: for U = 1
//   threads run along the rows in aligned 16-byte vectors, the head and
//   tail of a misaligned chunk as scalars (long_chunk_flat_kernel); for
//   wider units threads run along the unit, in 16-byte vectors when rows
//   are whole 16-byte granules on a 16-byte base (long_chunk_rows_kernel).
//   Pass 2 (long_fold_kernel): a warp per (long segment, unit element)
//   folds the segment's partials in chunk order: lane l a contiguous run of
//   chunks, then a shuffle tree with ascending offsets, the earlier run
//   always the left operand.
//   Why the split equals the sequential fold: integer sum and prod wrap
//   mod 2^n, so they are associative and commutative; max / min satisfy
//   fold(A ++ B) == combine(fold(A), fold(B)), because the sequential fold
//   keeps the first NaN, else the first element that reaches the extremum,
//   and combine with fold(A) first keeps exactly that element.  Inside a
//   chunk the threads' elements interleave, so each float partial carries
//   the row of its element and merges by merge_at (a NaN before a number,
//   then the extremum, two NaNs or two equal values to the earlier row),
//   an order-free merge that picks the same element.
// * Long, order-dependent: float dtypes under sum / prod.  The sequential
//   fold stays the contract (changing its order would change the results).
//   A CTA owns one long segment and a tile of up to 256 unit elements
//   (long_ordered_kernel): its threads stage the rows through shared memory
//   with 16-byte cp.async copies (scalar head and tail), kStages stages in
//   flight, and the threads that own an element fold the staged rows in
//   order, with the next rows' shared-memory loads in flight (for U = 1 as
//   16-byte vectors).  What is left is the chain of dependent adds or
//   multiplies.
//
// Bound on this card.  Short and order-free routes: bytes, over the 3.35
// TB/s of HBM3: the rows read once, the (start, len) metadata, the partial
// rows written and read once (n_chunks * U elements each way), one row a
// segment written.  The vector route must keep about 25 KB of loads in
// flight an SM to reach it (Little's law at ~1 us): R rows of 16 bytes a
// lane give 4 KB a warp, so a few resident warps an SM suffice.
// Order-dependent route: the larger of those bytes and the dependent chain
// of the longest segment, len * U / tile threads combines of ~4 cycles
// each (an f32 add's latency).
//
// Every entry point returns cudaGetLastError() after its launches (-1 for
// an unknown code or a grid the card cannot take).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };

constexpr int kLongChunkRows = 8192;  // C: sf_unpack.LONG_CHUNK_ROWS
constexpr int kLongThreads = 256;     // pass-1 and ordered CTAs
constexpr int kFoldWarps = 4;         // pass-2 warps a CTA
constexpr int kFoldLoads = 8;         // pass-2 loads in flight a lane
constexpr int kStages = 3;            // ordered route: stages in flight
constexpr int kStageBytes = 16000;    // 3 x 16,000 B of static shared memory

template <typename T>
struct Num {
  static constexpr bool kFloat = true;
  __device__ static T lowest() { return -INFINITY; }
  __device__ static T highest() { return INFINITY; }
  __device__ static T zero() { return T(0); }
  __device__ static T one() { return T(1); }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T mul(T a, T b) { return a * b; }
  __device__ static bool isnan_(T a) { return a != a; }
  __device__ static bool gt(T a, T b) { return a > b; }
};

// Integers wrap around as torch's integer tensors do: the sum and product
// are taken in the unsigned type W of at least T's width (an int8 or int16
// product in int would overflow a signed int) and cut back to T's width.
template <typename T, typename W, long long LO, long long HI>
struct IntNum {
  static constexpr bool kFloat = false;
  __device__ static T lowest() { return (T)LO; }
  __device__ static T highest() { return (T)HI; }
  __device__ static T zero() { return T(0); }
  __device__ static T one() { return T(1); }
  __device__ static T add(T a, T b) { return (T)((W)a + (W)b); }
  __device__ static T mul(T a, T b) { return (T)((W)a * (W)b); }
  __device__ static bool isnan_(T) { return false; }
  __device__ static bool gt(T a, T b) { return a > b; }
};

template <>
struct Num<int> : IntNum<int, unsigned, INT_MIN, INT_MAX> {};
template <>
struct Num<signed char> : IntNum<signed char, unsigned, -128, 127> {};
template <>
struct Num<unsigned char> : IntNum<unsigned char, unsigned, 0, 255> {};
template <>
struct Num<short> : IntNum<short, unsigned, -32768, 32767> {};
template <>
struct Num<long long>
    : IntNum<long long, unsigned long long, LLONG_MIN, LLONG_MAX> {};

// Half-width floats fold in float and round after every step, as torch's
// bf16 and fp16 tensor arithmetic does.
template <>
struct Num<__half> {
  typedef __half T;
  static constexpr bool kFloat = true;
  __device__ static T lowest() { return __float2half_rn(-INFINITY); }
  __device__ static T highest() { return __float2half_rn(INFINITY); }
  __device__ static T zero() { return __float2half_rn(0.f); }
  __device__ static T one() { return __float2half_rn(1.f); }
  __device__ static T add(T a, T b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
  }
  __device__ static T mul(T a, T b) {
    return __float2half_rn(__half2float(a) * __half2float(b));
  }
  __device__ static bool isnan_(T a) {
    const float f = __half2float(a);
    return f != f;
  }
  __device__ static bool gt(T a, T b) {
    return __half2float(a) > __half2float(b);
  }
};

template <>
struct Num<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  static constexpr bool kFloat = true;
  __device__ static T lowest() { return __float2bfloat16_rn(-INFINITY); }
  __device__ static T highest() { return __float2bfloat16_rn(INFINITY); }
  __device__ static T zero() { return __float2bfloat16_rn(0.f); }
  __device__ static T one() { return __float2bfloat16_rn(1.f); }
  __device__ static T add(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static T mul(T a, T b) {
    return __float2bfloat16_rn(__bfloat162float(a) * __bfloat162float(b));
  }
  __device__ static bool isnan_(T a) {
    const float f = __bfloat162float(a);
    return f != f;
  }
  __device__ static bool gt(T a, T b) {
    return __bfloat162float(a) > __bfloat162float(b);
  }
};

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if (OP == OP_SUM) return Num<T>::zero();
  if (OP == OP_PROD) return Num<T>::one();
  if (OP == OP_MAX) return Num<T>::lowest();
  return Num<T>::highest();
}

// combine(acc, v) with acc first, as torch.maximum(acc, v): a NaN already
// in acc stays; otherwise a NaN in v wins.
template <typename T, int OP>
__device__ __forceinline__ T combine(T acc, T v) {
  if (OP == OP_SUM) return Num<T>::add(acc, v);
  if (OP == OP_PROD) return Num<T>::mul(acc, v);
  if (Num<T>::isnan_(acc)) return acc;
  if (Num<T>::isnan_(v)) return v;
  if (OP == OP_MAX) return Num<T>::gt(v, acc) ? v : acc;
  return Num<T>::gt(acc, v) ? v : acc;
}

// ----------------------------------------------------- short route: scalar
// CTA (x, y) folds segments [x * segs_per_cta, ...) over the unit's
// columns [y * width, y * width + width).
template <typename T, int OP>
__global__ void segment_reduce_kernel(const T* __restrict__ buf,
                                      T* __restrict__ out,
                                      const int* __restrict__ seg_start,
                                      const int* __restrict__ seg_len,
                                      long long S, long long U,
                                      int segs_per_cta, int long_cut,
                                      long long width) {
  const long long s0 = (long long)blockIdx.x * segs_per_cta;
  const long long ns = min((long long)segs_per_cta, S - s0);
  const long long e0 = (long long)blockIdx.y * width;
  const long long w = min(width, U - e0);
  const long long total = ns * w;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const long long ds = t / w;
    const long long e = e0 + (t - ds * w);
    const long long s = s0 + ds;
    const long long start = seg_start[s];
    const int len = seg_len[s];
    if (len > long_cut) continue;  // the long route writes this one
    T acc = identity<T, OP>();
    for (int k = 0; k < len; ++k) {
      acc = combine<T, OP>(acc, buf[(start + k) * U + e]);
    }
    out[s * U + e] = acc;
  }
}

// ----------------------------------------------------- short route: vector
constexpr int kShortRows = 8;      // R: sf_unpack.SHORT_ROWS
constexpr int kShortMaxK = 4;      // sf_unpack.SHORT_MAX_K
constexpr int kShortWarps = 4;     // sf_unpack.SHORT_WARPS: warps a CTA, at most

// The numbers of sf_unpack.ShortPlan for one vector launch.
struct VecPlan {
  long long UV;      // 16-byte vectors a row
  long long S;       // segments
  unsigned items;    // warp items: ceil(S / (32 / LS)) * chunks
  unsigned chunks;   // chunks a segment row (1 when LS < 32)
  unsigned per_cta;  // items a CTA walks, its warps in turn
  int K;             // vectors a lane folds a chunk, in turn
  int lg_lanes;      // log2 LS: lanes a segment row
  int long_cut;      // longer segments are the long route's
};

// acc (+) x, element by element: V independent folds of T.
template <typename T, int OP>
__device__ __forceinline__ int4 fold16(int4 acc, int4 x) {
  constexpr int V = 16 / (int)sizeof(T);
  T a[V], e[V];
  memcpy(a, &acc, 16);
  memcpy(e, &x, 16);
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = combine<T, OP>(a[i], e[i]);
  memcpy(&acc, a, 16);
  return acc;
}

// Warp item `it` is segment group it / chunks, chunk it % chunks.  Lane
// group `sub` (LS lanes) takes segment group * (32 / LS) + sub; lane lv of
// the group vectors c * LS * K + lv + LS * q, q < K, of that segment's row.
template <typename T, int OP>
__global__ void __launch_bounds__(32 * kShortWarps)
    segment_reduce_vec_kernel(const int4* __restrict__ buf,
                              int4* __restrict__ out,
                              const int* __restrict__ seg_start,
                              const int* __restrict__ seg_len,
                              const VecPlan p) {
  constexpr int V = 16 / (int)sizeof(T);
  T idv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) idv[i] = identity<T, OP>();
  int4 ident;
  memcpy(&ident, idv, 16);
  const int lane = (int)threadIdx.x & 31;
  const int LS = 1 << p.lg_lanes;
  const int sub = lane >> p.lg_lanes, lv = lane & (LS - 1);
  const unsigned W = blockDim.x >> 5;
  const unsigned first = blockIdx.x * p.per_cta;
  const unsigned last = min(first + p.per_cta, p.items);
  for (unsigned it = first + (threadIdx.x >> 5); it < last; it += W) {
    const unsigned grp = it / p.chunks;
    const unsigned c = it - grp * p.chunks;
    const long long s = ((long long)grp << (5 - p.lg_lanes)) + sub;
    if (s >= p.S) continue;
    const int len = __ldg(seg_len + s);
    if (len > p.long_cut) continue;  // the long route writes this one
    const long long v0 = (long long)c * LS * p.K + lv;
    const int4* src = buf + (long long)__ldg(seg_start + s) * p.UV + v0;
    int4* dst = out + s * p.UV + v0;
    for (int q = 0; q < p.K && v0 + (long long)q * LS < p.UV; ++q) {
      const int4* row = src + q * LS;
      int4 acc = ident;
      int k = 0;
      for (; k + kShortRows <= len; k += kShortRows) {
        int4 x[kShortRows];
#pragma unroll
        for (int r = 0; r < kShortRows; ++r) x[r] = __ldcs(row + r * p.UV);
#pragma unroll
        for (int r = 0; r < kShortRows; ++r) acc = fold16<T, OP>(acc, x[r]);
        row += kShortRows * p.UV;
      }
      const int rem = len - k;
      if (rem > 0) {
        int4 x[kShortRows];
#pragma unroll
        for (int r = 0; r < kShortRows; ++r) {
          if (r < rem) x[r] = __ldcs(row + r * p.UV);
        }
#pragma unroll
        for (int r = 0; r < kShortRows; ++r) {
          if (r < rem) acc = fold16<T, OP>(acc, x[r]);
        }
      }
      dst[q * LS] = acc;
    }
  }
}

template <typename T>
int launch(const void* buf, void* out, const int* seg_start,
           const int* seg_len, long long S, long long U, int op,
           int segs_per_cta, int long_cut, long long width, int threads,
           unsigned gx, unsigned gy, cudaStream_t stream) {
  const dim3 grid(gx, gy);
  const T* b = (const T*)buf;
  T* o = (T*)out;
#define SF_SHORT_AS(OPC)                                                   \
  segment_reduce_kernel<T, OPC><<<grid, threads, 0, stream>>>(             \
      b, o, seg_start, seg_len, S, U, segs_per_cta, long_cut, width);      \
  break
  switch (op) {
    case OP_SUM: SF_SHORT_AS(OP_SUM);
    case OP_PROD: SF_SHORT_AS(OP_PROD);
    case OP_MAX: SF_SHORT_AS(OP_MAX);
    case OP_MIN: SF_SHORT_AS(OP_MIN);
    default:
      return -1;
  }
#undef SF_SHORT_AS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(const void* buf, void* out, const int* seg_start,
               const int* seg_len, const VecPlan& p, int op, int warps,
               unsigned grid, cudaStream_t stream) {
  if (((uintptr_t)buf & 15) || ((uintptr_t)out & 15) || p.K < 1 ||
      p.K > kShortMaxK || warps < 1 || warps > kShortWarps ||
      p.lg_lanes < 0 || p.lg_lanes > 5 || (p.lg_lanes < 5 && p.chunks != 1))
    return -1;
  const int4* b = (const int4*)buf;
  int4* o = (int4*)out;
#define SF_VEC_AS(OPC)                                                     \
  segment_reduce_vec_kernel<T, OPC><<<grid, 32 * warps, 0, stream>>>(      \
      b, o, seg_start, seg_len, p);                                        \
  break
  switch (op) {
    case OP_SUM: SF_VEC_AS(OP_SUM);
    case OP_PROD: SF_VEC_AS(OP_PROD);
    case OP_MAX: SF_VEC_AS(OP_MAX);
    case OP_MIN: SF_VEC_AS(OP_MIN);
    default:
      return -1;
  }
#undef SF_VEC_AS
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ long route
// merge_at: of two elements of one segment (values a, b at rows ra, rb),
// the one the sequential max / min fold keeps: a NaN before a number, then
// the extremum, and of two NaNs or two equal values the earlier row.  It is
// associative and commutative, so any tree over any split of the rows
// picks the same element.
template <typename T, int OP>
__device__ __forceinline__ void merge_at(T& a, int& ra, T b, int rb) {
  const bool an = Num<T>::isnan_(a), bn = Num<T>::isnan_(b);
  bool take_b;
  if (an || bn) {
    take_b = an && bn ? rb < ra : bn;
  } else if (OP == OP_MAX ? Num<T>::gt(b, a) : Num<T>::gt(a, b)) {
    take_b = true;
  } else if (OP == OP_MAX ? Num<T>::gt(a, b) : Num<T>::gt(b, a)) {
    take_b = false;
  } else {
    take_b = rb < ra;
  }
  if (take_b) {
    a = b;
    ra = rb;
  }
}

// A pass-1 accumulator.  TRACK (float max / min): the value and its row in
// the chunk; otherwise (integers) the value alone, folded in any order.
template <typename T, int OP, bool TRACK>
struct Acc {
  T v;
  int row;
  __device__ __forceinline__ void init() {
    v = identity<T, OP>();
    row = INT_MAX;
  }
  __device__ __forceinline__ void add(T x, int r) {
    if constexpr (TRACK) {
      merge_at<T, OP>(v, row, x, r);
    } else {
      v = combine<T, OP>(v, x);
    }
  }
};

template <typename T>
__device__ __forceinline__ T shfl_down(T v, int d) {
  if constexpr (sizeof(T) == 8) {
    unsigned long long b;
    memcpy(&b, &v, 8);
    b = __shfl_down_sync(0xffffffffu, b, d);
    memcpy(&v, &b, 8);
  } else {
    unsigned b = 0;
    memcpy(&b, &v, sizeof(T));
    b = __shfl_down_sync(0xffffffffu, b, d);
    memcpy(&v, &b, sizeof(T));
  }
  return v;
}

// Lane 0 gets the fold of the warp's 32 accumulators in lane order (each
// step's lower lane is the left operand).
template <typename T, int OP, bool TRACK>
__device__ __forceinline__ Acc<T, OP, TRACK> warp_reduce(
    Acc<T, OP, TRACK> a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T v = shfl_down(a.v, d);
    const int r = __shfl_down_sync(0xffffffffu, a.row, d);
    if (lane + d < 32) a.add(v, r);
  }
  return a;
}

struct Chunk {
  long long r0;  // first row in buf
  int n;         // rows
};

// Chunk c of the plan: the chunk_seg[c]-th long segment's rows from
// (c - chunk0) * C, at most C of them.
__device__ __forceinline__ Chunk chunk_of(int c, const int* long_start,
                                          const int* long_len,
                                          const int* long_chunk0,
                                          const int* chunk_seg) {
  const int j = chunk_seg[c];
  const long long k = (long long)(c - long_chunk0[j]) * kLongChunkRows;
  return {long_start[j] + k,
          (int)min((long long)kLongChunkRows, (long long)long_len[j] - k)};
}

// Pass 1, U = 1: a CTA folds one chunk's rows into part[c].  The rows are
// contiguous: aligned 16-byte vectors, one a thread in turn, and the scalar
// head / tail that misalign them.
template <typename T, int OP>
__global__ void __launch_bounds__(kLongThreads)
    long_chunk_flat_kernel(const T* __restrict__ buf, T* __restrict__ part,
                           const int* __restrict__ long_start,
                           const int* __restrict__ long_len,
                           const int* __restrict__ long_chunk0,
                           const int* __restrict__ chunk_seg) {
  constexpr bool TRACK = Num<T>::kFloat;
  constexpr int V = 16 / (int)sizeof(T);
  __shared__ __align__(16) unsigned char s_v[(kLongThreads / 32) * 8];
  __shared__ int s_row[kLongThreads / 32];
  const int c = blockIdx.x, t = threadIdx.x;
  const Chunk ch = chunk_of(c, long_start, long_len, long_chunk0, chunk_seg);
  const T* p = buf + ch.r0;
  const int mis = (int)((uintptr_t)p & 15);
  const int head = min(ch.n, ((16 - mis) & 15) / (int)sizeof(T));
  const int nvec = (ch.n - head) / V;
  const int tail0 = head + nvec * V;
  Acc<T, OP, TRACK> acc;
  acc.init();
  if (t < head) acc.add(p[t], t);
  const int4* pv = reinterpret_cast<const int4*>(p + head);
#pragma unroll 4
  for (int v = t; v < nvec; v += kLongThreads) {
    const int4 raw = __ldg(pv + v);
    T e[V];
    memcpy(e, &raw, 16);
#pragma unroll
    for (int q = 0; q < V; ++q) acc.add(e[q], head + v * V + q);
  }
  if (tail0 + t < ch.n) acc.add(p[tail0 + t], tail0 + t);

  acc = warp_reduce(acc);
  T* sv = reinterpret_cast<T*>(s_v);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    sv[warp] = acc.v;
    s_row[warp] = acc.row;
  }
  __syncthreads();
  if (warp == 0) {
    Acc<T, OP, TRACK> b;
    b.init();
    if (lane < kLongThreads / 32) {
      b.v = sv[lane];
      b.row = s_row[lane];
    }
    b = warp_reduce(b);
    if (lane == 0) part[c] = b.v;
  }
}

// Pass 1, U > 1: a CTA folds one chunk's rows for a tile of EW unit
// vectors (VEC elements each) into part[c]'s tile.  Thread t owns vector
// t % EW of the tile and the rows t / EW, + kLongThreads / EW, ...; then a
// tree over those row lanes in shared memory, the earlier lane left.
template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(kLongThreads)
    long_chunk_rows_kernel(const T* __restrict__ buf, T* __restrict__ part,
                           const int* __restrict__ long_start,
                           const int* __restrict__ long_len,
                           const int* __restrict__ long_chunk0,
                           const int* __restrict__ chunk_seg, long long U,
                           int EW) {
  constexpr bool TRACK = Num<T>::kFloat;
  __shared__ __align__(16) unsigned char s_v[kLongThreads * 16];
  __shared__ int s_row[TRACK ? kLongThreads * VEC : 1];
  const int c = blockIdx.x, t = threadIdx.x;
  const Chunk ch = chunk_of(c, long_start, long_len, long_chunk0, chunk_seg);
  const int rl = kLongThreads / EW, rg = t / EW, el = t - rg * EW;
  const long long ev = (long long)blockIdx.y * EW + el;
  const bool live = rg < rl && ev * VEC < U;
  Acc<T, OP, TRACK> acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q].init();
  if (live) {
    const T* base = buf + ch.r0 * U + ev * VEC;
#pragma unroll 4
    for (int r = rg; r < ch.n; r += rl) {
      if constexpr (VEC == 1) {
        acc[0].add(base[(long long)r * U], r);
      } else {
        const int4 raw =
            __ldg(reinterpret_cast<const int4*>(base + (long long)r * U));
        T e[VEC];
        memcpy(e, &raw, 16);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q].add(e[q], r);
      }
    }
  }
  T* sv = reinterpret_cast<T*>(s_v);
  for (int d = 1; d < rl; d <<= 1) {
    if (live && rg % (2 * d) == d) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        sv[t * VEC + q] = acc[q].v;
        if constexpr (TRACK) s_row[t * VEC + q] = acc[q].row;
      }
    }
    __syncthreads();
    if (live && rg % (2 * d) == 0 && rg + d < rl) {
      const int o = (t + d * EW) * VEC;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        if constexpr (TRACK) {
          acc[q].add(sv[o + q], s_row[o + q]);
        } else {
          acc[q].add(sv[o + q], 0);
        }
      }
    }
    __syncthreads();
  }
  if (live && rg == 0) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) part[c * U + ev * VEC + q] = acc[q].v;
  }
}

// Pass 2: a warp per (long segment j, unit element e) folds the segment's
// chunk partials in chunk order into out[long_seg[j], e].
template <typename T, int OP>
__global__ void __launch_bounds__(32 * kFoldWarps)
    long_fold_kernel(const T* __restrict__ part, T* __restrict__ out,
                     const int* __restrict__ long_seg,
                     const int* __restrict__ long_len,
                     const int* __restrict__ long_chunk0, long long n_long,
                     long long U) {
  const long long item =
      (long long)blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  if (item >= n_long * U) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long j = item / U, e = item - j * U;
  const int nc = (int)(((long long)long_len[j] + kLongChunkRows - 1) /
                       kLongChunkRows);
  const long long c0 = long_chunk0[j];
  const int q = (nc + 31) / 32;
  const int lo = min(lane * q, nc), hi = min(lo + q, nc);
  // kFoldLoads partials in flight a lane; a missing one is the identity,
  // which every order-free combine leaves unchanged
  T acc = identity<T, OP>();
  for (int c = lo; c < hi; c += kFoldLoads) {
    T v[kFoldLoads];
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      v[k] = c + k < hi ? part[(c0 + c + k) * U + e] : identity<T, OP>();
    }
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) acc = combine<T, OP>(acc, v[k]);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T v = shfl_down(acc, d);
    if (lane + d < 32) acc = combine<T, OP>(acc, v);
  }
  if (lane == 0) out[(long long)long_seg[j] * U + e] = acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n elements from g into shared memory at sb + (g's offset from 16-byte
// alignment), so that g's aligned 16-byte vectors land on aligned vectors:
// those by cp.async, the head and tail around them by plain copies.
template <typename T>
__device__ __forceinline__ void copy_piece(const T* g, int n,
                                           unsigned char* sb) {
  constexpr int V = 16 / (int)sizeof(T);
  const int skew = (int)((uintptr_t)g & 15);
  T* d = reinterpret_cast<T*>(sb + skew);
  const int head = min(n, ((16 - skew) & 15) / (int)sizeof(T));
  const int nv = (n - head) / V;
  const int tail0 = head + nv * V;
  for (int x = threadIdx.x; x < head; x += blockDim.x) d[x] = g[x];
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    cp_async16(d + head + v * V, g + head + v * V);
  }
  for (int x = tail0 + threadIdx.x; x < n; x += blockDim.x) d[x] = g[x];
}

// acc (+) src[0] (+) src[U] (+) ... over n rows in order, software
// pipelined: the next kG rows' shared-memory loads are in flight while the
// current kG are combined, so the loop runs at the combine's latency.
constexpr int kG = 16;

template <typename T, int OP>
__device__ __forceinline__ T fold_staged(T acc, const T* src, int n, int U) {
  T a[kG], b[kG];
  int r = 0;
  if (n >= kG) {
#pragma unroll
    for (int q = 0; q < kG; ++q) a[q] = src[q * U];
    for (; r + 2 * kG <= n; r += kG) {
#pragma unroll
      for (int q = 0; q < kG; ++q) b[q] = src[(r + kG + q) * U];
#pragma unroll
      for (int q = 0; q < kG; ++q) acc = combine<T, OP>(acc, a[q]);
#pragma unroll
      for (int q = 0; q < kG; ++q) a[q] = b[q];
    }
#pragma unroll
    for (int q = 0; q < kG; ++q) acc = combine<T, OP>(acc, a[q]);
    r += kG;
  }
  for (; r < n; ++r) acc = combine<T, OP>(acc, src[r * U]);
  return acc;
}

// fold_staged for U = 1: the n contiguous staged elements read as aligned
// 16-byte vectors (scalar head and tail), kVG vectors a group and two
// groups in flight in turn, so the thread issues about one instruction per
// combine beside the chain.
constexpr int kVG = 4;

template <typename T, int OP>
__device__ __forceinline__ T fold_vec(T acc, const int4* g) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < kVG; ++i) {
    T e[V];
    memcpy(e, &g[i], 16);
#pragma unroll
    for (int q = 0; q < V; ++q) acc = combine<T, OP>(acc, e[q]);
  }
  return acc;
}

template <typename T, int OP>
__device__ __forceinline__ T fold_staged1(T acc, const T* src, int n) {
  constexpr int V = 16 / (int)sizeof(T);
  const int head =
      min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T)));
  int r = 0;
  for (; r < head; ++r) acc = combine<T, OP>(acc, src[r]);
  const int4* pv = reinterpret_cast<const int4*>(src + head);
  const int groups = (n - head) / (V * kVG);
  if (groups > 0) {
    int4 a[kVG], b[kVG];
#pragma unroll
    for (int i = 0; i < kVG; ++i) a[i] = pv[i];
    for (int gi = 0;;) {
      // a holds group gi
      bool more = gi + 1 < groups;
      if (more) {
#pragma unroll
        for (int i = 0; i < kVG; ++i) b[i] = pv[(gi + 1) * kVG + i];
      }
      acc = fold_vec<T, OP>(acc, a);
      if (!more) break;
      ++gi;  // b holds group gi
      more = gi + 1 < groups;
      if (more) {
#pragma unroll
        for (int i = 0; i < kVG; ++i) a[i] = pv[(gi + 1) * kVG + i];
      }
      acc = fold_vec<T, OP>(acc, b);
      if (!more) break;
      ++gi;
    }
    r = head + groups * V * kVG;
  }
  for (; r < n; ++r) acc = combine<T, OP>(acc, src[r]);
  return acc;
}

// The order-dependent route: CTA (j, tile) folds long segment j's unit
// elements [tile * EW, + EW) over all its rows in buffer order.  A stage is
// R rows: one contiguous piece when the tile is the whole unit (EW == U),
// else R pieces of EW elements, each in a slot of EW * size + 16 bytes.
template <typename T, int OP>
__global__ void __launch_bounds__(kLongThreads)
    long_ordered_kernel(const T* __restrict__ buf, T* __restrict__ out,
                        const int* __restrict__ long_seg,
                        const int* __restrict__ long_start,
                        const int* __restrict__ long_len, long long U,
                        int EW) {
  __shared__ __align__(16) unsigned char stage[kStages][kStageBytes];
  const int j = blockIdx.x, t = threadIdx.x;
  const long long e0 = (long long)blockIdx.y * EW;
  const int ew = (int)min((long long)EW, U - e0);
  const bool flat = EW == U;
  const long long first = long_start[j], len = long_len[j];
  const int slot = EW * (int)sizeof(T) + 16;
  const int R = flat ? (kStageBytes - 16) / (int)(U * sizeof(T))
                     : kStageBytes / slot;
  const long long nst = (len + R - 1) / R;

  auto issue = [&](long long s) {
    unsigned char* sb = stage[s % kStages];
    const long long r0 = first + s * R;
    const int nr = (int)min((long long)R, len - s * R);
    if (flat) {
      copy_piece<T>(buf + r0 * U, nr * (int)U, sb);
    } else {
      for (int i = 0; i < nr; ++i) {
        copy_piece<T>(buf + (r0 + i) * U + e0, ew, sb + i * slot);
      }
    }
  };

  T acc = identity<T, OP>();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  for (long long s = 0; s < nst; ++s) {
    if (s + kStages - 1 < nst) issue(s + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (t < ew) {
      const int nr = (int)min((long long)R, len - s * R);
      const long long r0 = first + s * R;
      const unsigned char* sb = stage[s % kStages];
      if (flat) {
        const T* src =
            reinterpret_cast<const T*>(sb + ((uintptr_t)(buf + r0 * U) & 15)) +
            t;
        acc = U == 1 ? fold_staged1<T, OP>(acc, src, nr)
                     : fold_staged<T, OP>(acc, src, nr, (int)U);
      } else {
        for (int r = 0; r < nr; ++r) {
          const int skew = (int)((uintptr_t)(buf + (r0 + r) * U + e0) & 15);
          acc = combine<T, OP>(
              acc, reinterpret_cast<const T*>(sb + r * slot + skew)[t]);
        }
      }
    }
    __syncthreads();
  }
  if (t < ew) out[(long long)long_seg[j] * U + e0 + t] = acc;
}

template <typename T, int OP>
int launch_long_op(const void* buf, void* out, void* part,
                   const int* long_seg, const int* long_start,
                   const int* long_len, const int* long_chunk0,
                   const int* chunk_seg, long long n_long, long long n_chunks,
                   long long U, cudaStream_t stream) {
  const T* b = (const T*)buf;
  T* o = (T*)out;
  if (n_long == 0) return 0;
  if constexpr (Num<T>::kFloat && (OP == OP_SUM || OP == OP_PROD)) {
    const int EW = (int)min(U, (long long)kLongThreads);
    const long long tiles = (U + EW - 1) / EW;
    if (tiles > 65535 || n_long > INT_MAX) return -1;
    long_ordered_kernel<T, OP>
        <<<dim3((unsigned)n_long, (unsigned)tiles), kLongThreads, 0,
           stream>>>(b, o, long_seg, long_start, long_len, U, EW);
  } else {
    T* p = (T*)part;
    if (p == nullptr || n_chunks > INT_MAX) return -1;
    if (U == 1) {
      long_chunk_flat_kernel<T, OP><<<(unsigned)n_chunks, kLongThreads, 0,
                                      stream>>>(b, p, long_start, long_len,
                                                long_chunk0, chunk_seg);
    } else {
      constexpr int V = 16 / (int)sizeof(T);
      const bool vec = U % V == 0 && ((uintptr_t)buf & 15) == 0;
      const long long UW = vec ? U / V : U;
      const int EW = (int)min(UW, (long long)kLongThreads);
      const long long tiles = (UW + EW - 1) / EW;
      if (tiles > 65535) return -1;
      const dim3 grid((unsigned)n_chunks, (unsigned)tiles);
      if (vec) {
        long_chunk_rows_kernel<T, OP, V><<<grid, kLongThreads, 0, stream>>>(
            b, p, long_start, long_len, long_chunk0, chunk_seg, U, EW);
      } else {
        long_chunk_rows_kernel<T, OP, 1><<<grid, kLongThreads, 0, stream>>>(
            b, p, long_start, long_len, long_chunk0, chunk_seg, U, EW);
      }
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
    const long long blocks = (n_long * U + kFoldWarps - 1) / kFoldWarps;
    if (blocks > INT_MAX) return -1;
    long_fold_kernel<T, OP><<<(unsigned)blocks, 32 * kFoldWarps, 0,
                              stream>>>(p, o, long_seg, long_len,
                                        long_chunk0, n_long, U);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_long(const void* buf, void* out, void* part, const int* long_seg,
                const int* long_start, const int* long_len,
                const int* long_chunk0, const int* chunk_seg,
                long long n_long, long long n_chunks, long long U, int op,
                cudaStream_t stream) {
#define SF_LONG_AS(OPC)                                                   \
  return launch_long_op<T, OPC>(buf, out, part, long_seg, long_start,     \
                                long_len, long_chunk0, chunk_seg, n_long, \
                                n_chunks, U, stream)
  switch (op) {
    case OP_SUM: SF_LONG_AS(OP_SUM);
    case OP_PROD: SF_LONG_AS(OP_PROD);
    case OP_MAX: SF_LONG_AS(OP_MAX);
    case OP_MIN: SF_LONG_AS(OP_MIN);
    default:
      return -1;
  }
#undef SF_LONG_AS
}

}  // namespace

extern "C" {

// Dtype codes: 0 float32, 1 float64, 2 int32, 3 bfloat16, 4 int8, 5 uint8,
// 6 int16, 7 int64, 8 float16.  Op codes: 0 sum, 1 prod, 2 max, 3 min.
// Returns -1 for an unknown code or a plan the kernel cannot take.
// Segments longer than long_cut are left to sf_segment_reduce_long.

// The short route's scalar kernel on short_plan's (gx, gy) grid of
// `threads`-thread CTAs: segs_per_cta segments and `width` unit columns a
// CTA.
int sf_segment_reduce(const void* buf, void* out, const int* seg_start,
                      const int* seg_len, long long S, long long U, int dtype,
                      int op, int segs_per_cta, int long_cut, long long width,
                      int threads, int gx, int gy, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (gx < 1 || gy < 1 || gy > 65535 || threads < 32 || threads > 1024)
    return -1;
#define SF_REDUCE_AS(T)                                                  \
  return launch<T>(buf, out, seg_start, seg_len, S, U, op, segs_per_cta, \
                   long_cut, width, threads, (unsigned)gx, (unsigned)gy, s)
  switch (dtype) {
    case 0: SF_REDUCE_AS(float);
    case 1: SF_REDUCE_AS(double);
    case 2: SF_REDUCE_AS(int);
    case 3: SF_REDUCE_AS(__nv_bfloat16);
    case 4: SF_REDUCE_AS(signed char);
    case 5: SF_REDUCE_AS(unsigned char);
    case 6: SF_REDUCE_AS(short);
    case 7: SF_REDUCE_AS(long long);
    case 8: SF_REDUCE_AS(__half);
    default:
      return -1;
  }
#undef SF_REDUCE_AS
}

// The short route's vector kernel: rows of UV 16-byte vectors, buf and out
// on 16-byte boundaries, short_plan's items / chunks / per_cta / K / log2
// lanes, `grid` CTAs of `warps` warps.
int sf_segment_reduce_vec(const void* buf, void* out, const int* seg_start,
                          const int* seg_len, long long S, long long UV,
                          int dtype, int op, int long_cut, int items,
                          int chunks, int per_cta, int K, int lg_lanes,
                          int warps, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (items < 1 || chunks < 1 || per_cta < 1 || grid < 1) return -1;
  const VecPlan p = {UV, S, (unsigned)items, (unsigned)chunks,
                     (unsigned)per_cta, K, lg_lanes, long_cut};
#define SF_VEC_REDUCE_AS(T) \
  return launch_vec<T>(buf, out, seg_start, seg_len, p, op, warps, \
                       (unsigned)grid, s)
  switch (dtype) {
    case 0: SF_VEC_REDUCE_AS(float);
    case 1: SF_VEC_REDUCE_AS(double);
    case 2: SF_VEC_REDUCE_AS(int);
    case 3: SF_VEC_REDUCE_AS(__nv_bfloat16);
    case 4: SF_VEC_REDUCE_AS(signed char);
    case 5: SF_VEC_REDUCE_AS(unsigned char);
    case 6: SF_VEC_REDUCE_AS(short);
    case 7: SF_VEC_REDUCE_AS(long long);
    case 8: SF_VEC_REDUCE_AS(__half);
    default:
      return -1;
  }
#undef SF_VEC_REDUCE_AS
}

// The long route for the plan's n_long segments (ids long_seg, rows
// long_start / long_len, first chunk long_chunk0) and n_chunks chunks
// (chunk_seg: each chunk's index into the long lists).  The order-free
// route needs part, n_chunks * U scratch elements; the order-dependent one
// (float sum / prod) takes none.
int sf_segment_reduce_long(const void* buf, void* out, void* part,
                           const int* long_seg, const int* long_start,
                           const int* long_len, const int* long_chunk0,
                           const int* chunk_seg, long long n_long,
                           long long n_chunks, long long U, int dtype, int op,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SF_LONG_AS(T)                                                      \
  return launch_long<T>(buf, out, part, long_seg, long_start, long_len,    \
                        long_chunk0, chunk_seg, n_long, n_chunks, U, op, s)
  switch (dtype) {
    case 0: SF_LONG_AS(float);
    case 1: SF_LONG_AS(double);
    case 2: SF_LONG_AS(int);
    case 3: SF_LONG_AS(__nv_bfloat16);
    case 4: SF_LONG_AS(signed char);
    case 5: SF_LONG_AS(unsigned char);
    case 6: SF_LONG_AS(short);
    case 7: SF_LONG_AS(long long);
    case 8: SF_LONG_AS(__half);
    default:
      return -1;
  }
#undef SF_LONG_AS
}

}  // extern "C"
