// SF pack kernels for Hopper (sm_90a): row gathers and the fused local bcast.
//
// Replaces the Pallas functions of repro/kernels/sf_pack.py:
//   pack          (sf_pack.py:60)   -> sf_gather_rows, one row per CTA
//   pack_blocked  (sf_pack.py:96)   -> sf_gather_narrow for rows of 1-4
//                                      32-bit words; sf_gather_rows (generic
//                                      loop) for wider or odd rows
//   pack_strided  (sf_pack.py:177)  -> sf_strided_panels (aligned 16-byte
//                                      vectors, a warp per panel item);
//                                      sf_strided_lanes for panels of 1-4
//                                      words; sf_gather_strided (generic
//                                      loop) for rows that are not whole
//                                      32-bit words or bases off 4 bytes
//   bcast_fused   (sf_pack.py:141)  -> sf_bcast_narrow_copy / _cast for rows
//                                      of 1-4 words / elements;
//                                      sf_bcast_fused_copy / _cast otherwise
//
// Bound on this card: bytes.  A gather does no arithmetic; it must read each
// needed source row once, each index once and write each output row once,
// so its floor is those bytes over the 3.35 TB/s of HBM3: 0.00082 ms for the
// SpMV ghost pack (229,376 f32 rows, 2.75 MB), 0.0108 ms for the general
// SF's bcast pack (4,194,304 f32 rows, about 36 MB), 0.0093 ms for the fused
// bcast of the local-only SF (1,114,112 leaves of 3 f32, 31 MB).  The first
// is so small that launch, CTA dispatch and two dependent memory round trips
// (index, then row) set its time; the others need about 2 MB in flight
// across the card (Little's law at ~0.7 us) to reach the bound.
//
// Narrow rows (the redesign): rows of 1-4 32-bit words, 32-bit-aligned
// sources, a 16-byte-aligned output.  Each thread moves 4 rows' worth of
// words per tile and starts all its index loads, then all its row loads
// (through the read-only path), before its first store, so a thread has 4x
// the bytes of the one-word-per-thread kernel in flight; the row width is a
// template parameter, row indices are 32-bit, and no division by a runtime
// value is left in the loop.  Two layouts:
//   rows   where one load carries a row (1, 2 or 4 words, aligned): a
//          thread owns 4 consecutive rows, loads their 4 indices in one
//          16-byte load (4 scalar loads when the index array starts off the
//          16-byte alignment) and writes them as 16-byte vectors (4 f32
//          rows make one uint4), so a warp stores 512 contiguous bytes and
//          the fused bcast reads each src_of_leaf entry once;
//   lanes  otherwise (3-word rows, rows off the vector alignment): a warp
//          owns 128 consecutive rows and lane l moves words l, l + 32, ...
//          of them.  A thread that loaded a 12-byte row as three words
//          sent three sector requests to L1/L2 per row; neighbouring lanes
//          reading neighbouring words of a row send one, which is what
//          bounds a gather of random rows (the 4M-row pack of 12-byte rows
//          ran 1.3x slower in the rows layout than in this one).
// The cast keeps the rows layout (it packs the converted bits of its 4 rows
// into the widest vectors their size allows; on the card it was no slower
// than the lanes layout).  A CTA of 128-256 threads walks tiles of
// 4 x threads rows; the grid gives every CTA the same number of tiles within
// the CTAs the SMs hold (one short wave for the SpMV pack, 4 tiles per CTA
// for the 4M-row pack).  The copy bcast reads src_of_leaf and the leaf rows
// evict-first (ld.global.cs) so that the root rows, read at random, stay in
// L2 from call to call.  The plan (row width, layout, index vector, cache
// flags, threads, tile, grid) is computed in Python (kernels/sf_pack.py,
// row_plan), where a CPU test walks it in numpy and checks that every
// output byte is written exactly once and every vector access is aligned.
// Hopper's TMA has no row-gather mode, so the gather stays on per-thread
// loads.
//
// Generic rows (the first design, kept for wide rows, rows that are not
// whole 32-bit words, and pointers off 4-byte alignment): rows are copied
// as raw bytes in the widest word (16/8/4/2/1 bytes) that the row size and
// base pointers allow; neighbouring threads take neighbouring words of a
// row, then the next row of a block of rows_per_cta rows.  pack uses it,
// and pack_strided for such rows (its strided form divides every word's
// index into (i, j, k) with 64-bit divisions).
//
// The strided pack (the redesign): every (j, k) panel of a box is dx rows,
// contiguous in the source and in the output, so the pack is dy x dz
// copies with no index; its bound is bytes (each box byte read once and
// written once: 0.00057 ms for the box halo SF's 100x100x8 rows of 3 f32,
// 0.120 ms for the 256^3 interior of a 258^3 ghosted array of rows of 3
// f32, whose 206 MB source is four times L2).  A warp owns an item (up to
// 32 x K aligned 16-byte output vectors of a panel); panel origins come
// from (j, k) once per item, and each lane starts all its loads before its
// first store.  A panel's source and output starts may disagree mod 16
// (the box halo's by 4 bytes: its first row is 36 bytes into a 16-byte
// granule); aligned source vectors are then shifted by whole words through
// warp shuffles.  Staging the vectors through shared memory (cp.async in,
// the shift on the way out) was tried and removed: no faster on the card
// (PERF.md).
// Panels of 1-4 words (x-faces) take the lanes layout with the panel's
// source word computed from (j, k).  Hopper's TMA box copy was tried and
// removed: its box must start on a 16-byte boundary (the card faults on a
// box 4 or 8 bytes in), which the box halo's rows are not, and where a box
// did qualify it read slower than the vectors (PERF.md).
//
// The fused bcast avoids the packed intermediate entirely: the setup builds
// the inverse map src_of_leaf[l] (root row feeding leaf l, or -1), and one
// race-free pass writes every output row exactly once, from the root row or
// from the old leaf row.
//
// The checked gathers (CHECK, asked for by nsrc >= 0 in sf_gather_rows and
// by flag 16 in sf_gather_narrow) test each index against the nsrc rows of
// their source on the device: one out of range prints the row and stops
// the kernel with a trap, which fails the CUDA context loudly.  They take an
// index written on the device this step (DynPlan's routing,
// kernels/ops.py pack_rows(dynamic=True)) with no host read of its range.
// A plan's index lists are checked once on the host at setup, so their
// gathers take the unchecked instances: with the check compiled in, the
// SpMV's narrow pack read 0.00192 ms against 0.00170 (PERF.md).
//
// Every entry point returns cudaGetLastError() after its launch (-1 for an
// unsupported dtype pair, row width or launch plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>


namespace {

struct Box {
  long long start, dx, dy, sy, sz;
};

// A gather met an index outside the nsrc rows of its source: report it and
// stop the kernel (the CUDA context fails, and the next synchronisation
// raises).  Out of line, so that the copy loops keep their registers.
__device__ __noinline__ void bad_index(long long row, long long s,
                                       long long nsrc) {
  printf("sf_pack gather: idx[%lld] = %lld outside [0, %lld)\n", row, s,
         nsrc);
  __trap();
}

template <typename W, bool STRIDED, bool CHECK>
__global__ void gather_rows_kernel(const W* __restrict__ src,
                                   W* __restrict__ dst,
                                   const int* __restrict__ idx, long long M,
                                   long long wpr, int rows_per_cta, Box box,
                                   long long nsrc) {
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long nrows = min((long long)rows_per_cta, M - r0);
  const long long total = nrows * wpr;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const long long dr = t / wpr;
    const long long w = t - dr * wpr;
    const long long r = r0 + dr;
    long long s;
    if (STRIDED) {
      const long long i = r % box.dx;
      const long long jk = r / box.dx;
      s = box.start + i + (jk % box.dy) * box.sy + (jk / box.dy) * box.sz;
    } else {
      s = idx[r];
      if (CHECK && (unsigned long long)s >= (unsigned long long)nsrc)
        bad_index(r, s, nsrc);
    }
    dst[r * wpr + w] = src[s * wpr + w];
  }
}

template <typename W>
__global__ void bcast_copy_kernel(const W* __restrict__ root,
                                  const W* __restrict__ leaf,
                                  W* __restrict__ out,
                                  const int* __restrict__ src_of_leaf,
                                  long long Nl, long long wpr,
                                  int rows_per_cta) {
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long nrows = min((long long)rows_per_cta, Nl - r0);
  const long long total = nrows * wpr;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const long long dr = t / wpr;
    const long long w = t - dr * wpr;
    const long long r = r0 + dr;
    const long long s = src_of_leaf[r];
    out[r * wpr + w] = s >= 0 ? root[s * wpr + w] : leaf[r * wpr + w];
  }
}

// Conversions as torch's Tensor.to performs them: float -> bf16 rounds to
// nearest even; double -> bf16 goes through float, as c10::BFloat16 does.
template <typename TO>
__device__ __forceinline__ TO convert(float v);
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }
template <>
__device__ __forceinline__ double convert<double>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TO, typename TI>
__device__ __forceinline__ TO cast(TI v) {
  return convert<TO>((float)v);
}
template <>
__device__ __forceinline__ double cast<double, float>(float v) { return v; }
template <>
__device__ __forceinline__ float cast<float, double>(double v) {
  return (float)v;
}
template <>
__device__ __forceinline__ double cast<double, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return (double)__bfloat162float(v);
}
template <>
__device__ __forceinline__ float cast<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TR, typename TL>
__global__ void bcast_cast_kernel(const TR* __restrict__ root,
                                  const TL* __restrict__ leaf,
                                  TL* __restrict__ out,
                                  const int* __restrict__ src_of_leaf,
                                  long long Nl, long long U,
                                  int rows_per_cta) {
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long nrows = min((long long)rows_per_cta, Nl - r0);
  const long long total = nrows * U;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const long long dr = t / U;
    const long long e = t - dr * U;
    const long long r = r0 + dr;
    const long long s = src_of_leaf[r];
    out[r * U + e] = s >= 0 ? cast<TL, TR>(root[s * U + e]) : leaf[r * U + e];
  }
}

int word_bytes(uintptr_t a, uintptr_t b, uintptr_t c, long long row_bytes) {
  const uintptr_t p = a | b | c | (uintptr_t)row_bytes;
  if (p % 16 == 0) return 16;
  if (p % 8 == 0) return 8;
  if (p % 4 == 0) return 4;
  if (p % 2 == 0) return 2;
  return 1;
}

int threads_for(long long items_per_cta) {
  const long long warps = (items_per_cta + 31) / 32;
  return (int)(warps >= 8 ? 256 : (warps < 1 ? 32 : warps * 32));
}

// Rows of W words; the checked instance where nsrc >= 0 (index gathers).
template <typename W, bool STRIDED>
void gather_words(const void* src, void* dst, const int* idx, long long M,
                  long long wpr, int rows_per_cta, Box box, long long nsrc,
                  unsigned grid, int threads, cudaStream_t stream) {
  if (!STRIDED && nsrc >= 0)
    gather_rows_kernel<W, STRIDED, !STRIDED><<<grid, threads, 0, stream>>>(
        (const W*)src, (W*)dst, idx, M, wpr, rows_per_cta, box, nsrc);
  else
    gather_rows_kernel<W, STRIDED, false><<<grid, threads, 0, stream>>>(
        (const W*)src, (W*)dst, idx, M, wpr, rows_per_cta, box, nsrc);
}

template <bool STRIDED>
int launch_gather(const void* src, void* dst, const int* idx, long long M,
                  long long row_bytes, int rows_per_cta, Box box,
                  long long nsrc, cudaStream_t stream) {
  const int wb = word_bytes((uintptr_t)src, (uintptr_t)dst, 0, row_bytes);
  const long long wpr = row_bytes / wb;
  const int threads = threads_for((long long)rows_per_cta * wpr);
  const unsigned grid = (unsigned)((M + rows_per_cta - 1) / rows_per_cta);
  switch (wb) {
    case 16:
      gather_words<uint4, STRIDED>(src, dst, idx, M, wpr, rows_per_cta, box,
                                   nsrc, grid, threads, stream);
      break;
    case 8:
      gather_words<uint2, STRIDED>(src, dst, idx, M, wpr, rows_per_cta, box,
                                   nsrc, grid, threads, stream);
      break;
    case 4:
      gather_words<unsigned, STRIDED>(src, dst, idx, M, wpr, rows_per_cta,
                                      box, nsrc, grid, threads, stream);
      break;
    case 2:
      gather_words<unsigned short, STRIDED>(src, dst, idx, M, wpr,
                                            rows_per_cta, box, nsrc, grid,
                                            threads, stream);
      break;
    default:
      gather_words<unsigned char, STRIDED>(src, dst, idx, M, wpr,
                                           rows_per_cta, box, nsrc, grid,
                                           threads, stream);
  }
  return (int)cudaGetLastError();
}

template <typename TR, typename TL>
void launch_cast(const void* root, const void* leaf, void* out,
                 const int* src, long long Nl, long long U, int rows_per_cta,
                 cudaStream_t stream) {
  const int threads = threads_for((long long)rows_per_cta * U);
  const unsigned grid = (unsigned)((Nl + rows_per_cta - 1) / rows_per_cta);
  bcast_cast_kernel<TR, TL><<<grid, threads, 0, stream>>>(
      (const TR*)root, (const TL*)leaf, (TL*)out, src, Nl, U, rows_per_cta);
}


// ------------------------------------------------------------ narrow rows
constexpr int kRows = 4;          // output rows a thread owns
constexpr int kMaxThreads = 256;  // threads of a CTA
constexpr int kIdxVec = 1;        // flag: indices by one 16-byte load
constexpr int kStreaming = 2;     // flag: evict-first (.cs) output stores
constexpr int kLanes = 4;         // flag: the warp-cooperative layout
constexpr int kStreamLoads = 8;   // flag: evict-first index and leaf loads
constexpr int kCheckIdx = 16;     // flag: the checked gather (CHECK)

// A load through the read-only path, or an evict-first (.cs) load.
template <typename T>
__device__ __forceinline__ T ld(const T* p, bool stream) {
  return stream ? __ldcs(p) : __ldg(p);
}

// A row of W 32-bit words (W = 1, 2, 4) in one load.
template <int W>
struct Row;
template <>
struct Row<1> {
  static __device__ __forceinline__ void load(const unsigned* p,
                                              unsigned* w, bool stream) {
    w[0] = ld(p, stream);
  }
};
template <>
struct Row<2> {
  static __device__ __forceinline__ void load(const unsigned* p,
                                              unsigned* w, bool stream) {
    const uint2 v = ld(reinterpret_cast<const uint2*>(p), stream);
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct Row<4> {
  static __device__ __forceinline__ void load(const unsigned* p,
                                              unsigned* w, bool stream) {
    const uint4 v = ld(reinterpret_cast<const uint4*>(p), stream);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};

// The kRows indices of rows row0 .. row0 + 3.
__device__ __forceinline__ void load_indices(const int* __restrict__ idx,
                                             int row0, bool vec, bool stream,
                                             int (&s)[kRows]) {
  if (vec) {
    const int4 v = ld(reinterpret_cast<const int4*>(idx + row0), stream);
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) s[j] = ld(idx + row0 + j, stream);
  }
}

// NW words to dst in the widest vectors NW allows; dst is aligned to them.
template <int NW>
__device__ __forceinline__ void store_words(unsigned* __restrict__ dst,
                                            const unsigned (&w)[NW],
                                            bool streaming) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 v = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                 w[4 * k + 3]);
      uint4* p = reinterpret_cast<uint4*>(dst) + k;
      if (streaming) __stcs(p, v); else *p = v;
    }
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) {
      const uint2 v = make_uint2(w[2 * k], w[2 * k + 1]);
      uint2* p = reinterpret_cast<uint2*>(dst) + k;
      if (streaming) __stcs(p, v); else *p = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (streaming) __stcs(dst + k, w[k]); else dst[k] = w[k];
    }
  }
}

// The rows layout, for rows that one load carries (WPR = 1, 2, 4 words,
// aligned).  A thread owns kRows consecutive rows: their indices in one
// 16-byte load (idx_vec) or kRows scalar loads, then kRows independent row
// loads, then the kRows x WPR words as 16-byte stores.  Gather (BCAST
// false): dst[r] = src[idx[r]].  Fused bcast (BCAST true): dst[r] =
// src[idx[r]] (root row) where idx[r] >= 0, else leaf[r].
template <int WPR, bool BCAST, bool CHECK>
__global__ void __launch_bounds__(kMaxThreads)
    rows_copy_kernel(const unsigned* __restrict__ src,
                     const unsigned* __restrict__ leaf,
                     unsigned* __restrict__ dst, const int* __restrict__ idx,
                     int M, int tile_rows, int tiles, int flags, int nsrc) {
  const bool idx_vec = flags & kIdxVec, streaming = flags & kStreaming;
  const bool stream = flags & kStreamLoads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tile_rows + (int)threadIdx.x * kRows;
    if (row0 + kRows <= M) {
      int s[kRows];
      load_indices(idx, row0, idx_vec, stream, s);
      if (CHECK) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if ((unsigned)s[j] >= (unsigned)nsrc)
            bad_index(row0 + j, s[j], nsrc);
      }
      unsigned w[kRows * WPR];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const bool own = BCAST && s[j] < 0;
        Row<WPR>::load((own ? leaf + (long long)(row0 + j) * WPR
                            : src + (long long)s[j] * WPR),
                       w + j * WPR, own && stream);
      }
      store_words(dst + (long long)row0 * WPR, w, streaming);
    } else {
      for (int r = row0; r < M; ++r) {  // the ragged end: at most 3 rows
        const int s = __ldg(idx + r);
        if (CHECK && (unsigned)s >= (unsigned)nsrc) bad_index(r, s, nsrc);
        const bool own = BCAST && s < 0;
        unsigned w[WPR];
        Row<WPR>::load(own ? leaf + (long long)r * WPR
                           : src + (long long)s * WPR,
                       w, false);
#pragma unroll
        for (int k = 0; k < WPR; ++k) dst[(long long)r * WPR + k] = w[k];
      }
    }
  }
}

// Where the lanes kernel finds row r.  key(r) is read for all of a lane's
// rows before any row load; word(key) is the first source word of the row.
// An index list: key = idx[r] (in the fused bcast, < 0 means the leaf row).
// A gather's key must name one of the nsrc source rows.
template <int WPR>
struct IndexRows {
  const int* __restrict__ idx;
  int nsrc;
  __device__ __forceinline__ int key(int r, bool stream) const {
    return ld(idx + r, stream);
  }
  __device__ __forceinline__ void check(int r, int key) const {
    if ((unsigned)key >= (unsigned)nsrc) bad_index(r, key, nsrc);
  }
  __device__ __forceinline__ long long word(int key) const {
    return (long long)key * WPR;
  }
};

// The panels of a 3D box (pack_strided's x-faces and other panels of at
// most 4 words): row r is panel (j, k) = (r % dy, r / dy), whose first word
// is start + j * sy + k * sz (all in words), computed, not loaded.
struct BoxRows {
  long long start, sy, sz;
  unsigned dy;
  __device__ __forceinline__ int key(int r, bool) const { return r; }
  __device__ __forceinline__ void check(int, int) const {}
  __device__ __forceinline__ long long word(int r) const {
    const unsigned j = (unsigned)r % dy, k = (unsigned)r / dy;
    return start + j * sy + k * sz;
  }
};

// The warp-cooperative layout, for rows that one load cannot carry (a row
// of 3 words, or rows off the vector alignment).  A warp owns 32 x ROWS
// consecutive rows; lane l takes the words l, l + 32, ... of the warp's
// ROWS x WPR output words, so neighbouring lanes read neighbouring words
// of a source row (one sector request per row and instruction, not one per
// word) and every store instruction writes 128 contiguous bytes.  All
// index loads, then all row loads, are in flight before the first store.
// The gathers take ROWS = kRows; the box panels ROWS = 1 (four times the
// warps: their rows cost no index load to amortise).
template <int WPR, bool BCAST, typename Rows, int ROWS = kRows,
          bool CHECK = false>
__global__ void __launch_bounds__(kMaxThreads)
    lanes_copy_kernel(const unsigned* __restrict__ src,
                      const unsigned* __restrict__ leaf,
                      unsigned* __restrict__ dst, const Rows rows, int M,
                      int tile_rows, int tiles, int flags) {
  constexpr int K = ROWS * WPR;  // words a lane moves per tile
  const bool streaming = flags & kStreaming;
  const bool stream = flags & kStreamLoads;
  const int lane = (int)threadIdx.x & 31;
  const int warp_row = ((int)threadIdx.x >> 5) * 32 * ROWS;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tile_rows + warp_row;
    int s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = row0 + (lane + 32 * k) / WPR;
      s[k] = r < M ? rows.key(r, stream) : 0;
      if (CHECK && r < M) rows.check(r, s[k]);
    }
    unsigned w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = lane + 32 * k;
      const int r = row0 + p / WPR;
      const bool own = BCAST && s[k] < 0;
      const unsigned* q = (own ? leaf + (long long)r * WPR
                               : src + rows.word(s[k])) + p % WPR;
      w[k] = r < M ? ld(q, own && stream) : 0u;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = lane + 32 * k;
      if (row0 + p / WPR < M) {
        unsigned* q = dst + (long long)row0 * WPR + p;
        if (streaming) __stcs(q, w[k]); else *q = w[k];
      }
    }
  }
}

// The raw bits of element i of a row of T, little-endian, into words w.
__device__ __forceinline__ void put_bits(unsigned* w, int i, float x) {
  w[i] = __float_as_uint(x);
}
__device__ __forceinline__ void put_bits(unsigned* w, int i, double x) {
  w[2 * i] = (unsigned)__double2loint(x);
  w[2 * i + 1] = (unsigned)__double2hiint(x);
}
__device__ __forceinline__ void put_bits(unsigned* w, int i,
                                         __nv_bfloat16 x) {
  const unsigned b = __bfloat16_as_ushort(x);
  w[i >> 1] = (i & 1) ? (w[i >> 1] | (b << 16)) : b;
}

// Fused bcast with a cast, rows of U elements, in the rows layout: out[r] =
// cast(root[map[r]]) where map[r] >= 0, else leaf[r]; the converted bits of
// a thread's kRows rows leave in the widest vectors their size allows.
template <typename TR, typename TL, int U>
__global__ void __launch_bounds__(kMaxThreads)
    rows_cast_kernel(const TR* __restrict__ root,
                     const TL* __restrict__ leaf, TL* __restrict__ out,
                     const int* __restrict__ map, int M, int tile_rows,
                     int tiles, int flags) {
  constexpr int NE = kRows * U;
  constexpr int NW = NE * (int)sizeof(TL) / 4;
  const bool idx_vec = flags & kIdxVec, streaming = flags & kStreaming;
  const bool stream = flags & kStreamLoads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * tile_rows + (int)threadIdx.x * kRows;
    if (row0 + kRows <= M) {
      int s[kRows];
      load_indices(map, row0, idx_vec, stream, s);
      TR a[NE];
      TL b[NE];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int e = 0; e < U; ++e) {
          a[j * U + e] = s[j] >= 0 ? __ldg(root + (long long)s[j] * U + e)
                                   : TR();
          b[j * U + e] = s[j] < 0
                             ? ld(leaf + (long long)(row0 + j) * U + e,
                                  stream)
                             : TL();
        }
      }
      unsigned w[NW];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const int i = j * U + e;
          put_bits(w, i, s[j] >= 0 ? cast<TL, TR>(a[i]) : b[i]);
        }
      }
      store_words(reinterpret_cast<unsigned*>(out + (long long)row0 * U), w,
                  streaming);
    } else {
      for (int r = row0; r < M; ++r) {  // the ragged end: at most 3 rows
        const int s = __ldg(map + r);
        for (int e = 0; e < U; ++e) {
          out[(long long)r * U + e] =
              s >= 0 ? cast<TL, TR>(root[(long long)s * U + e])
                     : leaf[(long long)r * U + e];
        }
      }
    }
  }
}

bool bad_plan(int tile_rows, int grid) {
  return tile_rows < kRows || tile_rows % kRows ||
         tile_rows / kRows > kMaxThreads || grid < 1;
}

template <bool BCAST, bool CHECK>
int narrow_copy(const unsigned* a, const unsigned* b, unsigned* d,
                const int* idx, int M, int wpr, int tile_rows, int tiles,
                int grid, int flags, int nsrc, cudaStream_t s) {
  const int threads = tile_rows / kRows;
  switch ((flags & kLanes) ? -wpr : wpr) {
#define ROWS_COPY(W)                                                    \
  case W:                                                               \
    rows_copy_kernel<W, BCAST, CHECK>                                   \
        <<<grid, threads, 0, s>>>(a, b, d, idx, M, tile_rows, tiles, flags, \
                                  nsrc);                                \
    break;
#define LANES_COPY(W)                                                   \
  case -W:                                                              \
    lanes_copy_kernel<W, BCAST, IndexRows<W>, kRows, CHECK>             \
        <<<grid, threads, 0, s>>>(a, b, d, IndexRows<W>{idx, nsrc}, M,  \
                                  tile_rows, tiles, flags);             \
    break;
    ROWS_COPY(1)
    ROWS_COPY(2)
    ROWS_COPY(4)
    LANES_COPY(2)
    LANES_COPY(3)
    LANES_COPY(4)
#undef ROWS_COPY
#undef LANES_COPY
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

template <bool BCAST>
int launch_narrow_copy(const void* src, const void* leaf, void* dst,
                       const int* idx, int M, int wpr, int tile_rows,
                       int tiles, int grid, int flags, int nsrc,
                       cudaStream_t s) {
  if (bad_plan(tile_rows, grid)) return -1;
  const unsigned* a = (const unsigned*)src;
  const unsigned* b = (const unsigned*)leaf;
  unsigned* d = (unsigned*)dst;
  if (!BCAST && (flags & kCheckIdx))
    return narrow_copy<BCAST, !BCAST>(a, b, d, idx, M, wpr, tile_rows, tiles,
                                      grid, flags, nsrc, s);
  return narrow_copy<BCAST, false>(a, b, d, idx, M, wpr, tile_rows, tiles,
                                   grid, flags, nsrc, s);
}

template <typename TR, typename TL>
int launch_narrow_cast(const void* root, const void* leaf, void* out,
                       const int* map, int M, int U, int tile_rows, int tiles,
                       int grid, int flags, cudaStream_t s) {
  if (bad_plan(tile_rows, grid)) return -1;
  const int threads = tile_rows / kRows;
  const TR* a = (const TR*)root;
  const TL* b = (const TL*)leaf;
  TL* d = (TL*)out;
  if (flags & kLanes) return -1;
  switch (U) {
#define ROWS_CAST(N)                                                      \
  case N:                                                                 \
    rows_cast_kernel<TR, TL, N>                                           \
        <<<grid, threads, 0, s>>>(a, b, d, map, M, tile_rows, tiles, flags); \
    break;
    ROWS_CAST(1)
    ROWS_CAST(2)
    ROWS_CAST(3)
    ROWS_CAST(4)
#undef ROWS_CAST
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ box panels
// pack_strided: out[i + dx (j + dy k)] = src[start + i + j sy + k sz].
// Every (j, k) panel is dx rows, lw words, contiguous in the source and in
// the output, so the pack is dy x dz copies of lw words with no index.
constexpr int kPanelThreads = 128;  // 4 warps; a warp owns an item

struct Panels {
  long long s0;      // source word of panel (0, 0) from the 16-byte base
  long long sy, sz;  // source words between panels along j and along k
  long long d0;      // output word of panel 0 from the 16-byte base
  int lw;            // words per panel
  int dy;            // panels along j
  int per_panel;     // items per panel
  int items;         // panels x per_panel
};

// Words r .. r + 3 of the eight words lo, hi (r is warp-uniform).
__device__ __forceinline__ uint4 funnel(const uint4& lo, const uint4& hi,
                                        int r) {
  switch (r) {
    case 0: return lo;
    case 1: return make_uint4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_uint4(lo.z, lo.w, hi.x, hi.y);
    default: return make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
}

// A warp owns an item: up to 32 x K aligned 16-byte output vectors of one
// panel (item c of the panel's per_panel), and the 0-3 words before the
// first of them (head, item 0) or after the last (tail, last item).  The
// panel's source and output words come from (j, k) once per item; within
// the item all offsets are 32-bit.  Output vector v holds the source words
// 4v + delta ..  (delta = panel source word - panel output word), which
// lie in the aligned source vectors v + (delta >> 2) and the next one,
// shifted by r = delta & 3 words.  Lane l loads the aligned source vectors
// l, l + 32, ... of the item (and lane 0 the one after the last), all
// before its first store, then joins its own vector with the next lane's,
// which comes from lane l + 1 by warp shuffles (lane 31 takes lane 0's next
// one); the word shift is a select in registers.  Every global load and
// store is an aligned 16-byte vector and a warp instruction covers 512
// contiguous bytes.
template <int K>
__global__ void __launch_bounds__(kPanelThreads)
    panel_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                      const Panels b) {
  constexpr int N = 32 * K;
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned* sw = reinterpret_cast<const unsigned*>(src);
  unsigned* dw = reinterpret_cast<unsigned*>(dst);
  const int lane = (int)threadIdx.x & 31;
  const int warps = kPanelThreads / 32;
  for (int it = blockIdx.x * warps + ((int)threadIdx.x >> 5); it < b.items;
       it += gridDim.x * warps) {
    const int p = it / b.per_panel, c = it - p * b.per_panel;
    const int j = p % b.dy, k = p / b.dy;
    const long long s = b.s0 + j * b.sy + k * b.sz;  // panel's source word
    const long long d = b.d0 + (long long)p * b.lw;  // its output word
    const int h = min((int)(-d & 3), b.lw);          // head words
    const int nb = (b.lw - h) >> 2;                  // aligned vectors
    const long long delta = s - d;
    const int r = (int)(delta & 3);
    const long long v0 = ((d + h) >> 2) + (long long)c * N;
    const uint4* a = src + (v0 + (delta >> 2));  // source vector of v0
    uint4* o = dst + v0;
    const int n = min(max(nb - c * N, 0), N);   // vectors of this item
    const int nl = n ? n + (r != 0) : 0;        // source vectors it reads
    uint4 x[K];
    uint4 ex = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int pos = lane + 32 * q;
      x[q] = pos < nl ? __ldg(a + pos) : make_uint4(0u, 0u, 0u, 0u);
    }
    if (lane == 0 && N < nl) ex = __ldg(a + N);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      uint4 hi = x[q];
      if (r != 0) {  // warp-uniform
        const uint4 give = lane == 0 ? (q + 1 < K ? x[q + 1] : ex) : x[q];
        const int from = (lane + 1) & 31;
        hi.x = __shfl_sync(kAll, give.x, from);
        hi.y = __shfl_sync(kAll, give.y, from);
        hi.z = __shfl_sync(kAll, give.z, from);
        hi.w = __shfl_sync(kAll, give.w, from);
      }
      const int pos = lane + 32 * q;
      if (pos < n) o[pos] = funnel(x[q], hi, r);
    }
    if (c == 0 && lane < h) dw[d + lane] = __ldg(sw + s + lane);
    const int tail = b.lw - h - 4 * nb, at = h + 4 * nb;
    if (c == b.per_panel - 1 && lane < tail)
      dw[d + at + lane] = __ldg(sw + s + at + lane);
  }
}

int launch_panels(const uint4* src, uint4* dst, const Panels& b, int K,
                  int grid, cudaStream_t s) {
  switch (K) {
#define PANELS(N)                                                    \
  case N:                                                            \
    panel_copy_kernel<N><<<grid, kPanelThreads, 0, s>>>(src, dst, b); \
    break;
    PANELS(1)
    PANELS(2)
    PANELS(3)
    PANELS(4)
#undef PANELS
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = src[idx[i]] for i < M, rows of row_bytes bytes; with
// nsrc >= 0 the checked gather (an index outside the nsrc rows traps).
int sf_gather_rows(const void* src, void* dst, const int* idx, long long M,
                   long long row_bytes, int rows_per_cta, long long nsrc,
                   void* stream) {
  Box box = {0, 1, 1, 0, 0};
  return launch_gather<false>(src, dst, idx, M, row_bytes, rows_per_cta, box,
                              nsrc, (cudaStream_t)stream);
}

// out[i + dx*(j + dy*k)] = src[start + i + j*sy + k*sz], M = dx*dy*dz.
int sf_gather_strided(const void* src, void* dst, long long M,
                      long long row_bytes, int rows_per_cta, long long start,
                      long long dx, long long dy, long long sy, long long sz,
                      void* stream) {
  Box box = {start, dx, dy, sy, sz};
  return launch_gather<true>(src, dst, nullptr, M, row_bytes, rows_per_cta,
                             box, 0, (cudaStream_t)stream);
}

// out[l] = src_of_leaf[l] >= 0 ? root[src_of_leaf[l]] : leaf[l], same dtype.
int sf_bcast_fused_copy(const void* root, const void* leaf, void* out,
                        const int* src_of_leaf, long long Nl,
                        long long row_bytes, int rows_per_cta, void* stream) {
  const int wb = word_bytes((uintptr_t)root, (uintptr_t)leaf, (uintptr_t)out,
                            row_bytes);
  const long long wpr = row_bytes / wb;
  const int threads = threads_for((long long)rows_per_cta * wpr);
  const unsigned grid = (unsigned)((Nl + rows_per_cta - 1) / rows_per_cta);
  cudaStream_t s = (cudaStream_t)stream;
  switch (wb) {
    case 16:
      bcast_copy_kernel<uint4><<<grid, threads, 0, s>>>(
          (const uint4*)root, (const uint4*)leaf, (uint4*)out, src_of_leaf,
          Nl, wpr, rows_per_cta);
      break;
    case 8:
      bcast_copy_kernel<uint2><<<grid, threads, 0, s>>>(
          (const uint2*)root, (const uint2*)leaf, (uint2*)out, src_of_leaf,
          Nl, wpr, rows_per_cta);
      break;
    case 4:
      bcast_copy_kernel<unsigned><<<grid, threads, 0, s>>>(
          (const unsigned*)root, (const unsigned*)leaf, (unsigned*)out,
          src_of_leaf, Nl, wpr, rows_per_cta);
      break;
    case 2:
      bcast_copy_kernel<unsigned short><<<grid, threads, 0, s>>>(
          (const unsigned short*)root, (const unsigned short*)leaf,
          (unsigned short*)out, src_of_leaf, Nl, wpr, rows_per_cta);
      break;
    default:
      bcast_copy_kernel<unsigned char><<<grid, threads, 0, s>>>(
          (const unsigned char*)root, (const unsigned char*)leaf,
          (unsigned char*)out, src_of_leaf, Nl, wpr, rows_per_cta);
  }
  return (int)cudaGetLastError();
}

// The same with a cast root dtype -> leaf dtype.  Dtype codes:
// 0 float32, 1 float64, 3 bfloat16.  Returns -1 for an unsupported pair.
int sf_bcast_fused_cast(const void* root, const void* leaf, void* out,
                        const int* src_of_leaf, long long Nl, long long U,
                        int root_dtype, int leaf_dtype, int rows_per_cta,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int pair = root_dtype * 4 + leaf_dtype;
  switch (pair) {
    case 0 * 4 + 1:
      launch_cast<float, double>(root, leaf, out, src_of_leaf, Nl, U,
                                 rows_per_cta, s);
      break;
    case 0 * 4 + 3:
      launch_cast<float, __nv_bfloat16>(root, leaf, out, src_of_leaf, Nl, U,
                                        rows_per_cta, s);
      break;
    case 1 * 4 + 0:
      launch_cast<double, float>(root, leaf, out, src_of_leaf, Nl, U,
                                 rows_per_cta, s);
      break;
    case 1 * 4 + 3:
      launch_cast<double, __nv_bfloat16>(root, leaf, out, src_of_leaf, Nl, U,
                                         rows_per_cta, s);
      break;
    case 3 * 4 + 0:
      launch_cast<__nv_bfloat16, float>(root, leaf, out, src_of_leaf, Nl, U,
                                        rows_per_cta, s);
      break;
    case 3 * 4 + 1:
      launch_cast<__nv_bfloat16, double>(root, leaf, out, src_of_leaf, Nl, U,
                                         rows_per_cta, s);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// Narrow rows (plan from kernels/sf_pack.py::row_plan): out[i] =
// src[idx[i]] for i < M, rows of wpr 32-bit words (1-4; src 4-byte and dst
// 16-byte aligned).  tile_rows = 4 x threads rows per CTA tile, tiles =
// ceil(M / tile_rows), grid CTAs striding over them.  flags: 1 indices by
// 16-byte loads (idx 16-byte aligned), 2 evict-first stores, 4 the lanes
// layout (else the rows layout: wpr 1, 2 or 4 with src aligned to a row),
// 8 evict-first index and leaf loads, 16 the checked gather (an index
// outside the nsrc rows of src traps).
int sf_gather_narrow(const void* src, void* dst, const int* idx, int M,
                     int wpr, int tile_rows, int tiles, int grid, int flags,
                     int nsrc, void* stream) {
  return launch_narrow_copy<false>(src, nullptr, dst, idx, M, wpr, tile_rows,
                                   tiles, grid, flags, nsrc,
                                   (cudaStream_t)stream);
}

// Narrow fused bcast, same dtype: out[l] = src_of_leaf[l] >= 0 ?
// root[src_of_leaf[l]] : leaf[l], the plan as for sf_gather_narrow (root
// and leaf both aligned as src is there).
int sf_bcast_narrow_copy(const void* root, const void* leaf, void* out,
                         const int* src_of_leaf, int Nl, int wpr,
                         int tile_rows, int tiles, int grid, int flags,
                         void* stream) {
  return launch_narrow_copy<true>(root, leaf, out, src_of_leaf, Nl, wpr,
                                  tile_rows, tiles, grid, flags, 0,
                                  (cudaStream_t)stream);
}

// Narrow fused bcast with a cast, rows of U (1-4) elements in the rows
// layout; dtype codes as for sf_bcast_fused_cast.
int sf_bcast_narrow_cast(const void* root, const void* leaf, void* out,
                         const int* src_of_leaf, int Nl, int U,
                         int root_dtype, int leaf_dtype, int tile_rows,
                         int tiles, int grid, int flags, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (root_dtype * 4 + leaf_dtype) {
    case 0 * 4 + 1:
      return launch_narrow_cast<float, double>(root, leaf, out, src_of_leaf,
                                               Nl, U, tile_rows, tiles, grid,
                                               flags, s);
    case 0 * 4 + 3:
      return launch_narrow_cast<float, __nv_bfloat16>(
          root, leaf, out, src_of_leaf, Nl, U, tile_rows, tiles, grid, flags,
          s);
    case 1 * 4 + 0:
      return launch_narrow_cast<double, float>(root, leaf, out, src_of_leaf,
                                               Nl, U, tile_rows, tiles, grid,
                                               flags, s);
    case 1 * 4 + 3:
      return launch_narrow_cast<double, __nv_bfloat16>(
          root, leaf, out, src_of_leaf, Nl, U, tile_rows, tiles, grid, flags,
          s);
    case 3 * 4 + 0:
      return launch_narrow_cast<__nv_bfloat16, float>(
          root, leaf, out, src_of_leaf, Nl, U, tile_rows, tiles, grid, flags,
          s);
    case 3 * 4 + 1:
      return launch_narrow_cast<__nv_bfloat16, double>(
          root, leaf, out, src_of_leaf, Nl, U, tile_rows, tiles, grid, flags,
          s);
    default:
      return -1;
  }
}

// pack_strided's routes (plan from kernels/sf_pack.py::strided_plan).  All
// offsets and strides are in 32-bit words; src and dst must be 4-byte
// aligned (-1 otherwise).

// The panel route: panels of lw words, s0 = start x row words, sy / sz in
// words, per_panel items per panel, items = dy x dz x per_panel, K vectors
// per lane per item (1-4).
int sf_strided_panels(const void* src, void* dst, long long s0, long long sy,
                      long long sz, int lw, int dy, int per_panel, int items,
                      int K, int grid, void* stream) {
  const uintptr_t sa = (uintptr_t)src, da = (uintptr_t)dst;
  if (sa % 4 || da % 4 || grid < 1 || per_panel < 1 || lw < 1) return -1;
  const Panels b{s0 + (long long)(sa % 16) / 4, sy, sz,
                 (long long)(da % 16) / 4, lw, dy, per_panel, items};
  const uint4* s4 = (const uint4*)(sa - sa % 16);
  uint4* d4 = (uint4*)(da - da % 16);
  return launch_panels(s4, d4, b, K, grid, (cudaStream_t)stream);
}

// The lanes route (panels of 1-4 words): M = dy x dz panels of wpr words,
// one panel's worth of words a lane, tiles of tile_rows = threads panels,
// grid CTAs striding over them.
int sf_strided_lanes(const void* src, void* dst, int M, int wpr,
                     long long start, long long sy, long long sz, int dy,
                     int tile_rows, int tiles, int grid, void* stream) {
  if ((uintptr_t)src % 4 || (uintptr_t)dst % 4 || grid < 1 ||
      tile_rows % 32 || tile_rows < 32 || tile_rows > kMaxThreads)
    return -1;
  const unsigned* a = (const unsigned*)src;
  unsigned* d = (unsigned*)dst;
  const BoxRows rows{start, sy, sz, (unsigned)dy};
  cudaStream_t s = (cudaStream_t)stream;
  switch (wpr) {
#define BOX_LANES(W)                                                     \
  case W:                                                                \
    lanes_copy_kernel<W, false, BoxRows, 1><<<grid, tile_rows, 0, s>>>(  \
        a, nullptr, d, rows, M, tile_rows, tiles, 0);                    \
    break;
    BOX_LANES(1)
    BOX_LANES(2)
    BOX_LANES(3)
    BOX_LANES(4)
#undef BOX_LANES
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

const char* sf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
