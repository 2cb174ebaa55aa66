// Flash attention forward for Hopper (sm_90a): GQA online-softmax attention
// with causal and sliding-window masks, end-aligned positions.
//
// Replaces the Pallas function flash_attention
// (repro/kernels/flash_attention.py:92, pallas_call at :119):
//   q (B, Sq, H, D), k/v (B, Skv, Hkv, D), Hkv | H, query row i at absolute
//   position Skv - Sq + i; key j visible iff j < Skv, (causal) j <= qpos and
//   (window) j > qpos - window; out = softmax(scale * q k^T) v in q's dtype,
//   softmax and accumulation in float32.  A query row that sees no key
//   returns 0 (the contract of ref.flash_attention_ref; the Pallas kernel
//   returns the mean of v there).
//
// Bound on this card.  For the serving path's prefill (bf16, Sq = Skv = S,
// H 32, Hkv 8, D 128, causal) the work is 2 * S*(S+1)/2 * H * D
// multiply-adds (q k^T and p v, the causal half) against q + o + k + v
// bytes read or written once: at S = 1024, 8.6 GFLOP over 989 TFLOP/s of
// bf16 tensor cores (8.7 us) against 21 MB over 3.35 TB/s (6.3 us), so the
// bound is operations, by a little; at S <= 512 it is bytes.
//
// Design against that bound.
//  * bf16 (the serving path): one CTA of four warps owns 64 query rows of one
//    head; each warp owns 16 rows and keeps its q fragments, the running max,
//    the denominator and the 16 x D float32 accumulator in registers (the
//    Pallas kernel's m/l/acc VMEM scratch).  The CTA walks the K/V tiles of
//    KV head h / (H/Hkv), 64 keys at a time, inside the block (the Pallas
//    grid's sequential jk axis), staging each tile in shared memory once for
//    all four warps.  Both products run on the tensor cores as
//    mma.sync.m16n8k16 bf16 -> f32: S = q k^T from q fragments and k rows
//    read straight out of shared memory; the probabilities are rounded to
//    bf16 and reused in registers as the A operand of P V, whose B operand
//    ldmatrix.trans reads from the row-major V tile.  Head sizes 16, 32, 64,
//    112 and 128: D / 16 k-steps of q k^T, D / 8 n-tiles of P V (7 and 14
//    at kimi-k2's 112), rows of D + 8 in shared memory (240 bytes at 112:
//    16-byte aligned, eight rows on distinct banks).  Tiles that no row of
//    the block can see are never visited: under causal the walk stops at
//    the diagonal tile, under a window it starts at the window's first tile.
//    Row padding (ragged Sq and Skv) is masked here, not by padded copies.
//  * float32: one CTA of four warps owns 16 query rows (four per warp); lane
//    j scores key j of a 32-key tile for the warp's four rows with fp32 FMAs
//    (k rows padded in shared memory so the 32 lanes hit 32 banks), and the
//    P V update broadcasts each probability with a shuffle.  This keeps the
//    reference's float32 tolerance; it is not on the serving path.
// What is left for later: cp.async / TMA double buffering of the K/V tiles,
// wgmma on 64-row warpgroup tiles, and a persistent schedule for the
// causal triangle's uneven tiles (flash_attention_sm90.cu has all three).
//
// Split KV (flash_attention_split_fwd): the short-query route of the same
// function, bf16 at head sizes 64 and 128, where a KV head has few query
// rows (Sq x H / Hkv at most kernels/flash_attention.py's SPLIT_ROWS):
// whisper's cross-attention at decode (q (8, 1, 8, 64) over 1,500 encoder
// keys) and at its 4-token prefill.  Bound: bytes.  At decode the call
// reads K and V once (24.6 MB at whisper's shape, 7.3 us at 3.35 TB/s) for
// 2 x 64 x 1,500 x 8 x 64 multiply-adds.  The wgmma kernel gives such a
// call 64-row tiles with one live row and B x H = 64 work items on 132
// SMs, each walking 24 KV tiles behind a 2-slot ring: half the card idles
// and the rest waits on latency.  Here:
//  * the Sq x rep query rows of one KV head (row m = query row m / rep of
//    query head hk rep + m % rep: consecutive in memory) are one CTA's M
//    rows, so each K/V tile is read once per KV head, not per query head;
//    m16n8k16 mma.sync with M padded to 16 (MT m16 tiles: 1 up to 16
//    rows, else 4 in blocks of 64 rows), not m64 wgmma, which would leave
//    48-63 of 64 rows dead;
//  * the grid is (n_split, Hkv, B x row blocks): the KV tiles [j0, j0 +
//    n_tiles) that some query row can see are cut into n_split contiguous
//    ranges, each CTA one range; split_plan takes the most ranges whose
//    CTAs fit one wave of the SMs (on the H100 fewer, longer ranges beat
//    two or three waves, flash_variants.py's readings in PERF.md);
//  * K/V tiles of BC = 128 keys stream through a 3-slot ring by 16-byte
//    cp.async, issued two tiles ahead of the math (zero-filled past Skv);
//    128-key tiles beat 64-key ones (half the barriers and softmax steps
//    a key);
//  * the four warps share out the work of a tile: warp w takes m16 tile
//    w / KS against keys BC / KS x (w % KS) .. of it (KS = 4 / MT), with
//    its own running max, sum and output; at the end of the range the KS
//    warps of an m16 tile are folded through shared memory in warp order,
//    and the CTA writes its unnormalised float32 o with its max m and sum
//    l for each of its rows to scratch (with one range, the final o and
//    LSE, and the combine is not launched);
//  * flash_split_combine_kernel folds the n_split ranges of each output
//    row in split order (no float atomics: the bits do not depend on the
//    schedule); it is a programmatic dependent launch (PDL), so its CTAs
//    are resident before the split kernel ends and wait for its writes at
//    griddepcontrol.wait; it writes bf16 o and, when asked, the base-2
//    log-sum-exp M + log2(L) in the (B, H, Sq) float32 layout of the sm90
//    kernel's, for the training backward.  A row that sees no key gets
//    m = -inf in every range, and o = 0 with an LSE of -inf.
// Masks as in the other kernels: the element mask applies only on the
// tiles that split::tile_masked marks (the sm90 kernel's tile_masked over
// all Sq rows).  split_plan in kernels/flash_attention.py mirrors the
// ranges; a change to one side changes the other.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_fragments.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, Hkv;
  int causal, has_window, window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// Keys [lo, hi) that some query row in [r0, r1) may see; the tiles outside
// it are skipped.
__device__ __forceinline__ void kv_range(const Params& p, int r0, int r1,
                                         int& lo, int& hi) {
  const int off = p.Skv - p.Sq;
  lo = 0;
  hi = p.Skv;
  if (p.causal) hi = min(hi, off + r1);
  if (p.has_window) lo = max(lo, off + r0 - p.window + 1);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (!p.has_window || kpos > qpos - p.window);
}

// ------------------------------------------------------------------ bf16
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(Params p) {
  constexpr int BR = 64, BC = 64, LD = D + 8;  // LD: 16-byte rows, no conflicts
  __shared__ __align__(16) __nv_bfloat16 Ks[BC * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BC * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // longest causal rows first: they have the most tiles to walk
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)p.q +
                            (long long)b * p.Sq * qs + (long long)h * D;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)p.k +
                            (long long)b * p.Skv * ks + (long long)hk * D;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)p.v +
                            (long long)b * p.Skv * ks + (long long)hk * D;
  __nv_bfloat16* ob = (__nv_bfloat16*)p.o + (long long)b * p.Sq * qs +
                      (long long)h * D;

  // this thread's two rows of the warp's 16 (the mma C layout)
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const bool va = ra < p.Sq, vb_ = rb < p.Sq;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = va ? ld32(qb + ra * qs + c) : 0u;
    qa[kk][1] = vb_ ? ld32(qb + rb * qs + c) : 0u;
    qa[kk][2] = va ? ld32(qb + ra * qs + c + 8) : 0u;
    qa[kk][3] = vb_ ? ld32(qb + rb * qs + c + 8) : 0u;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int off = p.Skv - p.Sq;
  const int qpos[2] = {off + ra, off + rb};
  int lo, hi;
  kv_range(p, row0, min(row0 + BR, p.Sq), lo, hi);
  for (int kv0 = (lo / BC) * BC; kv0 < hi; kv0 += BC) {
    __syncthreads();  // the previous tile is consumed
    constexpr int CH = D / 8;  // 16-byte chunks per row
    for (int c = tid; c < BC * CH; c += 128) {
      const int j = c / CH, col = (c % CH) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kv0 + j < p.Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (kv0 + j) * ks + col);
        vx = *reinterpret_cast<const uint4*>(vb + (kv0 + j) * ks + col);
      }
      *reinterpret_cast<uint4*>(Ks + j * LD + col) = kx;
      *reinterpret_cast<uint4*>(Vs + j * LD + col) = vx;
    }
    __syncthreads();

    // s = q k^T for the warp's 16 rows and the tile's 64 keys
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + j * 8 + 2 * t + (e & 1);
        const float x = visible(p, qpos[e >> 1], kpos)
                            ? s[j][e] * p.scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;  // a row that sees nothing yet
      corr[i] = exp2f(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];  // this thread's part of the row sum
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p v: the C fragments of two key tiles are the A fragment of one
    // 16-key step
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vr + dn * 16);
        mma_bf16(acc[2 * dn], pa, b0, b1);
        mma_bf16(acc[2 * dn + 1], pa, b2, b3);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key: 0
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (va)
      *reinterpret_cast<uint32_t*>(ob + ra * qs + c) =
          pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    if (vb_)
      *reinterpret_cast<uint32_t*>(ob + rb * qs + c) =
          pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
}

// --------------------------------------------------------------- float32
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_f32_kernel(Params p) {
  constexpr int ROWS = 4, BR = 4 * ROWS, BC = 32, NI = (D + 31) / 32;
  __shared__ float Qs[BR][D];
  __shared__ float Ks[BC][D + 1];  // odd stride: lane j reads bank j + d
  __shared__ float Vs[BC][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const float* qb = (const float*)p.q + (long long)b * p.Sq * qs +
                    (long long)h * D;
  const float* kb = (const float*)p.k + (long long)b * p.Skv * ks +
                    (long long)hk * D;
  const float* vb = (const float*)p.v + (long long)b * p.Skv * ks +
                    (long long)hk * D;
  float* ob = (float*)p.o + (long long)b * p.Sq * qs + (long long)h * D;

  for (int c = tid; c < BR * D; c += 128) {
    const int r = c / D, d = c % D;
    Qs[r][d] = row0 + r < p.Sq ? qb[(row0 + r) * qs + d] : 0.f;
  }
  float acc[ROWS][NI], m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }
  const int off = p.Skv - p.Sq;
  const int wr0 = warp * ROWS;
  int lo, hi;
  kv_range(p, row0, min(row0 + BR, p.Sq), lo, hi);
  for (int kv0 = (lo / BC) * BC; kv0 < hi; kv0 += BC) {
    __syncthreads();
    for (int c = tid; c < BC * D; c += 128) {
      const int j = c / D, d = c % D;
      const bool in = kv0 + j < p.Skv;
      Ks[j][d] = in ? kb[(kv0 + j) * ks + d] : 0.f;
      Vs[j][d] = in ? vb[(kv0 + j) * ks + d] : 0.f;
    }
    __syncthreads();
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = Ks[lane][d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(Qs[wr0 + r][d], kd, s[r]);
    }
    const int kpos = kv0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = visible(p, off + row0 + wr0 + r, kpos)
                          ? s[r] * p.scale_log2 : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m[r] - mu);
      m[r] = mn;
      s[r] = exp2f(x - mu);
      l[r] = l[r] * corr + s[r];
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= corr;
    }
    for (int jj = 0; jj < BC; ++jj) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          if (D % 32 == 0 || d < D) acc[r][i] = fmaf(pj, Vs[jj][d], acc[r][i]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float sum = l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int row = row0 + wr0 + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D) ob[row * qs + d] = acc[r][i] * inv;
    }
  }
}

// ---------------------------------------------------------------- split KV
namespace split {

constexpr int BC = 128;      // keys per K/V tile
constexpr int STAGES = 3;   // cp.async ring depth
// the combine is launched as a programmatic dependent of the split kernel:
// its CTAs start while the split CTAs run and wait at griddepcontrol.wait
// for their writes, so the second launch's latency is hidden
constexpr bool PDL = true;

struct SplitParams {
  Params a;             // q, k, v, o, shapes, masks, scale
  float* part_o;        // (B, Hkv, row blocks, n_split, RS, D) unnormalised o
  float* part_ml;       // (B, Hkv, row blocks, n_split, RS, 2) max and sum
  float* lse;           // (B, H, Sq) base-2 log-sum-exp, or null
  int B, M;             // M = Sq * H / Hkv query rows per KV head
  int j0, n_tiles, n_split, row_blocks;
};

// Whether some (query row, key in tile j) pair is not visible: the sm90
// kernel's tile_masked over rows [0, Sq).
__device__ __forceinline__ bool tile_masked(const Params& p, int j) {
  const long long off = (long long)p.Skv - p.Sq;
  const long long k0 = (long long)j * BC, k1 = k0 + BC - 1;
  return k1 >= p.Skv || (p.causal && k1 > off) ||
         (p.has_window && k0 <= off + p.Sq - 1 - p.window);
}

template <int D>
constexpr int ring_bytes() {
  return STAGES * 2 * BC * (D + 8) * 2;
}

// One CTA: KV head blockIdx.y of batch blockIdx.z / row_blocks, rows
// [rb RS, rb RS + RS) of its M, KV tiles of range blockIdx.x.
template <int D, int MT>
__global__ void __launch_bounds__(128)
    flash_split_kernel(const SplitParams sp) {
  constexpr int KS = 4 / MT, KW = BC / KS, LD = D + 8, RS = MT * 16;
  static_assert(KW % 16 == 0, "a warp's key slice is whole k16 steps");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + STAGES * BC * LD;
  const Params& p = sp.a;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int mt = warp / KS, ks = warp % KS;
  const int split = blockIdx.x, hk = blockIdx.y;
  const int b = blockIdx.z / sp.row_blocks, rb = blockIdx.z % sp.row_blocks;
  const int rep = p.H / p.Hkv;
  const long long kstride = (long long)p.Hkv * D;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)p.k +
                            (long long)b * p.Skv * kstride + (long long)hk * D;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)p.v +
                            (long long)b * p.Skv * kstride + (long long)hk * D;
  // this CTA's KV tiles [t0, t1) (split_plan's ranges)
  const int t0 = sp.j0 + (int)((long long)split * sp.n_tiles / sp.n_split);
  const int t1 =
      sp.j0 + (int)((long long)(split + 1) * sp.n_tiles / sp.n_split);

  // this thread's two rows m of the KV head (the mma C layout)
  const int ma = rb * RS + mt * 16 + g, mb = ma + 8;
  const int qpos[2] = {p.Skv - p.Sq + ma / rep, p.Skv - p.Sq + mb / rep};
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* q = (const __nv_bfloat16*)p.q;
    // row m: query row m / rep of query head hk rep + m % rep
    const auto row = [&](int m) {
      return q + (((long long)b * p.Sq + m / rep) * p.H + hk * rep +
                  m % rep) * D;
    };
    const __nv_bfloat16* qra = ma < sp.M ? row(ma) : nullptr;
    const __nv_bfloat16* qrb = mb < sp.M ? row(mb) : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * c4;
      qa[kk][0] = qra ? ld32(qra + c) : 0u;
      qa[kk][1] = qrb ? ld32(qrb + c) : 0u;
      qa[kk][2] = qra ? ld32(qra + c + 8) : 0u;
      qa[kk][3] = qrb ? ld32(qrb + c + 8) : 0u;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // K and V of tile t into ring slot st (one commit group, empty past t1)
  const auto load = [&](int t, int st) {
    if (t < t1) {
      constexpr int CH = D / 8;  // 16-byte chunks per row
      for (int c = tid; c < BC * CH; c += 128) {
        const int j = c / CH, col = (c % CH) * 8;
        const bool in = t * BC + j < p.Skv;
        const long long at = (in ? (long long)(t * BC + j) * kstride : 0) +
                             col;
        cp_async16(Ks + (st * BC + j) * LD + col, kb + at, in);
        cp_async16(Vs + (st * BC + j) * LD + col, vb + at, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(t0 + i, i);
  if (PDL) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % STAGES;
    // tile t has landed for every thread, and every warp is done with the
    // slot the next load overwrites (tile t - 1's)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    load(t + STAGES - 1, (t - t0 + STAGES - 1) % STAGES);
    const __nv_bfloat16* Kt = Ks + st * BC * LD + ks * KW * LD;
    const __nv_bfloat16* Vt = Vs + st * BC * LD + ks * KW * LD;

    // s = q k^T for the warp's 16 rows and its KW keys of the tile
    float s[KW / 8][4];
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = Kt + (j * 8 + g) * LD + 2 * c4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    const bool masked = tile_masked(p, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = t * BC + ks * KW + j * 8 + 2 * c4 + (e & 1);
        float x = s[j][e] * p.scale_log2;
        if (masked && !visible(p, qpos[e >> 1], kpos)) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;  // a row that sees nothing yet
      corr[i] = exp2f(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mu[e >> 1]);
        l[e >> 1] += s[j][e];  // this thread's part of the row sum
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += p v over the warp's keys
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vr + dn * 16);
        mma_bf16(acc[2 * dn], pa, b0, b1);
        mma_bf16(acc[2 * dn + 1], pa, b2, b3);
      }
    }
  }

  // fold the KS warps of each m16 tile, in warp order, through shared
  // memory (the ring's, once every copy has landed and every warp is done)
  asm volatile("cp.async.wait_group 0;\n");
  __syncthreads();
  float* fo = reinterpret_cast<float*>(smem_raw);  // [4][16][D]
  float* fm = fo + 4 * 16 * D;                      // [4][16]
  float* fl = fm + 4 * 16;                          // [4][16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (c4 == 0) {
      fm[warp * 16 + g + 8 * i] = m[i];
      fl[warp * 16 + g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fo[(warp * 16 + g + 8 * (e >> 1)) * D + n * 8 + 2 * c4 + (e & 1)] =
          acc[n][e];
  __syncthreads();
  const long long cta =
      (((long long)b * p.Hkv + hk) * sp.row_blocks + rb) * sp.n_split + split;
  // one range (n_split = 1) is the whole walk: the CTA writes the bf16
  // output and the LSE itself, and no combine runs
  const bool whole = sp.n_split == 1;
  for (int e = tid; e < RS * D / 2; e += 128) {  // column pairs
    const int r = e / (D / 2), d = 2 * (e % (D / 2));
    const int w0 = (r / 16) * KS, rr = r % 16;
    if (rb * RS + r >= sp.M) break;  // rows past M: padding
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < KS; ++w) mm = fmaxf(mm, fm[(w0 + w) * 16 + rr]);
    float o0 = 0.f, o1 = 0.f, ll = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < KS; ++w) {
        const float f = exp2f(fm[(w0 + w) * 16 + rr] - mm);
        o0 += f * fo[((w0 + w) * 16 + rr) * D + d];
        o1 += f * fo[((w0 + w) * 16 + rr) * D + d + 1];
        ll += f * fl[(w0 + w) * 16 + rr];
      }
    }
    if (whole) {
      const int m = rb * RS + r, i = m / rep, h = hk * rep + m % rep;
      const float inv = ll > 0.f ? 1.f / ll : 0.f;  // no visible key: 0
      *reinterpret_cast<uint32_t*>(
          (__nv_bfloat16*)p.o + (((long long)b * p.Sq + i) * p.H + h) * D +
          d) = pack_bf16(o0 * inv, o1 * inv);
      if (sp.lse && d == 0)
        sp.lse[((long long)b * p.H + h) * p.Sq + i] =
            mm == -INFINITY ? -INFINITY : mm + log2f(ll);
    } else {
      *reinterpret_cast<float2*>(sp.part_o + (cta * RS + r) * D + d) =
          make_float2(o0, o1);
      if (d == 0) {
        sp.part_ml[(cta * RS + r) * 2] = mm;
        sp.part_ml[(cta * RS + r) * 2 + 1] = ll;
      }
    }
  }
}

// One warp per output row (b, query row i, head h): the n_split ranges of
// its partial output folded in split order, o in bf16 and the LSE.  Lane j
// reads the max and sum of ranges j, j + 32, ..; the ranges' outputs are
// then read eight at a time and added one range after the other, with
// each range's weight 2^(m - M) passed from its lane by a shuffle.
template <int D>
__global__ void __launch_bounds__(256)
    flash_split_combine_kernel(const SplitParams sp, int RS) {
  constexpr int NP = D / 64;  // column pairs per lane
  const Params& p = sp.a;
  // the split kernel's writes are complete and visible past this point
  if (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)sp.B * p.Sq * p.H) return;
  const int h = (int)(row % p.H), i = (int)((row / p.H) % p.Sq);
  const int b = (int)(row / ((long long)p.H * p.Sq));
  const int rep = p.H / p.Hkv, m = i * rep + h % rep;
  const int rb = m / RS, r = m % RS;
  const long long cta0 =
      (((long long)b * p.Hkv + h / rep) * sp.row_blocks + rb) * sp.n_split;
  const float* ml = sp.part_ml + (cta0 * RS + r) * 2;  // range s: + s RS 2
  const float* po = sp.part_o + (cta0 * RS + r) * D;   // range s: + s RS D
  // the largest max (exact in any order), keeping ranges 0..31's m and l
  float mm = -INFINITY, m0 = -INFINITY, l0 = 0.f;
  for (int s0 = 0; s0 < sp.n_split; s0 += 32) {
    if (s0 + lane < sp.n_split) {
      const float mx = ml[(long long)(s0 + lane) * RS * 2];
      if (s0 == 0) {
        m0 = mx;
        l0 = ml[(long long)lane * RS * 2 + 1];
      }
      mm = fmaxf(mm, mx);
    }
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, x));
  float ll = 0.f, o[NP][2] = {};
  if (mm != -INFINITY) {
    for (int s0 = 0; s0 < sp.n_split; s0 += 32) {
      const int n = min(32, sp.n_split - s0);
      float ms = m0, ls = l0;
      if (s0 > 0) {
        ms = lane < n ? ml[(long long)(s0 + lane) * RS * 2] : -INFINITY;
        ls = lane < n ? ml[(long long)(s0 + lane) * RS * 2 + 1] : 0.f;
      }
      const float f = lane < n ? exp2f(ms - mm) : 0.f;
      const float fl = f * ls;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {  // in range order
        const float fj = __shfl_sync(0xffffffffu, f, j);
        ll += __shfl_sync(0xffffffffu, fl, j);
        const float* x0 = po + (long long)(s0 + j) * RS * D + 2 * lane;
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          const float2 x = *reinterpret_cast<const float2*>(x0 + c * 64);
          o[c][0] += fj * x.x;
          o[c][1] += fj * x.y;
        }
      }
    }
  }
  const float inv = ll > 0.f ? 1.f / ll : 0.f;  // no visible key: 0
  __nv_bfloat16* out = (__nv_bfloat16*)p.o + row * D;
#pragma unroll
  for (int c = 0; c < NP; ++c)
    *reinterpret_cast<uint32_t*>(out + c * 64 + 2 * lane) =
        pack_bf16(o[c][0] * inv, o[c][1] * inv);
  if (sp.lse && lane == 0)
    sp.lse[((long long)b * p.H + h) * p.Sq + i] =
        mm == -INFINITY ? -INFINITY : mm + log2f(ll);
}

template <int D, int MT>
int launch(const SplitParams& sp, cudaStream_t s) {
  const auto kern = flash_split_kernel<D, MT>;
  constexpr int bytes = ring_bytes<D>();
  static_assert(bytes >= (4 * 16 * D + 128) * 4, "the fold fits the ring");
  static bool ready = false;
  if (!ready) {
    // the largest shared-memory carveout, so that several CTAs of the ring's
    // size share an SM (the runtime may otherwise pick a smaller one)
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid(sp.n_split, sp.a.Hkv, sp.B * sp.row_blocks);
  kern<<<grid, 128, bytes, s>>>(sp);
  if (sp.n_split == 1) return (int)cudaGetLastError();  // no combine
  const long long rows = (long long)sp.B * sp.a.Sq * sp.a.H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + 7) / 8));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, flash_split_combine_kernel<D>, sp, MT * 16);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace split

template <int D>
void launch_d(const Params& p, int B, int dtype, cudaStream_t s) {
  if (dtype == 3) {
    const dim3 grid((p.Sq + 63) / 64, p.H, B);
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, s>>>(p);
  } else {
    const dim3 grid((p.Sq + 15) / 16, p.H, B);
    flash_fwd_f32_kernel<D><<<grid, 128, 0, s>>>(p);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), o like q, all contiguous; dtype
// codes 0 float32, 3 bfloat16; D in {16, 32, 64, 112, 128}; has_window = 0
// means no window.  Returns -1 for an unsupported dtype or head size.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int Hkv, int D,
                        int causal, int has_window, int window, float scale,
                        int dtype, void* stream) {
  if (dtype != 0 && dtype != 3) return -1;
  Params p{q, k, v, o, Sq, Skv, H, Hkv, causal, has_window, window,
           scale * 1.4426950408889634f};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: launch_d<16>(p, B, dtype, s); break;
    case 32: launch_d<32>(p, B, dtype, s); break;
    case 64: launch_d<64>(p, B, dtype, s); break;
    case 112: launch_d<112>(p, B, dtype, s); break;
    case 128: launch_d<128>(p, B, dtype, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// The split-KV route: q (B, Sq, H, D), k/v (B, Skv, Hkv, D), o like q, all
// contiguous bf16, D in {64, 128} (kernels/flash_attention.py keeps head
// size 112 on the wgmma kernel); lse: float32 (B, H, Sq) or null;
// part_o / part_ml: float32 scratch of B x Hkv x row_blocks x n_split x
// (16 mt) rows of D and of 2 (unused, and may be null, when n_split = 1:
// the split kernel then writes o and the LSE, and no combine runs); KV tiles [j0, j0 + n_tiles) of 128 keys cut
// into n_split ranges (n_split >= 1); mt (m16 tiles a CTA) 1 or 4
// and row_blocks = ceil(Sq H / Hkv / (16 mt)).  Returns -1 for an
// unsupported head size or plan.
int flash_attention_split_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, void* part_o,
                              void* part_ml, int B, int Sq, int Skv, int H,
                              int Hkv, int D, int causal, int has_window,
                              int window, float scale, int j0, int n_tiles,
                              int n_split, int mt, int row_blocks,
                              void* stream) {
  if ((D != 64 && D != 128) || (mt != 1 && mt != 4) ||
      n_split < 1 || n_tiles < 0 || row_blocks < 1)
    return -1;
  const split::SplitParams sp{
      Params{q, k, v, o, Sq, Skv, H, Hkv, causal, has_window, window,
             scale * 1.4426950408889634f},
      (float*)part_o, (float*)part_ml, (float*)lse, B, Sq * (H / Hkv), j0,
      n_tiles, n_split, row_blocks};
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return mt == 1 ? split::launch<64, 1>(sp, s) : split::launch<64, 4>(sp, s);
  return mt == 1 ? split::launch<128, 1>(sp, s) : split::launch<128, 4>(sp, s);
}

}  // extern "C"
