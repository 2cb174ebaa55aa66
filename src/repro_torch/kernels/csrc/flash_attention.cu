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
//    ldmatrix.trans reads from the row-major V tile.  Tiles that no row of
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
// causal triangle's uneven tiles.
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
// codes 0 float32, 3 bfloat16; D in {16, 32, 64, 128}; has_window = 0 means
// no window.  Returns -1 for an unsupported dtype or head size.
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
    case 128: launch_d<128>(p, B, dtype, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
