// Flash attention backward for Hopper (sm_90a): the gradients of GQA
// softmax attention with causal and sliding-window masks, end-aligned
// positions, with respect to q, k and v.
//
// Replaces FlashAttention.backward's plain recompute (kernels/
// flash_attention.py), which rebuilt the whole (B, Hkv, rep, Sq, Skv)
// float32 score tensor and its softmax and differentiated them.  There is
// no Pallas counterpart: the reference trains attention through the
// checkpointed online-softmax scan _chunked_attn
// (repro/models/layers.py:70) and differentiates that.
//
// Contract: the forward's (flash_attention.cu).  q, o, dO (B, Sq, H, D),
// k, v (B, Skv, Hkv, D), Hkv | H; query row i at absolute position
// Skv - Sq + i; key j visible iff j < Skv, (causal) j <= qpos and (window)
// j > qpos - window.  With s = scale q k^T over the visible pairs,
// P = softmax(s) in float32, dP = dO v^T, delta = rowsum(dO * O) and
// dS = P * (dP - delta):
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T dO,
// dk and dv summed over the rep = H / Hkv query heads of each KV head.  A
// row that sees no key has P = 0, so its q gradient and its share of dk
// and dv are 0.
//
// Two routes (kernels/flash_attention.py: bwd_route, bwd_plan).
//
// The sm90 route: bf16 at head sizes 64 and 128, every shape the training
// path gives the kernels but its float32 copy and kimi-k2's head size 112
// (FlashAttention's forward takes flash_attention_sm90.cu there).
// FlashAttention-3's backward made deterministic:
//  * The forward saves each row's base-2 log-sum-exp of scale log2(e)
//    q k^T (flash_attention_sm90.cu writes m + log2(l) beside o when
//    asked), so P = exp2(s scale log2(e) - LSE) needs no statistics sweep.
//  * flash_bwd_dq_sm90 (query tiles outer): a CTA owns 64 or 128 query
//    rows of one head (one warpgroup per 64), q and dO resident; it
//    computes delta = rowsum(dO * O) for its rows (and writes it for dkdv)
//    and walks its visible 64-key tiles once: S = q k^T, dP = dO v^T,
//    dq += dS k.  Three products, where the mma.sync route's dq runs four
//    (q k^T twice).
//  * flash_bwd_dkdv_sm90 (KV tiles outer): a CTA, one warpgroup, owns 64
//    keys of one KV head, K and V resident, and walks the rep query heads
//    of that KV head in ascending order and each one's visible 64-row q
//    tiles in ascending order: S^T = k q^T, dP^T = v dO^T, dv += P^T dO,
//    dk += dS^T q, dk and dv summed in float32 registers across the heads
//    and written once in bf16: GQA needs no float32 (B, Skv, H, D) shares
//    and no reduce (the mma.sync route writes 134 MB of them at
//    qwen3-4b's step shape).  Where one CTA per KV head would leave SMs
//    idle (qwen3-4b at B = 1: 128 CTAs), the plan keeps the mma.sync
//    route's split instead: one CTA per query head, its share in float32,
//    flash_bwd_dkdv_reduce summing the shares in head order.
//  * Every product is wgmma.mma_async m64nNk16 bf16 -> f32 on warpgroup
//    tiles: q k^T and dO v^T (and their transposes) with both operands
//    read through 128-byte-swizzled matrix descriptors, K-major; P^T and
//    dS (dS^T) rounded to bf16 pairs in registers as the A operand (the
//    m64nN accumulator layout is the A-fragment layout, as the forward's
//    P v), against k, dO or q read MN-major (the transpose bit).  Tiles
//    come by TMA (cp.async.bulk.tensor, zero-filled past Sq or Skv) into
//    two-slot mbarrier rings; the dkdv loader's lanes also stage each q
//    tile's LSE and delta (rows past Sq: LSE +inf, so P = 0).  The
//    mbarrier, TMA and wgmma helpers are the forward's, shared through
//    wgmma_tma.cuh.
//  * No producer warp: the first warp of the CTA issues the loads (its
//    lane 0 the TMA copies), each one step ahead, into the slot the step
//    before has released.  A ninth warp would put three warps on one of
//    the SM's four register files and hold every thread to 168 registers
//    (setmaxnreg did not move ptxas's allocation in this build); dk and dv
//    alone are 128 float32 registers a thread at D = 128.  Without it a
//    dkdv thread has 236 registers at D = 128 (two CTAs an SM) and at most
//    168 at D = 64 (three), with no spills at D = 128, and the SM's tensor
//    cores take one CTA's products while another computes its softmax.
//    Tile widths and CTAs an SM were chosen on the H100 (PERF.md): dq 128
//    rows unless that leaves fewer than half the SMs busy; dkdv 64 keys
//    (128 keys over two warpgroups, a producer warp, a two-warpgroup split
//    by role, deeper rings and two dq CTAs an SM were slower or no faster).
//  * Determinism: every output element is written by exactly one CTA
//    (dq: its q tile's CTA; dk, dv: its KV tile's CTA, or the reduce), and
//    every sum is taken in one fixed order (KV tiles ascending for dq;
//    query heads, then q tiles ascending for dk and dv; the wgmma's own
//    order inside a tile) that depends on neither the grid nor the SM
//    count.  No atomics: two calls give the same bits.
//  * Tiles that no row of the block can see are never visited; the element
//    mask is applied only on the 64 x 64 slices where some pair is not
//    visible (the forward's kv_tiles and tile_masked; bwd_plan mirrors the
//    walk and its masks in Python).
//  Bound on this card: the larger of 10 B (visible pairs) H D FLOPs (the
//  five products of the least backward: q k^T, dO v^T, dS k, dS^T q,
//  P^T dO) over 989 TFLOP/s of bf16 tensor cores, and the bytes of q, k,
//  v, o, dO, dq, dk and dv over 3.35 TB/s: 0.0869 ms at qwen3-4b's step
//  shape (4, 1,024, 32 / 8 heads of 128, causal), operations.  This route
//  runs seven products (q k^T and dO v^T in both kernels), so it can reach
//  at best 5/7 of the bound.
//
// The mma.sync route: float32, and bf16 at head sizes 16, 32 and 112
// (kimi-k2's: its forward takes the wgmma kernel on 128-wide tiles, but
// the sm90 kernels here keep 64 and 128; D / 16 = 7 k-steps, the odd last
// one of a rows_dot a single m16n8k16, and D / 8 = 14 n-tiles).
// FlashAttention-2's backward, made deterministic.
//  * flash_bwd_dq (query tiles outer): one CTA owns 64 query rows of one
//    head.  Sweep 1 walks the visible K tiles and computes each row's max
//    and sum of exp2(scale log2(e) q k^T), so its base-2 log-sum-exp (LSE,
//    -inf for a row that sees nothing), and delta = rowsum(dO * O) in
//    float32; both go to float32 scratch (B, H, Sq).  Sweep 2 walks the
//    same tiles again, recomputes P = exp2(s log2(e) - LSE), dP and dS, and
//    accumulates dq = scale dS k in float32 registers.
//  * flash_bwd_dkdv (KV tiles outer): one CTA owns 64 keys for one query
//    head and walks that head's visible query tiles in ascending order,
//    recomputing P from the saved LSE and accumulating dv += P^T dO and
//    dk += scale dS^T q in float32 registers.  With H = Hkv it writes dk
//    and dv; under GQA it writes the head's share in float32 (B, Skv, H, D)
//    and flash_bwd_dkdv_reduce sums the rep = H / Hkv shares of each KV
//    head in head order.
//  * Determinism as above: one writer per element, one fixed order of
//    sums, no atomics.
//  * bf16: four warps, each owning 16 rows (dq) or 16 keys (dkdv); every
//    product runs on the tensor cores as mma.sync.m16n8k16 bf16 -> f32,
//    with P and dS rounded to bf16 as A operands, as the forward rounds P.
//    dq keeps its q and dO fragments in registers and streams K and V
//    tiles through two shared-memory stages by cp.async; dkdv keeps its K
//    and V tiles and streams each query tile's q and dO rows, LSE and delta
//    the same way.  Operands come out of shared memory by ldmatrix.
//  * float32: eight warps of FMAs with float32 operands, as the forward's
//    float32 kernel: lanes take keys (dq) or query rows (dkdv) for the dot
//    products and head columns for the accumulators, and the update
//    broadcasts each P or dS value with a shuffle.
//  * The walk is the sm90 route's at 64 query rows and 64 keys a tile;
//    query rows past Sq carry LSE = +inf in dkdv, so their P is 0.  This
//    design runs eight products (q k^T twice in dq), so it can reach at
//    best 5/8 of the bound.
//
// Each entry point returns cudaGetLastError() after each launch, -1 for an
// unsupported dtype, head size or tile, -2 if a tensor map cannot be made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_fragments.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int BR = 64;  // query rows of a q tile (a dq CTA's rows)
constexpr int BC = 64;  // keys of a KV tile (a dkdv CTA's keys)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, H, Sq): base-2 log-sum-exp of scale log2(e) q k^T
  float* delta;  // (B, H, Sq): rowsum(dO * O)
  float* dk_part;  // (B, Skv, H, D) float32 per-head dk and dv when
  float* dv_part;  // H > Hkv (summed by flash_bwd_dkdv_reduce), else null
  const int* q_order;   // the dq kernel's q tiles, longest first
  const int* kv_order;  // the dkdv kernel's KV tiles, longest first
  int Sq, Skv, H, Hkv;
  int causal, has_window, window;
  float scale;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// KV tiles [j0, j1) that some query row in [r0, r1) may see
// (flash_attention.py: _kv_tiles).
template <class P>
__device__ __forceinline__ void kv_tiles(const P& p, int r0, int r1, int& j0,
                                         int& j1) {
  const long long off = (long long)p.Skv - p.Sq;
  long long lo = 0, hi = p.Skv;
  if (p.causal) hi = min(hi, off + r1);
  if (p.has_window) lo = max(lo, off + r0 - p.window + 1);
  if (hi <= lo) {
    j0 = j1 = 0;
    return;
  }
  j0 = (int)(lo / BC);
  j1 = (int)((hi + BC - 1) / BC);
}

// Q tiles [t0, t1) with a row that may see some key of KV tile j
// (flash_attention.py: _q_tiles).
template <class P>
__device__ __forceinline__ void q_tiles(const P& p, int j, int& t0,
                                        int& t1) {
  const long long off = (long long)p.Skv - p.Sq;
  const long long k0 = (long long)j * BC;
  const long long k1 = min((long long)p.Skv, k0 + BC);
  long long lo = 0, hi = p.Sq;
  if (p.causal) lo = max(lo, k0 - off);
  if (p.has_window) hi = min(hi, k1 - 1 - off + p.window);
  if (hi <= lo) {
    t0 = t1 = 0;
    return;
  }
  t0 = (int)(lo / BR);
  t1 = (int)((hi + BR - 1) / BR);
}

// Whether some (row in [r0, r1), key in tile j) pair is not visible
// (flash_attention.py: _tile_masked).
template <class P>
__device__ __forceinline__ bool tile_masked(const P& p, int r0, int r1,
                                            int j) {
  const long long off = (long long)p.Skv - p.Sq;
  const long long k0 = (long long)j * BC, k1 = k0 + BC - 1;
  return k1 >= p.Skv || (p.causal && k1 > off + r0) ||
         (p.has_window && k0 <= off + r1 - 1 - p.window);
}

template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (!p.has_window || kpos > qpos - p.window);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// Merge a partial (max, sum) of exp2 terms from another lane.
__device__ __forceinline__ void merge_lse(float& m, float& l, float mo,
                                          float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both saw nothing
  l = l * exp2f(m - mn) + lo * exp2f(mo - mn);
  m = mn;
}

// ------------------------------------------------------------------ bf16
// all but the newest group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n");
}

// Four 8x8 b16 matrices out of shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3).
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Rows [0, n) of a (rows, D) bf16 tile at `src` (row stride `stride`) into
// shared memory with row stride LD by cp.async, zeros past `valid` rows.
template <int D, int LD>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long stride, int n,
                                            int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < n * CH; c += 128) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool in = r < valid;
    cp_async16(dst + r * LD + col, in ? src + r * stride + col : src, in);
  }
}

// S (+)= A B^T for one warp's 16 rows against 8 NT rows of a shared-memory
// tile (row stride LD): c[nn] is the 16 x 8 C fragment of tile rows
// n0 + 8 nn, A the warp's D-wide fragments in registers.
template <int D, int LD, int NT>
__device__ __forceinline__ void rows_dot(float (*c)[4],
                                         const uint32_t (*a)[4],
                                         const __nv_bfloat16* tile, int n0,
                                         int lane) {
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    const __nv_bfloat16* r =
        tile + (n0 + nn * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b0, b1, b2, b3;
      if (kk + 1 < D / 16) {
        ldmatrix_x4(b0, b1, b2, b3, r + kk * 16);
        mma_bf16(c[nn], a[kk], b0, b1);
        mma_bf16(c[nn], a[kk + 1], b2, b3);
      } else {  // an odd last step (D = 16, 112): one k16 step
        const __nv_bfloat16* b =
            tile + (n0 + nn * 8 + (lane >> 2)) * LD + kk * 16 + 2 * (lane & 3);
        b0 = ld32(b);
        b1 = ld32(b + 8);
        mma_bf16(c[nn], a[kk], b0, b1);
      }
    }
  }
}

// Keys a dq warp scores at a time: all 64 of a tile in sweep 1 (eight
// independent mma chains; the dq accumulators are not live yet), 16 in
// sweep 2 (beside the D-wide float32 dq accumulators, no spills at D = 128).
constexpr int KC1 = 64, KC2 = 16;

template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;  // 16-byte rows, no bank conflicts
  __nv_bfloat16 k[2][BC * LD], v[2][BC * LD];  // two stages
};

template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int LD = DqSmem<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = p.q_order[blockIdx.x] * BR;
  const int r1 = min(row0 + BR, p.Sq);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const long long qo = (long long)b * p.Sq * qs + (long long)h * D;
  const long long ko = (long long)b * p.Skv * ks + (long long)hk * D;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)p.q + qo;
  const __nv_bfloat16* ob = (const __nv_bfloat16*)p.o + qo;
  const __nv_bfloat16* db = (const __nv_bfloat16*)p.dout + qo;
  const __nv_bfloat16* kb = (const __nv_bfloat16*)p.k + ko;
  const __nv_bfloat16* vb = (const __nv_bfloat16*)p.v + ko;
  __nv_bfloat16* dqb = (__nv_bfloat16*)p.dq + qo;

  int j0, j1;
  kv_tiles(p, row0, r1, j0, j1);
  // K (and V) tile j into stage s, one cp.async group
  auto issue = [&](int s, int j, bool with_v) {
    const int kv0 = j * BC;
    stage_async<D, LD>(sm.k[s], kb + kv0 * ks, ks, BC, p.Skv - kv0);
    if (with_v)
      stage_async<D, LD>(sm.v[s], vb + kv0 * ks, ks, BC, p.Skv - kv0);
    cp_async_commit();
  };
  if (j0 < j1) issue(0, j0, false);

  // this thread's two rows of the warp's 16 (the mma C layout)
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const bool va = ra < p.Sq, vb_ = rb < p.Sq;
  uint32_t qa[D / 16][4], da[D / 16][4];
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = va ? ld32(qb + ra * qs + c) : 0u;
    qa[kk][1] = vb_ ? ld32(qb + rb * qs + c) : 0u;
    qa[kk][2] = va ? ld32(qb + ra * qs + c + 8) : 0u;
    qa[kk][3] = vb_ ? ld32(qb + rb * qs + c + 8) : 0u;
    da[kk][0] = va ? ld32(db + ra * qs + c) : 0u;
    da[kk][1] = vb_ ? ld32(db + rb * qs + c) : 0u;
    da[kk][2] = va ? ld32(db + ra * qs + c + 8) : 0u;
    da[kk][3] = vb_ ? ld32(db + rb * qs + c + 8) : 0u;
    // delta: dO * O over this thread's four columns of the 16
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? rb : ra;
      if (r < p.Sq) {
        const float2 x = unpack_bf16(da[kk][e]);
        const float2 y = unpack_bf16(ld32(ob + r * qs + c + (e >> 1) * 8));
        dl[e & 1] += x.x * y.x + x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
    dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
  }

  const int off = p.Skv - p.Sq;
  const int qpos[2] = {off + ra, off + rb};

  // sweep 1: each row's base-2 log-sum-exp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = j0; j < j1; ++j) {
    const int s = (j - j0) & 1, kv0 = j * BC;
    if (j + 1 < j1) issue(s ^ 1, j + 1, false);
    else cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile j has landed for every thread
    const bool masked = tile_masked(p, row0, r1, j);
#pragma unroll
    for (int kc = 0; kc < BC / KC1; ++kc) {
      float sc[KC1 / 8][4];
#pragma unroll
      for (int nn = 0; nn < KC1 / 8; ++nn)
        sc[nn][0] = sc[nn][1] = sc[nn][2] = sc[nn][3] = 0.f;
      rows_dot<D, LD, KC1 / 8>(sc, qa, sm.k[s], kc * KC1, lane);
#pragma unroll
      for (int nn = 0; nn < KC1 / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kv0 + kc * KC1 + nn * 8 + 2 * t + (e & 1);
          sc[nn][e] = !masked || visible(p, qpos[e >> 1], kpos)
                          ? sc[nn][e] * p.scale_log2 : -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mx = fmaxf(sc[nn][2 * i], sc[nn][2 * i + 1]);
          if (mx == -INFINITY) continue;
          const float mn = fmaxf(m[i], mx);
          l[i] = l[i] * exp2f(m[i] - mn) + exp2f(sc[nn][2 * i] - mn) +
                 exp2f(sc[nn][2 * i + 1] - mn);
          m[i] = mn;
        }
      }
    }
    __syncthreads();  // stage s is read; the next issue may refill it
  }
  if (j0 < j1) issue(0, j0, true);  // sweep 2's first tile, in flight now
  float lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      merge_lse(m[i], l[i], mo, lo);
    }
    lse[i] = m[i] == -INFINITY ? -INFINITY : m[i] + log2f(l[i]);
  }
  if (t == 0) {
    const long long so = ((long long)b * p.H + h) * p.Sq;
    if (va) {
      p.lse[so + ra] = lse[0];
      p.delta[so + ra] = dl[0];
    }
    if (vb_) {
      p.lse[so + rb] = lse[1];
      p.delta[so + rb] = dl[1];
    }
  }

  // sweep 2: dq = scale dS k, 16 keys at a time
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int s = (j - j0) & 1, kv0 = j * BC;
    if (j + 1 < j1) issue(s ^ 1, j + 1, true);
    else cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bool masked = tile_masked(p, row0, r1, j);
#pragma unroll
    for (int kc = 0; kc < BC / KC2; ++kc) {
      float sc[KC2 / 8][4], dp[KC2 / 8][4];
#pragma unroll
      for (int nn = 0; nn < KC2 / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nn][e] = dp[nn][e] = 0.f;
      rows_dot<D, LD, KC2 / 8>(sc, qa, sm.k[s], kc * KC2, lane);
      rows_dot<D, LD, KC2 / 8>(dp, da, sm.v[s], kc * KC2, lane);
#pragma unroll
      for (int nn = 0; nn < KC2 / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kpos = kv0 + kc * KC2 + nn * 8 + 2 * t + (e & 1);
          const float pe = !masked || visible(p, qpos[i], kpos)
                               ? exp2f(sc[nn][e] * p.scale_log2 - lse[i])
                               : 0.f;
          sc[nn][e] = pe * (dp[nn][e] - dl[i]);  // dS
        }
      }
#pragma unroll
      for (int ks16 = 0; ks16 < KC2 / 16; ++ks16) {
        // the C fragments of two key tiles are the A fragment of dS
        const uint32_t sa[4] = {pack_bf16(sc[2 * ks16][0], sc[2 * ks16][1]),
                                pack_bf16(sc[2 * ks16][2], sc[2 * ks16][3]),
                                pack_bf16(sc[2 * ks16 + 1][0],
                                          sc[2 * ks16 + 1][1]),
                                pack_bf16(sc[2 * ks16 + 1][2],
                                          sc[2 * ks16 + 1][3])};
        const __nv_bfloat16* kr =
            sm.k[s] +
            (kc * KC2 + ks16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
            (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, kr + dn * 16);
          mma_bf16(acc[2 * dn], sa, b0, b1);
          mma_bf16(acc[2 * dn + 1], sa, b2, b3);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (va)
      *reinterpret_cast<uint32_t*>(dqb + ra * qs + c) =
          pack_bf16(acc[n][0] * p.scale, acc[n][1] * p.scale);
    if (vb_)
      *reinterpret_cast<uint32_t*>(dqb + rb * qs + c) =
          pack_bf16(acc[n][2] * p.scale, acc[n][3] * p.scale);
  }
}

template <int D>
struct DkdvSmem {
  static constexpr int LD = D + 8;
  __nv_bfloat16 k[BC * LD], v[BC * LD];
  __nv_bfloat16 q[2][BR * LD], d[2][BR * LD];  // two stages
  float lse[2][BR], delta[2][BR];
};

template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_bf16_kernel(Params p) {
  constexpr int LD = DkdvSmem<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j = p.kv_order[blockIdx.x];
  const int kv0 = j * BC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const long long ko = (long long)b * p.Skv * ks + (long long)hk * D;
  const long long qo = (long long)b * p.Sq * qs + (long long)h * D;
  const long long so = ((long long)b * p.H + h) * p.Sq;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)p.q + qo;
  const __nv_bfloat16* db = (const __nv_bfloat16*)p.dout + qo;

  int t0, t1;
  q_tiles(p, j, t0, t1);
  // q tile qt's q and dO rows, LSE and delta into stage s, one group;
  // rows past Sq: LSE +inf makes their P 0
  auto issue = [&](int s, int qt) {
    const int r0 = qt * BR, n = min(BR, p.Sq - r0);
    stage_async<D, LD>(sm.q[s], qb + r0 * qs, qs, BR, n);
    stage_async<D, LD>(sm.d[s], db + r0 * qs, qs, BR, n);
    if (tid < BR) {
      sm.lse[s][tid] = tid < n ? p.lse[so + r0 + tid] : INFINITY;
      sm.delta[s][tid] = tid < n ? p.delta[so + r0 + tid] : 0.f;
    }
    cp_async_commit();
  };
  if (t0 < t1) {
    stage_async<D, LD>(sm.k, (const __nv_bfloat16*)p.k + ko + kv0 * ks, ks,
                       BC, p.Skv - kv0);
    stage_async<D, LD>(sm.v, (const __nv_bfloat16*)p.v + ko + kv0 * ks, ks,
                       BC, p.Skv - kv0);
    issue(0, t0);
  }

  // this thread's two keys of the warp's 16 (the mma C layout's rows)
  const int w16 = warp * 16;
  const int off = p.Skv - p.Sq;
  const int kpos[2] = {kv0 + w16 + g, kv0 + w16 + g + 8};
  // lane l's address of the warp's 16 x 16 A fragment (and of a B tile's
  // transposed 16 x 16 block) in a row-major shared-memory tile
  const int frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = t0; qt < t1; ++qt) {
    const int s = (qt - t0) & 1, r0 = qt * BR;
    if (qt + 1 < t1) issue(s ^ 1, qt + 1);
    else cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // q tile qt has landed for every thread
    const bool masked = tile_masked(p, r0, min(r0 + BR, p.Sq), j);
#pragma unroll 1
    for (int qc = 0; qc < BR / 16; ++qc) {
      // s^T = k q^T and dP^T = v dO^T for the warp's 16 keys and 16 rows
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nn][e] = dpt[nn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka[0], ka[1], ka[2], ka[3],
                    sm.k + w16 * LD + frag + kk * 16);
        ldmatrix_x4(va[0], va[1], va[2], va[3],
                    sm.v + w16 * LD + frag + kk * 16);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int qr = (qc * 16 + nn * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(st[nn], ka, ld32(sm.q[s] + qr), ld32(sm.q[s] + qr + 8));
          mma_bf16(dpt[nn], va, ld32(sm.d[s] + qr), ld32(sm.d[s] + qr + 8));
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = qc * 16 + nn * 8 + 2 * t + (e & 1);
          const float pe =
              !masked || visible(p, off + r0 + rl, kpos[e >> 1])
                  ? exp2f(st[nn][e] * p.scale_log2 - sm.lse[s][rl]) : 0.f;
          st[nn][e] = pe;                                    // P^T
          dpt[nn][e] = pe * (dpt[nn][e] - sm.delta[s][rl]);  // dS^T
        }
      }
      const uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]),
                              pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]),
                              pack_bf16(st[1][2], st[1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[0][0], dpt[0][1]),
                              pack_bf16(dpt[0][2], dpt[0][3]),
                              pack_bf16(dpt[1][0], dpt[1][1]),
                              pack_bf16(dpt[1][2], dpt[1][3])};
      // dv += P^T dO and dk += dS^T q: B from the row-major dO and q rows
      const int rr = qc * 16 * LD + frag;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, sm.d[s] + rr + dn * 16);
        mma_bf16(dv[2 * dn], pa, b0, b1);
        mma_bf16(dv[2 * dn + 1], pa, b2, b3);
        ldmatrix_x4_trans(b0, b1, b2, b3, sm.q[s] + rr + dn * 16);
        mma_bf16(dk[2 * dn], sa, b0, b1);
        mma_bf16(dk[2 * dn + 1], sa, b2, b3);
      }
    }
    __syncthreads();  // stage s is read; the next issue may refill it
  }
  // one query head's share: dk and dv themselves when H = Hkv, else
  // float32 rows for flash_bwd_dkdv_reduce
  const long long ps = (long long)p.H * D;
  const long long po = (long long)b * p.Skv * ps + (long long)h * D;
  __nv_bfloat16* dkb = (__nv_bfloat16*)p.dk + ko;
  __nv_bfloat16* dvb = (__nv_bfloat16*)p.dv + ko;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kpos[i] >= p.Skv) continue;
      const float k0 = dk[n][2 * i] * p.scale, k1 = dk[n][2 * i + 1] * p.scale;
      if (p.dk_part) {
        const long long at = po + (long long)kpos[i] * ps + c;
        *reinterpret_cast<float2*>(p.dk_part + at) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(p.dv_part + at) =
            make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      } else {
        const long long at = (long long)kpos[i] * ks + c;
        *reinterpret_cast<uint32_t*>(dkb + at) = pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(dvb + at) =
            pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- float32
// Eight warps; a dq CTA's warp owns 8 of its 64 rows, a dkdv CTA's warp 8
// of its 64 keys.  Lane l takes key l (dq) or query row l (dkdv) of a
// 32-wide half tile for the dot products, and columns l + 32 i for the
// accumulators.
constexpr int F32_THREADS = 256, F32_ROWS = 8, HALF = 32;

template <int D>
struct DqF32Smem {
  float q[BR * D], d[BR * D];            // read as broadcasts
  float k[HALF * (D + 1)], v[HALF * (D + 1)];  // odd stride: lane l, bank l
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_dq_f32_kernel(Params p) {
  constexpr int NI = (D + 31) / 32, KD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqF32Smem<D>& sm = *reinterpret_cast<DqF32Smem<D>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = p.q_order[blockIdx.x] * BR;
  const int r1 = min(row0 + BR, p.Sq);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const long long qo = (long long)b * p.Sq * qs + (long long)h * D;
  const long long ko = (long long)b * p.Skv * ks + (long long)hk * D;
  const float* kb = (const float*)p.k + ko;
  const float* vb = (const float*)p.v + ko;
  for (int c = tid; c < BR * D; c += F32_THREADS) {
    const int r = c / D, d = c % D;
    const bool in = row0 + r < p.Sq;
    sm.q[c] = in ? ((const float*)p.q)[qo + (row0 + r) * qs + d] : 0.f;
    sm.d[c] = in ? ((const float*)p.dout)[qo + (row0 + r) * qs + d] : 0.f;
  }
  __syncthreads();
  const int wr = warp * F32_ROWS;  // the warp's first row in the tile
  const int off = p.Skv - p.Sq;
  // delta = rowsum(dO * O), lanes over columns
  float dl[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    float x = 0.f;
    if (row0 + wr + r < p.Sq)
      for (int d = lane; d < D; d += 32)
        x += sm.d[(wr + r) * D + d] *
             ((const float*)p.o)[qo + (row0 + wr + r) * qs + d];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    dl[r] = x;
  }
  int j0, j1;
  kv_tiles(p, row0, r1, j0, j1);

  // sweep 1: each row's base-2 log-sum-exp
  float m[F32_ROWS], l[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int j = j0; j < j1; ++j) {
    const bool masked = tile_masked(p, row0, r1, j);
    for (int kv0 = j * BC; kv0 < j * BC + BC; kv0 += HALF) {
      __syncthreads();
      for (int c = tid; c < HALF * D; c += F32_THREADS) {
        const int jj = c / D, d = c % D;
        sm.k[jj * KD + d] = kv0 + jj < p.Skv ? kb[(kv0 + jj) * ks + d] : 0.f;
      }
      __syncthreads();
      float s[F32_ROWS];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) s[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = sm.k[lane * KD + d];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r)
          s[r] = fmaf(sm.q[(wr + r) * D + d], kd, s[r]);
      }
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const bool vis =
            !masked || visible(p, off + row0 + wr + r, kv0 + lane);
        if (!vis) continue;
        const float x = s[r] * p.scale_log2;
        const float mn = fmaxf(m[r], x);
        l[r] = l[r] * exp2f(m[r] - mn) + exp2f(x - mn);
        m[r] = mn;
      }
    }
  }
  float lse[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      merge_lse(m[r], l[r], mo, lo);
    }
    lse[r] = m[r] == -INFINITY ? -INFINITY : m[r] + log2f(l[r]);
    const int row = row0 + wr + r;
    if (lane == 0 && row < p.Sq) {
      const long long so = ((long long)b * p.H + h) * p.Sq;
      p.lse[so + row] = lse[r];
      p.delta[so + row] = dl[r];
    }
  }

  // sweep 2: dq = scale dS k
  float acc[F32_ROWS][NI];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const bool masked = tile_masked(p, row0, r1, j);
    for (int kv0 = j * BC; kv0 < j * BC + BC; kv0 += HALF) {
      __syncthreads();
      for (int c = tid; c < HALF * D; c += F32_THREADS) {
        const int jj = c / D, d = c % D;
        const bool in = kv0 + jj < p.Skv;
        sm.k[jj * KD + d] = in ? kb[(kv0 + jj) * ks + d] : 0.f;
        sm.v[jj * KD + d] = in ? vb[(kv0 + jj) * ks + d] : 0.f;
      }
      __syncthreads();
      float s[F32_ROWS], dp[F32_ROWS];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = sm.k[lane * KD + d], vd = sm.v[lane * KD + d];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) {
          s[r] = fmaf(sm.q[(wr + r) * D + d], kd, s[r]);
          dp[r] = fmaf(sm.d[(wr + r) * D + d], vd, dp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const bool vis =
            !masked || visible(p, off + row0 + wr + r, kv0 + lane);
        const float pe = vis ? exp2f(s[r] * p.scale_log2 - lse[r]) : 0.f;
        s[r] = pe * (dp[r] - dl[r]);  // dS
      }
      for (int jj = 0; jj < HALF; ++jj) {
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) {
          const float x = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int d = lane + 32 * i;
            if (D % 32 == 0 || d < D)
              acc[r][i] = fmaf(x, sm.k[jj * KD + d], acc[r][i]);
          }
        }
      }
    }
  }
  float* dqb = (float*)p.dq + qo;
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const int row = row0 + wr + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D) dqb[row * qs + d] = acc[r][i] * p.scale;
    }
  }
}

template <int D>
struct DkdvF32Smem {
  float k[BC * D], v[BC * D];                  // read as broadcasts
  float q[HALF * (D + 1)], d[HALF * (D + 1)];  // odd stride: lane l, bank l
  float lse[HALF], delta[HALF];
};

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_bwd_dkdv_f32_kernel(Params p) {
  constexpr int NI = (D + 31) / 32, QD = D + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvF32Smem<D>& sm = *reinterpret_cast<DkdvF32Smem<D>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = p.kv_order[blockIdx.x];
  const int kv0 = j * BC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qs = (long long)p.H * D, ks = (long long)p.Hkv * D;
  const long long ko = (long long)b * p.Skv * ks + (long long)hk * D;
  for (int c = tid; c < BC * D; c += F32_THREADS) {
    const int jj = c / D, d = c % D;
    const bool in = kv0 + jj < p.Skv;
    sm.k[c] = in ? ((const float*)p.k)[ko + (kv0 + jj) * ks + d] : 0.f;
    sm.v[c] = in ? ((const float*)p.v)[ko + (kv0 + jj) * ks + d] : 0.f;
  }
  const int wk = warp * F32_ROWS;  // the warp's first key in the tile
  const int off = p.Skv - p.Sq;
  float dk[F32_ROWS][NI], dv[F32_ROWS][NI];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
#pragma unroll
    for (int i = 0; i < NI; ++i) dk[r][i] = dv[r][i] = 0.f;

  int t0, t1;
  q_tiles(p, j, t0, t1);
  const long long qo = (long long)b * p.Sq * qs + (long long)h * D;
  const long long so = ((long long)b * p.H + h) * p.Sq;
  for (int qt = t0; qt < t1; ++qt) {
    {
      const bool masked = tile_masked(p, qt * BR, min(qt * BR + BR, p.Sq), j);
      for (int q0 = qt * BR; q0 < qt * BR + BR; q0 += HALF) {
        __syncthreads();  // the previous rows are consumed
        for (int c = tid; c < HALF * D; c += F32_THREADS) {
          const int rr = c / D, d = c % D;
          const bool in = q0 + rr < p.Sq;
          sm.q[rr * QD + d] =
              in ? ((const float*)p.q)[qo + (q0 + rr) * qs + d] : 0.f;
          sm.d[rr * QD + d] =
              in ? ((const float*)p.dout)[qo + (q0 + rr) * qs + d] : 0.f;
        }
        if (tid < HALF) {
          // rows past Sq: LSE +inf makes their P 0
          sm.lse[tid] = q0 + tid < p.Sq ? p.lse[so + q0 + tid] : INFINITY;
          sm.delta[tid] = q0 + tid < p.Sq ? p.delta[so + q0 + tid] : 0.f;
        }
        __syncthreads();
        float st[F32_ROWS], dpt[F32_ROWS];
#pragma unroll
        for (int kk = 0; kk < F32_ROWS; ++kk) st[kk] = dpt[kk] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float qd = sm.q[lane * QD + d], dd = sm.d[lane * QD + d];
#pragma unroll
          for (int kk = 0; kk < F32_ROWS; ++kk) {
            st[kk] = fmaf(sm.k[(wk + kk) * D + d], qd, st[kk]);
            dpt[kk] = fmaf(sm.v[(wk + kk) * D + d], dd, dpt[kk]);
          }
        }
        const float lse = sm.lse[lane], dl = sm.delta[lane];
#pragma unroll
        for (int kk = 0; kk < F32_ROWS; ++kk) {
          const bool vis =
              !masked || visible(p, off + q0 + lane, kv0 + wk + kk);
          const float pe = vis ? exp2f(st[kk] * p.scale_log2 - lse) : 0.f;
          st[kk] = pe;                       // P^T
          dpt[kk] = pe * (dpt[kk] - dl);     // dS^T
        }
        for (int rr = 0; rr < HALF; ++rr) {
#pragma unroll
          for (int kk = 0; kk < F32_ROWS; ++kk) {
            const float pv = __shfl_sync(0xffffffffu, st[kk], rr);
            const float sv = __shfl_sync(0xffffffffu, dpt[kk], rr);
#pragma unroll
            for (int i = 0; i < NI; ++i) {
              const int d = lane + 32 * i;
              if (D % 32 == 0 || d < D) {
                dv[kk][i] = fmaf(pv, sm.d[rr * QD + d], dv[kk][i]);
                dk[kk][i] = fmaf(sv, sm.q[rr * QD + d], dk[kk][i]);
              }
            }
          }
        }
      }
    }
  }
  // one query head's share, as the bf16 kernel writes it
  const long long ps = (long long)p.H * D;
  float* dkb = p.dk_part ? p.dk_part + (long long)b * p.Skv * ps +
                               (long long)h * D : (float*)p.dk + ko;
  float* dvb = p.dk_part ? p.dv_part + (long long)b * p.Skv * ps +
                               (long long)h * D : (float*)p.dv + ko;
  const long long rs = p.dk_part ? ps : ks;
#pragma unroll
  for (int kk = 0; kk < F32_ROWS; ++kk) {
    const int key = kv0 + wk + kk;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D) {
        dkb[key * rs + d] = dk[kk][i] * p.scale;
        dvb[key * rs + d] = dv[kk][i];
      }
    }
  }
}

// dk and dv of each KV head: the float32 shares of its rep query heads
// summed in head order (one fixed order), four columns a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_reduce_kernel(Params p, int D, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int rep = p.H / p.Hkv, D4 = D / 4;
  const long long row = i / (p.Hkv * D4);  // b * Skv + key
  const int hk = (int)(i / D4 % p.Hkv), c = (int)(i % D4) * 4;
  const long long src = (row * p.H + (long long)hk * rep) * D + c;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int r = 0; r < rep; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(p.dk_part + src + r * D);
    const float4 v = *reinterpret_cast<const float4*>(p.dv_part + src + r * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += v.x; sv.y += v.y; sv.z += v.z; sv.w += v.w;
  }
  store4((T*)p.dk + i * 4, sk);
  store4((T*)p.dv + i * 4, sv);
}

// ================================================================= sm90
// The bf16 route at head sizes 64 and 128: wgmma on warpgroup tiles, TMA
// rings, the forward's saved LSE (the note at the top).
constexpr int RING = 2;  // ring depth: K/V tiles (dq), q/dO tiles (dkdv)

struct P90 {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;  // (B, H, Sq): the forward's base-2 log-sum-exp
  float* delta;      // (B, H, Sq): rowsum(dO * O), written by dq
  float* dk_part;    // (B, Skv, H, D) float32 shares when split, else null
  float* dv_part;
  const int* q_order;   // dq's q tiles, longest first
  const int* kv_order;  // dkdv's KV tiles, longest first
  int B, Sq, Skv, H, Hkv;
  int causal, has_window, window;
  float scale;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int split;         // dkdv: one CTA per query head, shares + reduce
};

__device__ __forceinline__ int ring_slot(uint32_t n) { return n % RING; }
__device__ __forceinline__ uint32_t ring_parity(uint32_t n) {
  return (n / RING) & 1;
}

// The dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).
template <class S>
__device__ __forceinline__ S& aligned_smem(uint8_t* raw) {
  return *reinterpret_cast<S*>(raw +
                               ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// dO . O over eight bf16 values of each, in float32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = unpack_bf16(x[i]), v = unpack_bf16(y[i]);
    s += u.x * v.x + u.y * v.y;
  }
  return s;
}

// A tile of R rows x D columns is D / 64 boxes of R x 64, one after the
// other, each on a 1024-byte boundary.
template <int D, int NC>
struct DqSmem90 {
  __nv_bfloat16 q[NC * 64 * D];
  __nv_bfloat16 d[NC * 64 * D];  // dO
  __nv_bfloat16 k[RING][BC * D];
  __nv_bfloat16 v[RING][BC * D];
  float dl[NC][64];  // delta of each warpgroup's rows
  uint64_t full[RING], empty[RING], qd_full;
};

// dq: CTA x owns NC x 64 query rows of one head (q tile q_order[x / (B H)],
// then b and h), q and dO resident, and walks its visible KV tiles of BC
// keys in ascending order through a ring of K and V slots.  Each of NC
// warpgroups takes 64 rows: S = q k^T and dP = dO v^T (wgmma, both
// operands from shared memory), P = exp2(S scale log2(e) - LSE),
// dS = P (dP - delta), dq += dS k (wgmma, dS from registers, k MN-major).
// The first warp also loads (its lane 0 issues the TMA copies): starting
// tile j, it loads tile j + 1 into the slot tile j - 1 has released.
template <int D, int NC>
__global__ void __launch_bounds__(NC * 128, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const P90 p) {
  constexpr int BQ = NC * 64;  // query rows of the CTA
  extern __shared__ uint8_t smem_raw[];
  DqSmem90<D, NC>& sm = aligned_smem<DqSmem90<D, NC>>(smem_raw);
  // the warpgroup and warp, warp-uniform to the compiler (shuffled from
  // lane 0)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 32 % 4, 0);
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, c4 = lane % 4;
  const bool loader = wg == 0 && w == 0;
  const int bh = p.B * p.H, rem = blockIdx.x % bh;
  const int r0 = p.q_order[blockIdx.x / bh] * BQ;
  const int h = rem % p.H, b = rem / p.H, hk = h / (p.H / p.Hkv);
  int j0, j1;
  kv_tiles(p, r0, min(r0 + BQ, p.Sq), j0, j1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NC * 128);
    }
    mbar_init(&sm.qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // K and V tile j into its slot, once the tile before it there is done
  auto load = [&](int j) {
    const uint32_t n = j - j0;
    const int st = ring_slot(n);
    if (lane == 0) {
      mbar_wait(&sm.empty[st], ring_parity(n) ^ 1);
      mbar_expect_tx(&sm.full[st], 2 * BC * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sm.k[st] + c * BC * 64, &tm_k, c * 64, hk, j * BC, b,
                 &sm.full[st]);
        tma_load(sm.v[st] + c * BC * 64, &tm_v, c * 64, hk, j * BC, b,
                 &sm.full[st]);
      }
    }
    __syncwarp();
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(&sm.qd_full, 2 * BQ * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sm.q + c * BQ * 64, &tm_q, c * 64, h, r0, b, &sm.qd_full);
        tma_load(sm.d + c * BQ * 64, &tm_do, c * 64, h, r0, b, &sm.qd_full);
      }
    }
    if (j0 < j1) load(j0);
  }
  const int rw0 = r0 + wg * 64, rw1 = min(rw0 + 64, p.Sq);
  const long long so = ((long long)b * p.H + h) * p.Sq;
  const long long qs = (long long)p.H * D;
  {
    // delta = rowsum(dO * O) in float32, two threads a row (written for
    // dkdv); the loads overlap the first tiles' copies
    const int row = rw0 + t / 2;
    float x = 0.f;
    if (row < p.Sq) {
      const long long at = ((long long)b * p.Sq + row) * qs +
                           (long long)h * D + (t & 1) * (D / 2);
      const uint4* pd = reinterpret_cast<const uint4*>(p.dout + at);
      const uint4* po = reinterpret_cast<const uint4*>(p.o + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) x += dot8(pd[c], po[c]);
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    if ((t & 1) == 0) {
      sm.dl[wg][t / 2] = x;
      if (row < p.Sq) p.delta[so + row] = x;
    }
  }
  named_bar(1 + wg, 128);
  // this thread's two rows (the wgmma accumulator layout: warp w holds
  // rows 16w..16w+15 of the warpgroup's 64, lane l rows l/4 and l/4 + 8)
  const int ra = w * 16 + g;
  float lse[2], dl[2];
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw0 + ra + 8 * r;
    lse[r] = row < p.Sq ? p.lse[so + row] : INFINITY;  // past Sq: P = 0
    dl[r] = sm.dl[wg][ra + 8 * r];
    qpos[r] = p.Skv - p.Sq + row;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t sa[BC / 16][4];
  const uint32_t q_base = smem_u32(sm.q) + wg * 64 * 128;
  const uint32_t d_base = smem_u32(sm.d) + wg * 64 * 128;
  mbar_wait(&sm.qd_full, 0);
  uint32_t n = 0;
  for (int j = j0; j < j1; ++j, ++n) {
    const int st = ring_slot(n);
    if (loader && j + 1 < j1) load(j + 1);  // into tile j - 1's slot
    const uint32_t k_base = smem_u32(sm.k[st]);
    const uint32_t v_base = smem_u32(sm.v[st]);
    float s[BC / 2], dp[BC / 2];
    mbar_wait(&sm.full[st], ring_parity(n));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(
          s, desc_b128(q_base + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
          desc_b128(k_base + (kk / 4) * BC * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(
          dp,
          desc_b128(d_base + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
          desc_b128(v_base + (kk / 4) * BC * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    const bool masked = tile_masked(p, rw0, rw1, j);
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      // s[i]: row ra (i % 4 < 2) or ra + 8, key j*BC + 8*(i/4) + 2*c4 + i%2
      const int r = (i >> 1) & 1;
      const int kpos = j * BC + (i / 4) * 8 + 2 * c4 + (i & 1);
      const float pe = !masked || visible(p, qpos[r], kpos)
                           ? exp2f(s[i] * p.scale_log2 - lse[r])
                           : 0.f;
      s[i] = pe * (dp[i] - dl[r]);  // dS
    }
    // the accumulator's keys 16kk..16kk+15 are the A fragment of step kk
#pragma unroll
    for (int i = 0; i < BC / 2; i += 2)
      sa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wgmma_rs_d<D>(acc, sa[kk],
                    desc_b128(k_base + kk * 16 * 128, BC * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(sa);
    mbar_arrive(&sm.empty[st]);
  }
  __nv_bfloat16* dqb = p.dq + (long long)b * p.Sq * qs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = rw0 + ra + ((i >> 1) & 1) * 8;
    const int col = (i / 4) * 8 + 2 * c4;
    if (row < p.Sq)
      *reinterpret_cast<uint32_t*>(dqb + row * qs + col) =
          pack_bf16(acc[i] * p.scale, acc[i + 1] * p.scale);
  }
}

template <int D>
struct DkdvSmem90 {
  __nv_bfloat16 k[BC * D];
  __nv_bfloat16 v[BC * D];
  __nv_bfloat16 q[RING][BR * D];
  __nv_bfloat16 d[RING][BR * D];  // dO
  float lse[RING][BR], delta[RING][BR];
  uint64_t full[RING], empty[RING], kv_full;
};

// dkdv: CTA x, one warpgroup, owns the BC keys of one KV head (KV tile
// kv_order[x / (B heads)], then b and the head), K and V resident, and
// walks the rep = H / Hkv query heads of its KV head in ascending order
// and each one's visible q tiles of BR rows in ascending order (split: one
// query head, its share in float32) through a ring of q and dO slots:
// S^T = k q^T and dP^T = v dO^T (wgmma from shared memory), P^T,
// dv += P^T dO (P^T from registers, dO MN-major), dS^T = P^T (dP^T -
// delta) while that product runs, then dk += dS^T q.  dk and dv stay in
// float32 registers and are written once.  The first warp also loads:
// starting a q tile, it loads the next one into the slot the one before
// has released (its lane 0 issues the TMA copies, its lanes stage the
// tile's LSE and delta).
// Two CTAs an SM at D = 128 (236 registers a thread), three at D = 64:
// the SM's tensor cores take one CTA's products while another's
// warpgroup computes its softmax
template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 2)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_do,
                               const P90 p) {
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem90<D>& sm = aligned_smem<DkdvSmem90<D>>(smem_raw);
  // the warp, warp-uniform to the compiler (shuffled from lane 0)
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int t = threadIdx.x, lane = t % 32, g = lane / 4, c4 = lane % 4;
  const bool loader = w == 0;
  const int heads = p.split ? p.H : p.Hkv, rep = p.H / p.Hkv;
  const int bh = p.B * heads, rem = blockIdx.x % bh;
  const int j = p.kv_order[blockIdx.x / bh];
  const int hh = rem % heads, b = rem / heads;
  const int hk = p.split ? hh / rep : hh;
  const int h0 = p.split ? hh : hh * rep, nh = p.split ? 1 : rep;
  const int kv0 = j * BC;
  int t0, t1;
  q_tiles(p, j, t0, t1);
  const int nq = t1 - t0, steps = nh * nq;  // (query head, q tile) steps
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      // the TMA's arrival and the 32 lanes that store LSE and delta
      mbar_init(&sm.full[s], 33);
      mbar_init(&sm.empty[s], 128);
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step n's q and dO, LSE and delta into its slot, once the step before
  // it there is done; rows past Sq get LSE +inf, so P = 0 (their q and dO
  // are zeros)
  auto load = [&](int n) {
    const int st = ring_slot(n), h = h0 + n / nq, r0 = (t0 + n % nq) * BR;
    const long long so = ((long long)b * p.H + h) * p.Sq;
    mbar_wait(&sm.empty[st], ring_parity(n) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&sm.full[st], 2 * BR * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sm.q[st] + c * BR * 64, &tm_q, c * 64, h, r0, b,
                 &sm.full[st]);
        tma_load(sm.d[st] + c * BR * 64, &tm_do, c * 64, h, r0, b,
                 &sm.full[st]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = lane + 32 * e;
      const bool in = r0 + r < p.Sq;
      sm.lse[st][r] = in ? p.lse[so + r0 + r] : INFINITY;
      sm.delta[st][r] = in ? p.delta[so + r0 + r] : 0.f;
    }
    mbar_arrive(&sm.full[st]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * BC * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sm.k + c * BC * 64, &tm_k, c * 64, hk, kv0, b, &sm.kv_full);
        tma_load(sm.v + c * BC * 64, &tm_v, c * 64, hk, kv0, b, &sm.kv_full);
      }
    }
    __syncwarp();
    if (steps > 0) load(0);
  }
  const int key0 = kv0 + w * 16 + g;  // this thread's keys: key0, key0 + 8
  const int off = p.Skv - p.Sq;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[BR / 16][4], sa[BR / 16][4];
  const uint32_t k_base = smem_u32(sm.k), v_base = smem_u32(sm.v);
  mbar_wait(&sm.kv_full, 0);
  for (int n = 0; n < steps; ++n) {
    const int st = ring_slot(n), r0 = (t0 + n % nq) * BR;
    if (loader && n + 1 < steps) load(n + 1);  // into step n - 1's slot
    const bool masked = tile_masked(p, r0, min(r0 + BR, p.Sq), j);
    const uint32_t q_base = smem_u32(sm.q[st]);
    const uint32_t d_base = smem_u32(sm.d[st]);
    float s[BR / 2], dp[BR / 2];
    mbar_wait(&sm.full[st], ring_parity(n));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(
          s, desc_b128(k_base + (kk / 4) * BC * 128 + (kk % 4) * 32, 16, 1024),
          desc_b128(q_base + (kk / 4) * BR * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(
          dp,
          desc_b128(v_base + (kk / 4) * BC * 128 + (kk % 4) * 32, 16, 1024),
          desc_b128(d_base + (kk / 4) * BR * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // P^T: s[i] is key key0 (i % 4 < 2) or key0 + 8 against query row
    // r0 + 8*(i/4) + 2*c4 + i%2
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) {
      const int col = (i / 4) * 8 + 2 * c4 + (i & 1);
      const bool vis =
          !masked || visible(p, off + r0 + col, key0 + 8 * ((i >> 1) & 1));
      s[i] = vis ? exp2f(s[i] * p.scale_log2 - sm.lse[st][col]) : 0.f;
    }
    // the accumulator's rows 16kk..16kk+15 are the A fragment of step kk
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2)
      pa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
      wgmma_rs_d<D>(dv, pa[kk],
                    desc_b128(d_base + kk * 16 * 128, BR * 128, 1024), 1);
    wgmma_commit();
    // dS^T while dv's product runs
#pragma unroll
    for (int i = 0; i < BR / 2; ++i) {
      const int col = (i / 4) * 8 + 2 * c4 + (i & 1);
      dp[i] = s[i] * (dp[i] - sm.delta[st][col]);
    }
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2)
      sa[i / 8][(i % 8) / 2] = pack_bf16(dp[i], dp[i + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
      wgmma_rs_d<D>(dk, sa[kk],
                    desc_b128(q_base + kk * 16 * 128, BR * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(sa);
    mbar_arrive(&sm.empty[st]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = key0 + ((i >> 1) & 1) * 8;
    const int col = (i / 4) * 8 + 2 * c4;
    if (key >= p.Skv) continue;
    const float k0 = dk[i] * p.scale, k1 = dk[i + 1] * p.scale;
    if (p.split) {
      const long long at = (((long long)b * p.Skv + key) * p.H + h0) * D + col;
      *reinterpret_cast<float2*>(p.dk_part + at) = make_float2(k0, k1);
      *reinterpret_cast<float2*>(p.dv_part + at) =
          make_float2(dv[i], dv[i + 1]);
    } else {
      const long long at =
          (((long long)b * p.Skv + key) * p.Hkv + hk) * D + col;
      *reinterpret_cast<uint32_t*>(p.dk + at) = pack_bf16(k0, k1);
      *reinterpret_cast<uint32_t*>(p.dv + at) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

// One launch with `bytes` of dynamic shared memory (the attribute set once
// per instance); returns cudaGetLastError().
template <typename K>
int launch_dyn(K kern, dim3 grid, int threads, int bytes, const Params& p,
               cudaStream_t s, bool& ready) {
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  kern<<<grid, threads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Params& p, int B, int n_qt, int n_kt, int dtype,
             cudaStream_t s) {
  const dim3 gq(n_qt, p.H, B), gk(n_kt, p.H, B);
  int rc;
  if (dtype == 3) {
    static bool ready_dq = false, ready_kv = false;
    rc = launch_dyn(flash_bwd_dq_bf16_kernel<D>, gq, 128,
                    (int)sizeof(DqSmem<D>), p, s, ready_dq);
    if (rc) return rc;
    rc = launch_dyn(flash_bwd_dkdv_bf16_kernel<D>, gk, 128,
                    (int)sizeof(DkdvSmem<D>), p, s, ready_kv);
  } else {
    static bool ready_dq = false, ready_kv = false;
    rc = launch_dyn(flash_bwd_dq_f32_kernel<D>, gq, F32_THREADS,
                    (int)sizeof(DqF32Smem<D>), p, s, ready_dq);
    if (rc) return rc;
    rc = launch_dyn(flash_bwd_dkdv_f32_kernel<D>, gk, F32_THREADS,
                    (int)sizeof(DkdvF32Smem<D>), p, s, ready_kv);
  }
  if (rc || !p.dk_part) return rc;
  const long long n4 = (long long)B * p.Skv * p.Hkv * D / 4;
  const int blocks = (int)((n4 + 255) / 256);
  if (dtype == 3)
    flash_bwd_dkdv_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        p, D, n4);
  else
    flash_bwd_dkdv_reduce_kernel<float><<<blocks, 256, 0, s>>>(p, D, n4);
  return (int)cudaGetLastError();
}

// The sm90 route's launches: dq (NC = dq_rows / 64), dkdv, then, when
// split, the reduce of the float32 shares.
template <class K>
int launch_tma(K kern, int grid, int threads, int bytes, bool& ready,
               const CUtensorMap& a, const CUtensorMap& b,
               const CUtensorMap& c, const CUtensorMap& d, const P90& p,
               cudaStream_t s) {
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  if (grid > 0) kern<<<grid, threads, bytes, s>>>(a, b, c, d, p);
  return (int)cudaGetLastError();
}

template <int D, int NC>
int launch_dq90(const P90& p, const void* q, const void* k, const void* v,
                int n_qt, cudaStream_t s) {
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, D, NC * 64) ||
      !make_map(&tdo, p.dout, p.B, p.Sq, p.H, D, NC * 64) ||
      !make_map(&tk, k, p.B, p.Skv, p.Hkv, D, BC) ||
      !make_map(&tv, v, p.B, p.Skv, p.Hkv, D, BC))
    return -2;
  static bool ready = false;
  return launch_tma(flash_bwd_dq_sm90_kernel<D, NC>, n_qt * p.B * p.H,
                    NC * 128, (int)sizeof(DqSmem90<D, NC>) + 1024,
                    ready, tq, tdo, tk, tv, p, s);
}

template <int D>
int launch_dkdv90(const P90& p, const void* q, const void* k, const void* v,
                  int n_kt, cudaStream_t s) {
  CUtensorMap tk, tv, tq, tdo;
  if (!make_map(&tk, k, p.B, p.Skv, p.Hkv, D, BC) ||
      !make_map(&tv, v, p.B, p.Skv, p.Hkv, D, BC) ||
      !make_map(&tq, q, p.B, p.Sq, p.H, D, BR) ||
      !make_map(&tdo, p.dout, p.B, p.Sq, p.H, D, BR))
    return -2;
  static bool ready = false;
  return launch_tma(flash_bwd_dkdv_sm90_kernel<D>,
                    n_kt * p.B * (p.split ? p.H : p.Hkv), 128,
                    (int)sizeof(DkdvSmem90<D>) + 1024, ready, tk, tv, tq,
                    tdo, p, s);
}

template <int D>
int launch_d90(const P90& p, const void* q, const void* k, const void* v,
               int n_qt, int n_kt, int dq_rows, cudaStream_t s) {
  int rc = dq_rows == 64 ? launch_dq90<D, 1>(p, q, k, v, n_qt, s)
                         : launch_dq90<D, 2>(p, q, k, v, n_qt, s);
  if (rc) return rc;
  rc = launch_dkdv90<D>(p, q, k, v, n_kt, s);
  if (rc || !p.split) return rc;
  Params r{};  // the reduce's fields
  r.dk = p.dk;
  r.dv = p.dv;
  r.dk_part = p.dk_part;
  r.dv_part = p.dv_part;
  r.H = p.H;
  r.Hkv = p.Hkv;
  const long long n4 = (long long)p.B * p.Skv * p.Hkv * D / 4;
  flash_bwd_dkdv_reduce_kernel<__nv_bfloat16>
      <<<(int)((n4 + 255) / 256), 256, 0, s>>>(r, D, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, Hkv, D); all
// contiguous, of one dtype (0 float32, 3 bfloat16); lse, delta float32
// scratch of B * H * Sq; dk_part, dv_part float32 scratch of
// B * Skv * H * D when H > Hkv, else null; q_order: n_qt int32 q tiles,
// kv_order: n_kt int32 KV tiles, on the device, longest first
// (flash_attention.bwd_plan); D in
// {16, 32, 64, 112, 128}; has_window = 0 means no window.  Launches
// flash_bwd_dq, then flash_bwd_dkdv, then (H > Hkv) flash_bwd_dkdv_reduce,
// on `stream`.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* delta, void* dk_part,
                        void* dv_part, const void* q_order,
                        const void* kv_order, int n_qt, int n_kt, int B,
                        int Sq, int Skv, int H, int Hkv, int D, int causal,
                        int has_window, int window, float scale, int dtype,
                        void* stream) {
  if (dtype != 0 && dtype != 3) return -1;
  if ((H > Hkv) != (dk_part != nullptr)) return -1;
  Params p{q, k, v, o, dout, dq, dk, dv, (float*)lse, (float*)delta,
           (float*)dk_part, (float*)dv_part, (const int*)q_order,
           (const int*)kv_order, Sq, Skv, H, Hkv, causal, has_window, window,
           scale, scale * 1.4426950408889634f};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<16>(p, B, n_qt, n_kt, dtype, s);
    case 32: return launch_d<32>(p, B, n_qt, n_kt, dtype, s);
    case 64: return launch_d<64>(p, B, n_qt, n_kt, dtype, s);
    case 112: return launch_d<112>(p, B, n_qt, n_kt, dtype, s);
    case 128: return launch_d<128>(p, B, n_qt, n_kt, dtype, s);
    default: return -1;
  }
}

// The bf16 route at head sizes 64 and 128: q, o, dout, dq (B, Sq, H, D);
// k, v, dk, dv (B, Skv, Hkv, D), contiguous bf16; lse the forward's
// float32 (B, H, Sq) base-2 log-sum-exp; delta float32 scratch of
// B * H * Sq; split: dk_part, dv_part float32 scratch of B * Skv * H * D
// (else null); q_order: n_qt int32 tiles of dq_rows rows, kv_order: n_kt
// int32 tiles of 64 keys, on the device, longest first
// (flash_attention.bwd_plan); dq_rows in {64, 128}.  Launches
// flash_bwd_dq_sm90, then flash_bwd_dkdv_sm90 and (split)
// flash_bwd_dkdv_reduce on `stream`.
int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const void* lse, void* delta,
                             void* dk_part, void* dv_part,
                             const void* q_order, const void* kv_order,
                             int n_qt, int n_kt, int B, int Sq, int Skv,
                             int H, int Hkv, int D, int causal,
                             int has_window, int window, float scale,
                             int dq_rows, int split, void* stream) {
  if ((D != 64 && D != 128) || (dq_rows != 64 && dq_rows != 128)) return -1;
  if ((split != 0) != (dk_part != nullptr) || (split && H == Hkv)) return -1;
  const P90 p{(const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
              (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
              (const float*)lse, (float*)delta, (float*)dk_part,
              (float*)dv_part, (const int*)q_order, (const int*)kv_order,
              B, Sq, Skv, H, Hkv, causal, has_window, window, scale,
              scale * 1.4426950408889634f, split};
  cudaStream_t s = (cudaStream_t)stream;
  return D == 64 ? launch_d90<64>(p, q, k, v, n_qt, n_kt, dq_rows, s)
                 : launch_d90<128>(p, q, k, v, n_qt, n_kt, dq_rows, s);
}

}  // extern "C"
