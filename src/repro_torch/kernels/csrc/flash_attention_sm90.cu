// Flash attention forward for Hopper (sm_90a), bf16, head sizes 64, 112 and
// 128:
// TMA loads into a ring of K/V stages, warp-specialised producer and
// consumer warpgroups, both products on wgmma, a persistent schedule.
//
// Replaces the Pallas function flash_attention
// (repro/kernels/flash_attention.py:92, pallas_call at :119) on the serving
// path: q (B, Sq, H, D), k/v (B, Skv, Hkv, D), Hkv | H, query row i at
// absolute position Skv - Sq + i; key j visible iff j < Skv, (causal)
// j <= qpos and (window) j > qpos - window; out = softmax(scale * q k^T) v
// in bf16, softmax statistics and accumulation in float32; a row that sees
// no key returns exactly 0.  flash_attention.cu keeps float32 and the bf16
// head sizes 16 and 32; kernels/flash_attention.py routes between the two.
//
// Bound on this card.  The serving prefill (Sq = Skv = S, 32 query / 8 KV
// heads of 128, causal) needs 4 * S(S+1)/2 * H * D flops (q k^T and p v on
// the visible half) and reads q, k, v and writes o once: at S = 1024,
// 8.6 GFLOP over 989 TFLOP/s = 8.7 us against 21 MB over 3.35 TB/s = 6.3 us,
// so operations bound it; below S = 512 bytes do.
//
// What held the first kernel (flash_attention.cu) back, and the answer here:
//  1. No overlap of loads and math: every K/V tile went global -> registers
//     -> shared between two __syncthreads.  Here one producer thread issues
//     TMA loads (cp.async.bulk.tensor, 128-byte swizzle) into two rings of
//     STAGES slots, one for K and one for V, each slot guarded by a
//     full/empty mbarrier pair, so the next tiles land while the consumers
//     compute; q is loaded once per work item by TMA as well, the next
//     item's q during this one's epilogue.
//  2. mma.sync with B fed by scalar shared loads.  Here S = Q K^T is wgmma
//     m64n64k16 with both operands read by the tensor cores from the
//     swizzled tiles through matrix descriptors (K-major, B128, SBO 1024 B,
//     +32 B per k16 step inside a 128-byte row), and O += P V is wgmma
//     m64nDk16 with A = P in registers (the S accumulator rounded to bf16
//     pairs: its m64nN f32 layout is the A-fragment layout) and B = the V
//     tile, keys x d, read MN-major with the transpose bit (LBO = one
//     64-column box, SBO = 8 keys).  The walk is software-pipelined: S of
//     tile j and P V of tile j - 1 are issued together, and the softmax of
//     tile j runs while P V is in flight.
//  3. GQA reloads: the H / Hkv query heads of a KV head are consecutive in
//     the work order, so the CTAs that run them at once read the same K/V
//     tiles and all but the first find them in L2 (a KV head's K and V are
//     512 KB at S = 1024, 4 MB for all 8, against 50 MB of L2).  Packing a
//     KV group's heads into one CTA's M rows was the other choice; it needs
//     4 x 64 rows of q per tile at every bucket (only 8 q tiles of work at
//     S = 128) and a per-head row mapping in the epilogue, for HBM traffic
//     that L2 already absorbs.
//  4. Small CTAs, poor hiding, uneven causal tiles.  A CTA is NC consumer
//     warpgroups of 64 query rows each (NC = 2: 128 rows of one head) plus
//     one producer warpgroup.  The grid is persistent, at most SMs x
//     resident CTAs, and walks the work list (b, head, q tile) in the
//     longest-first order that tile_plan() computes, CTA c taking items c
//     and 2 grid - 1 - c, then 2 grid + c and 4 grid - 1 - c, and so on:
//     the CTA with the longest tile of a round takes the shortest of the
//     next, which evens out the causal triangle (at S = 1024 the busiest
//     CTA walks 18 KV tiles against a mean of 17.5; plain striding gave it
//     24).  The wrapper picks NC = 1 (64 rows) when 128-row tiles would
//     leave fewer CTAs than half the SMs (small buckets).
//  5. Masks on every tile.  Each q tile visits only KV tiles [j0, j1) that
//     some of its rows can see (kv_tiles), and applies the element mask
//     only on tiles that straddle the causal diagonal, the window's edge
//     or Skv (tile_masked).  TMA zero-fills K/V rows past Skv; such a tile
//     is always masked, so a zero key counts as absent, not as a logit 0.
//     The running max keeps the first kernel's guard (a row that has seen
//     nothing subtracts 0, not -inf) and the epilogue scales by
//     l > 0 ? 1/l : 0.
// The epilogue writes each consumer's 64 x D tile as bf16 into swizzled
// shared memory and stores it with TMA, which drops rows past Sq.  When
// the caller passes an LSE buffer (the training forward), it also writes
// each row's base-2 log-sum-exp, m + log2(l) (-inf for a row that sees no
// key), to float32 (B, H, Sq) for the backward (flash_attention_bwd.cu);
// o is the same either way.  The mbarrier, TMA and wgmma helpers are
// shared with the backward through wgmma_tma.cuh.
//
// Head size 112 (kimi-k2's) runs on the D = 128 tiles: the tensor maps
// carry the true head size as their inner extent, so each row's second
// 64-column box reads columns 64-127 of which TMA fills 112-127 with zeros
// (FLOAT_OOB_FILL_NONE) and still counts the whole box's bytes on the
// barrier; the zero columns add nothing to q k^T, give o columns 112-127
// of zeros, and the TMA store of o drops them.  The scale (1/sqrt(112))
// comes from the wrapper, the LSE is the same.  Cost: 12.5% of the tensor
// cores' work on zeros, no extra bytes moved.  A Tiles<112> of a 64- and a
// 48-column box would save that work but needs a second swizzle pattern
// for the partial box and other wgmma shapes (n112 for P V).
//
// Tile width, per head size and tile height (Tiles<D, NC>).  NC = 2
// launches at 65536 / 384
// threads = 168 registers a thread, and ptxas holds the consumers to that
// although setmaxnreg hands them 240: the pipelined walk keeps S (BC / 2
// floats), P (BC / 4 words) and O (D / 2 floats) live at once.  At D = 128
// a 128-key tile spills and serialises its wgmmas, a 64-key tile does not,
// and on the H100 the 64-key tile with a 2-slot ring was the fastest at
// the serving buckets: D = 128 keeps BC = 64, STAGES = 2.  At D = 64 a
// 64-key tile gives each consumer only 4 + 4 k16 steps per tile while the
// softmax's cost per tile does not shrink with D, and the registers allow
// BC = 128 (S 64 floats, P 32 words, O 32 floats): D = 64 at 128-row
// tiles takes BC = 128, a 3-slot ring (16 KB each of K and V a slot), and
// ping-pongs its two consumer warpgroups on named barriers (PINGPONG: one
// warpgroup issues its wgmmas while the other runs its softmax, strictly
// in turns).  64-row tiles (NC = 1) serve only calls of at most one wave
// of tiles (tile_height), where the 128-key tile's doubled S, softmax and
// TMA box per tile made a short call slower: D = 64 keeps BC = 64,
// STAGES = 2 there.  flash_variants.py times the alternatives; PERF.md
// has the readings.
//
// kv_tiles, tile_masked and the work order are mirrored by tile_plan() in
// kernels/flash_attention.py; a change to one side changes the other.
//
// Every entry point returns cudaGetLastError() after its launch, -1 for an
// unsupported head size or tile height, -2 if a tensor map cannot be made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

// keys per K/V tile, K/V ring depth, and whether the two consumer
// warpgroups take the tensor cores in turns (NC = 2 only), by head size
// and consumer warpgroups; tile_plan() and sm90_smem_bytes() in
// kernels/flash_attention.py mirror BC and STAGES
template <int D, int NC>
struct Tiles;
template <>
struct Tiles<128, 1> {
  static constexpr int BC = 64, STAGES = 2;
  static constexpr bool PINGPONG = false;
};
template <>
struct Tiles<128, 2> {
  static constexpr int BC = 64, STAGES = 2;
  static constexpr bool PINGPONG = false;
};
template <>
struct Tiles<64, 1> {
  static constexpr int BC = 64, STAGES = 2;
  static constexpr bool PINGPONG = false;
};
template <>
struct Tiles<64, 2> {
  static constexpr int BC = 128, STAGES = 3;
  static constexpr bool PINGPONG = true;
};

struct Params {
  const int* order;  // q tiles, longest first (tile_plan)
  float* lse;        // (B, H, Sq) base-2 log-sum-exp of each row, or null
  int B, Sq, Skv, H, Hkv;
  int causal, has_window, window;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int n_work;        // B * H * q tiles
};

// Shared memory: every tile starts on a 1024-byte boundary (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).  A tile of R rows x D
// columns is D / 64 boxes of R x 64, one after the other.
template <int D, int NC, int BC = Tiles<D, NC>::BC,
          int STAGES = Tiles<D, NC>::STAGES>
struct Smem {
  __nv_bfloat16 q[NC * 64 * D];
  __nv_bfloat16 k[STAGES][BC * D];
  __nv_bfloat16 v[STAGES][BC * D];
  __nv_bfloat16 o[NC][64 * D];
  uint64_t full_k[STAGES], empty_k[STAGES], full_v[STAGES], empty_v[STAGES];
  uint64_t q_full, q_empty;
};

// ---------------------------------------------------------------- schedule
// (mirrored by tile_plan in kernels/flash_attention.py)
__device__ __forceinline__ void tile_of(const Params& p, int idx, int br,
                                        int& b, int& h, int& r0) {
  const int bh = p.B * p.H;
  const int rem = idx % bh;
  r0 = p.order[idx / bh] * br;
  h = rem % p.H;
  b = rem / p.H;
}

// KV tiles [j0, j1) of BC keys that some query row in [r0, r1) may see.
template <int BC>
__device__ __forceinline__ void kv_tiles(const Params& p, int r0, int r1,
                                         int& j0, int& j1) {
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

// Whether some (row in [r0, r1), key in tile j of BC keys) pair is not
// visible.
template <int BC>
__device__ __forceinline__ bool tile_masked(const Params& p, int r0, int r1,
                                            int j) {
  const long long off = (long long)p.Skv - p.Sq;
  const long long k0 = (long long)j * BC, k1 = k0 + BC - 1;
  return k1 >= p.Skv || (p.causal && k1 > off + r0) ||
         (p.has_window && k0 <= off + r1 - 1 - p.window);
}

__device__ __forceinline__ bool visible(const Params& p, long long qpos,
                                        long long kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (!p.has_window || kpos > qpos - p.window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ kernel
// Work item of CTA c in round r: the list is walked in a snake, c in even
// rounds and grid - 1 - c in odd ones, so a CTA that took one of the
// longest tiles in a round takes one of the shortest in the next (a static
// longest-processing-time schedule).  Items only grow with r.
__device__ __forceinline__ int work_item(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// Ring slot and phase parity of the n-th K (or V) tile a CTA handles.
template <int STAGES>
__device__ __forceinline__ int slot(uint32_t n) { return n % STAGES; }
template <int STAGES>
__device__ __forceinline__ uint32_t parity(uint32_t n) {
  return (n / STAGES) & 1;
}

// s = a * b over a 64 x BC tile, a and b K-major in shared memory
template <int BC>
__device__ __forceinline__ void wgmma_ss_bc(float (&d)[BC / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (BC == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

// The consumer's softmax step on one S tile, in place: s becomes the
// tile's probabilities exp2(scale * s - mu), m / l are updated and the
// factor that rescales the running output is returned per row.
template <bool kMasked, int BC>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[BC / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int j, int c4,
                                             long long qpos_a,
                                             long long qpos_b) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) {
    float x = s[i] * p.scale_log2;
    // s[i]: row a (i % 4 < 2) or b, key j*BC + 8*(i/4) + 2*c4 + i%2
    if (kMasked) {
      const long long kpos = (long long)j * BC + (i / 4) * 8 + 2 * c4 + (i & 1);
      if (!visible(p, (i & 2) ? qpos_b : qpos_a, kpos)) x = -INFINITY;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    mu[r] = mn == -INFINITY ? 0.f : mn;  // a row that sees nothing yet
    corr[r] = exp2f(m[r] - mu[r]);
    m[r] = mn;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) {
    s[i] = exp2f(s[i] - mu[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];  // this thread's part of the row sum
  }
}

template <int D, int NC>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          const Params p) {
  constexpr int BR = NC * 64, BC = Tiles<D, NC>::BC;
  constexpr int STAGES = Tiles<D, NC>::STAGES;
  // the two consumer warpgroups take the tensor cores in turns
  constexpr bool kTurns = Tiles<D, NC>::PINGPONG && NC == 2;
  extern __shared__ uint8_t smem_raw[];
  Smem<D, NC>& sm = *reinterpret_cast<Smem<D, NC>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty_k[s], NC * 128);
      mbar_init(&sm.empty_v[s], NC * 128);
    }
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, NC * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------ producer warpgroup
    // NC = 2 launches at 65536 / 384 threads = 168 registers; the producer
    // gives back all but 24 and the consumers take them (240).  NC = 1
    // launches at up to 255, which the consumers keep.
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (t != 0) return;
    const int rep = p.H / p.Hkv;
    uint32_t n = 0, it = 0;  // K/V tiles loaded, work items
    for (int idx = work_item(0); idx < p.n_work; idx = work_item(++it)) {
      int b, h, r0, j0, j1;
      tile_of(p, idx, BR, b, h, r0);
      kv_tiles<BC>(p, r0, min(r0 + BR, p.Sq), j0, j1);
      mbar_wait(&sm.q_empty, (it & 1) ^ 1);  // the last tile's q is done
      mbar_expect_tx(&sm.q_full, BR * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(sm.q + c * BR * 64, &tm_q, c * 64, h, r0, b, &sm.q_full);
      const int hk = h / rep;
      for (int j = j0; j < j1; ++j, ++n) {
        const int st = slot<STAGES>(n);
        mbar_wait(&sm.empty_k[st], parity<STAGES>(n) ^ 1);
        mbar_expect_tx(&sm.full_k[st], BC * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(sm.k[st] + c * BC * 64, &tm_k, c * 64, hk, j * BC, b,
                   &sm.full_k[st]);
        mbar_wait(&sm.empty_v[st], parity<STAGES>(n) ^ 1);
        mbar_expect_tx(&sm.full_v[st], BC * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(sm.v[st] + c * BC * 64, &tm_v, c * 64, hk, j * BC, b,
                   &sm.full_v[st]);
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = t / 32, lane = t % 32, g = lane / 4, c4 = lane % 4;
  const long long off = (long long)p.Skv - p.Sq;
  const uint32_t q_base = smem_u32(sm.q) + wg * 64 * 128;
  uint8_t* o_tile = reinterpret_cast<uint8_t*>(sm.o[wg]);

  // s = q k^T on K slot st: 64 rows x BC keys, D / 16 steps of k16
  auto issue_s = [&](float (&s)[BC / 2], int st) {
    const uint32_t k_base = smem_u32(sm.k[st]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_bc<BC>(
          s, desc_b128(q_base + (kk / 4) * BR * 128 + (kk % 4) * 32, 16, 1024),
          desc_b128(k_base + (kk / 4) * BC * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // o += p v on V slot st: BC / 16 steps of k16
  auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[BC / 16][4],
                      int st) {
    const uint32_t v_base = smem_u32(sm.v[st]);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint64_t dv = desc_b128(v_base + kk * 16 * 128, BC * 128, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128(o, pa[kk], dv, 1);
      else
        wgmma_rs_n64(o, pa[kk], dv, 1);
    }
    wgmma_commit();
  };

  // Turns (kTurns): a warpgroup issues its wgmmas only after the other one
  // has issued its own, on named barriers 3 + wg of 256 threads (one
  // warpgroup waits, the other arrives).  Both walk the same KV tiles of
  // every work item, so they issue equally often: warpgroup 1 lets 0 go
  // first, and 0 takes 1's last turn back before it exits.
  const auto take_turn = [&]() {
    if constexpr (kTurns) named_bar(3 + wg, 256);
  };
  const auto pass_turn = [&]() {
    if constexpr (kTurns) named_bar_arrive(4 - wg, 256);
  };
  if (wg == 1) pass_turn();

  uint32_t n = 0, it = 0;  // K/V tiles consumed, work items
  for (int idx = work_item(0); idx < p.n_work; idx = work_item(++it)) {
    int b, h, r0, j0, j1;
    tile_of(p, idx, BR, b, h, r0);
    const int r1 = min(r0 + BR, p.Sq);
    kv_tiles<BC>(p, r0, r1, j0, j1);
    // this thread's two rows (the wgmma accumulator layout: warp w holds
    // rows 16w..16w+15 of the warpgroup's 64, lane l rows l/4 and l/4 + 8)
    const long long qpos_a = off + r0 + wg * 64 + w * 16 + g;
    const long long qpos_b = qpos_a + 8;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(&sm.q_full, it & 1);

    if (j0 < j1) {
      // The walk is software-pipelined: S of tile j and P V of tile j - 1
      // go to the tensor cores together, and the softmax of tile j runs
      // while P V is still in flight.  P stays in registers (bf16 pairs:
      // the accumulator's keys 16kk..16kk+15 are the A fragment
      // {a0 a1 | a2 a3 | a4 a5 | a6 a7} of k16 step kk).
      float s[BC / 2], corr[2];
      uint32_t pa[BC / 16][4];
      auto softmax = [&](int j) {
        if (tile_masked<BC>(p, r0, r1, j))
          softmax_tile<true, BC>(p, s, m, l, corr, j, c4, qpos_a, qpos_b);
        else
          softmax_tile<false, BC>(p, s, m, l, corr, j, c4, qpos_a, qpos_b);
      };
      auto to_p = [&]() {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < BC / 2; i += 2)
          pa[i / 8][(i % 8) / 2] = pack_bf16(s[i], s[i + 1]);
      };

      mbar_wait(&sm.full_k[slot<STAGES>(n)], parity<STAGES>(n));
      take_turn();
      wgmma_fence();
      issue_s(s, slot<STAGES>(n));
      pass_turn();
      wgmma_wait<0>();
      reg_fence(s);
      mbar_arrive(&sm.empty_k[slot<STAGES>(n)]);
      softmax(j0);
      to_p();
      for (int j = j0 + 1; j < j1; ++j) {
        const uint32_t prev = n++;
        mbar_wait(&sm.full_k[slot<STAGES>(n)], parity<STAGES>(n));
        mbar_wait(&sm.full_v[slot<STAGES>(prev)], parity<STAGES>(prev));
        take_turn();
        wgmma_fence();
        issue_s(s, slot<STAGES>(n));
        issue_pv(o, pa, slot<STAGES>(prev));
        pass_turn();
        wgmma_wait<1>();  // S of tile j is done
        reg_fence(s);
        mbar_arrive(&sm.empty_k[slot<STAGES>(n)]);
        softmax(j);
        wgmma_wait<0>();  // P V of tile j - 1 is done
        reg_fence(o);
        reg_fence(pa);
        mbar_arrive(&sm.empty_v[slot<STAGES>(prev)]);
        to_p();
      }
      mbar_wait(&sm.full_v[slot<STAGES>(n)], parity<STAGES>(n));
      take_turn();
      wgmma_fence();
      issue_pv(o, pa, slot<STAGES>(n));
      pass_turn();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(&sm.empty_v[slot<STAGES>(n)]);
      ++n;
    }
    mbar_arrive(&sm.q_empty);

    // epilogue: o / l in bf16 through swizzled shared memory, TMA store
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key: 0
    }
    // the training forward keeps each row's base-2 log-sum-exp of
    // scale log2(e) q k^T for the backward: m + log2(l), -inf for a row
    // that sees no key
    if (p.lse && c4 == 0) {
      const long long so = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + wg * 64 + w * 16 + g + 8 * r;
        if (row < p.Sq)
          p.lse[so + row] = m[r] == -INFINITY ? -INFINITY : m[r] + log2f(l[r]);
      }
    }
    if (t == 0) bulk_wait_read();  // the last tile's store has read o_tile
    named_bar(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = w * 16 + g + ((i >> 1) & 1) * 8;
      const int col = (i / 4) * 8 + 2 * c4, cc = col % 64;
      const int at = (col / 64) * 64 * 128 + row * 128 +
                     (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(o_tile + at) =
          pack_bf16(o[i] * inv[(i >> 1) & 1], o[i + 1] * inv[(i >> 1) & 1]);
    }
    fence_proxy_async();
    named_bar(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store(&tm_o, sm.o[wg] + c * 64 * 64, c * 64, h, r0 + wg * 64, b);
      bulk_commit();
    }
  }
  if (wg == 0) take_turn();
  if (t == 0) bulk_wait_all();
}

// ------------------------------------------------------------------- host
// D: the tile width (the kernel's instance); dg: the tensors' head size,
// at most D (the maps' inner extent: columns dg..D-1 read as zero and are
// not stored)
template <int D, int NC>
int launch(const Params& p, const void* q, const void* k, const void* v,
           void* o, int dg, cudaStream_t s) {
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, dg, NC * 64) ||
      !make_map(&tk, k, p.B, p.Skv, p.Hkv, dg, Tiles<D, NC>::BC) ||
      !make_map(&tv, v, p.B, p.Skv, p.Hkv, dg, Tiles<D, NC>::BC) ||
      !make_map(&to, o, p.B, p.Sq, p.H, dg, 64))
    return -2;
  const auto kern = flash_fwd_sm90_kernel<D, NC>;
  constexpr int threads = (NC + 1) * 128;
  constexpr int bytes = (int)sizeof(Smem<D, NC>) + 1024;  // + alignment
  static int resident = 0;  // CTAs per SM, asked once per instance
  if (!resident) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern,
                                                        threads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) resident = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = min(p.n_work, sms * resident);
  kern<<<grid, threads, bytes, s>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Skv, Hkv, D), o like q, all contiguous bf16;
// lse: float32 (B, H, Sq) for each row's base-2 log-sum-exp, or null (the
// serving path) for none; D in {64, 112, 128} (112 on the 128-wide
// tiles); br (query rows per CTA) in {64, 128}; order: n_qt int32 q-tile
// indices on the device, longest first; has_window = 0 means no window.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* order, int B,
                             int Sq, int Skv, int H, int Hkv, int D,
                             int causal, int has_window, int window,
                             float scale, int br, int n_qt, void* stream) {
  if ((D != 64 && D != 112 && D != 128) || (br != 64 && br != 128))
    return -1;
  const Params p{(const int*)order, (float*)lse, B, Sq, Skv, H, Hkv,
                 causal, has_window, window, scale * 1.4426950408889634f,
                 B * H * n_qt};
  if (p.n_work == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return br == 64 ? launch<64, 1>(p, q, k, v, o, D, s)
                    : launch<64, 2>(p, q, k, v, o, D, s);
  return br == 64 ? launch<128, 1>(p, q, k, v, o, D, s)
                  : launch<128, 2>(p, q, k, v, o, D, s);
}

}  // extern "C"
