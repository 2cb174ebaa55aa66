// SF unpack kernel for Hopper (sm_90a): deterministic segment reduction.
//
// Replaces the Pallas functions of repro/kernels/sf_unpack.py:
//   segment_reduce_sorted   (sf_unpack.py:86)  -> sf_segment_reduce, one
//                                                 segment per CTA
//   segment_reduce_blocked  (sf_unpack.py:154) -> sf_segment_reduce,
//                                                 segs_per_cta segments per CTA
//
// out[s, e] = buf[start[s], e] (+) buf[start[s]+1, e] (+) ... over len[s] rows,
// for sum / prod / max / min, starting from the op's identity.
//
// Determinism contract: one thread owns one (segment, unit element) output
// and walks the segment's rows in buffer order, so the float result is the
// left-to-right fold of the sorted buffer on every run and matches the plain
// version bit for bit.  No atomics anywhere.  max/min propagate NaN as
// torch.maximum / jnp.maximum do (fmaxf / fminf would drop it).  bf16 and
// fp16 fold in float and round after every step, as their tensor arithmetic
// does; integers wrap.  Only rows < len are read, so the buffer needs no
// padding.  Dtypes: float32, float64, bfloat16, float16, int8, uint8, int16,
// int32, int64 (uint16 / uint32 payloads arrive as int16 / int32 views or
// widened, core/ops.py).
//
// Bound on this card: bytes.  The work is one combine per input element;
// the floor is reading the sum of the segment lengths in rows once, the
// (start, len) metadata once and writing one row per segment, over the
// 3.35 TB/s of HBM3.  Design against that bound: the segments are sorted and
// contiguous, so the threads of a warp, which own neighbouring segments and
// unit elements, read neighbouring regions of the buffer; no shared memory
// and no second pass.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

enum { OP_SUM = 0, OP_PROD = 1, OP_MAX = 2, OP_MIN = 3 };

template <typename T>
struct Num {
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

template <typename T, int OP>
__global__ void segment_reduce_kernel(const T* __restrict__ buf,
                                      T* __restrict__ out,
                                      const int* __restrict__ seg_start,
                                      const int* __restrict__ seg_len,
                                      long long S, long long U,
                                      int segs_per_cta) {
  const long long s0 = (long long)blockIdx.x * segs_per_cta;
  const long long ns = min((long long)segs_per_cta, S - s0);
  const long long total = ns * U;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const long long ds = t / U;
    const long long e = t - ds * U;
    const long long s = s0 + ds;
    const long long start = seg_start[s];
    const int len = seg_len[s];
    T acc = identity<T, OP>();
    for (int k = 0; k < len; ++k) {
      acc = combine<T, OP>(acc, buf[(start + k) * U + e]);
    }
    out[s * U + e] = acc;
  }
}

template <typename T>
int launch(const void* buf, void* out, const int* seg_start,
           const int* seg_len, long long S, long long U, int op,
           int segs_per_cta, cudaStream_t stream) {
  const long long items = (long long)segs_per_cta * U;
  const long long warps = (items + 31) / 32;
  const int threads = (int)(warps >= 8 ? 256 : (warps < 1 ? 32 : warps * 32));
  const unsigned grid = (unsigned)((S + segs_per_cta - 1) / segs_per_cta);
  const T* b = (const T*)buf;
  T* o = (T*)out;
  switch (op) {
    case OP_SUM:
      segment_reduce_kernel<T, OP_SUM><<<grid, threads, 0, stream>>>(
          b, o, seg_start, seg_len, S, U, segs_per_cta);
      break;
    case OP_PROD:
      segment_reduce_kernel<T, OP_PROD><<<grid, threads, 0, stream>>>(
          b, o, seg_start, seg_len, S, U, segs_per_cta);
      break;
    case OP_MAX:
      segment_reduce_kernel<T, OP_MAX><<<grid, threads, 0, stream>>>(
          b, o, seg_start, seg_len, S, U, segs_per_cta);
      break;
    case OP_MIN:
      segment_reduce_kernel<T, OP_MIN><<<grid, threads, 0, stream>>>(
          b, o, seg_start, seg_len, S, U, segs_per_cta);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dtype codes: 0 float32, 1 float64, 2 int32, 3 bfloat16, 4 int8, 5 uint8,
// 6 int16, 7 int64, 8 float16.  Op codes: 0 sum, 1 prod, 2 max, 3 min.
// Returns -1 for an unknown code.
int sf_segment_reduce(const void* buf, void* out, const int* seg_start,
                      const int* seg_len, long long S, long long U, int dtype,
                      int op, int segs_per_cta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SF_REDUCE_AS(T) \
  return launch<T>(buf, out, seg_start, seg_len, S, U, op, segs_per_cta, s)
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

}  // extern "C"
