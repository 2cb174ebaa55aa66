// SF pack kernels for Hopper (sm_90a): row gathers and the fused local bcast.
//
// Replaces the Pallas functions of repro/kernels/sf_pack.py:
//   pack          (sf_pack.py:60)   -> sf_gather_rows,    one row per CTA
//   pack_blocked  (sf_pack.py:96)   -> sf_gather_rows,    block_rows rows per CTA
//   pack_strided  (sf_pack.py:177)  -> sf_gather_strided, rows computed from
//                                      (start, dims, strides), no index array
//   bcast_fused   (sf_pack.py:141)  -> sf_bcast_fused_copy / _cast
//
// Bound on this card: bytes.  A gather does no arithmetic; it must read each
// needed source row once and write each output row once (plus 4 bytes of
// index per row), so its floor is those bytes over the 3.35 TB/s of HBM3.
// Design against that bound: rows are copied as raw bytes in the widest word
// (16/8/4/2/1 bytes) that the row size and both base pointers allow, so a
// warp moves 512 contiguous bytes per instruction on aligned rows and the
// kernel is dtype-agnostic (bool, bf16, the uint carriers of bitcast
// bundles).  Neighbouring threads take neighbouring words of a row and then
// the next row of the block, so stores are fully coalesced and loads are
// coalesced within each source row.  Nothing is staged in shared memory:
// every byte is touched once.
//
// The fused bcast avoids the packed intermediate entirely: the setup builds
// the inverse map src_of_leaf[l] (root row feeding leaf l, or -1), and one
// race-free pass writes every output row exactly once, from the root row or
// from the old leaf row.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Box {
  long long start, dx, dy, sy, sz;
};

template <typename W, bool STRIDED>
__global__ void gather_rows_kernel(const W* __restrict__ src,
                                   W* __restrict__ dst,
                                   const int* __restrict__ idx, long long M,
                                   long long wpr, int rows_per_cta, Box box) {
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

template <bool STRIDED>
int launch_gather(const void* src, void* dst, const int* idx, long long M,
                  long long row_bytes, int rows_per_cta, Box box,
                  cudaStream_t stream) {
  const int wb = word_bytes((uintptr_t)src, (uintptr_t)dst, 0, row_bytes);
  const long long wpr = row_bytes / wb;
  const int threads = threads_for((long long)rows_per_cta * wpr);
  const unsigned grid = (unsigned)((M + rows_per_cta - 1) / rows_per_cta);
  switch (wb) {
    case 16:
      gather_rows_kernel<uint4, STRIDED><<<grid, threads, 0, stream>>>(
          (const uint4*)src, (uint4*)dst, idx, M, wpr, rows_per_cta, box);
      break;
    case 8:
      gather_rows_kernel<uint2, STRIDED><<<grid, threads, 0, stream>>>(
          (const uint2*)src, (uint2*)dst, idx, M, wpr, rows_per_cta, box);
      break;
    case 4:
      gather_rows_kernel<unsigned, STRIDED><<<grid, threads, 0, stream>>>(
          (const unsigned*)src, (unsigned*)dst, idx, M, wpr, rows_per_cta,
          box);
      break;
    case 2:
      gather_rows_kernel<unsigned short, STRIDED>
          <<<grid, threads, 0, stream>>>((const unsigned short*)src,
                                         (unsigned short*)dst, idx, M, wpr,
                                         rows_per_cta, box);
      break;
    default:
      gather_rows_kernel<unsigned char, STRIDED>
          <<<grid, threads, 0, stream>>>((const unsigned char*)src,
                                         (unsigned char*)dst, idx, M, wpr,
                                         rows_per_cta, box);
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

}  // namespace

extern "C" {

// out[i] = src[idx[i]] for i < M, rows of row_bytes bytes.
int sf_gather_rows(const void* src, void* dst, const int* idx, long long M,
                   long long row_bytes, int rows_per_cta, void* stream) {
  Box box = {0, 1, 1, 0, 0};
  return launch_gather<false>(src, dst, idx, M, row_bytes, rows_per_cta, box,
                              (cudaStream_t)stream);
}

// out[i + dx*(j + dy*k)] = src[start + i + j*sy + k*sz], M = dx*dy*dz.
int sf_gather_strided(const void* src, void* dst, long long M,
                      long long row_bytes, int rows_per_cta, long long start,
                      long long dx, long long dy, long long sy, long long sz,
                      void* stream) {
  Box box = {start, dx, dy, sy, sz};
  return launch_gather<true>(src, dst, nullptr, M, row_bytes, rows_per_cta,
                             box, (cudaStream_t)stream);
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

const char* sf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
