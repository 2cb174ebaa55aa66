// ELLPACK sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces the Pallas function spmv_ell (repro/kernels/spmv_ell.py:33):
//   y[i] = sum_k data[i, k] * x[cols[i, k]],  data/cols (N, K), x (Nx,)
// Padding entries point at a trailing zero of x (the caller appends it).
//
// Bound on this card: bytes.  Each nonzero is 2 flops against 8 bytes of
// value and column index, far below the card's flops per byte, so the floor
// is data + cols + the distinct x entries + y over the 3.35 TB/s of HBM3.
// Design against that bound: one thread per row folds its K entries in the
// data's type (float32 for the CG path); x is read through the read-only
// data cache (__ldg), where the 7-point stencil's neighbouring rows reuse
// each other's x entries, so x costs little more than one pass.  The row's
// K values and columns are contiguous, so a warp streams 32*K consecutive
// entries.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void spmv_ell_kernel(const T* __restrict__ data,
                                const int* __restrict__ cols,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long N, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const T* d = data + i * K;
  const int* c = cols + i * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    acc += d[k] * __ldg(x + c[k]);
  }
  y[i] = acc;
}

}  // namespace

extern "C" {

// Dtype codes: 0 float32, 1 float64.  Returns -1 for an unknown code.
int sf_spmv_ell(const void* data, const int* cols, const void* x, void* y,
                long long N, int K, int dtype, void* stream) {
  const int threads = 256;
  const unsigned grid = (unsigned)((N + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      spmv_ell_kernel<float><<<grid, threads, 0, s>>>(
          (const float*)data, cols, (const float*)x, (float*)y, N, K);
      break;
    case 1:
      spmv_ell_kernel<double><<<grid, threads, 0, s>>>(
          (const double*)data, cols, (const double*)x, (double*)y, N, K);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
