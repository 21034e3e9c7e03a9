// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_pallas -> _rmsnorm_kernel). x [M, d] in the model dtype, scale
// [d] in fp32 (layer norms) or the model dtype (exit heads), output in x's
// dtype.
//
// Bound on the H100: bytes. It reads each row once and writes it once, at
// a few flops per element. Design: one block per row, so the mean-square
// reduction never leaves the SM (warp shuffles, then one shared-memory
// pass over the warps); the second loop re-reads the row, which is still
// in L1/L2 at d = 4096, and writes the normalized row once.
#include "common.cuh"

constexpr int kThreads = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float part[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) tot += part[w];
  const float r = rsqrtf(tot / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
}

template <typename T>
static void launch(const void* x, const void* scale, int scale_dtype,
                   void* out, int m, int d, float eps, cudaStream_t s) {
  if (scale_dtype == kBF16)
    rmsnorm_kernel<T, __nv_bfloat16><<<m, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(scale),
        static_cast<T*>(out), d, eps);
  else
    rmsnorm_kernel<T, float><<<m, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), d, eps);
}

KERNEL_API int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int m, int d, float eps, int dtype,
                              int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch<__nv_bfloat16>(x, scale, scale_dtype, out, m, d, eps, s);
  else
    launch<float>(x, scale, scale_dtype, out, m, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}
