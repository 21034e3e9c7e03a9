// Normalized softmax entropy per row: H(softmax(logits)) / log(V), fp32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/entropy_exit/entropy_exit.py (entropy_pallas ->
// _entropy_kernel): the early-exit confidence check. logits [M, V] in the
// model dtype, output fp32 [M].
//
// Bound on the H100: bytes. The logits are read once; one exp per element
// is far below the card's arithmetic rate. Design: one block per row; each
// thread streams a strided slice of the vocabulary (neighbouring threads
// on neighbouring addresses) and keeps the running triple
//   m = max l,  s = sum exp(l - m),  u = sum exp(l - m) * l
// rescaling (s, u) when m grows, as the Pallas kernel does per vocab block.
// The triples of the threads are merged with the same rescaling (warp
// shuffles, then shared memory). H = m + log s - u / s.
#include "common.cuh"

constexpr int kThreads = 512;

struct Triple {
  float m, s, u;
};

__device__ __forceinline__ Triple merge(Triple a, Triple b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;  // both empty
  const float fa = expf(a.m - m), fb = expf(b.m - m);
  return {m, a.s * fa + b.s * fb, a.u * fa + b.u * fb};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    entropy_kernel(const T* __restrict__ logits, float* __restrict__ out,
                   int V, float log_v) {
  __shared__ Triple part[kThreads / 32];
  const T* row = logits + (size_t)blockIdx.x * V;
  Triple t = {-INFINITY, 0.f, 0.f};
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = to_f32(row[i]);
    if (x > t.m) {
      const float a = expf(t.m - x);  // 0 on the first element
      t = {x, t.s * a + 1.f, t.u * a + x};
    } else {
      const float e = expf(x - t.m);
      t.s += e;
      t.u += e * x;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Triple b = {__shfl_xor_sync(0xffffffffu, t.m, o),
                __shfl_xor_sync(0xffffffffu, t.s, o),
                __shfl_xor_sync(0xffffffffu, t.u, o)};
    t = merge(t, b);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Triple r = part[0];
    for (int w = 1; w < kThreads / 32; ++w) r = merge(r, part[w]);
    out[blockIdx.x] = (r.m + logf(r.s) - r.u / r.s) / log_v;
  }
}

KERNEL_API int entropy_launch(const void* logits, void* out, int m, int v,
                              float log_v, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    entropy_kernel<__nv_bfloat16><<<m, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(out),
        v, log_v);
  else
    entropy_kernel<float><<<m, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(out), v, log_v);
  return static_cast<int>(cudaGetLastError());
}
