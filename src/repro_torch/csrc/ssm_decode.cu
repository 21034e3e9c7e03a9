// Mamba decode step: one token of the selective-SSM recurrence for every
// sequence b and channel d, all fp32:
//   h_new[n] = exp(g * A[d, n]) * h[n] + (g * x) * B[b, n]
//   y        = sum_n h_new[n] * C[b, n] + D[d] * x
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_decode/ssm_decode.py
// (mamba_decode_pallas -> _mamba_kernel). Same contract: x (the conv +
// silu activation) and g (dt) [B, Din], A [Din, N], B, C [B, N], D [Din],
// h [B, Din, N]; returns y [B, Din] and h_new [B, Din, N]. The mLSTM mode
// of the same op (mlstm_decode_pallas) is not ported here.
//
// Bound on the H100: the state is read once and written once, 2 * B * Din
// * N * 4 bytes (4.2 MB at B = 4, Din = 8192, N = 16: ~1.3 us at 3.35
// TB/s); the ~8 * B * Din * N operations are far below the compute bound.
// The TPU kernel's point carries over: the whole update is one pass over
// the state.
//
// Design: one thread per (sequence, channel), as the prefill scan; the
// thread reads its N state values with 16-byte loads, keeps A[d] in
// registers, takes B[b] and C[b] from shared memory, and sums y over n in
// the fixed order n = 0 .. N-1 with accurate expf. A row reads nothing of
// another row, so row b of a launch is bitwise the same at any batch size.
#include <stdint.h>

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int N = 16;           // d_state (Jamba's)

__global__ void __launch_bounds__(kThreads)
    mamba_decode_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D,
                        const float* __restrict__ h, float* __restrict__ y,
                        float* __restrict__ h_new, int Din) {
  static_assert(N % 4 == 0 && N <= kThreads,
                "the state is read 4 values at a time");
  __shared__ float bs[N], cs[N];
  const int b = blockIdx.y, d = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x < N) {
    bs[threadIdx.x] = Bm[(size_t)b * N + threadIdx.x];
    cs[threadIdx.x] = Cm[(size_t)b * N + threadIdx.x];
  }
  __syncthreads();
  if (d >= Din) return;
  const size_t row = (size_t)b * Din + d;
  const float xv = x[row], gv = g[row];
  const float gx = gv * xv;
  const float4* hp = reinterpret_cast<const float4*>(h + row * N);
  const float4* ap = reinterpret_cast<const float4*>(A + (size_t)d * N);
  float4* hq = reinterpret_cast<float4*>(h_new + row * N);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 hv = hp[q], av = ap[q];
    const float hi[4] = {hv.x, hv.y, hv.z, hv.w};
    const float ai[4] = {av.x, av.y, av.z, av.w};
    float ho[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * q + e;
      ho[e] = expf(gv * ai[e]) * hi[e] + gx * bs[n];
      acc += ho[e] * cs[n];
    }
    hq[q] = make_float4(ho[0], ho[1], ho[2], ho[3]);
  }
  y[row] = acc + D[d] * xv;
}

KERNEL_API int mamba_decode_launch(const void* x, const void* g,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* D,
                                   const void* h, void* y, void* h_new,
                                   int B, int Din, int n_state,
                                   void* stream) {
  if (n_state != N) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid((Din + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mamba_decode_kernel<<<grid, kThreads, 0, s>>>(
      f(x), f(g), f(A), f(Bm), f(Cm), f(D), f(h), static_cast<float*>(y),
      static_cast<float*>(h_new), Din);
  return (int)cudaGetLastError();
}
