// Mamba decode step: one token of the selective-SSM recurrence for every
// sequence b and channel d, all fp32:
//   h_new[n] = exp(g * A[d, n]) * h[n] + (g * x) * B[b, n]
//   y        = sum_n h_new[n] * C[b, n] + D[d] * x
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_decode/ssm_decode.py
// (mamba_decode_pallas -> _mamba_kernel). Same contract: x (the conv +
// silu activation) and g (dt) [B, Din], A [Din, N], B, C [B, N], D [Din],
// h [B, Din, N]; returns y [B, Din] and h_new [B, Din, N]. h_new may be h
// itself: the state is then updated in place, as the JAX engine's jitted
// scan updates its carry. The mLSTM mode of the same op is
// csrc/mlstm_decode.cu.
//
// Bound on the H100: bytes. The state is read once and written once, 2 * B
// * Din * N * 4 bytes, plus A once (4.7 MB at B = 4, Din = 8192, N = 16:
// ~1.4 us at 3.35 TB/s); the ~8 * B * Din * N operations are far below the
// compute bound.
//
// Design: four lanes a (b, d) row, each holding one float4 of the row's N
// = 16 state values and of A[d], so that a warp reads and writes 512
// contiguous bytes of h (8 channels) and of A; a block is 64 channels of
// one row b, the grid Din * 4 / 256 x B (512 blocks at B = 4, 128 at B =
// 1). A thread issues every load before any arithmetic. (A thread walking
// the B rows of its channel, A's float4 loaded once a launch, was no
// faster on the card: A's second reads come from L2.) Every element of h
// is read and then written by one thread, once, so h_new may alias h
// (neither is __restrict__). y keeps one fixed order: the row's first
// lane gathers the other lanes' new values by shuffles and sums n = 0 ..
// N-1 from 0 in a dependent chain. The arithmetic is written out with
// intrinsics as the previous kernel's compiler contracted it (fma(exp(g a),
// h, (g x) B); fma(h', C, acc); fma(D, x, acc)), so the bits do not follow
// the schedule. A row reads nothing of another row: row b of a launch is
// bitwise the same at any batch size. Accurate expf; no fast-math.
#include <stdint.h>

#include "common.cuh"

constexpr int N = 16;                  // d_state (Jamba's)
constexpr int kLanes = N / 4;          // lanes a (b, d) row: a float4 each
constexpr int kThreads = 256;          // 64 channels of one row b a block

__global__ void __launch_bounds__(kThreads)
    mamba_decode_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D, const float* h,
                        float* __restrict__ y, float* h_new, int Din) {
  const int b = blockIdx.y;
  const int gt = blockIdx.x * kThreads + threadIdx.x;
  const int d = gt / kLanes, q = gt % kLanes;
  const bool on = d < Din;
  const int dc = on ? d : Din - 1;       // loads stay in bounds
  const size_t row = (size_t)b * Din + dc;
  // every load first: the state's float4 (streaming: read once), A's, and
  // the row's scalars and B, C (the same lines for the whole row)
  const float4 hv = __ldcs(reinterpret_cast<const float4*>(h) + row * kLanes
                           + q);
  const float4 av = reinterpret_cast<const float4*>(A)[(size_t)dc * kLanes
                                                       + q];
  const float xv = x[row], gv = g[row], dv = D[dc];
  const float4 bv = reinterpret_cast<const float4*>(Bm)[(size_t)b * kLanes
                                                        + q];
  float4 cv[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    cv[j] = reinterpret_cast<const float4*>(Cm)[(size_t)b * kLanes + j];

  const float gx = __fmul_rn(gv, xv);
  const float hi[4] = {hv.x, hv.y, hv.z, hv.w};
  const float ai[4] = {av.x, av.y, av.z, av.w};
  const float bi[4] = {bv.x, bv.y, bv.z, bv.w};
  float ho[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    ho[e] = __fmaf_rn(expf(__fmul_rn(gv, ai[e])), hi[e],
                      __fmul_rn(gx, bi[e]));
  if (on)
    __stcs(reinterpret_cast<float4*>(h_new) + row * kLanes + q,
           make_float4(ho[0], ho[1], ho[2], ho[3]));
  // the row's first lane gathers h'[0 .. N-1] and sums in order
  float hn[N];
  const int first = (threadIdx.x & 31) & ~(kLanes - 1);
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hn[4 * l + e] = __shfl_sync(0xffffffffu, ho[e], first + l);
  const float ci[N] = {cv[0].x, cv[0].y, cv[0].z, cv[0].w,
                       cv[1].x, cv[1].y, cv[1].z, cv[1].w,
                       cv[2].x, cv[2].y, cv[2].z, cv[2].w,
                       cv[3].x, cv[3].y, cv[3].z, cv[3].w};
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) acc = __fmaf_rn(hn[n], ci[n], acc);
  if (on && q == 0) y[row] = __fmaf_rn(dv, xv, acc);
}

KERNEL_API int mamba_decode_launch(const void* x, const void* g,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* D,
                                   const void* h, void* y, void* h_new,
                                   int B, int Din, int n_state,
                                   void* stream) {
  if (n_state != N) return (int)cudaErrorInvalidValue;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const long long threads = (long long)Din * kLanes;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mamba_decode_kernel<<<grid, kThreads, 0, s>>>(
      f(x), f(g), f(A), f(Bm), f(Cm), f(D), f(h), static_cast<float*>(y),
      static_cast<float*>(h_new), Din);
  return (int)cudaGetLastError();
}
