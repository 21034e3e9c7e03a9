// Mamba selective scan (prefill): for every sequence b and channel d,
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t      (h: N fp32)
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * u_t
// over t = 0 .. T-1, returning y [B, T, Din] in u's dtype and the final
// state h_T [B, Din, N] fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// (selective_scan_pallas -> _ssm_kernel). Same contract: u, dt [B, T, Din]
// and B, C [B, T, N] in the model dtype, A [Din, N] fp32, D [Din] fp32, an
// optional h0 [B, Din, N] fp32 (zeros when absent).
//
// Bound on the H100: each layer's prefill reads u, dt and writes y once
// (3 * T * Din values) plus the fp32 state, ~6.8 MB at T = 128, Din = 8192
// (~2 us at 3.35 TB/s), and does ~9 * T * Din * N fp32 operations (~2.3 us
// at 67 TFLOP/s; the exp runs on the SFU). The recurrence is sequential in
// T, so the work is latency-bound: what the design does is keep the state
// where it costs nothing to carry.
//
// Design: one thread per (sequence, channel), holding its N state values
// in registers across the whole time loop (the TPU kernel's "state in
// VMEM" becomes state in registers), with A[d] and D[d] in registers too.
// A block of kChannels threads walks t in chunks of kChunk steps: all its
// threads first stage the chunk's u and dt (coalesced across channels)
// and the chunk's B_t, C_t (shared by every channel) in shared memory,
// then each thread runs the chunk's steps from shared memory. T is not
// padded: the last chunk is short. The sum over n runs in the fixed order
// n = 0 .. N-1 with accurate expf, so a step's arithmetic does not depend
// on where the chunk boundaries fall: a scan of T1 tokens then T2 tokens
// with the state carried gives bitwise the scan of T1 + T2.
#include <stdint.h>

#include "common.cuh"

constexpr int kChannels = 64;   // threads (channels) per block
constexpr int kChunk = 32;      // time steps staged per pass
constexpr int N = 16;           // d_state (Jamba's): kept in registers

template <typename T>
__global__ void __launch_bounds__(kChannels)
    ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hT, int Tlen, int Din) {
  __shared__ float us[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int d = d0 + threadIdx.x;
  const bool on = d < Din;
  float a[N], h[N];
  float dskip = 0.f;
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = A[(size_t)d * N + n];
      h[n] = h0 ? h0[((size_t)b * Din + d) * N + n] : 0.f;
    }
    dskip = D[d];
  }
  const size_t row0 = (size_t)b * Tlen;      // row of (b, t = 0)
  for (int t0 = 0; t0 < Tlen; t0 += kChunk) {
    const int nt = min(kChunk, Tlen - t0);
    __syncthreads();                          // the previous chunk is read
    for (int i = threadIdx.x; i < nt * kChannels; i += kChannels) {
      const int tt = i / kChannels, c = i % kChannels;
      const size_t off = (row0 + t0 + tt) * Din + d0 + c;
      const bool in = d0 + c < Din;
      us[tt][c] = in ? to_f32(u[off]) : 0.f;
      dts[tt][c] = in ? to_f32(dt[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < nt * N; i += kChannels) {
      const int tt = i / N, n = i % N;
      const size_t off = (row0 + t0 + tt) * N + n;
      bs[tt][n] = to_f32(Bm[off]);
      cs[tt][n] = to_f32(Cm[off]);
    }
    __syncthreads();
    if (!on) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dts[tt][threadIdx.x], uv = us[tt][threadIdx.x];
      const float dtu = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(dtv * a[n]);
        h[n] = da * h[n] + dtu * bs[tt][n];
        acc += h[n] * cs[tt][n];
      }
      y[(row0 + t0 + tt) * Din + d] = from_f32<T>(acc + dskip * uv);
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) hT[((size_t)b * Din + d) * N + n] = h[n];
  }
}

template <typename T>
static int launch(const void* u, const void* dt, const float* A,
                  const void* Bm, const void* Cm, const float* D,
                  const float* h0, void* y, float* hT, int B, int Tlen,
                  int Din, cudaStream_t s) {
  const dim3 grid((Din + kChannels - 1) / kChannels, B);
  ssm_scan_kernel<T><<<grid, kChannels, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, h0,
      static_cast<T*>(y), hT, Tlen, Din);
  return (int)cudaGetLastError();
}

KERNEL_API int ssm_scan_launch(const void* u, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* hT, int B,
                               int Tlen, int Din, int n_state, int dtype,
                               void* stream) {
  if (n_state != N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(A);
  auto dd = static_cast<const float*>(D);
  auto h = static_cast<const float*>(h0);
  auto ht = static_cast<float*>(hT);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(u, dt, a, Bm, Cm, dd, h, y, ht, B, Tlen,
                                 Din, s);
  return launch<float>(u, dt, a, Bm, Cm, dd, h, y, ht, B, Tlen, Din, s);
}
