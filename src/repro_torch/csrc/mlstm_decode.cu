// mLSTM decode step: one token of the matrix-LSTM cell for every sequence b
// and head, all fp32:
//   m' = max(lf + m, li);  f = exp(lf + m - m');  i = exp(li - m')
//   C'[r, j] = f C[r, j] + i (k[r] v[j]);   n'[r] = f n[r] + i k[r]
//   h[j]     = (sum_r q[r] C'[r, j]) / max(|q . n'|, exp(-m'))
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_decode/ssm_decode.py
// (mlstm_decode_pallas -> _mlstm_kernel), the mLSTM mode of the ssm_decode
// op. Same contract: q, k, v [B, H, dh]; li, lf, m [B, H]; C [B, H, dh, dh];
// n [B, H, dh]; returns h [B, H, dh] and (C', n', m'), new tensors.
//
// Bound on the H100: bytes. C is read once and C' written once, 2 * B * H
// * dh^2 * 4 bytes (33.6 MB at B = H = 4, dh = 512: 10 us at 3.35 TB/s);
// the ~5 * B * H * dh^2 operations are far below the compute bound.
//
// Design. The Pallas grid is (B,): one program holds a row's whole
// [H, dh, dh] cell, which fits a TPU's VMEM at dh <= 128 but is 4 MiB at
// xlstm-350m's dh = 512. Here the grid is (column block of 64, head, row
// b): 8 x 4 x 4 = 128 blocks at the serving shape. A block's 256 threads
// are 16 row groups x 16 column threads; a column thread owns 4
// neighbouring columns and walks the rows r = group, group + 16, ... with
// 16-byte loads and stores (a warp reads two 256-byte row pieces), so each
// element of C is read and C' written by one thread, once. h[j] is summed
// over r in one fixed order: in the thread by ascending r, then the 16
// row groups in ascending order through shared memory; no atomics. Every
// block recomputes m', f, i and the dh-long q . n' in the same fixed order
// (thread strides, a butterfly in each warp, the 8 warps in order), so
// all blocks of a (b, head) divide by the identical denominator; the
// first column block alone writes n' and m'. A row reads nothing of
// another row, so row b of a launch is bitwise the same at any batch size.
// Accurate expf; no fast-math.
#include <stdint.h>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kColThreads = 16;                    // threads across columns
constexpr int kCols = 4 * kColThreads;             // 64 columns a block
constexpr int kRowGroups = kThreads / kColThreads;  // 16

__global__ void __launch_bounds__(kThreads)
    mlstm_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ li,
                        const float* __restrict__ lf,
                        const float* __restrict__ m,
                        const float* __restrict__ C,
                        const float* __restrict__ n, float* __restrict__ h,
                        float* __restrict__ C_new, float* __restrict__ n_new,
                        float* __restrict__ m_new, int H, int dh) {
  __shared__ float part[kThreads / 32];
  __shared__ float red[kRowGroups][kCols];
  const int tid = threadIdx.x;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qv = q + bh * dh;
  const float* kv = k + bh * dh;
  const float* nv = n + bh * dh;
  const float m_old = m[bh], lfv = lf[bh], liv = li[bh];
  const float mn = fmaxf(lfv + m_old, liv);
  const float fw = expf(lfv + m_old - mn);
  const float iw = expf(liv - mn);
  const bool first = blockIdx.x == 0;

  // q . n' in one fixed order (the same in every block of this head)
  float dot = 0.f;
  for (int r = tid; r < dh; r += kThreads) {
    const float nr = fw * nv[r] + iw * kv[r];
    dot += qv[r] * nr;
    if (first) n_new[bh * dh + r] = nr;
  }
  dot = warp_sum(dot);
  if ((tid & 31) == 0) part[tid >> 5] = dot;
  __syncthreads();
  float qn = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) qn += part[w];
  const float denom = fmaxf(fabsf(qn), expf(-mn));
  if (first && tid == 0) m_new[bh] = mn;

  // C' and the partial column sums of q^T C' over this thread's rows
  const int cg = tid % kColThreads, rg = tid / kColThreads;
  const int j = blockIdx.x * kCols + 4 * cg;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (j < dh) {
    const float4 vj = *reinterpret_cast<const float4*>(v + bh * dh + j);
    const float* cb = C + bh * dh * dh + j;
    float* cn = C_new + bh * dh * dh + j;
#pragma unroll 8
    for (int r = rg; r < dh; r += kRowGroups) {
      const float4 c = *reinterpret_cast<const float4*>(cb + (size_t)r * dh);
      const float kr = kv[r], qr = qv[r];
      float4 o;
      o.x = fw * c.x + iw * (kr * vj.x);
      o.y = fw * c.y + iw * (kr * vj.y);
      o.z = fw * c.z + iw * (kr * vj.z);
      o.w = fw * c.w + iw * (kr * vj.w);
      *reinterpret_cast<float4*>(cn + (size_t)r * dh) = o;
      acc[0] += qr * o.x;
      acc[1] += qr * o.y;
      acc[2] += qr * o.z;
      acc[3] += qr * o.w;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[rg][4 * cg + e] = acc[e];
  __syncthreads();
  if (tid < kCols) {
    const int jj = blockIdx.x * kCols + tid;
    if (jj < dh) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kRowGroups; ++g) s += red[g][tid];
      h[bh * dh + jj] = s / denom;
    }
  }
}

KERNEL_API int mlstm_decode_launch(const void* q, const void* k,
                                   const void* v, const void* li,
                                   const void* lf, const void* m,
                                   const void* C, const void* n, void* h,
                                   void* C_new, void* n_new, void* m_new,
                                   int B, int H, int dh, void* stream) {
  if (dh % 4) return (int)cudaErrorInvalidValue;   // 16-byte row pieces
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const dim3 grid((dh + kCols - 1) / kCols, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlstm_decode_kernel<<<grid, kThreads, 0, s>>>(
      f(q), f(k), f(v), f(li), f(lf), f(m), f(C), f(n), o(h), o(C_new),
      o(n_new), o(m_new), H, dh);
  return (int)cudaGetLastError();
}
