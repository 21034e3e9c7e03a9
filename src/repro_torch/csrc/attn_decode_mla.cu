// Precise-mode (MLA absorbed) decode attention, fp32 online softmax.
//
// Replaces the precise mode of the Pallas TPU kernel
// src/repro/kernels/attn_decode/attn_decode.py (attn_decode_pallas with
// precise=True): one query token per sequence against the MLA latent
// cache, which is both K and V, plus the shared rotary key.
//   q  fp32 [B, H, 512]   (the absorbed query, W_uk^T q_nope)
//   q2 fp32 [B, H, 64]    (the rotary query)
//   c  [B, S, 512]        (the latent, model dtype: K and V at once)
//   kr [B, S, 64]         (the rotary key, model dtype)
//   logit[h, s] = (q[h] . c[s] + q2[h] . kr[s]) * scale, masked for
//   s > cache_pos[b]; out[b, h] = softmax(logit[h]) . c, fp32 [B, H, 512].
// The scale is applied after the dot products and everything is fp32, as
// the JAX ref's precise mode.
//
// Bound on the H100: at serving lengths the latent of one sequence is a
// few hundred KB, so the kernel is far below the card's byte and flop
// floors; what it costs is latency. Design (simple first): one block per
// sequence, looping over its own positions in tiles of 32 (so a row's
// result depends on its own cache alone, whatever the batch), each latent
// row loaded into shared memory once and used for both the scores of all
// heads and the weighted sum. Warp w scores heads 2w and 2w + 1, lane p
// position p of the tile (odd row strides keep the lanes in distinct
// banks); 16 threads per head then accumulate its 512 output dims.
// Positions past cache_pos are zero-filled in shared memory and weighted 0,
// so junk there (even NaN) never reaches the output.
#include "common.cuh"

constexpr int DL = 512, DR = 64, MAXH = 16, TS = 32, kThreads = 256;
constexpr int LDC = DL + 1, LDR = DR + 1;
constexpr size_t kSmemBytes =
    sizeof(float) * (MAXH * (DL + DR) + TS * LDC + TS * LDR + MAXH * TS +
                     2 * MAXH);
constexpr float kNeg = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_decode_kernel(const float* __restrict__ q,
                      const float* __restrict__ q2, const T* __restrict__ c,
                      const T* __restrict__ kr,
                      const int* __restrict__ cache_pos,
                      float* __restrict__ out, int H, int S, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                         // [MAXH, DL + DR]: q then q2
  float* cs = qs + MAXH * (DL + DR);        // [TS, LDC]
  float* rs = cs + TS * LDC;                // [TS, LDR]
  float* ps = rs + TS * LDR;                // [MAXH, TS] softmax weights
  float* alpha_s = ps + MAXH * TS;          // [MAXH] rescale of the tile
  float* l_s = alpha_s + MAXH;              // [MAXH] final row sums

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = min(cache_pos[b] + 1, S);   // valid positions 0 .. n-1
  const T* cb = c + (size_t)b * S * DL;
  const T* rb = kr + (size_t)b * S * DR;
  for (int e = tid; e < H * DL; e += kThreads)
    qs[(e / DL) * (DL + DR) + e % DL] = q[(size_t)b * H * DL + e];
  for (int e = tid; e < H * DR; e += kThreads)
    qs[(e / DR) * (DL + DR) + DL + e % DR] = q2[(size_t)b * H * DR + e];

  // scores: warp w -> heads h0 = 2w, h1 = 2w + 1 (each a warp-wide row)
  const int h0 = 2 * warp, h1 = 2 * warp + 1;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  // weighted sum: thread -> head ho = tid / 16, dims sub + 16 i
  const int ho = tid >> 4, sub = tid & 15;
  float acc[DL / 16];
#pragma unroll
  for (int i = 0; i < DL / 16; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += TS) {
    __syncthreads();  // q staged / the previous tile fully consumed
    for (int e = tid; e < TS * DL; e += kThreads) {
      const int p = e / DL, dd = e % DL;
      cs[p * LDC + dd] = t0 + p < n ? to_f32(cb[(size_t)(t0 + p) * DL + dd])
                                    : 0.f;
    }
    for (int e = tid; e < TS * DR; e += kThreads) {
      const int p = e / DR, dd = e % DR;
      rs[p * LDR + dd] = t0 + p < n ? to_f32(rb[(size_t)(t0 + p) * DR + dd])
                                    : 0.f;
    }
    __syncthreads();
    if (h0 < H) {
      const bool ok = t0 + lane < n;
      const float* q0 = qs + h0 * (DL + DR);
      const float* q1 = qs + min(h1, H - 1) * (DL + DR);
      const float* cr = cs + lane * LDC;
      const float* rr = rs + lane * LDR;
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < DL; ++dd) {
        const float cv = cr[dd];
        a0 = fmaf(q0[dd], cv, a0);
        a1 = fmaf(q1[dd], cv, a1);
      }
#pragma unroll 8
      for (int dd = 0; dd < DR; ++dd) {
        const float rv = rr[dd];
        b0 = fmaf(q0[DL + dd], rv, b0);
        b1 = fmaf(q1[DL + dd], rv, b1);
      }
      const float s0 = ok ? (a0 + b0) * scale : kNeg;
      const float s1 = ok ? (a1 + b1) * scale : kNeg;
      const float mn0 = fmaxf(m0, warp_max(s0));
      const float mn1 = fmaxf(m1, warp_max(s1));
      const float p0 = ok ? expf(s0 - mn0) : 0.f;
      const float p1 = ok ? expf(s1 - mn1) : 0.f;
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      l0 = l0 * al0 + warp_sum(p0);
      l1 = l1 * al1 + warp_sum(p1);
      m0 = mn0;
      m1 = mn1;
      ps[h0 * TS + lane] = p0;
      if (lane == 0) alpha_s[h0] = al0;
      if (h1 < H) {
        ps[h1 * TS + lane] = p1;
        if (lane == 0) alpha_s[h1] = al1;
      }
    }
    __syncthreads();
    if (ho < H) {
      const float al = alpha_s[ho];
#pragma unroll
      for (int i = 0; i < DL / 16; ++i) acc[i] *= al;
      const int np = min(TS, n - t0);
      for (int p = 0; p < np; ++p) {
        const float w = ps[ho * TS + p];
        const float* cr = cs + p * LDC + sub;
#pragma unroll
        for (int i = 0; i < DL / 16; ++i) acc[i] = fmaf(w, cr[16 * i], acc[i]);
      }
    }
  }
  if (h0 < H && lane == 0) {
    l_s[h0] = l0;
    if (h1 < H) l_s[h1] = l1;
  }
  __syncthreads();
  if (ho < H) {
    const float inv = 1.f / fmaxf(l_s[ho], 1e-30f);
    float* ob = out + ((size_t)b * H + ho) * DL;
#pragma unroll
    for (int i = 0; i < DL / 16; ++i) ob[sub + 16 * i] = acc[i] * inv;
  }
}

template <typename T>
static int launch(const float* q, const float* q2, const void* c,
                  const void* kr, const int* cache_pos, float* out, int B,
                  int H, int S, float scale, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  mla_decode_kernel<T><<<B, kThreads, kSmemBytes, s>>>(
      q, q2, static_cast<const T*>(c), static_cast<const T*>(kr), cache_pos,
      out, H, S, scale);
  return (int)cudaGetLastError();
}

KERNEL_API int attn_decode_mla_launch(const void* q, const void* q2,
                                      const void* c, const void* kr,
                                      const void* cache_pos, void* out, int B,
                                      int H, int S, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto q2f = static_cast<const float*>(q2);
  auto cp = static_cast<const int*>(cache_pos);
  auto o = static_cast<float*>(out);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(qf, q2f, c, kr, cp, o, B, H, S, scale, s);
  return launch<float>(qf, q2f, c, kr, cp, o, B, H, S, scale, s);
}
