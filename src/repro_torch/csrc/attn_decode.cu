// Decode attention: one query token per sequence over a contiguous cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attn_decode/attn_decode.py
// (attn_decode_pallas -> _decode_kernel), GQA mode. q [B, Hq, 128],
// k/v [B, Hkv, S, 128] in the model dtype, cache_pos [B] int32: positions
// 0..cache_pos[b] are valid. Output fp32 [B, Hq, 128].
//
// Numerics follow the plain version (the JAX attn_decode ref, GQA mode):
// the query is pre-scaled and rounded to the cache dtype, scores and the
// weighted sum of V accumulate in fp32, the output is fp32.
//
// Bound on the H100: bytes. Each valid K and V row is read once and used
// for a handful of flops per byte. Design: one block per (sequence, KV
// head) serves all g = Hq / Hkv query heads of the group, so each K/V row
// is read from device memory once for the whole group, the bandwidth
// point of GQA. The block walks the cache in tiles of 64 positions up to
// cache_pos[b] only (the Pallas kernel streams the whole cache and masks),
// with an fp32 online softmax: each warp scores a position against all g
// heads (one warp-wide dot product per head over 4 dims a lane), one warp
// per head updates the running max and sum, then each thread adds the V
// rows of the tile into its output dims. A sequence's result never depends
// on the other sequences of the batch.
#include "common.cuh"

constexpr int D = 128, TILE = 64, kThreads = 256, kMaxGroup = 16;
constexpr float kNeg = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ cache_pos,
                  float* __restrict__ out, int Hq, int Hkv, int S,
                  float scale) {
  __shared__ float Qs[kMaxGroup * D];
  __shared__ float Ps[kMaxGroup * TILE];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, g = Hq / Hkv;
  const T* qb = q + ((size_t)b * Hq + (size_t)hk * g) * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)S * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)S * D;
  const int n = min(cache_pos[b], S - 1) + 1;  // valid positions

  for (int e = tid; e < g * D; e += kThreads)
    Qs[e] = to_f32(from_f32<T>(to_f32(qb[e]) * scale));

  // warp w keeps the running (max, sum) of heads w and w + 8
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};
  // thread t accumulates dim d = t % 128 of heads t / 128 + 2 j
  const int d = tid & (D - 1), hb = tid >> 7;
  float acc[kMaxGroup / 2];
#pragma unroll
  for (int j = 0; j < kMaxGroup / 2; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int nt = min(TILE, n - t0);
    // scores: warp w takes positions w, w + 8, ... of the tile
    for (int pi = warp; pi < nt; pi += kThreads / 32) {
      const T* kr = kb + (size_t)(t0 + pi) * D + lane * 4;
      float kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = to_f32(kr[e]);
      for (int h = 0; h < g; ++h) {
        const float* qh = Qs + h * D + lane * 4;
        float part = qh[0] * kv[0] + qh[1] * kv[1] + qh[2] * kv[2] + qh[3] * kv[3];
        part = warp_sum(part);
        if (lane == 0) Ps[h * TILE + pi] = part;
      }
    }
    __syncthreads();
    // online softmax update: one warp per head
    for (int h = warp, hi = 0; h < g; h += kThreads / 32, ++hi) {
      const bool ok0 = lane < nt, ok1 = lane + 32 < nt;
      const float s0 = ok0 ? Ps[h * TILE + lane] : kNeg;
      const float s1 = ok1 ? Ps[h * TILE + lane + 32] : kNeg;
      const float m_new = fmaxf(m_run[hi], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_run[hi] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      l_run[hi] = l_run[hi] * alpha + warp_sum(p0 + p1);
      m_run[hi] = m_new;
      Ps[h * TILE + lane] = p0;
      Ps[h * TILE + lane + 32] = p1;
      if (lane == 0) alpha_s[h] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxGroup / 2; ++j)
      if (hb + 2 * j < g) acc[j] *= alpha_s[hb + 2 * j];
    for (int pi = 0; pi < nt; ++pi) {
      const float vv = to_f32(vb[(size_t)(t0 + pi) * D + d]);
#pragma unroll
      for (int j = 0; j < kMaxGroup / 2; ++j)
        if (hb + 2 * j < g) acc[j] = fmaf(Ps[(hb + 2 * j) * TILE + pi], vv, acc[j]);
    }
    __syncthreads();  // Ps and alpha_s are rewritten by the next tile
  }
  for (int h = warp, hi = 0; h < g; h += kThreads / 32, ++hi)
    if (lane == 0) l_s[h] = l_run[hi];
  __syncthreads();
  float* ob = out + ((size_t)b * Hq + (size_t)hk * g) * D;
#pragma unroll
  for (int j = 0; j < kMaxGroup / 2; ++j) {
    const int h = hb + 2 * j;
    if (h < g) ob[h * D + d] = acc[j] / fmaxf(l_s[h], 1e-30f);
  }
}

KERNEL_API int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* cache_pos, void* out, int B,
                                  int Hq, int Hkv, int S, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  const int* cp = static_cast<const int*>(cache_pos);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16)
    decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), cp, o, Hq, Hkv, S, scale);
  else
    decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), cp, o, Hq, Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}
