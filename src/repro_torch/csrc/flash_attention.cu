// Blockwise (flash) attention with an fp32 online softmax, GQA-native.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas -> _fa_kernel): the prefill attention.
// q/k [B, H, T|S, Dqk], v [B, Hkv, S, Dv] in the model dtype, with (Dqk,
// Dv) = (128, 128) (GQA) or (192, 128) (MLA prefill: 128 latent-decompressed
// dims + 64 rotary dims per head, values of 128); query head h reads KV
// head h / (Hq / Hkv). Causal mode masks bottom-right:
// key j is visible to query i iff j <= i + (S - T). Output in q's dtype.
//
// Bound on the H100: at prefill lengths up to a few hundred tokens the
// work is small next to the projections around it; its floor is the bytes
// of q, k, v and the output. The [T, S] score matrix never reaches device
// memory. Design: one block per (query tile of 64 rows, query head,
// sequence). K and V stream through shared memory in tiles of 64 keys,
// converted to fp32 once per tile; the block keeps the running row max
// m, row sum l and the fp32 output accumulator, as the Pallas kernel keeps
// them in VMEM scratch. Tiles entirely past the causal edge are skipped.
// Masked scores contribute exactly 0 (p is set to 0, and a tile with no
// visible key leaves m unchanged, so its rescale factor is exactly 1):
// a row's result does not depend on how many rows follow it, which keeps
// prefill of a right-padded prompt bitwise equal to prefill of the prompt.
//
// Threads: 256; thread t owns query row t / 4 of the tile and, within it,
// score columns c = t % 4 + 4 j and output dims d = t % 4 + 4 i, so shared
// memory reads of neighbouring threads fall in distinct banks. The kernel
// is a template over (Dqk, Dv); the (128, 128) instance does the same
// arithmetic as the kernel fixed at D = 128 did, so yi-9b's tokens keep
// their bits. Shared memory: ~115 KB at (128, 128), ~148 KB at (192, 128).
#include "common.cuh"

constexpr int BQ = 64, BKV = 64, kThreads = 256;
constexpr float kNeg = -1e30f;

template <int DQK, int DV>
struct Smem {
  static constexpr int LDQ = DQK + 1, LDK = DQK + 1, LDV = DV, LDP = BKV + 1;
  static constexpr size_t bytes =
      sizeof(float) * (BQ * LDQ + BKV * LDK + BKV * LDV + BQ * LDP);
};

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq,
                 int Hkv, int T_, int S, int causal, float scale) {
  using L = Smem<DQK, DV>;
  constexpr int LDQ = L::LDQ, LDK = L::LDK, LDV = L::LDV, LDP = L::LDP;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BKV * LDK;
  float* Ps = Vs + BKV * LDV;

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + (((size_t)b * Hq + h) * T_) * DQK;
  const T* kb = k + (((size_t)b * Hkv + hk) * S) * DQK;
  const T* vb = v + (((size_t)b * Hkv + hk) * S) * DV;
  const int off = S - T_;  // causal offset: query i sees keys j <= i + off

  for (int e = tid; e < BQ * DQK; e += kThreads) {
    const int rr = e / DQK, dd = e % DQK;
    Qs[rr * LDQ + dd] =
        q0 + rr < T_ ? to_f32(qb[(size_t)(q0 + rr) * DQK + dd]) * scale : 0.f;
  }
  const int q_last = min(T_ - 1, q0 + BQ - 1);
  const int kv_end = causal ? min(S, q_last + off + 1) : S;
  const int qi = q0 + r;

  float m_i = kNeg, l_i = 0.f, acc[DV / 4];
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int e = tid; e < BKV * DQK; e += kThreads) {
      const int rr = e / DQK, dd = e % DQK;
      Ks[rr * LDK + dd] =
          kv0 + rr < S ? to_f32(kb[(size_t)(kv0 + rr) * DQK + dd]) : 0.f;
    }
    for (int e = tid; e < BKV * DV; e += kThreads) {
      const int rr = e / DV, dd = e % DV;
      Vs[rr * LDV + dd] =
          kv0 + rr < S ? to_f32(vb[(size_t)(kv0 + rr) * DV + dd]) : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int c = sub + 4 * j, kj = kv0 + c;
      float dot = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < DQK; ++dd) dot = fmaf(Qs[r * LDQ + dd], Ks[c * LDK + dd], dot);
      const bool ok = kj < S && (!causal || kj <= qi + off);
      s[j] = ok ? dot : kNeg;
      mt = fmaxf(mt, s[j]);
    }
    // the 4 threads of a row are neighbouring lanes of one warp
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int c = sub + 4 * j, kj = kv0 + c;
      const bool ok = kj < S && (!causal || kj <= qi + off);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      Ps[r * LDP + c] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l_i = l_i * alpha + lsum;
    m_i = m_new;
    __syncwarp();  // the row's P is written by its own 4 lanes
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < BKV; ++j) {
      const float p = Ps[r * LDP + j];
#pragma unroll
      for (int i = 0; i < DV / 4; ++i)
        acc[i] = fmaf(p, Vs[j * LDV + sub + 4 * i], acc[i]);
    }
  }
  if (qi < T_) {
    const float inv_l = 1.f / fmaxf(l_i, 1e-30f);
    T* ob = out + (((size_t)b * Hq + h) * T_ + qi) * DV;
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) ob[sub + 4 * i] = from_f32<T>(acc[i] * inv_l);
  }
}

template <typename T, int DQK, int DV>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Hq, int Hkv, int T_, int S, int causal,
                  float scale, cudaStream_t s) {
  constexpr size_t smem = Smem<DQK, DV>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_ + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, DQK, DV><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, T_, S, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dims(const void* q, const void* k, const void* v, void* out,
                       int B, int Hq, int Hkv, int T_, int S, int dqk, int dv,
                       int causal, float scale, cudaStream_t s) {
  if (dqk == 128 && dv == 128)
    return launch<T, 128, 128>(q, k, v, out, B, Hq, Hkv, T_, S, causal, scale,
                               s);
  if (dqk == 192 && dv == 128)
    return launch<T, 192, 128>(q, k, v, out, B, Hq, Hkv, T_, S, causal, scale,
                               s);
  return (int)cudaErrorInvalidValue;
}

KERNEL_API int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int T_, int S, int dqk, int dv,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_dims<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, T_, S, dqk,
                                      dv, causal, scale, s);
  return launch_dims<float>(q, k, v, out, B, Hq, Hkv, T_, S, dqk, dv, causal,
                            scale, s);
}
