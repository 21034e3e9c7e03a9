// The tile loop of precise-mode (MLA absorbed) decode attention, shared by
// attn_decode_mla.cu (contiguous latent cache) and paged_attention_mla.cu
// (latent pages behind a page table).
//
// Both kernels run this one function, so a query row sees the same
// arithmetic in the same order whichever cache layout holds its latent:
// on the same latent the paged kernel equals the contiguous one bit for
// bit, which is what makes the paged engine's tokens equal the contiguous
// engine's on an MLA arch.
//
//   q  fp32 [B, H, 512]   (the absorbed query, W_uk^T q_nope)
//   q2 fp32 [B, H, 64]    (the rotary query)
//   c  rows of 512        (the latent, model dtype: K and V at once)
//   kr rows of 64         (the rotary key, model dtype)
//   logit[h, s] = (q[h] . c[s] + q2[h] . kr[s]) * scale, masked for
//   s > cache_pos[b]; out[b, h] = softmax(logit[h]) . c, fp32 [B, H, 512].
// The scale is applied after the dot products and everything is fp32, as
// the JAX ref's precise mode.
//
// Design (simple first): one block per sequence, looping over its own
// positions in tiles of 32 (so a row's result depends on its own cache
// alone, whatever the batch). A row-address policy (Contiguous / Paged)
// names the storage row of each position of the tile once, in shared
// memory; each latent row is then loaded into shared memory once and used
// for both the scores of all heads and the weighted sum. Warp w scores
// heads 2w and 2w + 1, lane p position p of the tile (odd row strides
// keep the lanes in distinct banks); 16 threads per head then accumulate
// its 512 output dims. Positions past cache_pos, and positions whose row
// has no storage (an unallocated page), are zero-filled in shared memory
// and weighted 0, so junk there (even NaN) never reaches the output.
#pragma once

#include "common.cuh"

namespace mla {

constexpr int DL = 512, DR = 64, MAXH = 16, TS = 32, kThreads = 256;
constexpr int LDC = DL + 1, LDR = DR + 1;
constexpr int RJ = TS * DR / kThreads;  // rotary elements a thread stages
static_assert(DL == 2 * kThreads && kThreads % DR == 0,
              "the staging loop gives each thread 2 latent dims");
constexpr size_t kSmemBytes =
    TS * sizeof(long long) +
    sizeof(float) * (MAXH * (DL + DR) + TS * LDC + TS * LDR + MAXH * TS +
                     2 * MAXH);
constexpr float kNeg = -1e30f;

// Storage row of position p of sequence b (the latent at c + row * DL, the
// rotary key at kr + row * DR), or -1 when the position has no storage.
struct Contiguous {  // c [B, S, DL], kr [B, S, DR]
  int S;
  __device__ __forceinline__ long long operator()(int b, int p) const {
    return (long long)b * S + p;
  }
};

struct Paged {  // pools c [P, ps, DL], kr [P, ps, DR]; table [B, NP] (-1 none)
  const int* table;
  int ps, NP;
  __device__ __forceinline__ long long operator()(int b, int p) const {
    const int page = table[(long long)b * NP + p / ps];
    return page < 0 ? -1 : (long long)page * ps + p % ps;
  }
};

// S is the extent of a sequence's positions (NP * ps when paged).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    mla_decode_kernel(const float* __restrict__ q,
                      const float* __restrict__ q2, const T* __restrict__ c,
                      const T* __restrict__ kr,
                      const int* __restrict__ cache_pos,
                      float* __restrict__ out, int H, int S, float scale,
                      Rows rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_s = reinterpret_cast<long long*>(smem_raw);  // [TS]
  float* qs = reinterpret_cast<float*>(row_s + TS);  // [MAXH, DL + DR]
  float* cs = qs + MAXH * (DL + DR);                 // [TS, LDC]
  float* rs = cs + TS * LDC;                         // [TS, LDR]
  float* ps = rs + TS * LDR;                // [MAXH, TS] softmax weights
  float* alpha_s = ps + MAXH * TS;          // [MAXH] rescale of the tile
  float* l_s = alpha_s + MAXH;              // [MAXH] final row sums

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = min(cache_pos[b] + 1, S);   // valid positions 0 .. n-1
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
    if (tid < TS) row_s[tid] = t0 + tid < n ? rows(b, t0 + tid) : -1;
    __syncthreads();
    // stage the tile: thread t copies dims t and t + 256 of every latent
    // row and dim t % 64 of the rotary rows of positions t / 64 + 4 j. All
    // loads go to registers first, then all stores to shared memory, so
    // the loads of a tile are in flight together (a store to shared memory
    // between them could alias row_s and would serialise them)
    float c_st[2 * TS], r_st[RJ];
#pragma unroll
    for (int p = 0; p < TS; ++p) {
      const long long r = row_s[p];
      c_st[2 * p] = r >= 0 ? to_f32(c[r * DL + tid]) : 0.f;
      c_st[2 * p + 1] = r >= 0 ? to_f32(c[r * DL + kThreads + tid]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const long long r = row_s[(tid / DR) + j * (kThreads / DR)];
      r_st[j] = r >= 0 ? to_f32(kr[r * DR + tid % DR]) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < TS; ++p) {
      cs[p * LDC + tid] = c_st[2 * p];
      cs[p * LDC + kThreads + tid] = c_st[2 * p + 1];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j)
      rs[((tid / DR) + j * (kThreads / DR)) * LDR + tid % DR] = r_st[j];
    __syncthreads();
    if (h0 < H) {
      const bool ok = row_s[lane] >= 0;
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

template <typename T, typename Rows>
cudaError_t launch_t(const float* q, const float* q2, const void* c,
                     const void* kr, const int* cache_pos, float* out, int B,
                     int H, int S, float scale, Rows rows, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      mla_decode_kernel<T, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  mla_decode_kernel<T, Rows><<<B, kThreads, kSmemBytes, s>>>(
      q, q2, static_cast<const T*>(c), static_cast<const T*>(kr), cache_pos,
      out, H, S, scale, rows);
  return cudaGetLastError();
}

// Launch on `stream` for dtype code `dtype` (common.cuh); returns
// cudaGetLastError().
template <typename Rows>
int launch(const void* q, const void* q2, const void* c, const void* kr,
           const void* cache_pos, void* out, int B, int H, int S,
           float scale, int dtype, Rows rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto q2f = static_cast<const float*>(q2);
  auto cp = static_cast<const int*>(cache_pos);
  auto o = static_cast<float*>(out);
  return static_cast<int>(
      dtype == kBF16 ? launch_t<__nv_bfloat16>(qf, q2f, c, kr, cp, o, B, H,
                                               S, scale, rows, s)
                     : launch_t<float>(qf, q2f, c, kr, cp, o, B, H, S, scale,
                                       rows, s));
}

}  // namespace mla
