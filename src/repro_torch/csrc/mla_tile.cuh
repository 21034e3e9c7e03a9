// The kernel of precise-mode (MLA absorbed) decode attention, shared by
// attn_decode_mla.cu (contiguous latent cache) and paged_attention_mla.cu
// (latent pages behind a page table).
//
// Both launch this one kernel with the same plan, so a query row sees the
// same arithmetic in the same order whichever cache layout holds its
// latent: on the same latent the paged kernel equals the contiguous one
// bit for bit, which is what makes the paged engine's tokens equal the
// contiguous engine's on an MLA arch.
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
// A row's arithmetic (one head of one sequence), fixed by this file: the
// positions in tiles of 32 from position 0; position p's score is one
// fmaf chain over the latent dims 0..511 and one over the rotary dims
// 0..63, then (a + b) * scale; per tile one online-softmax update over
// its 32 positions (warp max and warp sum by lane = position), then each
// output dim rescaled and the tile's valid positions added in order by
// fmaf; the output is acc * (1 / l). It depends on the row's own cache
// alone.
//
// Bound on the H100: at serving lengths the latent of a sequence is a few
// hundred KB, far below the card's byte and flop floors; what a block
// waits on is latency, above all the score chain of 576 dependent fmafs a
// position. The schedule:
//  - one block per (head, sequence): grid (H, B), 64 blocks at deepseek's
//    B = 4, H = 16; each block writes all 512 output dims of its head, so
//    no score is computed twice;
//  - positions go in rounds of TPR tiles (2 in bf16), staged in shared
//    memory as stored (the latent and rotary rows; bf16 -> fp32 at use is
//    exact) by cp.async, double-buffered, so a round's loads fly while the
//    round before it is scored and summed; the paged kernel reads the
//    page table a round ahead of the copies it addresses;
//  - warp w < TPR scores tile w of the round, lane = position, so the
//    round's chains run at once; warp 0 then takes the round's softmax
//    updates in tile order, and all threads add the round's latent rows
//    into the output (thread t: dims 2t, 2t + 1), 8 rows loaded ahead of
//    their fmafs.
// Positions past cache_pos, and positions whose row has no storage (an
// unallocated page), are zero-filled in shared memory (never read) and
// weighted 0, so junk there (even NaN) never reaches the output.
#pragma once

#include "common.cuh"

namespace mla {

constexpr int DL = 512, DR = 64, TS = 32, kThreads = 256;
constexpr int kVec = 8;  // latent rows loaded ahead of their fmafs
static_assert(DL == 2 * kThreads, "thread t sums output dims 2t, 2t + 1");
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
  int lg_ps, NP;  // ps = 2^lg_ps (the page size divides the tile)
  __device__ __forceinline__ long long operator()(int b, int p) const {
    const int page = table[(long long)b * NP + (p >> lg_ps)];
    return page < 0 ? -1
                    : ((long long)page << lg_ps) + (p & ((1 << lg_ps) - 1));
  }
};

// Tiles a round: two in bf16 (152 KB of staging), one in fp32.
template <typename T>
constexpr int tiles_per_round() {
  return sizeof(T) == 2 ? 2 : 1;
}

// Shared memory of a block: two buffers of a round's latent and rotary
// rows (each row padded by 16 bytes, so the 8 lanes of a 16-byte load
// phase fall in distinct banks) and their storage rows, the query, the
// scores (then the softmax weights), the tile rescales and the row sum.
template <typename T>
struct Smem {
  static constexpr int TPR = tiles_per_round<T>();
  static constexpr int RT = TPR * TS;                     // positions a round
  static constexpr int LC = DL * sizeof(T) + 16;          // bytes a row
  static constexpr int LR = DR * sizeof(T) + 16;
  static constexpr size_t c_off = 0;
  static constexpr size_t r_off = c_off + 2 * (size_t)RT * LC;
  static constexpr size_t row_off = r_off + 2 * (size_t)RT * LR;
  static constexpr size_t q_off = row_off + 2 * RT * sizeof(long long);
  static constexpr size_t s_off = q_off + (DL + DR) * sizeof(float);
  static constexpr size_t a_off = s_off + RT * sizeof(float);
  static constexpr size_t l_off = a_off + TPR * sizeof(float);
  static constexpr size_t bytes = l_off + sizeof(float);
};

// One fmaf chain over n dims (a multiple of 16 / sizeof(T)) of a query row
// (fp32, shared, 16-byte aligned, broadcast to the warp) and a staged row
// (as stored), in dim order.
template <typename T>
__device__ __forceinline__ float dot_chain(const float* qh,
                                           const unsigned char* row, int n) {
  constexpr int EPC = 16 / sizeof(T);
  float a = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < n; dd += EPC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + dd * sizeof(T));
    const T* cv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < EPC; e += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qh + dd + e);
      a = fmaf(qv.x, to_f32(cv[e]), a);
      a = fmaf(qv.y, to_f32(cv[e + 1]), a);
      a = fmaf(qv.z, to_f32(cv[e + 2]), a);
      a = fmaf(qv.w, to_f32(cv[e + 3]), a);
    }
  }
  return a;
}

// Elements i, i + 1 of a staged row (i even), as fp32.
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* r, int i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r + i));
}
__device__ __forceinline__ float2 pair_f32(const float* r, int i) {
  return *reinterpret_cast<const float2*>(r + i);
}

// Block (h, b) serves head h of sequence b. S is the extent of a
// sequence's positions (NP * ps when paged).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    mla_decode_kernel(const float* __restrict__ q,
                      const float* __restrict__ q2, const T* __restrict__ c,
                      const T* __restrict__ kr,
                      const int* __restrict__ cache_pos,
                      float* __restrict__ out, int H, int S, float scale,
                      Rows rows) {
  using L = Smem<T>;
  constexpr int TPR = L::TPR, RT = L::RT;
  constexpr int CC = DL * sizeof(T) / 16, CR = DR * sizeof(T) / 16;
  constexpr int TPW = kThreads / RT;         // threads copying one row
  static_assert(kThreads % RT == 0 && (CC + CR) % TPW == 0,
                "a round's rows split evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* cs = smem_raw + L::c_off;        // [2][RT] rows of LC bytes
  unsigned char* rs = smem_raw + L::r_off;        // [2][RT] rows of LR bytes
  long long* row_s = reinterpret_cast<long long*>(smem_raw + L::row_off);
  float* qs = reinterpret_cast<float*>(smem_raw + L::q_off);   // [576]
  float* ss = reinterpret_cast<float*>(smem_raw + L::s_off);   // [RT]
  float* alpha_s = reinterpret_cast<float*>(smem_raw + L::a_off);  // [TPR]
  float* l_s = reinterpret_cast<float*>(smem_raw + L::l_off);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = min(cache_pos[b] + 1, S);   // valid positions 0 .. n-1
  const int n_rounds = (n + RT - 1) / RT;
  for (int e = tid; e < DL; e += kThreads)
    qs[e] = q[((size_t)b * H + h) * DL + e];
  if (tid < DR) qs[DL + tid] = q2[((size_t)b * H + h) * DR + tid];

  // Thread t copies chunks t % TPW, t % TPW + TPW, ... of row t / TPW of a
  // round (the latent's CC chunks, then the rotary key's CR). The row is
  // looked up a round before its copies are issued, so a page-table read
  // is never waited on before a copy.
  const int pr = tid / TPW, sub = tid % TPW;
  auto round_row = [&](int it) -> long long {
    const int p = it * RT + pr;
    return it < n_rounds && p < n ? rows(b, p) : -1;
  };
  // issue the copies of round it (this thread's row r) into buffer it % 2
  // and commit them as one group (empty past the last round)
  auto load_round = [&](int it, long long r) {
    if (it < n_rounds) {
      const int slot = it & 1;
      if (sub == 0) row_s[slot * RT + pr] = r;
      const long long r0 = r < 0 ? 0 : r;
      unsigned char* cd = cs + (size_t)(slot * RT + pr) * L::LC;
      unsigned char* rd = rs + (size_t)(slot * RT + pr) * L::LR;
#pragma unroll
      for (int j = 0; j < (CC + CR) / TPW; ++j) {
        const int ch = sub + j * TPW;
        if (ch < CC)
          cp_async16(cd + ch * 16, c + r0 * DL + ch * (16 / sizeof(T)),
                     r >= 0);
        else
          cp_async16(rd + (ch - CC) * 16,
                     kr + r0 * DR + (ch - CC) * (16 / sizeof(T)), r >= 0);
      }
    }
    cp_async_commit();
  };

  float m_run = kNeg, l_run = 0.f;  // warp 0's
  float acc0 = 0.f, acc1 = 0.f;     // output dims 2 tid, 2 tid + 1

  load_round(0, round_row(0));
  long long nxt = round_row(1);  // the row of the next round to issue
  for (int it = 0; it < n_rounds; ++it) {
    const int slot = it & 1, t0 = it * RT;
    load_round(it + 1, nxt);
    nxt = round_row(it + 2);
    cp_async_wait<1>();  // round it has landed
    __syncthreads();
    const unsigned char* cb = cs + (size_t)slot * RT * L::LC;
    const unsigned char* rb = rs + (size_t)slot * RT * L::LR;
    const long long* rw = row_s + slot * RT;

    // scores: warp w scores tile w of the round, lane = position
    if (warp < TPR && t0 + warp * TS < n) {
      const int pos = warp * TS + lane;
      const float a = dot_chain<T>(qs, cb + (size_t)pos * L::LC, DL);
      const float bb = dot_chain<T>(qs + DL, rb + (size_t)pos * L::LR, DR);
      ss[pos] = rw[pos] >= 0 ? (a + bb) * scale : kNeg;
    }
    __syncthreads();
    // softmax updates: warp 0 takes the round's tiles in order
    if (warp == 0) {
      for (int tt = 0; tt < TPR && t0 + tt * TS < n; ++tt) {
        const int pos = tt * TS + lane;
        const bool ok = rw[pos] >= 0;
        const float s = ss[pos];
        const float mn = fmaxf(m_run, warp_max(s));
        const float p = ok ? expf(s - mn) : 0.f;
        const float al = expf(m_run - mn);
        l_run = l_run * al + warp_sum(p);
        m_run = mn;
        ss[pos] = p;
        if (lane == 0) alpha_s[tt] = al;
      }
    }
    __syncthreads();
    // weighted sum, tile by tile: rescale, then the tile's valid positions
    // in order, kVec at a time with their loads issued first (a position
    // past the tile's valid ones is left out by a select)
    for (int tt = 0; tt < TPR && t0 + tt * TS < n; ++tt) {
      acc0 *= alpha_s[tt];
      acc1 *= alpha_s[tt];
      const int np = min(TS, n - (t0 + tt * TS));
      for (int pv = 0; pv < np; pv += kVec) {
        float2 cv[kVec];
        float w[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int pos = tt * TS + pv + u;
          cv[u] = pair_f32(
              reinterpret_cast<const T*>(cb + (size_t)pos * L::LC), 2 * tid);
          w[u] = ss[pos];
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const float a0 = fmaf(w[u], cv[u].x, acc0);
          const float a1 = fmaf(w[u], cv[u].y, acc1);
          acc0 = pv + u < np ? a0 : acc0;
          acc1 = pv + u < np ? a1 : acc1;
        }
      }
    }
    __syncthreads();  // the buffer, ss and alpha_s are rewritten next
  }
  if (tid == 0) l_s[0] = l_run;
  __syncthreads();
  const float inv = 1.f / fmaxf(l_s[0], 1e-30f);
  float2 o;
  o.x = acc0 * inv;
  o.y = acc1 * inv;
  reinterpret_cast<float2*>(out + ((size_t)b * H + h) * DL)[tid] = o;
}

template <typename T, typename Rows>
cudaError_t launch_t(const float* q, const float* q2, const void* c,
                     const void* kr, const int* cache_pos, float* out, int B,
                     int H, int S, float scale, Rows rows, cudaStream_t s) {
  constexpr size_t smem = Smem<T>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_decode_kernel<T, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  mla_decode_kernel<T, Rows><<<dim3(H, B), kThreads, smem, s>>>(
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

// The tiles of 32 positions a round of a launch for dtype code `dtype`
// (grid (H, B), one head a block).
KERNEL_API int mla_tiles_per_round(int dtype) {
  return dtype == kBF16 ? mla::tiles_per_round<__nv_bfloat16>()
                        : mla::tiles_per_round<float>();
}
