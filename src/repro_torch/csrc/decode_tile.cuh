// GQA decode attention's row arithmetic and the one kernel that serves
// it. attn_decode.cu and paged_attention.cu launch gqa_decode_kernel with
// K1 = 1 query token a sequence; verify_decode.cu (contiguous and paged)
// launches it with K1 = k + 1. A row-address policy (Contiguous / Paged)
// names the K/V row of each position. The head dim D is 128 or 64, a
// template parameter: each has its own instance and thread map (below).
//
// So a query row sees the same arithmetic in the same order whichever of
// the four kernels serves it. The serving path's bitwise token identities
// rest on that: paged tokens == contiguous tokens (attn_decode_paged ==
// attn_decode on the same KV), and greedy speculative tokens == plain
// greedy tokens (verify row i == the single-token kernel at cache_pos +
// i).
//
// Rows: a (sequence b, KV head hk) has R = g * K1 query rows, row r =
// (group head r / K1, query r % K1), laid out as consecutive D-vectors in
// q and out. Row r attends positions < n_r = min(cache_pos[b] + r % K1,
// S - 1) + 1 of an extent of S positions. A row's arithmetic: the query
// pre-scaled and rounded to the cache dtype (scaled_query); tiles of 64
// positions from position 0, each position scored by a lane group (LPP
// lanes of DPL dims each: lane_partial) and summed by a butterfly over the
// group (warp_sum_n), then one fp32 online softmax update by one warp
// (softmax_update), then the tile's V rows added into each output dim in
// position order (accumulate_masked). A tile wholly beyond a row's n_r
// leaves that row's (m, l, acc) unchanged bit for bit (alpha = exp(0) = 1,
// p = 0), and a V row is never multiplied in for a row that masks its
// position (0 * NaN is NaN), so row r's result equals a one-row run at its
// own n_r, whatever rows share its block. A position whose K/V row has no
// storage (an unallocated page) is masked for every row and not read.
//
// Bound on the H100: bytes in principle (each valid K and V row read once
// for the g * K1 rows of its group), but at serving shapes the work is a
// few tiles a sequence, so what a block waits on is latency: the loads of
// a tile and the butterflies of its scores. The schedule:
//  - the R rows of a (sequence, KV head) are split into groups of RB rows,
//    one block each: grid (Hkv, B, ceil(R / RB)), RB the largest of 8, 4,
//    2, 1 that still gives >= kTargetBlocks blocks. Decode at yi-9b's
//    shape (B 4, Hkv 4, g 8) and at jamba's (Hkv 8, g 4) runs RB 1, 128
//    blocks; verify at yi-9b's K1 = 4 runs RB 4, 128 blocks; musicgen's
//    (Hkv 24, g 1, D 64) decode runs RB 1, 96 blocks, its verify at K1 = 4
//    RB 2, 192 blocks;
//  - each 64-position K/V tile is staged in shared memory (as stored) by
//    cp.async, double-buffered, so the next tile's loads fly while a tile
//    is scored and summed; the paged kernels read the page table a tile
//    ahead of the copies it addresses, and a -1 page is not read (its rows
//    are zero-filled and masked for every row);
//  - a warp's 8 positions x RB rows of scores go through the butterfly
//    together, their shuffles interleaved; the V sum loads 8 positions
//    ahead of their fmafs.
// The two head dims' thread maps:
//  - D = 128: a position's score is the whole warp's (4 dims a lane, a
//    5-shuffle butterfly), 8 rounds a tile; in the V sum thread t adds dim
//    t % 128 of rows t / 128 + 2 j over all the tile's positions, so at
//    RB = 1 half the block idles there;
//  - D = 64: a position's score is 8 lanes' (8 dims a lane, one 16-byte
//    shared load, a 3-shuffle butterfly), 4 positions a warp at once, 2
//    rounds a tile; in the V sum thread t adds dim t % 64 of every row over
//    the tile's positions 16 (t / 64) .. 16 (t / 64) + 15, so the whole
//    block works at any RB, and the 4 spans' partial sums are added in
//    span order at the end (the same order for every RB, so a row's result
//    still does not depend on the rows beside it).
// A block walks tiles up to the largest window of its own rows. Every
// position goes through the masked select: where a row sees the position
// it gives fmaf's bits, the same as an unmasked fmaf.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int TILE = 64, kThreads = 256, kWarps = kThreads / 32;
constexpr int kPosPerWarp = TILE / kWarps;  // positions a warp scores a tile
constexpr int kVec = 8;  // V rows loaded ahead of their fmafs (divides TILE)
constexpr int kTargetBlocks = 128;          // ~ the H100's 132 SMs
constexpr float kNeg = -1e30f;

// Element offset of the K (and V) row of position p at head dim D, or -1
// when the position has no storage.
struct Contiguous {  // k/v [B, Hkv, S, D]
  int Hkv, S;
  template <int D>
  __device__ __forceinline__ long long offset(int b, int hk, int p) const {
    return (((long long)b * Hkv + hk) * S + p) * D;
  }
};

struct Paged {  // pools [P, Hkv, ps, D], page_table [B, NP], -1 = none
  const int* table;
  int Hkv, lg_ps, NP;  // ps = 2^lg_ps (the page size divides the tile)
  template <int D>
  __device__ __forceinline__ long long offset(int b, int hk, int p) const {
    const int page = table[(long long)b * NP + (p >> lg_ps)];
    return page < 0 ? -1
                    : ((((long long)page * Hkv + hk) << lg_ps) +
                       (p & ((1 << lg_ps) - 1))) * D;
  }
};

// A row's query element, pre-scaled and rounded to the cache dtype.
template <typename T>
__device__ __forceinline__ float scaled_query(T x, float scale) {
  return to_f32(from_f32<T>(to_f32(x) * scale));
}

// A lane's partial of a score: its dims of the query row qh and the K row
// kv, 4 (D = 128) or 8 (D = 64; two sums of 4, added).
__device__ __forceinline__ float lane_partial(const float* qh,
                                              const float (&kv)[4]) {
  return qh[0] * kv[0] + qh[1] * kv[1] + qh[2] * kv[2] + qh[3] * kv[3];
}
__device__ __forceinline__ float lane_partial(const float* qh,
                                              const float (&kv)[8]) {
  return (qh[0] * kv[0] + qh[1] * kv[1] + qh[2] * kv[2] + qh[3] * kv[3]) +
         (qh[4] * kv[4] + qh[5] * kv[5] + qh[6] * kv[6] + qh[7] * kv[7]);
}

// N scores at once: a butterfly over each group of L lanes on each
// element, the N shuffles of a stage issued together. At L = 32 each
// element gets warp_sum's bits.
template <int N, int L>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// The 8 elements at p (16 or 32 bytes, 16-byte aligned) as floats, by
// 16-byte shared loads.
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// The online-softmax update of one row over one tile of 64 positions, by
// one warp: lane holds the scores of positions lane and lane + 32 (s0,
// s1) and whether the row sees them (ok0, ok1). Updates the row's running
// max and sum, returns the rescale factor of its accumulator, and sets
// the softmax weights p0, p1 (0 where the row does not see the position).
__device__ __forceinline__ float softmax_update(float& m_run, float& l_run,
                                                float s0, float s1, bool ok0,
                                                bool ok1, float& p0,
                                                float& p1) {
  s0 = ok0 ? s0 : kNeg;
  s1 = ok1 ? s1 : kNeg;
  const float m_new = fmaxf(m_run, warp_max(fmaxf(s0, s1)));
  const float alpha = expf(m_run - m_new);
  p0 = ok0 ? expf(s0 - m_new) : 0.f;
  p1 = ok1 ? expf(s1 - m_new) : 0.f;
  l_run = l_run * alpha + warp_sum(p0 + p1);
  m_run = m_new;
  return alpha;
}

// One position's V element added into a row's accumulator (positions are
// taken in order), dropped by a select where the row does not see the
// position, never multiplied in (0 * NaN is NaN).
__device__ __forceinline__ float accumulate_masked(float acc, float p,
                                                   float v, bool ok) {
  const float a = fmaf(p, v, acc);
  return ok ? a : acc;
}

template <typename T, int D, int RB>
constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)TILE * D * sizeof(T) +      // K, V: 2 buffers
         2 * TILE * sizeof(long long) +              // row offsets
         sizeof(float) * ((size_t)RB * (D + TILE) + 2 * RB);
}

// Block (hk, b, z) serves rows z * RB .. of the g * K1 rows of sequence b
// and KV head hk.
template <typename T, int D, int RB, typename Rows>
__global__ void __launch_bounds__(kThreads)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ cache_pos,
                      float* __restrict__ out, int Hq, int K1, int S,
                      float scale, Rows rows) {
  static_assert(D == 128 || D == 64, "the kernel serves head dims 128, 64");
  constexpr int CH = D * sizeof(T) / 16;   // 16-byte chunks of a K/V row
  constexpr int EPC = 16 / sizeof(T);      // elements of a chunk
  constexpr int PPT = TILE * CH / kThreads;  // rows a thread copies a tile
  constexpr int RSTEP = kThreads / CH;       // between a thread's rows
  // scores: LPP lanes of DPL dims a position, SUB positions a warp at once,
  // NU rounds a tile
  constexpr int DPL = D == 128 ? 4 : 8, LPP = D / DPL, SUB = 32 / LPP;
  constexpr int NU = kPosPerWarp / SUB;
  // V sum: D = 128, dim t % 128 of NACC rows; D = 64, dim t % 64 of every
  // row over the span of SPAN positions t / 64
  constexpr int NSPAN = kThreads / D, SPAN = TILE / NSPAN;
  constexpr int NACC = D == 128 ? (RB + 1) / 2 : RB;
  static_assert(D == 128 || NSPAN * RB * D * sizeof(float) <=
                                2 * TILE * D * sizeof(T),
                "the spans' partial sums fit in the K buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                      // [2][TILE][D]
  T* Vs = Ks + 2 * TILE * D;                                   // [2][TILE][D]
  long long* off_s = reinterpret_cast<long long*>(Vs + 2 * TILE * D);
  float* Qs = reinterpret_cast<float*>(off_s + 2 * TILE);      // [RB][D]
  float* Ps = Qs + RB * D;                                    // [RB][TILE]
  float* alpha_s = Ps + RB * TILE;                            // [RB]
  float* l_s = alpha_s + RB;                                  // [RB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, g = Hq / rows.Hkv;
  const int r0 = blockIdx.z * RB, nr = min(RB, g * K1 - r0);
  const size_t row0 = ((size_t)b * Hq + (size_t)hk * g) * K1 + r0;
  const int cp = cache_pos[b];
  int n_max = 0;  // the largest window among this block's rows
  for (int j = 0; j < nr; ++j)
    n_max = max(n_max, min(cp + (r0 + j) % K1, S - 1) + 1);
  const int n_tiles = (n_max + TILE - 1) / TILE;

  const T* qb = q + row0 * D;
  for (int e = tid; e < RB * D; e += kThreads)  // rows past nr: zeros
    Qs[e] = e < nr * D ? scaled_query(qb[e], scale) : 0.f;

  // Thread t copies chunk t % CH of the rows t / CH + i * RSTEP of a tile.
  // The rows' offsets are looked up one tile before their copies are
  // issued, so a page-table read is never waited on before a copy.
  const int p0 = tid / CH, e0 = (tid % CH) * EPC;
  auto tile_rows = [&](int it, long long (&off)[PPT]) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = it * TILE + p0 + i * RSTEP;
      off[i] = it < n_tiles && p < n_max
                   ? rows.template offset<D>(b, hk, p) : -1;
    }
  };
  // issue the copies of tile it (offsets `off`) into buffer it % 2, and
  // commit them as one group (empty past the last tile)
  auto load_tile = [&](int it, const long long (&off)[PPT]) {
    if (it < n_tiles) {
      const int slot = it & 1;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = p0 + i * RSTEP;
        if (e0 == 0) off_s[slot * TILE + p] = off[i];
        const long long src = (off[i] < 0 ? 0 : off[i]) + e0;
        const int dst = (slot * TILE + p) * D + e0;
        cp_async16(Ks + dst, k + src, off[i] >= 0);
        cp_async16(Vs + dst, v + src, off[i] >= 0);
      }
    }
    cp_async_commit();
  };

  float m_run = kNeg, l_run = 0.f;  // row `warp`'s, if warp < nr
  // V sum: D = 128, thread t adds dim d of rows hb + 2 j; D = 64, dim d of
  // rows j over the positions span * SPAN ..
  const int d = tid & (D - 1), hb = D == 128 ? tid >> 7 : 0;
  const int span = tid / D;
  float acc[NACC];
  int lim[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    acc[j] = 0.f;
    lim[j] = min(cp + (r0 + hb + (D == 128 ? 2 : 1) * j) % K1, S - 1) + 1;
  }

  long long nxt[PPT];  // the offsets of the next tile to issue
  tile_rows(0, nxt);
  load_tile(0, nxt);
  tile_rows(1, nxt);
  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1, t0 = it * TILE, nt = min(TILE, n_max - t0);
    load_tile(it + 1, nxt);
    tile_rows(it + 2, nxt);
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const T* Kt = Ks + slot * TILE * D;
    const T* Vt = Vs + slot * TILE * D;
    const long long* ot = off_s + slot * TILE;

    // scores: lane group `sub` of warp w takes positions w + kWarps (SUB u
    // + sub) of the tile against every row of the block (a position
    // without storage or past the tile's end scores zeros, masked below)
    const int sub = lane / LPP, dl = (lane % LPP) * DPL;
    float part[NU * RB];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const T* kr = Kt + (warp + kWarps * (SUB * u + sub)) * D + dl;
      float kv[DPL];
      if constexpr (D == 128) {
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = to_f32(kr[e]);
      } else {
        load8(kr, kv);
      }
#pragma unroll
      for (int j = 0; j < RB; ++j)
        part[u * RB + j] = lane_partial(Qs + j * D + dl, kv);
    }
    warp_sum_n<NU * RB, LPP>(part);
    if (lane % LPP == 0) {
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int j = 0; j < RB; ++j)
          if (j < nr)
            Ps[j * TILE + warp + kWarps * (SUB * u + sub)] = part[u * RB + j];
    }
    __syncthreads();
    // online softmax update: warp j updates row j
    if (warp < nr) {
      const int nrow = min(cp + (r0 + warp) % K1, S - 1) + 1 - t0;
      const bool ok0 = lane < nrow && ot[lane] >= 0;
      const bool ok1 = lane + 32 < nrow && ot[lane + 32] >= 0;
      float p0, p1;
      const float alpha = softmax_update(m_run, l_run, Ps[warp * TILE + lane],
                                         Ps[warp * TILE + lane + 32], ok0,
                                         ok1, p0, p1);
      Ps[warp * TILE + lane] = p0;
      Ps[warp * TILE + lane + 32] = p1;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();
    if constexpr (D == 128) {
      // V: thread t adds dim t % 128 of rows t / 128 + 2 j, in position
      // order, kVec positions at a time with their loads issued first (a
      // slot's rows past the tile's end are zeros without storage, masked)
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        if (hb + 2 * j < nr) acc[j] *= alpha_s[hb + 2 * j];
      for (int pv = 0; pv < nt; pv += kVec) {
        float vv[kVec];
        bool has[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          vv[u] = to_f32(Vt[(pv + u) * D + d]);
          has[u] = ot[pv + u] >= 0;
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u)
#pragma unroll
          for (int j = 0; j < NACC; ++j)
            if (hb + 2 * j < nr)
              acc[j] = accumulate_masked(
                  acc[j], Ps[(hb + 2 * j) * TILE + pv + u], vv[u],
                  has[u] && t0 + pv + u < lim[j]);
      }
    } else {
      // V: thread t adds dim t % 64 of every row, over the positions of
      // its span in order, kVec at a time with their loads issued first
#pragma unroll
      for (int j = 0; j < RB; ++j)
        if (j < nr) acc[j] *= alpha_s[j];
      const int pend = min(span * SPAN + SPAN, nt);
      for (int pv = span * SPAN; pv < pend; pv += kVec) {
        float vv[kVec];
        bool has[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          vv[u] = to_f32(Vt[(pv + u) * D + d]);
          has[u] = ot[pv + u] >= 0;
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u)
#pragma unroll
          for (int j = 0; j < RB; ++j)
            if (j < nr)
              acc[j] = accumulate_masked(acc[j], Ps[j * TILE + pv + u],
                                         vv[u],
                                         has[u] && t0 + pv + u < lim[j]);
      }
    }
    __syncthreads();  // slot and Ps are rewritten by the next tiles
  }
  if (warp < nr && lane == 0) l_s[warp] = l_run;
  float* ob = out + row0 * D;
  if constexpr (D == 128) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int r = hb + 2 * j;
      if (r < nr) ob[r * D + d] = acc[j] / fmaxf(l_s[r], 1e-30f);
    }
  } else {
    // the spans' partial sums, over the K buffers (every copy has landed
    // and every thread has left the loop), added in span order
    float* red = reinterpret_cast<float*>(smem_raw);  // [NSPAN][RB][D]
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < RB; ++j)
      if (j < nr) red[(span * RB + j) * D + d] = acc[j];
    __syncthreads();
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D;
      float sum = red[e];
#pragma unroll
      for (int sp = 1; sp < NSPAN; ++sp) sum += red[sp * RB * D + e];
      ob[e] = sum / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename T, int D, int RB, typename Rows>
cudaError_t launch_rb(const void* q, const void* k, const void* v,
                      const int* cp, float* o, int B, int Hq, int K1, int S,
                      float scale, Rows rows, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, D, RB>();
  const cudaError_t e = cudaFuncSetAttribute(
      gqa_decode_kernel<T, D, RB, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int R = Hq / rows.Hkv * K1;
  gqa_decode_kernel<T, D, RB, Rows>
      <<<dim3(rows.Hkv, B, (R + RB - 1) / RB), kThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), cp, o, Hq, K1, S, scale, rows);
  return cudaGetLastError();
}

// Rows a block serves: the largest of 8, 4, 2, 1 that gives at least
// kTargetBlocks blocks, else 1. From the shapes alone.
inline int rows_per_block(int B, int Hkv, int R) {
  int rb = 8;
  while (rb > 1 && (long long)B * Hkv * ((R + rb - 1) / rb) < kTargetBlocks)
    rb /= 2;
  return rb;
}

template <typename T, int D, typename Rows>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* cp, float* o, int B, int Hq, int K1, int S,
                     float scale, Rows rows, cudaStream_t s) {
  switch (rows_per_block(B, rows.Hkv, Hq / rows.Hkv * K1)) {
    case 8:
      return launch_rb<T, D, 8>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                s);
    case 4:
      return launch_rb<T, D, 4>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                s);
    case 2:
      return launch_rb<T, D, 2>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                s);
    default:
      return launch_rb<T, D, 1>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                s);
  }
}

template <typename T, typename Rows>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* cp, float* o, int B, int Hq, int K1, int S,
                     int D, float scale, Rows rows, cudaStream_t s) {
  if (D == 128)
    return launch_t<T, 128>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s);
  if (D == 64)
    return launch_t<T, 64>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s);
  return cudaErrorInvalidValue;
}

// Launch on `stream` for dtype code `dtype` (common.cuh) and head dim D
// (128 or 64); returns cudaGetLastError(). q holds B * Hq * K1 rows of D,
// out the same in fp32.
template <typename Rows>
int launch(const void* q, const void* k, const void* v, const void* cache_pos,
           void* out, int B, int Hq, int K1, int S, int D, float scale,
           int dtype, Rows rows, void* stream) {
  const int* cp = static_cast<const int*>(cache_pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBF16
          ? launch_d<__nv_bfloat16>(q, k, v, cp, o, B, Hq, K1, S, D, scale,
                                    rows, s)
          : launch_d<float>(q, k, v, cp, o, B, Hq, K1, S, D, scale, rows, s));
}

}  // namespace decode

// The rows a block serves at B sequences, Hkv KV heads and R = g * K1 rows
// a KV head: the plan a launch takes (grid (Hkv, B, ceil(R / RB))).
KERNEL_API int decode_rows_per_block(int B, int Hkv, int R) {
  return decode::rows_per_block(B, Hkv, R);
}
