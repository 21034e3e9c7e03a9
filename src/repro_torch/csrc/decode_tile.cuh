// Decode attention's row arithmetic and its tile loop. attn_decode.cu and
// paged_attention.cu run the tile loop (decode_kernel); verify_decode.cu
// (contiguous and paged) runs its own schedule of the same rows and calls
// the row functions below (the query's rounding, a lane's score partial
// and its butterfly, the 64-position softmax update, the V accumulation
// with its masked select).
//
// So a query row sees the same arithmetic in the same order whichever of
// the four kernels serves it. The serving path's bitwise token identities
// rest on that: paged tokens == contiguous tokens (attn_decode_paged ==
// attn_decode on the same KV), and greedy speculative tokens == plain
// greedy tokens (verify row i == the single-token kernel at cache_pos +
// i).
//
// One block serves one (sequence b, KV head hk): R = g * K1 query rows,
// row r = (group head r / K1, query r % K1), laid out as consecutive
// D-vectors in q and out. Row r attends positions < n_r = min(cache_pos[b]
// + r % K1, S - 1) + 1 of an extent of S positions. The block walks tiles
// of 64 positions up to the largest n_r with an fp32 online softmax: each
// warp scores a position against all R rows (one warp-wide dot product per
// row over 4 dims a lane), one warp per row updates its running max and
// sum, then each thread adds the V rows of the tile into its output dims.
// A tile that lies wholly beyond a row's n_r leaves that row's (m, l, acc)
// unchanged bit for bit (alpha = exp(0) = 1, p = 0), and a V row is never
// multiplied in for a row that masks its position (0 * NaN is NaN), so row
// r's result equals a one-row run at its own n_r. A position whose K/V row
// has no storage (an unallocated page) is masked for every row: offset 0
// is read in its place and never used.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int D = 128, TILE = 64, kThreads = 256, kWarps = kThreads / 32;
constexpr int kVec = 8;  // V rows loaded ahead of their fmafs (divides TILE)
constexpr float kNeg = -1e30f;

// Element offset of the K (and V) row of position p, or -1 when the
// position has no storage.
struct Contiguous {  // k/v [B, Hkv, S, D]
  int Hkv, S;
  __device__ __forceinline__ long long operator()(int b, int hk,
                                                  int p) const {
    return (((long long)b * Hkv + hk) * S + p) * D;
  }
};

struct Paged {  // pools [P, Hkv, ps, D], page_table [B, NP], -1 = none
  const int* table;
  int Hkv, ps, NP;
  __device__ __forceinline__ long long operator()(int b, int hk,
                                                  int p) const {
    const int page = table[(long long)b * NP + p / ps];
    return page < 0 ? -1 : (((long long)page * Hkv + hk) * ps + p % ps) * D;
  }
};

// A row's query element, pre-scaled and rounded to the cache dtype.
template <typename T>
__device__ __forceinline__ float scaled_query(T x, float scale) {
  return to_f32(from_f32<T>(to_f32(x) * scale));
}

// A lane's partial of a score: its 4 dims (4 lane .. 4 lane + 3) of the
// query row qh and the K row kv.
__device__ __forceinline__ float lane_partial(const float* qh,
                                              const float (&kv)[4]) {
  return qh[0] * kv[0] + qh[1] * kv[1] + qh[2] * kv[2] + qh[3] * kv[3];
}

// A score: the lanes' partials summed by the butterfly of warp_sum.
__device__ __forceinline__ float score(const float* qh, const float (&kv)[4]) {
  return warp_sum(lane_partial(qh, kv));
}

// N scores at once: warp_sum's butterfly on each element, the N shuffles
// of a stage issued together. Each element gets warp_sum's bits.
template <int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
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
// taken in order); the masked form drops it by a select where the row
// does not see the position, never multiplying it in (0 * NaN is NaN).
// Both give the same bits where both apply.
__device__ __forceinline__ float accumulate(float acc, float p, float v) {
  return fmaf(p, v, acc);
}
__device__ __forceinline__ float accumulate_masked(float acc, float p,
                                                   float v, bool ok) {
  const float a = fmaf(p, v, acc);
  return ok ? a : acc;
}

// Dynamic shared memory of a block serving R rows.
inline size_t smem_bytes(int R) {
  return TILE * sizeof(long long) + sizeof(float) * (size_t)R * (D + TILE + 2);
}

// MAXR bounds R = g * K1 (registers: MAXR / 2 accumulators a thread).
template <typename T, int MAXR, typename Rows>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ cache_pos,
                  float* __restrict__ out, int Hq, int K1, int S, float scale,
                  Rows rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);  // [TILE]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, g = Hq / rows.Hkv;
  const int R = g * K1;
  float* Qs = reinterpret_cast<float*>(off_s + TILE);  // [R, D]
  float* Ps = Qs + R * D;                              // [R, TILE]
  float* alpha_s = Ps + R * TILE;                      // [R]
  float* l_s = alpha_s + R;                            // [R]
  const size_t row0 = ((size_t)b * Hq + (size_t)hk * g) * K1;
  const T* qb = q + row0 * D;
  const int cp = cache_pos[b];
  const int n_max = min(cp + K1 - 1, S - 1) + 1;

  for (int e = tid; e < R * D; e += kThreads)
    Qs[e] = scaled_query(qb[e], scale);

  // warp w keeps the running (max, sum) of rows w, w + 8, ...
  float m_run[MAXR / kWarps], l_run[MAXR / kWarps];
#pragma unroll
  for (int j = 0; j < MAXR / kWarps; ++j) {
    m_run[j] = kNeg;
    l_run[j] = 0.f;
  }
  // thread t accumulates dim d = t % 128 of rows t / 128 + 2 j
  const int d = tid & (D - 1), hb = tid >> 7;
  float acc[MAXR / 2];
  int lim[MAXR / 2];  // n of each of those rows
  int lim_min = S;    // the least of them
#pragma unroll
  for (int j = 0; j < MAXR / 2; ++j) {
    acc[j] = 0.f;
    lim[j] = min(cp + (hb + 2 * j) % K1, S - 1) + 1;
    if (hb + 2 * j < R) lim_min = min(lim_min, lim[j]);
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_max; t0 += TILE) {
    const int nt = min(TILE, n_max - t0);
    // (-1 past the tile's end too: the V loop reads all TILE entries
    // unconditionally, which lets it issue a group's loads together)
    if (tid < TILE) off_s[tid] = tid < nt ? rows(b, hk, t0 + tid) : -1;
    __syncthreads();
    // scores: warp w takes positions w, w + 8, ... of the tile (a
    // position without storage is scored against offset 0, masked below)
    for (int pi = warp; pi < nt; pi += kWarps) {
      const long long off = off_s[pi];
      const T* kr = k + (off < 0 ? 0 : off) + lane * 4;
      float kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = to_f32(kr[e]);
      for (int r = 0; r < R; ++r) {
        const float part = score(Qs + r * D + lane * 4, kv);
        if (lane == 0) Ps[r * TILE + pi] = part;
      }
    }
    __syncthreads();
    // online softmax update: one warp per row (hi unrolled, so the
    // running max and sum stay in registers)
#pragma unroll
    for (int hi = 0; hi < MAXR / kWarps; ++hi) {
      const int r = warp + hi * kWarps;
      if (r >= R) break;
      const int nr = min(cp + r % K1, S - 1) + 1 - t0;  // row's valid count
      const bool ok0 = lane < nr && off_s[lane] >= 0;
      const bool ok1 = lane + 32 < nr && off_s[lane + 32] >= 0;
      float p0, p1;
      const float alpha =
          softmax_update(m_run[hi], l_run[hi], Ps[r * TILE + lane],
                         Ps[r * TILE + lane + 32], ok0, ok1, p0, p1);
      Ps[r * TILE + lane] = p0;
      Ps[r * TILE + lane + 32] = p1;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXR / 2; ++j)
      if (hb + 2 * j < R) acc[j] *= alpha_s[hb + 2 * j];
    // V rows in groups of kVec, the group's loads issued before its
    // fmafs; each acc[j] takes its fmafs in position order. A group in
    // which every position has storage and lies inside the window of each
    // of this thread's rows (all groups but a row's last) runs plain
    // fmafs; otherwise a position a row masks (or one without storage,
    // read at offset 0 instead) is dropped by a select, never multiplied
    // in. Both give the same bits where both apply.
    for (int p0 = 0; p0 < nt; p0 += kVec) {
      long long off[kVec];
      bool full = p0 + kVec <= lim_min - t0;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        off[u] = off_s[p0 + u];
        full = full && off[u] >= 0;
      }
      float vv[kVec];
      if (full) {
#pragma unroll
        for (int u = 0; u < kVec; ++u) vv[u] = to_f32(v[off[u] + d]);
#pragma unroll
        for (int u = 0; u < kVec; ++u)
#pragma unroll
          for (int j = 0; j < MAXR / 2; ++j)
            if (hb + 2 * j < R)
              acc[j] = accumulate(acc[j], Ps[(hb + 2 * j) * TILE + p0 + u],
                                  vv[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          vv[u] = to_f32(v[(off[u] < 0 ? 0 : off[u]) + d]);
#pragma unroll
        for (int u = 0; u < kVec; ++u)
#pragma unroll
          for (int j = 0; j < MAXR / 2; ++j)
            if (hb + 2 * j < R)
              acc[j] = accumulate_masked(
                  acc[j], Ps[(hb + 2 * j) * TILE + p0 + u], vv[u],
                  off[u] >= 0 && t0 + p0 + u < lim[j]);
      }
    }
    __syncthreads();  // off_s, Ps and alpha_s are rewritten by the next tile
  }
#pragma unroll
  for (int hi = 0; hi < MAXR / kWarps; ++hi) {
    const int r = warp + hi * kWarps;
    if (r < R && lane == 0) l_s[r] = l_run[hi];
  }
  __syncthreads();
  float* ob = out + row0 * D;
#pragma unroll
  for (int j = 0; j < MAXR / 2; ++j) {
    const int r = hb + 2 * j;
    if (r < R) ob[r * D + d] = acc[j] / fmaxf(l_s[r], 1e-30f);
  }
}

// Launch on `stream` for dtype code `dtype` (common.cuh); returns
// cudaGetLastError(). q holds B * Hq * K1 rows of D, out the same in fp32.
template <typename T, int MAXR, typename Rows>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* cp, float* o, int B, int Hq, int K1, int S,
                     float scale, Rows rows, cudaStream_t s) {
  const size_t smem = smem_bytes(Hq / rows.Hkv * K1);
  if (smem > 48 * 1024) {  // above the static limit: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, MAXR, Rows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_kernel<T, MAXR, Rows><<<dim3(rows.Hkv, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cp, o, Hq, K1, S, scale, rows);
  return cudaGetLastError();
}

template <int MAXR, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* cache_pos,
           void* out, int B, int Hq, int K1, int S, float scale, int dtype,
           Rows rows, void* stream) {
  const int* cp = static_cast<const int*>(cache_pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBF16
          ? launch_t<__nv_bfloat16, MAXR>(q, k, v, cp, o, B, Hq, K1, S, scale,
                                          rows, s)
          : launch_t<float, MAXR>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                  s));
}

}  // namespace decode
