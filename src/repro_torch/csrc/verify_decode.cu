// Multi-token verify attention of speculative decoding, contiguous and
// paged.
//
// Replaces the Pallas TPU kernels src/repro/kernels/verify_decode/
// verify_decode.py (verify_decode_pallas -> _verify_kernel and
// verify_decode_paged_pallas -> _verify_paged_kernel). q [B, Hq, K1, 128]
// holds K1 = k + 1 query tokens per sequence; query i attends positions
// 0..cache_pos[b] + i, the window of the i-th sequential decode step.
// KV is contiguous [B, Hkv, S, 128] or pools [P, Hkv, ps, 128] with a page
// table [B, NP] (-1 = none). Output fp32 [B, Hq, K1, 128].
//
// Bound on the H100: bytes (each valid K and V row read once for the g *
// K1 query rows of its KV group). At serving shapes the work is a few
// tiles a sequence, so what a block waits on is latency: the loads of a
// tile and the 5-shuffle butterfly of each score. Row i's result must
// equal attn_decode (attn_decode_paged) at cache_pos + i bit for bit,
// which is what makes greedy speculative tokens equal plain greedy
// tokens; so a row's arithmetic is decode_tile.cuh's, through its device
// functions (the query's rounding, the lane partials and butterfly, the
// softmax update over tiles of 64 positions from position 0, the V fmafs
// in position order with the masked select; no split of the position
// axis). What changes is the schedule:
//  - the R = g * K1 rows of a (sequence, KV head) are split into groups of
//    RB rows, one block each: grid (Hkv, B, R / RB), RB the largest of 8,
//    4, 2 that still gives >= kTargetBlocks blocks (yi-9b's spec shape, B
//    4, Hkv 4, R 32: 128 blocks in place of 16);
//  - each 64-position K/V tile is staged in shared memory (bf16 as
//    stored) by cp.async, double-buffered, so the next tile's loads fly
//    while this tile is scored and summed; the paged kernel addresses
//    rows through the page table, and a -1 page is not read (its rows are
//    zero-filled and masked for every row);
//  - a warp's 8 positions x RB rows of scores go through the butterfly
//    together, their shuffles interleaved.
// A block walks tiles up to the largest window of its own rows; a tile
// wholly past a row's window leaves that row unchanged (decode_tile.cuh).
#include "decode_tile.cuh"

namespace verify {

using decode::D;
using decode::TILE;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kPosPerWarp = TILE / kWarps;  // positions a warp scores a tile
constexpr int kTargetBlocks = 128;          // ~ the H100's 132 SMs

template <typename T, int RB>
constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)TILE * D * sizeof(T) +      // K, V: 2 buffers
         2 * TILE * sizeof(long long) +              // row offsets
         sizeof(float) * ((size_t)RB * (D + TILE) + 2 * RB);
}

// Block (hk, b, z) serves rows z * RB .. of the g * K1 rows of sequence b
// and KV head hk, in decode_tile.cuh's row order: row r = (group head
// r / K1, query r % K1).
template <typename T, int RB, typename Rows>
__global__ void __launch_bounds__(kThreads)
    verify_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ cache_pos,
                  float* __restrict__ out, int Hq, int K1, int S, float scale,
                  Rows rows) {
  constexpr int CH = D * sizeof(T) / 16;   // 16-byte chunks of a K/V row
  constexpr int EPC = 16 / sizeof(T);      // elements of a chunk
  constexpr int NACC = (RB + 1) / 2;       // rows a thread accumulates
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                      // [2][TILE][D]
  T* Vs = Ks + 2 * TILE * D;                                   // [2][TILE][D]
  long long* off_s = reinterpret_cast<long long*>(Vs + 2 * TILE * D);
  float* Qs = reinterpret_cast<float*>(off_s + 2 * TILE);      // [RB][D]
  float* Ps = Qs + RB * D;                                     // [RB][TILE]
  float* alpha_s = Ps + RB * TILE;                             // [RB]
  float* l_s = alpha_s + RB;                                   // [RB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, g = Hq / rows.Hkv;
  const int r0 = blockIdx.z * RB, nr = min(RB, g * K1 - r0);
  const size_t row0 = ((size_t)b * Hq + (size_t)hk * g) * K1 + r0;
  const int cp = cache_pos[b];
  int n_max = 0;  // the largest window among this block's rows
  for (int j = 0; j < nr; ++j)
    n_max = max(n_max, min(cp + (r0 + j) % K1, S - 1) + 1);

  const T* qb = q + row0 * D;
  for (int e = tid; e < RB * D; e += kThreads)  // rows past nr: zeros
    Qs[e] = e < nr * D ? decode::scaled_query(qb[e], scale) : 0.f;

  // issue the cp.async copies of the tile at t0 into buffer bi
  auto load_tile = [&](int t0, int bi) {
    const int nt = min(TILE, n_max - t0);
    if (tid < TILE)
      off_s[bi * TILE + tid] = tid < nt ? rows(b, hk, t0 + tid) : -1;
    for (int c = tid; c < TILE * CH; c += kThreads) {
      const int p = c / CH, e = (c % CH) * EPC;
      const long long off = p < nt ? rows(b, hk, t0 + p) : -1;
      const long long src = (off < 0 ? 0 : off) + e;
      const int dst = (bi * TILE + p) * D + e;
      cp_async16(Ks + dst, k + src, off >= 0);
      cp_async16(Vs + dst, v + src, off >= 0);
    }
    cp_async_commit();
  };

  float m_run = decode::kNeg, l_run = 0.f;  // row `warp`'s, if warp < nr
  const int d = tid & (D - 1), hb = tid >> 7;
  float acc[NACC];
  int lim[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    acc[j] = 0.f;
    lim[j] = min(cp + (r0 + hb + 2 * j) % K1, S - 1) + 1;
  }

  const int n_tiles = (n_max + TILE - 1) / TILE;
  load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int bi = it & 1, t0 = it * TILE, nt = min(TILE, n_max - t0);
    if (it + 1 < n_tiles) {
      load_tile(t0 + TILE, bi ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + bi * TILE * D;
    const T* Vt = Vs + bi * TILE * D;
    const long long* ot = off_s + bi * TILE;

    // scores: warp w takes positions w, w + 8, ... of the tile against
    // every row of the block (a position without storage or past the
    // tile's end scores zeros, masked below)
    float part[kPosPerWarp * RB];
#pragma unroll
    for (int u = 0; u < kPosPerWarp; ++u) {
      const T* kr = Kt + (warp + kWarps * u) * D + lane * 4;
      float kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = to_f32(kr[e]);
#pragma unroll
      for (int j = 0; j < RB; ++j)
        part[u * RB + j] = decode::lane_partial(Qs + j * D + lane * 4, kv);
    }
    decode::warp_sum_n(part);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kPosPerWarp; ++u)
#pragma unroll
        for (int j = 0; j < RB; ++j)
          if (j < nr) Ps[j * TILE + warp + kWarps * u] = part[u * RB + j];
    }
    __syncthreads();
    // online softmax update: warp j updates row j
    if (warp < nr) {
      const int nrow = min(cp + (r0 + warp) % K1, S - 1) + 1 - t0;
      const bool ok0 = lane < nrow && ot[lane] >= 0;
      const bool ok1 = lane + 32 < nrow && ot[lane + 32] >= 0;
      float p0, p1;
      const float alpha = decode::softmax_update(
          m_run, l_run, Ps[warp * TILE + lane], Ps[warp * TILE + lane + 32],
          ok0, ok1, p0, p1);
      Ps[warp * TILE + lane] = p0;
      Ps[warp * TILE + lane + 32] = p1;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();
    // V: thread t adds dim t % 128 of rows t / 128 + 2 j, in position order
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      if (hb + 2 * j < nr) acc[j] *= alpha_s[hb + 2 * j];
    for (int p = 0; p < nt; ++p) {
      const float vv = to_f32(Vt[p * D + d]);
      const bool has = ot[p] >= 0;
#pragma unroll
      for (int j = 0; j < NACC; ++j)
        if (hb + 2 * j < nr)
          acc[j] = decode::accumulate_masked(
              acc[j], Ps[(hb + 2 * j) * TILE + p], vv,
              has && t0 + p < lim[j]);
    }
    __syncthreads();  // buffer bi and Ps are rewritten by the next tiles
  }
  if (warp < nr && lane == 0) l_s[warp] = l_run;
  __syncthreads();
  float* ob = out + row0 * D;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int r = hb + 2 * j;
    if (r < nr) ob[r * D + d] = acc[j] / fmaxf(l_s[r], 1e-30f);
  }
}

template <typename T, int RB, typename Rows>
cudaError_t launch_rb(const void* q, const void* k, const void* v,
                      const int* cp, float* o, int B, int Hq, int K1, int S,
                      float scale, Rows rows, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, RB>();
  const cudaError_t e = cudaFuncSetAttribute(
      verify_kernel<T, RB, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int R = Hq / rows.Hkv * K1;
  verify_kernel<T, RB, Rows>
      <<<dim3(rows.Hkv, B, (R + RB - 1) / RB), kThreads, smem, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), cp, o, Hq, K1, S, scale, rows);
  return cudaGetLastError();
}

// Rows a block serves: the largest of 8, 4, 2 that gives at least
// kTargetBlocks blocks, else 2.
inline int rows_per_block(int B, int Hkv, int R) {
  int rb = 8;
  while (rb > 2 && (long long)B * Hkv * ((R + rb - 1) / rb) < kTargetBlocks)
    rb /= 2;
  return rb;
}

template <typename T, typename Rows>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int* cp, float* o, int B, int Hq, int K1, int S,
                     float scale, Rows rows, cudaStream_t s) {
  switch (rows_per_block(B, rows.Hkv, Hq / rows.Hkv * K1)) {
    case 8:
      return launch_rb<T, 8>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s);
    case 4:
      return launch_rb<T, 4>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s);
    default:
      return launch_rb<T, 2>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s);
  }
}

template <typename Rows>
int launch(const void* q, const void* k, const void* v, const void* cache_pos,
           void* out, int B, int Hq, int K1, int S, float scale, int dtype,
           Rows rows, void* stream) {
  const int* cp = static_cast<const int*>(cache_pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBF16
          ? launch_t<__nv_bfloat16>(q, k, v, cp, o, B, Hq, K1, S, scale, rows,
                                    s)
          : launch_t<float>(q, k, v, cp, o, B, Hq, K1, S, scale, rows, s));
}

}  // namespace verify

KERNEL_API int verify_decode_launch(const void* q, const void* k,
                                    const void* v, const void* cache_pos,
                                    void* out, int B, int Hq, int Hkv, int K1,
                                    int S, float scale, int dtype,
                                    void* stream) {
  return verify::launch(q, k, v, cache_pos, out, B, Hq, K1, S, scale, dtype,
                        decode::Contiguous{Hkv, S}, stream);
}

KERNEL_API int verify_decode_paged_launch(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* page_table,
                                          const void* cache_pos, void* out,
                                          int B, int Hq, int Hkv, int K1,
                                          int ps, int NP, float scale,
                                          int dtype, void* stream) {
  const decode::Paged rows{static_cast<const int*>(page_table), Hkv, ps, NP};
  return verify::launch(q, k_pages, v_pages, cache_pos, out, B, Hq, K1,
                        NP * ps, scale, dtype, rows, stream);
}
