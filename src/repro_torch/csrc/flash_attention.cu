// Blockwise (flash) attention with an fp32 online softmax, GQA-native.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas -> _fa_kernel): the prefill attention.
// q/k [B, H, T|S, Dqk], v [B, Hkv, S, Dv] in the model dtype, with (Dqk,
// Dv) = (128, 128) (GQA) or (192, 128) (MLA prefill: 128 latent-decompressed
// dims + 64 rotary dims per head, values of 128), in bf16 also (64, 64)
// (musicgen's 24 heads of 64, group 1), and in fp32 also (16, 16) (the
// seizure transformer's 4 heads of 16, non-causal, T = S = 16);
// query head h reads KV head h / (Hq / Hkv). Causal mode masks bottom-right:
// key j is visible to query i iff j <= i + (S - T). Output in q's dtype.
//
// Bound on the H100: bytes (q, k, v read once, the output written once;
// the [T, S] score matrix never reaches device memory). At the serving
// path's prefill lengths (T <= 128) the bound is under a microsecond, so
// what a launch waits on is latency and how many SMs it keeps busy.
//
// bf16 design (flash_tc_kernel):
//  - tensor cores by mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by
//    ldmatrix. Not wgmma: its 64-row warpgroup tiles would leave most of
//    the card idle at T <= 128 (yi-9b: 32 heads x 128 rows = 64 such
//    tiles), where 16-row warp tiles make 256;
//  - a block is 4 warps; warp w takes 16 query rows of one head. When
//    4 (else 2) divides the group size g = Hq / Hkv, the block's warps are
//    4 (2) heads of one KV group on the same 16 (32) rows, so one staged
//    K/V tile serves all of them and they share one causal extent;
//    otherwise (g = 1: MLA, musicgen) the warps are 4 row tiles of one
//    head. Grid (T / rows a block, Hq / heads a block, B);
//  - Q, K and V stay bf16 in shared memory (rows padded by 16 bytes, so
//    ldmatrix's 8 row addresses fall in distinct banks: at (64, 64) rows
//    of 144 bytes put them 36 words apart, 4 banks apart mod 32): ~87 KB
//    at (128, 128), ~112 KB at (192, 128), 45 KB at (64, 64). K/V tiles
//    of 64 keys are
//    double-buffered with cp.async: the next tile's loads fly while this
//    one is multiplied. Rows past T or S are zero-filled, never stale;
//  - S = Q K^T stays in registers as the fp32 accumulator fragment, is
//    scaled (scale * log2 e, in fp32), masked, and exponentiated (exp2);
//    P is rounded to bf16 in registers and becomes the A operand of P V,
//    as a TPU's default-precision fp32 dot rounds its inputs; the row sum
//    l is taken from the fp32 P;
//  - causal tile skipping: a warp runs only the tiles its rows see.
// A row's result does not depend on the rows after it (so a right-padded
// prompt's prefill equals the prompt's, bit for bit): a masked score
// gives p = 0 exactly; K/V rows past S are zeros (0 * 0, never 0 * NaN);
// the tiling of the key axis starts at 0 whatever T is; and a tile a row
// sees nothing of leaves its (m, l, acc) unchanged (m stays, alpha =
// exp2(0) = 1, P = 0 adds exact zeros), whichever warp runs it.
//
// The fp32 instances (on no serving path: the fp32 references, and the
// seizure transformer's evaluation) are scalar:
//  - (128, 128) and (192, 128), flash_kernel<float>: one block per (64
//    query rows, head, sequence), K and V tiles converted to fp32 in
//    shared memory, one thread per (row, 4 columns), scalar fmaf dot
//    products; ~115 KB of shared memory at (128, 128), ~148 KB at (192,
//    128);
//  - (16, 16), small::flash_small_kernel: a warp per (32 query rows,
//    head, sequence), 4 warps a block on 4 such items (no block-wide
//    barrier), a thread per query row holding its q row and its output
//    row in registers; K and V in tiles of 32 keys in the warp's own
//    4 KB of shared memory, read as broadcasts. At the seizure
//    transformer's T = S = 16 (1024 (head, sequence) pairs a batch of
//    256) half of each warp idles; flash_kernel's 64-row blocks idled
//    3/4 of their threads and ran their full loops on them (0.0387 ms
//    against plain's 0.0277 on the card).
#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4, kThreads = 32 * kWarps, WR = 16, BKV = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int DQK, int DV>
struct Layout {
  static constexpr int LQ = DQK + 8, LV = DV + 8;  // padded rows (bf16)
  static constexpr int q_elems = kWarps * WR * LQ, k_elems = BKV * LQ,
                       v_elems = BKV * LV;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (q_elems + 2 * k_elems + 2 * v_elems);
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Fragment layout (m16n8k16): lane = 4 gr + tq holds rows gr and gr + 8,
// columns 2 tq and 2 tq + 1 of each 8-column accumulator tile (c[0..1]
// row gr, c[2..3] row gr + 8).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int T_,
                    int S, int causal, float scale, int hpb) {
  using L = Layout<DQK, DV>;
  constexpr int LQ = L::LQ, LV = L::LV, NS = BKV / 8, NO = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L::q_elems;   // [2][BKV][LQ]
  __nv_bfloat16* Vs = Ks + 2 * L::k_elems;  // [2][BKV][LV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int g = Hq / Hkv, hgroups = g / hpb;
  const int rpb = WR * (kWarps / hpb);  // query rows a block covers
  const int hk = blockIdx.y / hgroups, b = blockIdx.z;
  const int h = hk * g + (blockIdx.y % hgroups) * hpb + warp % hpb;
  const int qb0 = blockIdx.x * rpb, q0 = qb0 + (warp / hpb) * WR;
  const int off = S - T_;  // causal offset: query i sees keys j <= i + off
  const int blk_last = min(T_ - 1, qb0 + rpb - 1);
  const int kv_end = causal ? min(S, blk_last + off + 1) : S;
  const int n_tiles = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  const int kv_end_w =
      q0 >= T_ ? 0 : causal ? min(S, min(T_ - 1, q0 + WR - 1) + off + 1) : S;

  const __nv_bfloat16* qh = q + (((size_t)b * Hq + h) * T_) * DQK;
  const __nv_bfloat16* kb = k + (((size_t)b * Hkv + hk) * S) * DQK;
  const __nv_bfloat16* vb = v + (((size_t)b * Hkv + hk) * S) * DV;

  // the warp's 16 query rows (rows past T: zeros)
  __nv_bfloat16* qs = Qs + warp * WR * LQ;
  for (int c = lane; c < WR * (DQK / 8); c += 32) {
    const int r = c / (DQK / 8), e = (c % (DQK / 8)) * 8;
    const bool ok = q0 + r < T_;
    cp_async16(qs + r * LQ + e, qh + (size_t)(ok ? q0 + r : 0) * DQK + e, ok);
  }
  auto load_kv = [&](int kv0, int bi) {  // rows past S: zeros
    __nv_bfloat16* ks = Ks + bi * L::k_elems;
    __nv_bfloat16* vs = Vs + bi * L::v_elems;
    for (int c = tid; c < BKV * (DQK / 8); c += kThreads) {
      const int r = c / (DQK / 8), e = (c % (DQK / 8)) * 8;
      const bool ok = kv0 + r < S;
      cp_async16(ks + r * LQ + e, kb + (size_t)(ok ? kv0 + r : 0) * DQK + e,
                 ok);
    }
    for (int c = tid; c < BKV * (DV / 8); c += kThreads) {
      const int r = c / (DV / 8), e = (c % (DV / 8)) * 8;
      const bool ok = kv0 + r < S;
      cp_async16(vs + r * LV + e, vb + (size_t)(ok ? kv0 + r : 0) * DV + e,
                 ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  unsigned qa[DQK / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;
  const int row[2] = {q0 + gr, q0 + gr + 8};

  for (int it = 0; it < n_tiles; ++it) {
    const int bi = it & 1, kv0 = it * BKV;
    if (it + 1 < n_tiles) {
      load_kv(kv0 + BKV, bi ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LQ +
                                kk * 16 + (lane >> 4) * 8);
    }
    if (kv0 < kv_end_w) {
      const __nv_bfloat16* ks = Ks + bi * L::k_elems;
      const __nv_bfloat16* vs = Vs + bi * L::v_elems;
      // S = Q K^T (fp32)
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          unsigned bf[4];
          ldmatrix_x4(bf, ks + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LQ +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma(s[j], qa[kk], bf[0], bf[1]);
          mma(s[j + 1], qa[kk], bf[2], bf[3]);
        }
      // scale, mask, row max (rows gr and gr + 8; a row's 4 lanes are a
      // quad)
      float mt[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kv0 + j * 8 + 2 * tq + (c & 1);
          const bool ok = key < S && (!causal || key <= row[c >> 1] + off);
          s[j][c] = ok ? s[j][c] * sl2 : kNeg;
          mt[c >> 1] = fmaxf(mt[c >> 1], s[j][c]);
        }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        mt[i] = fmaxf(m[i], mt[i]);  // the new running max
        alpha[i] = exp2f(m[i] - mt[i]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kv0 + j * 8 + 2 * tq + (c & 1);
          const bool ok = key < S && (!causal || key <= row[c >> 1] + off);
          s[j][c] = ok ? exp2f(s[j][c] - mt[c >> 1]) : 0.f;
          ls[c >> 1] += s[j][c];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 1);
        ls[i] += __shfl_xor_sync(0xffffffffu, ls[i], 2);
        l[i] = l[i] * alpha[i] + ls[i];
        m[i] = mt[i];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P V, P rounded to bf16 in registers (the A fragment of 16
      // keys is two neighbouring S accumulator tiles)
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          unsigned bf[4];
          ldmatrix_x4_trans(bf, vs + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LV +
                                    j * 8 + (lane >> 4) * 8);
          mma(o[j], pa, bf[0], bf[1]);
          mma(o[j + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // buffer bi is refilled by the next iteration's load
  }
  cp_async_wait<0>();  // no tile (a row sees no key): Q's copies landed
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= T_) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* ob = out + (((size_t)b * Hq + h) * T_ + row[i]) * DV;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + j * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[j][2 * i] * inv_l, o[j][2 * i + 1] * inv_l);
  }
}

// Heads of one KV group a block serves: 4 or 2 when they divide g, else 1.
inline int heads_per_block(int g) {
  return g % 4 == 0 ? 4 : g % 2 == 0 ? 2 : 1;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int T_, int S, int causal, float scale,
           cudaStream_t s) {
  constexpr size_t smem = Layout<DQK, DV>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int hpb = heads_per_block(Hq / Hkv), rpb = WR * (kWarps / hpb);
  const dim3 grid((T_ + rpb - 1) / rpb, Hq / hpb, B);
  flash_tc_kernel<DQK, DV><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, T_, S, causal, scale, hpb);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32, small heads (16, 16)
// ---------------------------------------------------------------------------

namespace small {

constexpr int kWarps = 4, kRows = 32, kKeys = 32;

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * kWarps)
    flash_small_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int B, int Hq, int Hkv, int T_, int S, int causal,
                       float scale) {
  __shared__ __align__(16) float Ks[kWarps][kKeys][DQK];
  __shared__ __align__(16) float Vs[kWarps][kKeys][DV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (T_ + kRows - 1) / kRows;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)B * Hq * chunks) return;  // no block barrier below
  const int chunk = (int)(item % chunks);
  const int h = (int)(item / chunks % Hq), b = (int)(item / chunks / Hq);
  const int hk = h / (Hq / Hkv), r0 = chunk * kRows, qi = r0 + lane;
  const int off = S - T_;  // causal offset: query i sees keys j <= i + off
  const float* kb = k + (((size_t)b * Hkv + hk) * S) * DQK;
  const float* vb = v + (((size_t)b * Hkv + hk) * S) * DV;

  float qr[DQK], acc[DV];
  const float* qp = q + (((size_t)b * Hq + h) * T_ + (qi < T_ ? qi : 0)) * DQK;
#pragma unroll
  for (int d = 0; d < DQK; d += 4) {
    const float4 u = *reinterpret_cast<const float4*>(qp + d);
    qr[d] = u.x * scale;
    qr[d + 1] = u.y * scale;
    qr[d + 2] = u.z * scale;
    qr[d + 3] = u.w * scale;
  }
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  float m_i = kNeg, l_i = 0.f;
  const int last = min(T_ - 1, r0 + kRows - 1);
  const int kv_end = causal ? min(S, last + off + 1) : S;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kKeys) {
    __syncwarp();  // the previous tile is consumed
    for (int c = lane; c < kKeys * DQK / 4; c += 32) {
      const int j = c / (DQK / 4), d = (c % (DQK / 4)) * 4;
      *reinterpret_cast<float4*>(&Ks[warp][j][d]) =
          kv0 + j < S
              ? *reinterpret_cast<const float4*>(kb + (size_t)(kv0 + j) * DQK + d)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c = lane; c < kKeys * DV / 4; c += 32) {
      const int j = c / (DV / 4), d = (c % (DV / 4)) * 4;
      *reinterpret_cast<float4*>(&Vs[warp][j][d]) =
          kv0 + j < S
              ? *reinterpret_cast<const float4*>(vb + (size_t)(kv0 + j) * DV + d)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    float s[kKeys], mt = kNeg;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DQK; ++d) dot = fmaf(qr[d], Ks[warp][j][d], dot);
      const int kj = kv0 + j;
      const bool ok = kj < S && (!causal || kj <= qi + off);
      s[j] = ok ? dot : kNeg;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int kj = kv0 + j;
      const bool ok = kj < S && (!causal || kj <= qi + off);
      const float p = ok ? expf(s[j] - m_new) : 0.f;
      lsum += p;
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] = fmaf(p, Vs[warp][j][d], acc[d]);
    }
    l_i = l_i * alpha + lsum;
    m_i = m_new;
  }
  if (qi < T_) {
    const float inv_l = 1.f / fmaxf(l_i, 1e-30f);
    float* ob = out + (((size_t)b * Hq + h) * T_ + qi) * DV;
#pragma unroll
    for (int d = 0; d < DV; d += 4)
      *reinterpret_cast<float4*>(ob + d) =
          make_float4(acc[d] * inv_l, acc[d + 1] * inv_l, acc[d + 2] * inv_l,
                      acc[d + 3] * inv_l);
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int T_, int S, int causal, float scale,
           cudaStream_t s) {
  const long long items =
      (long long)B * Hq * ((T_ + kRows - 1) / kRows);
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_small_kernel<DQK, DV><<<(unsigned)blocks, 32 * kWarps, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, Hq, Hkv, T_,
      S, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace small

KERNEL_API int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int T_, int S, int dqk, int dv,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (dqk == 128 && dv == 128)
      return tc::launch<128, 128>(q, k, v, out, B, Hq, Hkv, T_, S, causal,
                                  scale, s);
    if (dqk == 192 && dv == 128)
      return tc::launch<192, 128>(q, k, v, out, B, Hq, Hkv, T_, S, causal,
                                  scale, s);
    if (dqk == 64 && dv == 64)
      return tc::launch<64, 64>(q, k, v, out, B, Hq, Hkv, T_, S, causal,
                                scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dqk == 16 && dv == 16)
    return small::launch<16, 16>(q, k, v, out, B, Hq, Hkv, T_, S, causal,
                                 scale, s);
  return launch_dims<float>(q, k, v, out, B, Hq, Hkv, T_, S, dqk, dv, causal,
                            scale, s);
}
