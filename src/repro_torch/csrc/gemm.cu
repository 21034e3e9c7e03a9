// Fused GEMM: out = act(x @ w + bias), fp32 accumulation; and the
// per-head fp32 products of MLA's absorbed decode and the xLSTM mixers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm/gemm.py
// (gemm_pallas -> _gemm_kernel). Same contract: x [M, K], w [K, N] in the
// model dtype (or int8 with a scale per column: the int8-weight instance),
// optional bias [N] (passed as fp32), activation in {none, relu, gelu
// (tanh form, as jax.nn.gelu), silu}, output in x's dtype.
//
// Bound on the H100: at decode (M = the slot count, a handful of rows)
// every weight is read once for ~2 M flops: far below the ~295 flops/byte
// where the tensor cores become the limit, so the bytes of w bound it.
// The tile choices (``kernels/gemm/ops.py``: ``gemm_plan``, ``f32_plan``)
// are functions of the shape of w alone, never of M.
//
// Batch invariance, which the serve engine's bitwise token identity with
// the one-request loop rests on: every output element is reduced over K
// in one order fixed by the shape of w, whatever M, the M tile or the
// other rows; nothing is padded in device memory.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "gemm_epilogue.cuh"
#include "mma.cuh"

// 16 bytes of row `row` of a [rows, cols] matrix from column `col`,
// element by element, zero past the matrix's edges (the ragged path).
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int row, int col,
                                        int rows, int cols) {
  constexpr int E = 16 / sizeof(T);
  T t[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    t[e] = (row < rows && col + e < cols) ? p[(size_t)row * cols + col + e]
                                          : T(0);
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

// ---------------------------------------------------------------------------
// bf16 and int8-weight GEMM: mma.sync m16n8k16 with w^T as the A operand
// (16 columns of w a fragment, ldmatrix.trans) and x^T as B (8 rows of x a
// fragment, M padded to 8 in registers): out^T = w^T x^T.
//
// A block is 4 warps over a BN x MT output tile (BN = 16..128 columns
// from N, MT = 16 rows at decode and spec verify, 64 beyond; the M tiles
// of one column tile are adjacent blocks, so a prefill reads its weights
// from DRAM once). Its weight tiles (BK rows of K x BN) and x tiles (MT x
// BK) stream through a ring of 4 stages in dynamic shared memory, filled
// by cp.async 16 bytes a thread (zero-filled past K, N and M), 24-48 KB
// of weights in flight a block; one block-wide wait per stage. Weight
// tiles are XOR-swizzled at 16-byte granularity and x rows padded by 16
// bytes, so that ldmatrix's 8 row addresses fall in distinct banks. At
// decode only the rows of x below M are staged and the warps whose 8-row
// fragments lie past M skip the MMAs. Each warp loads the fragments of
// the next k16 step before it runs the current step's MMAs.
//
// K order: every output element accumulates in fp32 from zero over k = 0,
// 16, 32, ... one m16n8k16 step at a time, whatever M, N, BN, BK or MT.
//
// int8 weights (WQ): the ring holds int8 (half the bytes). ldmatrix.trans
// of the bytes as 16-bit pairs hands a lane two adjacent columns at k and
// k + 1, so A row r of a 16-column subtile is column 2 r (r < 8) or 2 (r -
// 8) + 1; the fragment is dequantized in registers, one rounding a value:
// bf16(q * scale[n]), as ``dequantize``, so the product is bitwise the
// bf16 kernel's on the dequantized weight.
// ---------------------------------------------------------------------------
namespace bf {

constexpr int kStages = 4, kThreads = 128;

// The 16-byte chunk of row r where logical chunk c lives, for rows of CH
// chunks: 8 consecutive rows at one chunk (an ldmatrix's 8 addresses)
// fall in distinct banks.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8) return c ^ (r & 7);
  if constexpr (CH == 4) return c ^ ((r >> 1) & 3);
  if constexpr (CH == 2) return c ^ ((r >> 2) & 1);
  return c;
}

// Byte i of u (an int8 weight + 128, as ``u = r ^ 0x80808080`` makes
// it) as a float, exactly: the bits 0x4B0000uu are 2^23 + u, and 2^23 +
// 128 is subtracted (full-rate integer and fp32 ops in place of I2F).
template <int I>
__device__ __forceinline__ float byte_f32(unsigned u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7550 | I)) -
         8388736.f;
}

// Bytes LO and HI of r (int8 weights) dequantized as a bf16 pair, LO in
// the low half: bf16(q * scale), one rounding each (the product is never
// fused with anything).
template <int LO, int HI>
__device__ __forceinline__ unsigned deq2(unsigned r, float sc) {
  const unsigned u = r ^ 0x80808080u;
  const __nv_bfloat162 v = __floats2bfloat162_rn(
      __fmul_rn(byte_f32<LO>(u), sc), __fmul_rn(byte_f32<HI>(u), sc));
  return *reinterpret_cast<const unsigned*>(&v);
}

// The most K rows a stage takes (``gemm_plan``: 8 or 16 KB of weights a
// stage, 64 <= BK <= 512 at decode; 64 or 128 in the prefill tiles).
template <int BN, int MT, bool WQ>
constexpr int max_bk() {
  const int bk = 16384 / (BN * (WQ ? 1 : 2));
  return MT > 16 ? 128 : bk < 64 ? 64 : bk > 512 ? 512 : bk;
}

template <int BN, int MT, bool WQ>
constexpr size_t smem_bytes(int bk) {
  return (size_t)kStages *
         ((size_t)bk * BN * (WQ ? 1 : 2) + (size_t)MT * (2 * bk + 16));
}

// VEC: K and N multiples of 8 (int8: N of 16), x and w 16-byte aligned,
// so every chunk is copied by cp.async; else element by element.
template <int BN, int MT, bool WQ, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const unsigned short* __restrict__ x,
                     const void* __restrict__ w,
                     const float* __restrict__ wscale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int lbk, int act) {
  constexpr int WN = BN / 16 < 4 ? BN / 16 : 4;  // warps along N
  constexpr int NS = BN / 16 / WN;               // 16-column subtiles a warp
  constexpr int WM = 4 / WN;                     // warps along M
  constexpr int NF = MT / 8;                     // 8-row fragments a tile
  constexpr int MF = (NF + WM - 1) / WM;         // ... a warp
  constexpr int ESZ = WQ ? 1 : 2, WROW = BN * ESZ, WCH = WROW / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  // x rows padded by 16 bytes: ldmatrix's 8 rows fall in distinct banks
  const int BK = 1 << lbk, XROW = 2 * BK + 16, XCH = BK / 8;
  const int wbytes = BK * WROW, stage = wbytes + MT * XROW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wm = warp / WN, g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * BN;  // M tiles adjacent
  const int mlive = min(MT, M - m0);
  const int xrows = min(MT, (mlive + 7) & ~7);  // staged rows, 0 past M
  const int nk = (K + BK - 1) >> lbk;

  auto load = [&](int t) {
    unsigned char* ws = smem + (t % kStages) * stage;
    unsigned char* xs = ws + wbytes;
    const int k0 = t << lbk;
    for (int i = tid; i < BK * WCH; i += kThreads) {
      const int r = i / WCH, c = i % WCH, k = k0 + r;
      const int n = n0 + c * (16 / ESZ);
      unsigned char* dst = ws + r * WROW + swz<WCH>(r, c) * 16;
      if constexpr (VEC) {
        const bool ok = k < K && n < N;
        cp_async16(dst,
                   static_cast<const unsigned char*>(w) +
                       (ok ? ((size_t)k * N + n) * ESZ : 0),
                   ok);
      } else if constexpr (WQ) {
        *reinterpret_cast<uint4*>(dst) =
            load16(static_cast<const signed char*>(w), k, n, K, N);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            load16(static_cast<const unsigned short*>(w), k, n, K, N);
      }
    }
    for (int i = tid; i < xrows * XCH; i += kThreads) {
      const int r = i >> (lbk - 3), c = i & (XCH - 1), m = m0 + r;
      const int k = k0 + c * 8;
      unsigned char* dst = xs + r * XROW + c * 16;
      if constexpr (VEC) {
        const bool ok = m < M && k < K;
        cp_async16(dst, x + (ok ? (size_t)m * K + k : 0), ok);
      } else {
        *reinterpret_cast<uint4*>(dst) = load16(x, m, k, M, K);
      }
    }
  };

  // A row r of a subtile is column r (bf16), or 2 r and 2 (r - 8) + 1
  // for r >= 8 (int8: ldmatrix.trans of bytes hands a lane two adjacent
  // columns at two adjacent k); `cn[e]` is accumulator e's column.
  int cn[2];
  cn[0] = WQ ? 2 * g : g;
  cn[1] = WQ ? 2 * g + 1 : g + 8;
  float sc[NS][2];  // WQ: the scales of a lane's two columns of a subtile
  // a lane's shared-memory offsets at k16 step 0 (step kk adds kk rows):
  // the swizzle of row kk + r equals row r's, kk being a multiple of 16
  int a_off[NS], b_off[MF];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int col = (wn * NS + s) * 16;
    if constexpr (WQ) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + col + cn[j];
        sc[s][j] = n < N ? wscale[n] : 0.f;
      }
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;  // x2: k, k + 8
      a_off[s] = r * WROW + (swz<WCH>(r, col >> 4) << 4);
    } else {
      const int mat = lane >> 3, r = (mat >> 1) * 8 + (lane & 7);
      a_off[s] = r * WROW + (swz<WCH>(r, (col >> 3) + (mat & 1)) << 4);
    }
  }
  bool live[MF];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    const int f = wm + i * WM;
    live[i] = f < NF && f * 8 < mlive;
    b_off[i] = (f * 8 + (lane & 7)) * XROW + ((lane >> 3) & 1) * 16;
  }

  // the A fragments of a subtile and the B fragments of x at step kk
  auto frags = [&](const unsigned char* ws, const unsigned char* xs, int kk,
                   unsigned (&a)[NS][4], unsigned (&b)[MF][2]) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
      if (live[i]) ldmatrix_x2(b[i], xs + b_off[i] + kk * 2);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if constexpr (WQ) {
        unsigned r[2];  // bytes (k, 2g), (k, 2g + 1), (k + 1, 2g), ...
        ldmatrix_x2_trans(r, ws + a_off[s] + kk * WROW);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[s][2 * h] = deq2<0, 2>(r[h], sc[s][0]);
          a[s][2 * h + 1] = deq2<1, 3>(r[h], sc[s][1]);
        }
      } else {
        ldmatrix_x4_trans(a[s], ws + a_off[s] + kk * WROW);
      }
    }
  };
  float acc[NS][MF][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][i][e] = 0.f;
  auto mmas = [&](const unsigned (&a)[NS][4], const unsigned (&b)[MF][2]) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int i = 0; i < MF; ++i)
        if (live[i]) mma(acc[s][i], a[s], b[i][0], b[i][1]);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; stage t - 1's slot is free
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    if (!live[0]) continue;  // fragments ascend: none of this warp's live
    const unsigned char* ws = smem + (t % kStages) * stage;
    const unsigned char* xs = ws + wbytes;
    const int kend = min(BK, K - (t << lbk));
    // k16 steps in order; the next step's fragments load during the MMAs
    unsigned a0[NS][4], b0[MF][2], a1[NS][4], b1[MF][2];
    frags(ws, xs, 0, a0, b0);
    for (int kk = 0; kk < kend; kk += 32) {
      const bool odd = kk + 16 < kend;
      if (odd) frags(ws, xs, kk + 16, a1, b1);
      mmas(a0, b0);
      if (kk + 32 < kend) frags(ws, xs, kk + 32, a0, b0);
      if (odd) mmas(a1, b1);
    }
  }
  cp_async_wait<0>();

  // acc[e]: column cn[e >> 1] of the subtile, row (m) 2 q + (e & 1)
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + (wn * NS + s) * 16 + cn[e >> 1];
        const int m = m0 + (wm + i * WM) * 8 + 2 * q + (e & 1);
        if (m < M && n < N) {
          float v = acc[s][i][e];
          if (bias) v += bias[n];
          out[(size_t)m * N + n] = __float2bfloat16(activate(v, act));
        }
      }
    }
  }
}

template <int BN, int MT, bool WQ, bool VEC>
static int run(const void* x, const void* w, const float* wscale,
               const float* bias, void* out, int M, int N, int K, int lbk,
               int act, cudaStream_t s) {
  auto kern = gemm_bf16_kernel<BN, MT, WQ, VEC>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<BN, MT, WQ>(max_bk<BN, MT, WQ>()));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((M + MT - 1) / MT, (N + BN - 1) / BN);
  kern<<<grid, kThreads, smem_bytes<BN, MT, WQ>(1 << lbk), s>>>(
      static_cast<const unsigned short*>(x), w, wscale, bias,
      static_cast<__nv_bfloat16*>(out), M, N, K, lbk, act);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool WQ>
static int dispatch(const void* x, const void* w, const float* wscale,
                    const float* bias, void* out, int M, int N, int K,
                    int bn, int lbk, bool vec, int act, cudaStream_t s) {
  if (!vec)  // the ragged path: 16 columns a block
    return run<16, MT, WQ, false>(x, w, wscale, bias, out, M, N, K, lbk,
                                  act, s);
  switch (bn) {
    case 16:
      return run<16, MT, WQ, true>(x, w, wscale, bias, out, M, N, K, lbk,
                                   act, s);
    case 32:
      return run<32, MT, WQ, true>(x, w, wscale, bias, out, M, N, K, lbk,
                                   act, s);
    case 64:
      return run<64, MT, WQ, true>(x, w, wscale, bias, out, M, N, K, lbk,
                                   act, s);
    case 128:
      return run<128, MT, WQ, true>(x, w, wscale, bias, out, M, N, K, lbk,
                                    act, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bf

// x bf16 [M, K]; w bf16 [K, N], or int8 [K, N] with wscale fp32 [N];
// bias fp32 [N] or null; out bf16 [M, N]. bn (16, 32, 64, 128) and the
// K rows of a stage, 2^lbk at M <= 16 (64..512) and 2^lbk_prefill beyond
// (64 or 128, in 64-row M tiles), come from ``gemm_plan``: functions of
// (N, K) only. None of them changes any element's arithmetic.
KERNEL_API int gemm_bf16_launch(const void* x, const void* w,
                                const void* wscale, const void* bias,
                                void* out, int M, int N, int K, int act,
                                int bn, int lbk, int lbk_prefill,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wq = wscale != nullptr;
  const bool vec = K % 8 == 0 && N % (wq ? 16 : 8) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto sc = static_cast<const float*>(wscale);
  auto b = static_cast<const float*>(bias);
  if (M <= 16)
    return wq ? bf::dispatch<16, true>(x, w, sc, b, out, M, N, K, bn, lbk,
                                       vec, act, s)
              : bf::dispatch<16, false>(x, w, sc, b, out, M, N, K, bn, lbk,
                                        vec, act, s);
  return wq ? bf::dispatch<64, true>(x, w, sc, b, out, M, N, K, bn,
                                     lbk_prefill, vec, act, s)
            : bf::dispatch<64, false>(x, w, sc, b, out, M, N, K, bn,
                                      lbk_prefill, vec, act, s);
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores, in full fp32 (no TF32: the routers' top-k
// is decided on these logits). One kernel serves the fused GEMM (H = 1)
// and the per-head products of MLA's absorbed decode and of the xLSTM
// mixers: for each head h (grid.z), out_h [M, N] = act(x_h [M, K] @ W_h
// [K, N] + bias), x fp32, W fp32 or bf16 (upcast in registers) read in
// place through strides. The heads replace the JAX package's per-head
// einsums, plain XLA ops there: the two fp32 einsums of the absorbed
// decode (models/attention.py apply_mla_decode: "bhd,lhd->bhl" and
// "bhl,lhd->bhd") and the block-diagonal q/k/v and recurrent products of
// models/xlstm.py ("bthd,hde->bhte", "bhd,hde->bhe", w [H, K, N]).
//
// At decode the weights are read once for 2 M flops each: bytes bound it,
// and the routers (N = 8..64) are too narrow to fill the card by columns.
// So K is split into `parts` ranges (from N, K, H and the layout, never
// M) and the card works on one product: a block is one column tile x one
// K range x 16 rows x one head. Each thread starts all its loads of w
// at once, 16 bytes each, neighbouring threads on neighbouring addresses
// (along N, or along K where W_h is read transposed), and keeps them in
// registers while the block's 16 rows of x over its K range wait in
// shared memory; then for each 4 rows every thread runs one fma chain
// over its k (ascending), the block adds its threads' chains by a fixed
// binary tree in shared memory. Where K is split, each block writes its
// partial sums to scratch and the last block of its tile to arrive (an
// integer counter a tile; no float atomics) adds the K ranges in index
// order and re-arms the counter, so a call is one launch. An element's
// arithmetic is thus fixed by (N, K, H, layout, dtype): a row's result
// never depends on M, the other rows or the order the blocks ran in.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kMT = 16, kMG = 4, kMaxLoads = 8, kMaxThreads = 256;
constexpr int kMaxSmem = 96 * 1024;

// Where head h's operands lie (unit stride along k for x, along n for
// out): x_h[m][k] = x[h * x_head + m * x_row + k]; W_h[k][n] =
// w[h * w_head + k * w_step + n], or with KFAST (W_h read transposed)
// w[h * w_head + n * w_step + k]; out_h[m][n] = out[h * out_head +
// m * out_row + n].
struct Layout {
  long long x_head, w_head, out_head;
  int x_row, w_step, out_row;
};

// From ``f32_plan``. Along N (W_h[k][n] contiguous in n): lanes_k = KT
// threads along K, threads / KT along N, each 16 bytes of one row: bn
// columns; each thread loads kc / KT rows k = k0 + lane + j KT. KFAST:
// lanes_k = KVT threads along K, 16 bytes each (kc = KVT x 16 bytes of
// w), threads / KVT along N, each bn / (threads / KVT) columns.
struct Plan {
  int threads, bn, kc, parts, lanes_k;
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// 16 bytes of w from p, of which the first `valid` elements are in range
// (0: none; VECOK: all or none, and p is 16-byte aligned).
template <typename TW, bool VECOK>
__device__ __forceinline__ uint4 load_w(const TW* p, int valid) {
  if (valid <= 0) return make_uint4(0, 0, 0, 0);
  if constexpr (VECOK) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    constexpr int E = 16 / sizeof(TW);
    TW t[E];
#pragma unroll
    for (int e = 0; e < E; ++e) t[e] = e < valid ? p[e] : TW(0);
    uint4 u;
    memcpy(&u, t, sizeof(u));
    return u;
  }
}

// TW: float, or unsigned short for bf16 (its bits).
template <typename TW, bool KFAST, bool VECOK>
__global__ void __launch_bounds__(kMaxThreads)
    gemm_f32_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ part, unsigned* __restrict__ arrived,
                    int M, int N, int K, int act, Layout lay, Plan p) {
  constexpr int E = 16 / sizeof(TW);
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, H = gridDim.z;
  const int tiles = (N + p.bn - 1) / p.bn;
  const int n0 = (blockIdx.x % tiles) * p.bn, pi = blockIdx.x / tiles;
  const int k0 = pi * p.kc, m0 = blockIdx.y * kMT, h = blockIdx.z;
  const int rows = min(kMT, M - m0), kc = min(p.kc, K - k0);
  const int lanes = p.lanes_k, ob = kMG * p.bn;   // outputs of a group
  const int rs = ob + (KFAST ? 1 : 4);            // padded row of `red`
  float* xs = fsm;                                  // [rows + 3][p.kc]
  float* red = fsm + ((rows + kMG - 1) / kMG * kMG) * p.kc;  // [lanes][rs]
  const TW* wh = w + h * lay.w_head;

  // 1. every load of w this thread makes, all in flight at once
  const int kl = KFAST ? tid % lanes : tid / (p.threads / lanes);
  const int nl = KFAST ? tid / lanes : tid % (p.threads / lanes);
  const int nt = p.threads / lanes;           // threads along N
  const int nload = KFAST ? p.bn / nt : p.kc / lanes;
  uint4 raw[kMaxLoads];
#pragma unroll
  for (int j = 0; j < kMaxLoads; ++j) {
    if (j >= nload) break;
    if constexpr (KFAST) {
      const int n = n0 + nl + j * nt, k = k0 + kl * E;
      raw[j] = load_w<TW, VECOK>(wh + (size_t)n * lay.w_step + k,
                                 n < N ? min(E, K - k) : 0);
    } else {
      const int k = k0 + kl + j * lanes, n = n0 + nl * E;
      raw[j] = load_w<TW, VECOK>(wh + (size_t)k * lay.w_step + n,
                                 k < K ? min(E, N - n) : 0);
    }
  }

  // 2. this block's rows of x over its K range
  const float* xh = x + h * lay.x_head + (size_t)m0 * lay.x_row + k0;
  for (int i = tid; i < rows * kc; i += p.threads) {
    const int r = i / kc, c = i - r * kc;
    xs[r * p.kc + c] = xh[(size_t)r * lay.x_row + c];
  }
  __syncthreads();

  // 3. for each 4 rows: per-thread chains, the block's tree, the store
  for (int mg = 0; mg < rows; mg += kMG) {
    if constexpr (KFAST) {
      float acc[kMG][kMaxLoads];
#pragma unroll
      for (int r = 0; r < kMG; ++r)
#pragma unroll
        for (int j = 0; j < kMaxLoads; ++j) acc[r][j] = 0.f;
      const int kx = kl * E;  // this thread's k in the block's range
#pragma unroll
      for (int j = 0; j < kMaxLoads; ++j) {
        if (j >= nload) break;
        float wf[E];
        unpack(raw[j], wf);
#pragma unroll
        for (int r = 0; r < kMG; ++r) {
          const float* xr = xs + (mg + r) * p.kc + kx;
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (kx + e < kc) acc[r][j] = fmaf(xr[e], wf[e], acc[r][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxLoads; ++j) {
        if (j >= nload) break;
#pragma unroll
        for (int r = 0; r < kMG; ++r)
          red[kl * rs + r * p.bn + nl + j * nt] = acc[r][j];
      }
    } else {
      float acc[kMG][E];
#pragma unroll
      for (int r = 0; r < kMG; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxLoads; ++j) {
        if (j >= nload) break;
        const int kx = kl + j * lanes;
        if (kx >= kc) break;
        float wf[E];
        unpack(raw[j], wf);
#pragma unroll
        for (int r = 0; r < kMG; ++r) {
          const float xv = xs[(mg + r) * p.kc + kx];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] = fmaf(xv, wf[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMG; ++r) {
        float4* dst = reinterpret_cast<float4*>(red + kl * rs + r * p.bn +
                                                nl * E);
#pragma unroll
        for (int v = 0; v < E / 4; ++v)
          dst[v] = make_float4(acc[r][4 * v], acc[r][4 * v + 1],
                               acc[r][4 * v + 2], acc[r][4 * v + 3]);
      }
    }
    __syncthreads();
    // lane l += lane l + s, s = lanes / 2, ..., 1 (lanes a power of 2)
    for (int s = lanes >> 1; s > 0; s >>= 1) {
      for (int i = tid; i < s * ob; i += p.threads) {
        const int l = i / ob, o = i - l * ob;
        red[l * rs + o] += red[(l + s) * rs + o];
      }
      __syncthreads();
    }
    for (int o = tid; o < ob; o += p.threads) {
      const int r = o / p.bn, n = n0 + o - r * p.bn, m = m0 + mg + r;
      if (mg + r < rows && n < N) {
        float v = red[o];
        if (p.parts == 1) {
          if (bias) v += bias[n];
          out[h * lay.out_head + (size_t)m * lay.out_row + n] =
              activate(v, act);
        } else {
          part[(((size_t)pi * H + h) * M + m) * N + n] = v;
        }
      }
    }
    __syncthreads();
  }
  if (p.parts == 1) return;

  // 4. the last of the tile's `parts` blocks to arrive: out = act(the K
  // ranges' partials added in index order + bias); then re-arm the counter
  __shared__ bool last;
  unsigned* cnt = arrived + ((size_t)h * gridDim.y + blockIdx.y) * tiles +
                  blockIdx.x % tiles;
  __threadfence();  // this block's partials are visible before it counts
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt, 1u) == (unsigned)p.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t total = (size_t)H * M * N;
  for (int o = tid; o < rows * p.bn; o += p.threads) {
    const int r = o / p.bn, n = n0 + o - r * p.bn, m = m0 + r;
    if (n >= N) continue;
    const size_t i = ((size_t)h * M + m) * N + n;
    float v = __ldcg(part + i);  // from L2: other SMs wrote them
    for (int q = 1; q < p.parts; ++q) v += __ldcg(part + q * total + i);
    if (bias) v += bias[n];
    out[h * lay.out_head + (size_t)m * lay.out_row + n] = activate(v, act);
  }
  if (tid == 0) *cnt = 0;
}

template <typename TW, bool KFAST, bool VECOK>
static int run(const float* x, const TW* w, const float* bias, float* out,
               float* part, unsigned* arrived, int M, int N, int K, int H,
               int act, const Layout& lay, const Plan& p, cudaStream_t s) {
  auto kern = gemm_f32_kernel<TW, KFAST, VECOK>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int rows = M < kMT ? M : kMT;
  const size_t smem =
      sizeof(float) * ((size_t)(rows + kMG - 1) / kMG * kMG * p.kc +
                       (size_t)p.lanes_k * (kMG * p.bn + (KFAST ? 1 : 4)));
  const dim3 grid((N + p.bn - 1) / p.bn * p.parts, (M + kMT - 1) / kMT, H);
  kern<<<grid, p.threads, smem, s>>>(x, w, bias, out, part, arrived, M, N,
                                     K, act, lay, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
static int dispatch(const void* x, const void* w, const float* bias,
                    float* out, float* part, unsigned* arrived, int M, int N,
                    int K, int H, int act, bool kfast, const Layout& lay,
                    const Plan& p, cudaStream_t s) {
  constexpr int E = 16 / sizeof(TW);
  const bool vecok = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     (lay.w_step * sizeof(TW)) % 16 == 0 &&
                     (lay.w_head * sizeof(TW)) % 16 == 0 &&
                     (kfast ? K : N) % E == 0;
  auto xf = static_cast<const float*>(x);
  auto wt = static_cast<const TW*>(w);
  if (kfast)
    return vecok ? run<TW, true, true>(xf, wt, bias, out, part, arrived, M,
                                       N, K, H, act, lay, p, s)
                 : run<TW, true, false>(xf, wt, bias, out, part, arrived, M,
                                        N, K, H, act, lay, p, s);
  return vecok ? run<TW, false, true>(xf, wt, bias, out, part, arrived, M, N,
                                      K, H, act, lay, p, s)
               : run<TW, false, false>(xf, wt, bias, out, part, arrived, M,
                                       N, K, H, act, lay, p, s);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// fp32 GEMM at 1-7 columns (the seizure models' two-class heads, x [256,
// 32-128] @ w [32-128, 2]): narrower than the fp32 kernel's tiles (8
// columns at least), whose block there reduces 16 rows through a tree of
// 128 lanes along a K of a few dozen. Here one warp a row of x: lane l
// takes k = l, l + 32, ... (coalesced reads of the row; w, a few hundred
// bytes, stays in L1), one fmaf chain a column, then the warp's butterfly
// (xor 16, 8, 4, 2, 1); lane 0 adds the bias, activates and stores. The
// arithmetic is fixed by (N, K): a row's result never depends on M.
// ---------------------------------------------------------------------------
namespace f32n {

constexpr int kWarps = 8;

template <int N>
__global__ void __launch_bounds__(kWarps * 32)
    gemm_f32_narrow_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int M, int K, int act) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp: m is the warp's
  const float* xr = x + (size_t)m * K;
  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float xv = __ldg(xr + k);
#pragma unroll
    for (int n = 0; n < N; ++n)
      acc[n] = fmaf(xv, __ldg(w + (size_t)k * N + n), acc[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], s);
  if (lane) return;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float v = acc[n];
    if (bias) v += bias[n];
    out[(size_t)m * N + n] = activate(v, act);
  }
}

template <int N>
static int run(const float* x, const float* w, const float* bias, float* out,
               int M, int K, int act, cudaStream_t s) {
  gemm_f32_narrow_kernel<N><<<(M + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      x, w, bias, out, M, K, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32n

// x fp32 [M, K]; w fp32 [K, N], 1 <= N <= 7; bias fp32 [N] or null; out
// fp32 [M, N].
KERNEL_API int gemm_f32_narrow_launch(const void* x, const void* w,
                                      const void* bias, void* out, int M,
                                      int N, int K, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<float*>(out);
  switch (N) {
    case 1: return f32n::run<1>(xf, wf, b, o, M, K, act, s);
    case 2: return f32n::run<2>(xf, wf, b, o, M, K, act, s);
    case 3: return f32n::run<3>(xf, wf, b, o, M, K, act, s);
    case 4: return f32n::run<4>(xf, wf, b, o, M, K, act, s);
    case 5: return f32n::run<5>(xf, wf, b, o, M, K, act, s);
    case 6: return f32n::run<6>(xf, wf, b, o, M, K, act, s);
    case 7: return f32n::run<7>(xf, wf, b, o, M, K, act, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layouts of w in gemm_heads_launch.
enum HeadLayout { kLHD = 0, kLHDTransposed = 1, kHeadMajor = 2 };

// x fp32 [M, H, K]; w of dtype wdtype (0 fp32, 1 bf16); bias fp32 [N] or
// null; out fp32 [M, H, N]. When parts > 1: part fp32 [parts, H, M, N]
// scratch, and arrived uint32 [H, ceil(M / 16), ceil(N / bn)] counters,
// zero before the launch and zero again after it (the last block of each
// tile re-arms its own); else both null. The plan (threads, bn, kc,
// parts, lanes_k) is ``f32_plan``'s for (N, K, H, layout, wdtype).
// layout kLHD: w [L, H, D], K = L, N = D, W_h[k][n] = w[k, h, n];
// layout kLHDTransposed: w [L, H, D], K = D, N = L, W_h[k][n] = w[n, h, k];
// layout kHeadMajor: w [H, L, D], K = L, N = D, W_h[k][n] = w[h, k, n]
// (the block-diagonal per-head projections of the xLSTM mixers; with
// H = 1 the fp32 fused GEMM x [M, K] @ w [K, N]).
KERNEL_API int gemm_heads_launch(const void* x, const void* w,
                                 const void* bias, void* out, void* part,
                                 void* arrived, int M, int H, int L, int D,
                                 int layout, int wdtype, int act,
                                 int threads, int bn, int kc, int parts,
                                 int lanes_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kfast = layout == kLHDTransposed;
  const int K = kfast ? D : L, N = kfast ? L : D;
  const f32::Layout lay =
      layout == kHeadMajor
          ? f32::Layout{K, (long long)L * D, N, H * K, D, H * N}
          : f32::Layout{K, D, N, H * K, H * D, H * N};
  const f32::Plan p{threads, bn, kc, parts, lanes_k};
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<float*>(out);
  auto pt = static_cast<float*>(part);
  auto ar = static_cast<unsigned*>(arrived);
  if (wdtype == kBF16)
    return f32::dispatch<unsigned short>(x, w, b, o, pt, ar, M, N, K, H,
                                         act, kfast, lay, p, s);
  return f32::dispatch<float>(x, w, b, o, pt, ar, M, N, K, H, act, kfast,
                              lay, p, s);
}
