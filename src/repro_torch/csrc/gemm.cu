// Fused GEMM: out = act(x @ w + bias), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm/gemm.py
// (gemm_pallas -> _gemm_kernel). Same contract: x [M, K], w [K, N] in the
// model dtype, optional bias [N] (passed as fp32), activation in
// {none, relu, gelu (tanh form, as jax.nn.gelu), silu}, output in x's dtype.
//
// Bound on the H100: at decode (M = the slot count, a handful of rows) the
// product reads every weight once and does ~2*M flops per weight byte pair:
// far below the ~295 flops/byte where the tensor cores become the limit,
// so it is bound by the bytes of w. At prefill (M >= 128) the larger
// shapes approach the compute bound. Design for now: one shared-memory
// tiled kernel (64 x 64 output tile, K in steps of 32, one tile of
// registers prefetched ahead of the tensor-core work) with bias and
// activation fused into the epilogue, so the output is written once.
// bf16 goes through WMMA (mma.sync) tensor-core fragments; fp32 through
// FMA on the CUDA cores, so fp32 keeps full precision (no TF32).
//
// Batch invariance: each output element is reduced over K in one fixed
// order (k = 0, 32, 64, ... with the same fragment steps), with no split-K
// and the same tiling for every M, so a row's result never depends on the
// other rows of the batch. The serve engine's bitwise token identity with
// the one-request loop rests on this. Ragged M/N/K edges are masked in the
// loads (zero fill) and the stores; nothing is padded in device memory.
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "gemm_epilogue.cuh"

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;  // padded strides

// ---------------------------------------------------------------------------
// bf16: WMMA 16x16x16 fragments, 4 warps, each warp a 32 x 32 sub-tile
// ---------------------------------------------------------------------------

// One 8-element (16-byte) piece of a tile: vector load where it lies whole
// inside the matrix and the rows are 16-byte aligned, else element by
// element with zero fill.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const unsigned short* p, int row,
                                       int col, int rows, int cols) {
  if (VEC && row < rows && col + 8 <= cols)
    return *reinterpret_cast<const uint4*>(p + (size_t)row * cols + col);
  unsigned short t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    t[e] = (row < rows && col + e < cols) ? p[(size_t)row * cols + col + e]
                                          : (unsigned short)0;
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

// 8 int8 values (8 bytes) of a tile piece, the same way.
template <bool VEC>
__device__ __forceinline__ uint2 load8q(const signed char* p, int row,
                                        int col, int rows, int cols) {
  if (VEC && row < rows && col + 8 <= cols)
    return *reinterpret_cast<const uint2*>(p + (size_t)row * cols + col);
  signed char t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    t[e] = (row < rows && col + e < cols) ? p[(size_t)row * cols + col + e]
                                          : (signed char)0;
  uint2 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

// 8 int8 weights -> 8 bf16 values round(float(q) * scale), one rounding
// each (the product is never fused with anything).
__device__ __forceinline__ uint4 dequant8(uint2 raw, const float* sc) {
  signed char q[8];
  memcpy(q, &raw, sizeof(raw));
  __nv_bfloat16 t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    t[e] = __float2bfloat16_rn(__fmul_rn(static_cast<float>(q[e]), sc[e]));
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

// WQ: w is int8 with a scale per column (wscale), else bf16 (wscale unused).
template <bool VEC, bool WQ>
__global__ void __launch_bounds__(128)
    gemm_bf16_kernel(const unsigned short* __restrict__ x,
                     const void* __restrict__ w,
                     const float* __restrict__ wscale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int act) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // each thread stages two 8-element pieces of A and two of B per K step;
  // its B pieces lie in the same 8 columns at every step. int8 pieces stay
  // raw in registers until the store, so the loads stay in flight during
  // the MMAs
  const int bc = (tid % (BN / 8)) * 8;
  uint4 ra[2];
  typename std::conditional<WQ, uint2, uint4>::type rb[2];
  float sc[8];
  if constexpr (WQ) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sc[e] = n0 + bc + e < N ? wscale[n0 + bc + e] : 0.f;
  }
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * 128;
      ra[i] = load8<VEC>(x, m0 + v / (BK / 8), k0 + (v % (BK / 8)) * 8, M, K);
      if constexpr (WQ)
        rb[i] = load8q<VEC>(static_cast<const signed char*>(w),
                            k0 + v / (BN / 8), n0 + bc, K, N);
      else
        rb[i] = load8<VEC>(static_cast<const unsigned short*>(w),
                           k0 + v / (BN / 8), n0 + bc, K, N);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * 128;
      *reinterpret_cast<uint4*>(&As[(v / (BK / 8)) * LDA + (v % (BK / 8)) * 8]) = ra[i];
      uint4 b;
      if constexpr (WQ)
        b = dequant8(rb[i], sc);
      else
        b = rb[i];
      *reinterpret_cast<uint4*>(&Bs[(v / (BN / 8)) * LDB + bc]) = b;
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // next tile in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm + 16 * i) * LDC + wn + 16 * j],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN, gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = Cs[r * LDC + c];
      if (bias) v += bias[gc];
      out[(size_t)gr * N + gc] = __float2bfloat16(activate(v, act));
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores, 256 threads, each a 4 x 4 block of outputs.
// One kernel serves the fused GEMM (H = 1, row-major) and the per-head
// products of MLA's absorbed decode and of the xLSTM mixers: for each
// head h (grid.z), out_h [M, N] = act(x_h [M, K] @ W_h [K, N] + bias), x
// fp32, W fp32 or bf16 read in place through strides (no transposed
// copy). The heads replace the JAX package's per-head einsums, plain XLA
// ops there: the two fp32 einsums of the absorbed decode
// (models/attention.py apply_mla_decode: "bhd,lhd->bhl" and
// "bhl,lhd->bhd") and the block-diagonal q/k/v and recurrent products of
// models/xlstm.py ("bthd,hde->bhte", "bhd,hde->bhe", w [H, K, N]). cuBLAS
// picks its algorithm by M and could give a B = 4 row other bits than the
// B = 1 row, while here the tile and the K order are the same for every M
// and every H.
// ---------------------------------------------------------------------------

constexpr int FBK = 16;

// Where head h's operands lie (unit stride along k for x, along n for
// out): x_h[m][k] = x[h * x_head + m * x_row + k]; W_h[k][n] =
// w[h * w_head + k * w_step + n], or with KFAST (W_h read transposed)
// w[h * w_head + n * w_step + k]; out_h[m][n] = out[h * out_head +
// m * out_row + n].
struct Layout {
  long long x_head, w_head, out_head;
  int x_row, w_step, out_row;
};

template <typename TW, bool KFAST>
__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int K, int act, Layout lay) {
  __shared__ float As[BM][FBK + 1];
  __shared__ float Bs[FBK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, h = blockIdx.z;
  const float* xh = x + h * lay.x_head;
  const TW* wh = w + h * lay.w_head;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < BM * FBK; e += 256) {
      const int r = e / FBK, c = e % FBK;
      As[r][c] = (m0 + r < M && k0 + c < K)
                     ? xh[(size_t)(m0 + r) * lay.x_row + k0 + c] : 0.f;
    }
    // neighbouring threads load neighbouring addresses of w
    for (int e = tid; e < FBK * BN; e += 256) {
      const int r = KFAST ? e % FBK : e / BN, c = KFAST ? e / FBK : e % BN;
      Bs[r][c] = (k0 + r < K && n0 + c < N)
                     ? to_f32(KFAST ? wh[(size_t)(n0 + c) * lay.w_step + k0 + r]
                                    : wh[(size_t)(k0 + r) * lay.w_step + n0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oh = out + h * lay.out_head;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty * 4 + i, gc = n0 + tx * 4 + j;
      if (gr < M && gc < N) {
        float v = acc[i][j];
        if (bias) v += bias[gc];
        oh[(size_t)gr * lay.out_row + gc] = activate(v, act);
      }
    }
}

template <typename TW>
static void gemm_f32_run(const float* x, const TW* w, const float* bias,
                         float* out, int M, int N, int K, int H, int act,
                         bool kfast, const Layout& lay, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, H);
  if (kfast)
    gemm_f32_kernel<TW, true><<<grid, 256, 0, s>>>(x, w, bias, out, M, N, K,
                                                   act, lay);
  else
    gemm_f32_kernel<TW, false><<<grid, 256, 0, s>>>(x, w, bias, out, M, N, K,
                                                    act, lay);
}

// The layouts of w in gemm_heads_launch.
enum HeadLayout { kLHD = 0, kLHDTransposed = 1, kHeadMajor = 2 };

// x fp32 [M, H, K]; w of dtype wdtype (0 fp32, 1 bf16); out fp32 [M, H, N].
// layout kLHD: w [L, H, D], K = L, N = D, W_h[k][n] = w[k, h, n];
// layout kLHDTransposed: w [L, H, D], K = D, N = L, W_h[k][n] = w[n, h, k];
// layout kHeadMajor: w [H, L, D], K = L, N = D, W_h[k][n] = w[h, k, n]
// (the block-diagonal per-head projections of the xLSTM mixers).
KERNEL_API int gemm_heads_launch(const void* x, const void* w, void* out,
                                 int M, int H, int L, int D, int layout,
                                 int wdtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kfast = layout == kLHDTransposed;
  const int K = kfast ? D : L, N = kfast ? L : D;
  const Layout lay = layout == kHeadMajor
                         ? Layout{K, (long long)L * D, N, H * K, D, H * N}
                         : Layout{K, D, N, H * K, H * D, H * N};
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (wdtype == kBF16)
    gemm_f32_run(xf, static_cast<const __nv_bfloat16*>(w), nullptr, o, M, N,
                 K, H, kNone, kfast, lay, s);
  else
    gemm_f32_run(xf, static_cast<const float*>(w), nullptr, o, M, N, K, H,
                 kNone, kfast, lay, s);
  return static_cast<int>(cudaGetLastError());
}

KERNEL_API int gemm_launch(const void* x, const void* w, const void* bias,
                           void* out, int M, int N, int K, int dtype, int act,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* b = static_cast<const float*>(bias);
  if (dtype == kBF16) {
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto xs = static_cast<const unsigned short*>(x);
    auto ws = static_cast<const unsigned short*>(w);
    auto o = static_cast<__nv_bfloat16*>(out);
    if (vec)
      gemm_bf16_kernel<true, false><<<grid, 128, 0, s>>>(xs, ws, nullptr, b, o,
                                                         M, N, K, act);
    else
      gemm_bf16_kernel<false, false><<<grid, 128, 0, s>>>(xs, ws, nullptr, b,
                                                          o, M, N, K, act);
  } else {
    gemm_f32_run(static_cast<const float*>(x), static_cast<const float*>(w),
                 b, static_cast<float*>(out), M, N, K, 1, act, false,
                 Layout{0, 0, 0, K, N, N}, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [M, K]; q int8 [K, N]; scale fp32 [N]; bias fp32 [N] or null;
// out bf16 [M, N].
KERNEL_API int gemm_wq_launch(const void* x, const void* q, const void* scale,
                              const void* bias, void* out, int M, int N,
                              int K, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  auto xs = static_cast<const unsigned short*>(x);
  auto sc = static_cast<const float*>(scale);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (vec)
    gemm_bf16_kernel<true, true><<<grid, 128, 0, s>>>(xs, q, sc, b, o, M, N,
                                                      K, act);
  else
    gemm_bf16_kernel<false, true><<<grid, 128, 0, s>>>(xs, q, sc, b, o, M, N,
                                                       K, act);
  return static_cast<int>(cudaGetLastError());
}
