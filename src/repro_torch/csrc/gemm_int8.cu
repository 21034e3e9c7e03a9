// W8A8 GEMM: out = act((float(xq @ wq) * xs[m]) * ws[n] (+ bias[n])),
// int32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm/gemm.py
// (gemm_int8_pallas -> _gemm_int8_kernel). Same contract: xq [M, K] int8
// (activations quantized per row by the wrapper), wq [K, N] int8 (the
// serving weights' int8 tiles, or a weight quantized per column), xs [M]
// and ws [N] fp32 scales, optional bias [N] fp32, activation in {none,
// relu, gelu (tanh form), silu}, output bf16 (the activations' dtype on
// the serving path).
//
// Bound on the H100: at decode (M = the slot count) the product reads each
// weight byte once and does 2 * M integer operations per byte, far below
// the ~590 operations per byte at which int8 tensor cores (1979 TOP/s)
// overtake the memory (3.35 TB/s): bound by the bytes of wq, half those of
// the bf16 GEMM. Design for now: the bf16 kernel's shape (gemm.cu) with
// int8 operands -- a 64 x 64 output tile, K in steps of 64 bytes, one tile
// of registers prefetched ahead of the tensor-core work, 4 warps each on a
// 32 x 32 sub-tile of int8 WMMA 16x16x16 fragments with int accumulators.
// WMMA wants 32-byte aligned fragment pointers, and a 16-byte step along K
// of a row-major tile is not; so shared memory holds each tile as slabs of
// 16 bytes per row -- A as [K / 16][BM][16], B as [N / 16][BK][16] -- and
// every fragment lies whole in one slab with a leading dimension of 16.
// wgmma and TMA are later work.
//
// Exactness: integer sums are exact in any order, so a row's result never
// depends on the batch or the tiling. The epilogue keeps JAX's order,
// (acc * xs) * ws + bias, with JAX's roundings as XLA compiles them: each
// product rounded on its own (__fmul_rn, never contracted), and with a
// bias the second product and the sum one fused multiply-add (__fmaf_rn;
// XLA contracts "out * ws + b" alike). So the output equals the plain
// version (kernels/gemm/ref.py gemm_int8_ref) bitwise for none / relu and
// to the activation's own rounding (expf, tanhf) for silu / gelu. Ragged
// M/N/K edges are zero filled in the loads and masked in the stores.
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "gemm_epilogue.cuh"

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 64;  // BK in int8 values (bytes)
constexpr int LDC = BN + 4;

// One 16-byte piece of an int8 tile: a vector load where it lies whole
// inside the matrix and the rows are 16-byte aligned, else byte by byte
// with zero fill.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const signed char* p, int row,
                                        int col, int rows, int cols) {
  if (VEC && row < rows && col + 16 <= cols)
    return *reinterpret_cast<const uint4*>(p + (size_t)row * cols + col);
  signed char t[16];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    t[e] = (row < rows && col + e < cols) ? p[(size_t)row * cols + col + e]
                                          : (signed char)0;
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

template <bool VEC>
__global__ void __launch_bounds__(128)
    gemm_int8_kernel(const signed char* __restrict__ xq,
                     const signed char* __restrict__ wq,
                     const float* __restrict__ xs,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int act) {
  __shared__ __align__(128) signed char As[BK / 16][BM][16];
  __shared__ __align__(128) signed char Bs[BN / 16][BK][16];
  __shared__ __align__(128) int Cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // a tile is 64 rows of 4 pieces of 16 bytes; each thread stages two
  // pieces of A and two of B per K step, piece v = (row v / 4, slab v % 4)
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * 128;
      ra[i] = load16<VEC>(xq, m0 + v / 4, k0 + (v % 4) * 16, M, K);
      rb[i] = load16<VEC>(wq, k0 + v / 4, n0 + (v % 4) * 16, K, N);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * 128;
      *reinterpret_cast<uint4*>(&As[v % 4][v / 4][0]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[v % 4][v / 4][0]) = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // next tile in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk][wm + 16 * i][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[(wn + 16 * j) / 16][16 * kk][0], 16);
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
      float v = __fmul_rn(__int2float_rn(Cs[r * LDC + c]), xs[gr]);
      v = bias ? __fmaf_rn(v, ws[gc], bias[gc]) : __fmul_rn(v, ws[gc]);
      out[(size_t)gr * N + gc] = __float2bfloat16(activate(v, act));
    }
  }
}

// xq int8 [M, K]; wq int8 [K, N]; xs fp32 [M]; ws fp32 [N]; bias fp32 [N]
// or null; out bf16 [M, N].
KERNEL_API int gemm_int8_launch(const void* xq, const void* wq,
                                const void* xs, const void* ws,
                                const void* bias, void* out, int M, int N,
                                int K, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  auto x8 = static_cast<const signed char*>(xq);
  auto w8 = static_cast<const signed char*>(wq);
  auto xsf = static_cast<const float*>(xs);
  auto wsf = static_cast<const float*>(ws);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<__nv_bfloat16*>(out);
  if (vec)
    gemm_int8_kernel<true><<<grid, 128, 0, s>>>(x8, w8, xsf, wsf, b, o, M, N,
                                                K, act);
  else
    gemm_int8_kernel<false><<<grid, 128, 0, s>>>(x8, w8, xsf, wsf, b, o, M,
                                                 N, K, act);
  return static_cast<int>(cudaGetLastError());
}
