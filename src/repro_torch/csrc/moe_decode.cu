// Dropless MoE decode: out[b] = sum_j gate[b, j] * SwiGLU_e(x[b]), e =
// expert_idx[b, j], SwiGLU_e(x) = (silu(x Wg_e) * (x Wu_e)) Wd_e, fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_decode/moe_decode.py
// (moe_decode_pallas -> _moe_kernel). Same contract: x [B, d] in the model
// dtype, expert_idx [B, K] int32, gate [B, K] fp32, w_gate / w_up [E, d, h]
// and w_down [E, h, d] in x's dtype; fp32 output [B, d].
//
// Bound on the H100: decode MoE does ~6 flops per expert weight it reads,
// far below the ~295 flops/byte where the tensor cores limit, so it is
// bound by the bytes of the experts that received an assignment (at B = 4,
// top-6 of 64 experts, ~21 experts x 17.3 MB a layer at full width). The
// TPU kernel's point carries over: only touched experts' panels are read.
// There is no host sync: every block reads the routing itself.
//
// Design: three kernels on the caller's stream.
//   1. up: one block per (expert e, tile of 64 hidden columns). The block
//      lists the assignments (b, j) routed to e with a nonzero gate
//      (ascending b * K + j); a block whose expert has none returns before
//      reading any weight. It stages up to 4 of them in shared memory and
//      streams the [d, 64] panel slices of Wg_e and Wu_e once for all of
//      them: hidden[a, c] = silu(x Wg)[c] * (x Wu)[c], fp32, to a scratch
//      [B * K, h] buffer.
//   2. down: the same over (expert, tile of 64 output columns) with Wd_e:
//      tok[a, c] = hidden[a] . Wd_e[:, c], to a scratch [B * K, d] buffer.
//      The hidden rows are staged kHChunk columns at a time (at Jamba's h =
//      14336 four whole rows would need 224 KiB of shared memory, past
//      what a block may have beside the static arrays); each warp keeps its
//      sums in registers across the chunks, in the same order.
//   3. combine: out[b] = sum_j gate[b, j] * tok[b * K + j], j = 0 .. K-1 in
//      order (the JAX ref's order); a zero gate adds nothing.
//
// Batch invariance: an assignment's dot products reduce over d (and h) in
// one fixed order — warp w sums rows w, w + 8, w + 16, ... and the 8 warp
// partials are added in warp order — whatever other assignments share its
// expert or its block. No split-K across blocks, no atomics. Row b of a
// launch is therefore bitwise the same at any batch size; the serve
// engine's token equality with the one-request loop rests on this.
#include <stdint.h>

#include "common.cuh"

constexpr int kThreads = 256, kWarps = kThreads / 32, kTile = 64;
constexpr int kMaxRows = 4;         // assignments a block computes at once
constexpr int kMaxAssign = 2048;    // B * K a launch may carry
// hidden columns the down pass stages in shared memory at a time: a
// multiple of kWarps, so row k stays on warp k % 8 across the chunks
// (4 x 2048 fp32 = 32 KiB beside 16 KiB of static shared memory)
constexpr int kHChunk = 2048;
static_assert(kHChunk % kWarps == 0, "a chunk must keep row k on warp k % 8");

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

// The assignments routed to expert e with a nonzero gate, ascending.
__device__ int collect(const int* __restrict__ idx,
                       const float* __restrict__ gate, int BK, int e,
                       int* list, int* count) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int a = 0; a < BK; ++a)
      if (idx[a] == e && gate[a] != 0.f) list[n++] = a;
    *count = n;
  }
  __syncthreads();
  return *count;
}

// Accumulates the partial products of up to kMaxRows input rows with the
// [len, n_cols] panel `w` at columns col0 .. col0 + 63, over the panel
// rows k0 .. k1 - 1, into the caller's registers: warp w takes rows k
// with k % 8 == w (k0 must be a multiple of 8), lane l columns col0 + 2l
// and + 2l + 1. The rows are staged in `in` (row r at in[r * stride + k -
// k0]). Called over consecutive chunks of k, each acc[r][c] adds its
// products in the one order k = w, w + 8, ... whatever the chunking.
template <typename T>
__device__ __forceinline__ void panel_accumulate(const float* in, int stride,
                                                 int k0, int k1, int nr,
                                                 const T* __restrict__ w,
                                                 int n_cols, int col0,
                                                 float (&acc)[kMaxRows][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = col0 + 2 * lane;
  if (c >= n_cols) return;
#pragma unroll 4
  for (int k = k0 + warp; k < k1; k += kWarps) {
    float w0, w1;
    load2(w + (size_t)k * n_cols + c, w0, w1);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nr) {
        const float xv = in[r * stride + k - k0];
        acc[r][0] = fmaf(xv, w0, acc[r][0]);
        acc[r][1] = fmaf(xv, w1, acc[r][1]);
      }
    }
  }
}

// Leaves each warp's partial sums in red[warp][row][column].
__device__ __forceinline__ void store_partials(
    const float (&acc)[kMaxRows][2], float (*red)[kMaxRows][kTile]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    red[warp][r][2 * lane] = acc[r][0];
    red[warp][r][2 * lane + 1] = acc[r][1];
  }
}

// Partial products of the rows staged in `in` (row stride `len`) with the
// whole [len, n_cols] panel, left in red[warp][row][column].
template <typename T>
__device__ __forceinline__ void panel_partials(const float* in, int len,
                                               int nr, const T* __restrict__ w,
                                               int n_cols, int col0,
                                               float (*red)[kMaxRows][kTile]) {
  float acc[kMaxRows][2];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  panel_accumulate(in, len, 0, len, nr, w, n_cols, col0, acc);
  store_partials(acc, red);
}

// The warp partials of (row r, tile column c), added in warp order.
__device__ __forceinline__ float warp_ordered_sum(float (*red)[kMaxRows][kTile],
                                                  int r, int c) {
  float s = red[0][r][c];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w][r][c];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_up_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ gate, const T* __restrict__ wg,
                  const T* __restrict__ wu, float* __restrict__ hidden,
                  int BK, int K, int d, int h) {
  extern __shared__ float xs[];                     // [kMaxRows, d]
  __shared__ int list[kMaxAssign];
  __shared__ int count;
  __shared__ float red_g[kWarps][kMaxRows][kTile];
  __shared__ float red_u[kWarps][kMaxRows][kTile];
  const int e = blockIdx.y, col0 = blockIdx.x * kTile;
  const int n = collect(idx, gate, BK, e, list, &count);
  if (n == 0) return;                               // no weight is read
  const T* wge = wg + (size_t)e * d * h;
  const T* wue = wu + (size_t)e * d * h;
  for (int a0 = 0; a0 < n; a0 += kMaxRows) {
    const int nr = min(kMaxRows, n - a0);
    __syncthreads();                                // xs / red reusable
    for (int i = threadIdx.x; i < nr * d; i += kThreads) {
      const int r = i / d, k = i % d;
      xs[i] = to_f32(x[(size_t)(list[a0 + r] / K) * d + k]);
    }
    __syncthreads();
    panel_partials(xs, d, nr, wge, h, col0, red_g);
    panel_partials(xs, d, nr, wue, h, col0, red_u);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      if (col0 + c < h) {
        const float g = warp_ordered_sum(red_g, r, c);
        const float u = warp_ordered_sum(red_u, r, c);
        hidden[(size_t)list[a0 + r] * h + col0 + c] =
            g / (1.f + expf(-g)) * u;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const int* __restrict__ idx,
                    const float* __restrict__ gate,
                    const float* __restrict__ hidden,
                    const T* __restrict__ wd, float* __restrict__ tok, int BK,
                    int d, int h) {
  extern __shared__ float hs[];                     // [kMaxRows, kHChunk]
  __shared__ int list[kMaxAssign];
  __shared__ int count;
  __shared__ float red[kWarps][kMaxRows][kTile];
  const int e = blockIdx.y, col0 = blockIdx.x * kTile;
  const int n = collect(idx, gate, BK, e, list, &count);
  if (n == 0) return;
  const T* wde = wd + (size_t)e * h * d;
  const int hc = min(h, kHChunk);
  for (int a0 = 0; a0 < n; a0 += kMaxRows) {
    const int nr = min(kMaxRows, n - a0);
    float acc[kMaxRows][2];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r][0] = acc[r][1] = 0.f;
    // the hidden rows pass through shared memory kHChunk columns at a
    // time; the accumulators stay in registers across the chunks
    for (int k0 = 0; k0 < h; k0 += hc) {
      const int k1 = min(h, k0 + hc), len = k1 - k0;
      __syncthreads();                              // hs / red reusable
      for (int i = threadIdx.x; i < nr * len; i += kThreads) {
        const int r = i / len, k = i % len;
        hs[r * hc + k] = hidden[(size_t)list[a0 + r] * h + k0 + k];
      }
      __syncthreads();
      panel_accumulate(hs, hc, k0, k1, nr, wde, d, col0, acc);
    }
    store_partials(acc, red);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      if (col0 + c < d)
        tok[(size_t)list[a0 + r] * d + col0 + c] = warp_ordered_sum(red, r, c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const int* __restrict__ idx,
                       const float* __restrict__ gate,
                       const float* __restrict__ tok, float* __restrict__ out,
                       int K, int E, int d) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const int a = b * K + j, e = idx[a];
      const float g = gate[a];
      // a zero gate (a dead slot) or an expert outside [0, E) adds nothing:
      // its token row was never computed
      if (g != 0.f && e >= 0 && e < E)
        acc = __fadd_rn(acc, __fmul_rn(g, tok[(size_t)a * d + c]));
    }
    out[(size_t)b * d + c] = acc;
  }
}

template <typename T>
static int launch(const void* x, const int* idx, const float* gate,
                  const void* wg, const void* wu, const void* wd,
                  float* hidden, float* tok, float* out, int B, int K, int E,
                  int d, int h, cudaStream_t s) {
  const size_t up_smem = sizeof(float) * kMaxRows * d;
  const size_t down_smem =
      sizeof(float) * kMaxRows * (h < kHChunk ? h : kHChunk);
  cudaError_t err = cudaFuncSetAttribute(
      moe_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)up_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(moe_down_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)down_smem);
  if (err != cudaSuccess) return (int)err;
  const int BK = B * K;
  moe_up_kernel<T><<<dim3((h + kTile - 1) / kTile, E), kThreads, up_smem, s>>>(
      static_cast<const T*>(x), idx, gate, static_cast<const T*>(wg),
      static_cast<const T*>(wu), hidden, BK, K, d, h);
  moe_down_kernel<T><<<dim3((d + kTile - 1) / kTile, E), kThreads, down_smem,
                       s>>>(idx, gate, hidden, static_cast<const T*>(wd), tok,
                            BK, d, h);
  moe_combine_kernel<<<B, kThreads, 0, s>>>(idx, gate, tok, out, K, E, d);
  return (int)cudaGetLastError();
}

KERNEL_API int moe_decode_max_assignments() { return kMaxAssign; }

KERNEL_API int moe_decode_launch(const void* x, const void* idx,
                                 const void* gate, const void* wg,
                                 const void* wu, const void* wd, void* hidden,
                                 void* tok, void* out, int B, int K, int E,
                                 int d, int h, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(idx);
  auto g = static_cast<const float*>(gate);
  auto hd = static_cast<float*>(hidden);
  auto tk = static_cast<float*>(tok);
  auto o = static_cast<float*>(out);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, i, g, wg, wu, wd, hd, tk, o, B, K, E, d,
                                 h, s);
  return launch<float>(x, i, g, wg, wu, wd, hd, tk, o, B, K, E, d, h, s);
}
