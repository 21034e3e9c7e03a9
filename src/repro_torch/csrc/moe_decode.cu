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
// top-6 of 64 experts, ~20 experts x 17.3 MB a layer at full width; top-2
// of 16 experts of 4096 x 14336, ~5 x 352 MB). The TPU kernel's point
// carries over: only touched experts' panels are read. There is no host
// sync: every block reads the routing itself.
//
// Design: three kernels on the caller's stream.
//   1. up: a block per (touched expert, tile of hidden columns). Grid y is
//      min(E, B * K) expert slots; block y finds the y-th touched expert in
//      ascending order (a bitmap of the experts with a live assignment in
//      shared memory, a warp's prefix count over it) and returns at once
//      if there is none; warp 0 then lists the expert's assignments with a
//      nonzero gate, ascending a = b * K + j, by ballots. Up to 4 of them
//      at a time, it streams the [d, tile] panels of Wg_e and Wu_e through
//      a ring of 4 stages of 64 rows (cp.async, 16 bytes a thread, zero
//      past d), each stage carrying the matching 64 values of the 4 rows of
//      x beside the weights, and writes hidden[a, c] = silu(x Wg)[c] * (x
//      Wu)[c], fp32, to a scratch [B * K, h] buffer.
//   2. down: the same over (touched expert, tile of output columns) with
//      Wd_e and the fp32 hidden rows (fp32 FMAs: rounding them to bf16 or
//      TF32 for the tensor cores would break the fp32 tolerance):
//      tok[a, c] = hidden[a] . Wd_e[:, c], to a scratch [B * K, d] buffer.
//   3. combine: out[b] = sum_j gate[b, j] * tok[b * K + j], j = 0 .. K-1 in
//      order (the JAX ref's order); a zero gate adds nothing.
// A tile is kCH = 8 chunks of 16 bytes a row: 64 columns of bf16 (32 of
// fp32) in both passes, whatever (d, h); ``moe_plan`` in
// kernels/moe_decode/ops.py counts its tiles. At every served shape the
// touched experts' tiles fill the card, so d is never split.
//
// Within a block, thread t takes chunk t % kCH of each panel row and the
// rows k = t / kCH + (256 / kCH) i: one fmaf chain a (row, column) over its
// k ascending; the chains of a column are added by a fixed butterfly
// inside the warp and then in warp order through shared memory. So an
// assignment's sums go in one order fixed by the plan, whatever other
// assignments share its expert or its block: row b of a launch is bitwise
// the same at any batch size; the serve engine's token equality with the
// one-request loop rests on this. No split across blocks, no atomics on
// values.
#include <stdint.h>

#include "common.cuh"

namespace moe {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxRows = 4;         // assignments a block computes at once
constexpr int kMaxAssign = 2048;    // B * K a launch may carry
constexpr int kMaxExperts = 1024;   // E a launch may carry (the bitmap)
constexpr int kStages = 4, kRows = 64;  // ring stages, panel rows a stage
constexpr int kCH = 8;              // 16-byte chunks a tile row

// bytes of one ring stage: NMAT panels of kRows x kCH chunks, and kRows
// values of each of kMaxRows input rows
template <int NMAT, typename TX>
__host__ __device__ constexpr int stage_bytes() {
  return NMAT * kRows * kCH * 16 + kMaxRows * kRows * (int)sizeof(TX);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// The expert of this block's slot (blockIdx.y: the slot-th expert with a
// live assignment, ascending) and its live assignments, ascending, in
// `list`; returns their count, 0 if the slot has no expert.
__device__ int find_assignments(const int* __restrict__ idx,
                                const float* __restrict__ gate, int BK,
                                int E, unsigned* mask, int* list,
                                int* sh, int& expert_out) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int nw = (E + 31) / 32, slot = blockIdx.y;
  for (int i = tid; i < nw; i += kThreads) mask[i] = 0u;
  __syncthreads();
  for (int a = tid; a < BK; a += kThreads) {
    const int e = idx[a];
    if (gate[a] != 0.f && e >= 0 && e < E)
      atomicOr(&mask[e >> 5], 1u << (e & 31));
  }
  __syncthreads();
  if (tid < 32) {
    int expert = -1, base = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const unsigned word = w0 + lane < nw ? mask[w0 + lane] : 0u;
      const int c = __popc(word);
      int incl = c;  // inclusive prefix count of the touched experts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int want = slot - base, excl = incl - c;
      if (want >= excl && want < incl) {
        unsigned wd = word;
        for (int i = 0; i < want - excl; ++i) wd &= wd - 1;
        expert = (w0 + lane) * 32 + __ffs(wd) - 1;
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    expert = __reduce_max_sync(0xffffffffu, expert);
    int n = 0;
    if (expert >= 0) {
      for (int a0 = 0; a0 < BK; a0 += 32) {
        const int a = a0 + lane;
        const bool hit = a < BK && idx[a] == expert && gate[a] != 0.f;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) list[n + __popc(bal & ((1u << lane) - 1u))] = a;
        n += __popc(bal);
      }
    }
    if (lane == 0) {
      sh[0] = expert;
      sh[1] = n;
    }
  }
  __syncthreads();
  expert_out = sh[0];
  return sh[1];
}

// One pass over the touched experts' panels. UP: xin = x [B, d] (row of
// assignment a: a / K), panels w0 = Wg, w1 = Wu [E, d, h], out = hidden
// [B * K, h] = silu(x Wg) * (x Wu). Else: xin = hidden [B * K, h] (row a),
// panel w0 = Wd [E, h, d], out = tok [B * K, d]. len: the reduction length
// (d or h); ncols: the panel's columns (h or d).
template <typename TW, typename TX, bool UP>
__global__ void __launch_bounds__(kThreads, 2)
    moe_pass_kernel(const TX* __restrict__ xin, const int* __restrict__ idx,
                    const float* __restrict__ gate,
                    const TW* __restrict__ w0, const TW* __restrict__ w1,
                    float* __restrict__ out, int BK, int K, int E, int len,
                    int ncols) {
  constexpr int NMAT = UP ? 2 : 1;
  constexpr int EL = 16 / sizeof(TW);       // panel values a chunk
  constexpr int TN = kCH * EL;              // columns a tile
  constexpr int KL = kThreads / kCH;        // threads along k
  constexpr int RPT = kRows / KL;           // rows a thread a stage
  constexpr int XCH = kRows * sizeof(TX) / 16;  // chunks of an x slice
  constexpr int SB = stage_bytes<NMAT, TX>();
  constexpr int PANEL = kRows * kCH * 16;   // bytes of a panel a stage
  static_assert(kRows % KL == 0, "a stage's rows split evenly");
  static_assert(kWarps * NMAT * kMaxRows * TN * 4 <= kStages * SB,
                "the warp partials fit in the ring");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ unsigned mask[kMaxExperts / 32];
  __shared__ int list[kMaxAssign];
  __shared__ int sh[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int expert;
  const int n = find_assignments(idx, gate, BK, E, mask, list, sh, expert);
  if (n == 0) return;                      // no weight is read
  const int col0 = blockIdx.x * TN;
  const TW* we0 = w0 + (size_t)expert * len * ncols;
  const TW* we1 = UP ? w1 + (size_t)expert * len * ncols : nullptr;
  const int c = tid % kCH, kl = tid / kCH;
  const int nk = (len + kRows - 1) / kRows;
  float* red = reinterpret_cast<float*>(ring);  // [warp][mat][row][col]

  for (int a0 = 0; a0 < n; a0 += kMaxRows) {
    const int nr = min(kMaxRows, n - a0);
    auto load = [&](int t) {
      unsigned char* st = ring + (t % kStages) * SB;
      const int k0 = t * kRows;
#pragma unroll
      for (int i = tid; i < NMAT * kRows * kCH; i += kThreads) {
        const int mat = i / (kRows * kCH), r = (i / kCH) % kRows,
                  cc = i % kCH;
        const int k = k0 + r, col = col0 + cc * EL;
        const bool ok = k < len && col < ncols;
        const TW* src = (mat ? we1 : we0) + (ok ? (size_t)k * ncols + col : 0);
        cp_async16(st + i * 16, src, ok);
      }
      for (int i = tid; i < nr * XCH; i += kThreads) {
        const int r = i / XCH, cc = i % XCH;
        const int a = list[a0 + r], k = k0 + cc * (16 / (int)sizeof(TX));
        const TX* row = xin + (size_t)(UP ? a / K : a) * len;
        cp_async16(st + NMAT * PANEL + (r * XCH + cc) * 16,
                   row + (k < len ? k : 0), k < len);
      }
    };

    float acc[NMAT][kMaxRows][EL];
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[m][r][e] = 0.f;

    __syncthreads();  // the ring (and `red`) of the previous rows is free
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
      const unsigned char* st = ring + (t % kStages) * SB;
      const TX* xs = reinterpret_cast<const TX*>(st + NMAT * PANEL);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int k = kl + j * KL;
        float wv[NMAT][EL];
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
          unpack(*reinterpret_cast<const uint4*>(st + m * PANEL +
                                                 (k * kCH + c) * 16),
                 wv[m]);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            const float xv = to_f32(xs[r * kRows + k]);
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
#pragma unroll
              for (int e = 0; e < EL; ++e)
                acc[m][r][e] = fmaf(xv, wv[m][e], acc[m][r][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every stage consumed: the ring holds `red` now

    // the chains of a column: lanes l, l ^ kCH, ... of the warp, then warps
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nr) continue;
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          float v = acc[m][r][e];
#pragma unroll
          for (int o = kCH; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane < kCH)
            red[((warp * NMAT + m) * kMaxRows + r) * TN + c * EL + e] = v;
        }
    }
    __syncthreads();
    for (int o = tid; o < nr * TN; o += kThreads) {
      const int r = o / TN, cc = o % TN, col = col0 + cc;
      if (col >= ncols) continue;
      float s[NMAT];
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        s[m] = red[(m * kMaxRows + r) * TN + cc];
        for (int w = 1; w < kWarps; ++w)
          s[m] += red[((w * NMAT + m) * kMaxRows + r) * TN + cc];
      }
      const float v = UP ? s[0] / (1.f + expf(-s[0])) * s[NMAT - 1] : s[0];
      out[(size_t)list[a0 + r] * ncols + col] = v;
    }
  }
}

// A thread a column of one row; grid (columns / 256, B). Each thread loads
// its row's K token values (8 at a time, all in flight together) before
// it adds them in j order.
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const int* __restrict__ idx,
                       const float* __restrict__ gate,
                       const float* __restrict__ tok, float* __restrict__ out,
                       int K, int E, int d) {
  const int b = blockIdx.y, c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int j0 = 0; j0 < K; j0 += 8) {
    float g[8], t[8];
    bool live[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = b * K + j0 + j, e = j0 + j < K ? idx[a] : -1;
      g[j] = j0 + j < K ? gate[a] : 0.f;
      // a zero gate (a dead slot) or an expert outside [0, E) adds
      // nothing: its token row was never computed (read, not used)
      live[j] = g[j] != 0.f && e >= 0 && e < E;
      t[j] = j0 + j < K ? tok[(size_t)a * d + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (live[j]) acc = __fadd_rn(acc, __fmul_rn(g[j], t[j]));
  }
  out[(size_t)b * d + c] = acc;
}

template <typename TW, typename TX, bool UP>
static int pass(const TX* xin, const int* idx, const float* gate,
                const TW* w0, const TW* w1, float* out, int BK, int K, int E,
                int len, int ncols, cudaStream_t s) {
  auto kern = moe_pass_kernel<TW, TX, UP>;
  constexpr int smem = kStages * stage_bytes<UP ? 2 : 1, TX>();
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  constexpr int TN = kCH * 16 / (int)sizeof(TW);
  const int slots = E < BK ? E : BK;
  kern<<<dim3((ncols + TN - 1) / TN, slots), kThreads, smem, s>>>(
      xin, idx, gate, w0, w1, out, BK, K, E, len, ncols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* x, const int* idx, const float* gate,
                  const void* wg, const void* wu, const void* wd,
                  float* hidden, float* tok, float* out, int B, int K, int E,
                  int d, int h, cudaStream_t s) {
  const int BK = B * K;
  auto xt = static_cast<const T*>(x);
  auto g = static_cast<const T*>(wg), u = static_cast<const T*>(wu),
       dn = static_cast<const T*>(wd);
  int rc = pass<T, T, true>(xt, idx, gate, g, u, hidden, BK, K, E, d, h, s);
  if (rc) return rc;
  rc = pass<T, float, false>(hidden, idx, gate, dn, nullptr, tok, BK, K, E,
                             h, d, s);
  if (rc) return rc;
  moe_combine_kernel<<<dim3((d + kThreads - 1) / kThreads, B), kThreads, 0,
                       s>>>(idx, gate, tok, out, K, E, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe

KERNEL_API int moe_decode_max_assignments() { return moe::kMaxAssign; }
KERNEL_API int moe_decode_max_experts() { return moe::kMaxExperts; }

// x [B, d] and the expert panels in `dtype` (0 fp32, 1 bf16); hidden fp32
// [B * K, h] and tok fp32 [B * K, d] scratch; out fp32 [B, d]. d and h
// multiples of 8, every pointer 16-byte aligned.
KERNEL_API int moe_decode_launch(const void* x, const void* idx,
                                 const void* gate, const void* wg,
                                 const void* wu, const void* wd, void* hidden,
                                 void* tok, void* out, int B, int K, int E,
                                 int d, int h, int dtype, void* stream) {
  if (d % 8 || h % 8 || B * K > moe::kMaxAssign || E > moe::kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(idx);
  auto g = static_cast<const float*>(gate);
  auto hd = static_cast<float*>(hidden);
  auto tk = static_cast<float*>(tok);
  auto o = static_cast<float*>(out);
  if (dtype == kBF16)
    return moe::launch<__nv_bfloat16>(x, i, g, wg, wu, wd, hd, tk, o, B, K,
                                      E, d, h, s);
  return moe::launch<float>(x, i, g, wg, wu, wd, hd, tk, o, B, K, E, d, h,
                            s);
}
