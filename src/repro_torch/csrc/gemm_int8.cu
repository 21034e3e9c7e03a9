// W8A8 GEMM with the activations' quantization fused in:
//   xq[m] = clamp(rint(x[m] / xs[m]), -127, 127),
//   xs[m] = max(amax |x[m]|, 1e-8) / 127,
//   out = act((float(xq @ wq) * xs[m]) * ws[n] (+ bias[n])),
// int32 accumulation: one kernel at decode (at most 16 rows), two beyond.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gemm/gemm.py
// (gemm_int8_pallas -> _gemm_int8_kernel) together with the per-row
// quantization the JAX op runs before it (kernels/gemm/ops.py
// gemm_int8_pallas_op -> quantize_int8). Contract: x [M, K] bf16 (the
// serving activations, quantized here), wq [K, N] int8 (the serving
// weights' int8 tiles, or a weight quantized per column by the wrapper),
// ws [N] fp32 scales, optional bias [N] fp32, activation in {none, relu,
// gelu (tanh form), silu}, output bf16.
//
// Bound on the H100: at decode (M = the slot count) the product reads each
// weight byte once for 2 M integer operations, far below the ~590
// operations a byte at which int8 tensor cores (1979 TOP/s) overtake the
// memory (3.35 TB/s): the bytes of wq bound it, half those of the bf16
// GEMM. So the design streams wq from many blocks at once and keeps the
// activations' work off the path:
//
// * Tiles. A block is 4 warps over BN (64 or 128) columns of w, one K
//   range of `kc` rows and 16 rows of x (M tiles are adjacent blocks, so a
//   prefill reads each weight tile from DRAM once). The plan (bn, kc,
//   parts) comes from ``int8_plan`` in kernels/gemm/ops.py: a function of
//   (N, K) alone, never of M.
// * Weights stream through a ring of 4 stages of 8 KB in dynamic shared
//   memory, filled by cp.async 16 bytes a thread (zero past K and N) and
//   XOR-swizzled at 16-byte granularity so that ldmatrix's 8 row addresses
//   fall in distinct banks.
// * Products: mma.sync m16n8k32 (s8 in, s32 accumulate) with w^T as the A
//   operand (16 columns of w a fragment) and x^T as B (8 rows of x; at
//   decode only the live rows are non-zero). mma wants 4 consecutive k of
//   one column in a register, but w is [K, N] with N contiguous and
//   ldmatrix .trans moves 16-bit pairs only: ldmatrix.x4.trans of the
//   bytes hands a lane (k, 2g), (k, 2g + 1), (k + 1, 2g), (k + 1, 2g + 1)
//   for k = 2q, 2q + 8, 2q + 16, 2q + 24, and two __byte_perm a pair of
//   registers make column 2g and column 2g + 1 of k = 2q, 2q + 1, 2q + 8,
//   2q + 9. So A row r of a 16-column subtile is column 2 r (r < 8) or 2 (r
//   - 8) + 1, and the K positions inside each 16 are permuted: the
//   quantized x is written to shared memory in that same order (word q of
//   a 16-byte group holds k = 2q, 2q + 1, 2q + 8, 2q + 9), so a plain
//   32-bit load gives each B fragment. Integer sums are exact, so the
//   permutation changes no bit.
// * Activation quantization, the block's prologue: while the first stages
//   of w are in flight, each warp takes rows of the block and reduces
//   |x| over the WHOLE row (bf16 bit patterns with the sign cleared,
//   unsigned 16-bit max: exact), scale = __fdiv_rn(fmaxf(amax, 1e-8f),
//   127.f); then the block quantizes its own K range, q =
//   clamp(rintf(__fdiv_rn(x, scale)), -127, 127) (round half to even):
//   the numbers of ``quantize_int8`` (kernels/gemm/ref.py), bit for bit.
//   Every block of a row computes the same scale. No PyTorch op runs on x.
//   Beyond one M tile of 16 rows (a prefill) every column tile would
//   repeat that work for all the rows, so there a first kernel quantizes
//   each row once, with the same arithmetic, and the blocks copy their
//   range of it: one launch a call at decode, two at prefill.
// * Split K: where `parts` > 1, each block adds its int32 partial sums to
//   a [M, N] scratch with integer atomics (exact in any order), and the
//   last block of a tile to arrive (one counter a tile) reads the sums,
//   runs the epilogue, and zeroes the scratch and its counter again: one
//   launch a call.
//
// Exactness: the integer sums are exact in any order and every row is
// quantized by itself, so a row's result never depends on the batch, the
// plan or the order the blocks ran in. The epilogue keeps JAX's order,
// (acc * xs) * ws + bias, with JAX's roundings as XLA compiles them: each
// product rounded on its own (__fmul_rn, never contracted), and with a
// bias the second product and the sum one fused multiply-add (__fmaf_rn;
// XLA contracts "out * ws + b" alike). So the output equals the plain
// version (kernels/gemm/ref.py gemm_w8a8_ref) bitwise for none / relu and
// to the activation's own rounding (expf, tanhf) for silu / gelu, for
// finite x. Ragged M/N/K edges are zero filled in the loads and masked in
// the stores.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "gemm_epilogue.cuh"
#include "mma.cuh"

namespace i8 {

constexpr int kThreads = 128, kStages = 4, kMT = 16;
constexpr int kStageBytes = 8192;  // bytes of w a ring stage
constexpr int kMaxKc = 8192;       // K rows a block (``int8_plan``)
// the largest dynamic shared memory a launch asks for: the ring and 16
// rows of quantized x over kMaxKc (+ 16 bytes of padding a row)
constexpr int kMaxSmem = kStages * kStageBytes + kMT * (kMaxKc + 16);

// The 16-byte chunk of row r where logical chunk c lives, for rows of CH
// chunks: 8 consecutive rows at one chunk fall in distinct banks.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8) return c ^ (r & 7);
  if constexpr (CH == 4) return c ^ ((r >> 1) & 3);
  return c;
}

// c += a (16 x 32, row) * b (32 x 8, col): s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of w at (k, n), byte by byte, zero past N (the ragged path).
__device__ __forceinline__ uint4 load16(const signed char* w, int k, int n,
                                        int N) {
  signed char t[16];
#pragma unroll
  for (int e = 0; e < 16; ++e)
    t[e] = n + e < N ? w[(size_t)k * N + n + e] : (signed char)0;
  uint4 u;
  memcpy(&u, t, sizeof(u));
  return u;
}

// This thread's part of max |x| over row xr [K], elements i0, i0 +
// stride, ... (VEC: 8 at a time), as two bf16 bit patterns a word with
// the sign cleared: ordered as the values they encode.
template <bool VEC>
__device__ __forceinline__ unsigned absmax_part(const unsigned short* xr,
                                                int K, int i0, int stride) {
  unsigned mx = 0;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
#pragma unroll 16
    for (int c = i0; c < K / 8; c += stride) {
      const uint4 u = __ldg(xv + c);
      mx = __vmaxu2(mx, __vmaxu2(__vmaxu2(u.x & 0x7fff7fffu,
                                          u.y & 0x7fff7fffu),
                                 __vmaxu2(u.z & 0x7fff7fffu,
                                          u.w & 0x7fff7fffu)));
    }
  } else {
    for (int k = i0; k < K; k += stride) mx = max(mx, xr[k] & 0x7fffu);
  }
  return max(mx & 0xffffu, mx >> 16);
}

// The row's scale from the bits of its max |x|: max(amax, 1e-8) / 127.
__device__ __forceinline__ float row_scale(unsigned amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits << 16), 1e-8f), 127.f);
}

__device__ __forceinline__ unsigned quantize(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// 16 values of x from p (the first `valid` of them; zero past), quantized
// in the B fragments' order: word j holds k = 2j, 2j + 1, 2j + 8, 2j + 9.
template <bool VEC>
__device__ __forceinline__ uint4 quantize16(const unsigned short* p,
                                            int valid, float sc) {
  unsigned short v[16];
  if (VEC && valid >= 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    memcpy(v, &a, 16);
    memcpy(v + 8, &b, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = e < valid ? p[e] : 0;
  }
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e[4] = {2 * j, 2 * j + 1, 2 * j + 8, 2 * j + 9};
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      word |= quantize(__uint_as_float((unsigned)v[e[b]] << 16), sc)
              << (8 * b);
    o[j] = word;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Beyond one M tile (a prefill), the rows are quantized once, here, not
// by every block: one block a row, its scale to xs[m] and the row to
// xq[m] [Kp] (Kp: K rounded up to 16, zero past K) in quantize16's order.
template <bool VEC>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const unsigned short* __restrict__ x,
                         unsigned char* __restrict__ xq,
                         float* __restrict__ xs, int K, int Kp) {
  __shared__ unsigned red[8];
  __shared__ float sc;
  const int m = blockIdx.x, tid = threadIdx.x;
  const unsigned short* xr = x + (size_t)m * K;
  const unsigned mx = __reduce_max_sync(
      0xffffffffu, absmax_part<VEC>(xr, K, tid, 256));
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    unsigned v = red[0];
    for (int i = 1; i < 8; ++i) v = max(v, red[i]);
    sc = row_scale(v);
    xs[m] = sc;
  }
  __syncthreads();
  for (int kl = tid * 16; kl < Kp; kl += 256 * 16)
    *reinterpret_cast<uint4*>(xq + (size_t)m * Kp + kl) =
        quantize16<VEC>(xr + kl, K - kl, sc);
}

// (acc * xs) * ws (+ b): with a bias, the second product and the sum one
// fused multiply-add, as XLA compiles JAX's "out * ws + b"
__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float xs,
                                                  float ws, bool has_bias,
                                                  float b, int act) {
  float v = __fmul_rn(__int2float_rn(acc), xs);
  v = has_bias ? __fmaf_rn(v, ws, b) : __fmul_rn(v, ws);
  return __float2bfloat16(activate(v, act));
}

// VEC: N and K multiples of 16, x and w 16-byte aligned: w by cp.async, x
// by 16-byte loads; else both element by element. PREQ: the rows come
// quantized (quantize_rows_kernel: xq [M, Kp], xs [M]) and the block
// copies its range; else the block quantizes them itself.
template <int BN, bool VEC, bool PREQ>
__global__ void __launch_bounds__(kThreads)
    gemm_int8_kernel(const unsigned short* __restrict__ x,
                     const signed char* __restrict__ w,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int* __restrict__ part,
                     unsigned* __restrict__ arrived,
                     const unsigned char* __restrict__ xqg,
                     const float* __restrict__ xsg, int M, int N, int K,
                     int kc, int parts, int act) {
  constexpr int BK = kStageBytes / BN;  // K rows a stage: 128 or 64
  constexpr int WCH = BN / 16;          // 16-byte chunks a row of w
  constexpr int NS = BN / 64;           // 16-column subtiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float xscale[kMT];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (N + BN - 1) / BN;
  const int tile = blockIdx.y % tiles, pi = blockIdx.y / tiles;
  const int m0 = blockIdx.x * kMT, n0 = tile * BN, k0 = pi * kc;
  const int mr = min(kMT, M - m0);       // rows of x in this block
  const int klen = min(kc, K - k0);      // K rows of this block's range
  const int nk = (klen + BK - 1) / BK;   // ring stages
  const int xrow = nk * BK + 16;         // padded row of quantized x
  unsigned char* xq = smem + kStages * kStageBytes;

  auto load = [&](int t) {
    unsigned char* st = smem + (t % kStages) * kStageBytes;
    const int kb = t * BK;
#pragma unroll
    for (int i = tid; i < BK * WCH; i += kThreads) {
      const int r = i / WCH, c = i % WCH, k = kb + r, n = n0 + c * 16;
      unsigned char* dst = st + r * BN + swz<WCH>(r, c) * 16;
      const bool ok = k < klen && n < N;
      if constexpr (VEC) {
        cp_async16(dst, w + (ok ? (size_t)(k0 + k) * N + n : 0), ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            ok ? load16(w, k0 + k, n, N) : make_uint4(0, 0, 0, 0);
      }
    }
  };
  const int groups = nk * BK / 16;  // 16-byte groups of a staged x row
  if constexpr (PREQ) {
    // the rows' scales and this block's range of the quantized rows, in
    // the first commit group with stage 0 (zero past Kp; between the
    // range's end and Kp, values that meet zero rows of w)
    const int kp = (K + 15) & ~15;
    if (tid < mr) xscale[tid] = xsg[m0 + tid];
    for (int i = tid; i < mr * groups; i += kThreads) {
      const int r = i / groups, k = k0 + (i % groups) * 16;
      cp_async16(xq + r * xrow + (i % groups) * 16,
                 xqg + (size_t)(m0 + r) * kp + (k < kp ? k : 0), k < kp);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  if constexpr (!PREQ) {
    // 1. each row's scale from |x| over the whole row, a warp a row
    for (int r = warp; r < mr; r += kThreads / 32) {
      const unsigned mx = __reduce_max_sync(
          0xffffffffu,
          absmax_part<VEC>(x + (size_t)(m0 + r) * K, K, lane, 32));
      if (lane == 0) xscale[r] = row_scale(mx);
    }
    __syncthreads();
    // 2. this block's K range of its rows, quantized
    for (int i = tid; i < mr * groups; i += kThreads) {
      const int r = i / groups, kl = (i % groups) * 16;
      *reinterpret_cast<uint4*>(xq + r * xrow + kl) = quantize16<VEC>(
          x + (size_t)(m0 + r) * K + k0 + kl, klen - kl, xscale[r]);
    }
  }

  // 3. the ring: stage t's products while stages t + 1 .. t + 3 land
  int acc[NS][2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][f][e] = 0;
  const bool f1 = mr > 8;  // the second 8-row fragment of x is live
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed (and, at t = 0, the quantized x)
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (t % kStages) * kStageBytes;
    const int kend = min(BK, klen - t * BK);
    for (int kk = 0; kk < kend; kk += 32) {
      const unsigned char* xk = xq + t * BK + kk + 4 * q;
      unsigned b[2][2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = 8 * f + g;
        const bool live = r < mr;
        b[f][0] = live ? *reinterpret_cast<const unsigned*>(xk + r * xrow)
                       : 0u;
        b[f][1] = live ? *reinterpret_cast<const unsigned*>(xk + r * xrow +
                                                             16)
                       : 0u;
      }
      const int row = kk + lane;  // ldmatrix: lane l names row kk + l
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int chunk = warp * NS + s;
        unsigned r4[4];
        ldmatrix_x4_trans(r4, st + row * BN + swz<WCH>(row, chunk) * 16);
        const unsigned a[4] = {__byte_perm(r4[0], r4[1], 0x6420),
                               __byte_perm(r4[0], r4[1], 0x7531),
                               __byte_perm(r4[2], r4[3], 0x6420),
                               __byte_perm(r4[2], r4[3], 0x7531)};
        mma_s8(acc[s][0], a, b[0][0], b[0][1]);
        if (f1) mma_s8(acc[s][1], a, b[1][0], b[1][1]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[s][f][e]: column n0 + 16 (warp NS + s) + 2 g + (e >> 1), row m0 +
  // 8 f + 2 q + (e & 1)
  if (parts == 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 16 * (warp * NS + s) + 2 * g + (e >> 1);
          const int r = 8 * f + 2 * q + (e & 1);
          if (r < mr && n < N)
            out[(size_t)(m0 + r) * N + n] =
                epilogue(acc[s][f][e], xscale[r], ws[n], bias != nullptr,
                         bias ? bias[n] : 0.f, act);
        }
    return;
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * (warp * NS + s) + 2 * g + (e >> 1);
        const int r = 8 * f + 2 * q + (e & 1);
        if (r < mr && n < N)
          atomicAdd(part + (size_t)(m0 + r) * N + n, acc[s][f][e]);
      }
  // the last of the tile's `parts` blocks: the epilogue on the sums, then
  // the scratch and the counter back to zero
  unsigned* cnt = arrived + (size_t)blockIdx.x * tiles + tile;
  __threadfence();  // this block's sums are visible before it counts
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt, 1u) == (unsigned)parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the tile's sums (from L2: other SMs added to them) and scales, all
  // loads in flight together, then the epilogue
  constexpr int PER = kMT * BN / kThreads;
  int v[PER];
  float wsn[PER], bv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * kThreads, r = o / BN, n = n0 + o % BN;
    const bool ok = r < mr && n < N;
    v[i] = ok ? __ldcg(part + (size_t)(m0 + r) * N + n) : 0;
    wsn[i] = ok ? ws[n] : 0.f;
    bv[i] = ok && bias ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int o = tid + i * kThreads, r = o / BN, n = n0 + o % BN;
    if (r < mr && n < N) {
      part[(size_t)(m0 + r) * N + n] = 0;
      out[(size_t)(m0 + r) * N + n] =
          epilogue(v[i], xscale[r], wsn[i], bias != nullptr, bv[i], act);
    }
  }
  if (tid == 0) *cnt = 0;
}

template <int BN, bool VEC, bool PREQ>
static int run_kernel(const void* x, const void* w, const float* ws,
                      const float* bias, void* out, int* part,
                      unsigned* arrived, unsigned char* xq, float* xs, int M,
                      int N, int K, int kc, int parts, int act,
                      cudaStream_t s) {
  auto kern = gemm_int8_kernel<BN, VEC, PREQ>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  constexpr int BK = kStageBytes / BN;
  const int rows = M < kMT ? M : kMT;
  const size_t smem = (size_t)kStages * kStageBytes +
                      (size_t)rows * ((kc + BK - 1) / BK * BK + 16);
  const dim3 grid((M + kMT - 1) / kMT, (N + BN - 1) / BN * parts);
  auto x16 = static_cast<const unsigned short*>(x);
  if constexpr (PREQ) {
    quantize_rows_kernel<VEC><<<M, 256, 0, s>>>(x16, xq, xs, K,
                                                (K + 15) & ~15);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, kThreads, smem, s>>>(
      x16, static_cast<const signed char*>(w), ws, bias,
      static_cast<__nv_bfloat16*>(out), part, arrived, xq, xs, M, N, K, kc,
      parts, act);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool VEC>
static int run(const void* x, const void* w, const float* ws,
               const float* bias, void* out, int* part, unsigned* arrived,
               unsigned char* xq, float* xs, int M, int N, int K, int kc,
               int parts, int act, cudaStream_t s) {
  if (M > kMT)
    return run_kernel<BN, VEC, true>(x, w, ws, bias, out, part, arrived, xq,
                                     xs, M, N, K, kc, parts, act, s);
  return run_kernel<BN, VEC, false>(x, w, ws, bias, out, part, arrived, xq,
                                    xs, M, N, K, kc, parts, act, s);
}

}  // namespace i8

// x bf16 [M, K]; wq int8 [K, N]; ws fp32 [N]; bias fp32 [N] or null; out
// bf16 [M, N]. The plan (bn 64 or 128 columns a block, kc K rows a block
// (a multiple of 8192 / bn, at most 8192), parts = ceil(K / kc)) is
// ``int8_plan``'s for (N, K). When parts > 1: part int32 [M, N] and
// arrived uint32 [ceil(M / 16), ceil(N / bn)], both zero before the launch
// and zero again after it; else both may be null. M <= 16: one kernel,
// which quantizes the rows itself (xq and xs may be null); M > 16: the
// rows are quantized first, into the scratch xq int8 [M, K rounded up to
// 16] and xs fp32 [M], then the GEMM runs: two kernels.
KERNEL_API int gemm_int8_launch(const void* x, const void* wq,
                                const void* ws, const void* bias, void* out,
                                void* part, void* arrived, void* xq,
                                void* xs, int M, int N, int K, int act,
                                int bn, int kc, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bn != 64 && bn != 128) || kc <= 0 || kc > i8::kMaxKc ||
      kc % (i8::kStageBytes / bn) ||
      (long long)kc * parts < K || (long long)kc * (parts - 1) >= K ||
      (M > i8::kMT && (!xq || !xs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  auto wsf = static_cast<const float*>(ws);
  auto b = static_cast<const float*>(bias);
  auto pt = static_cast<int*>(part);
  auto ar = static_cast<unsigned*>(arrived);
  auto xq8 = static_cast<unsigned char*>(xq);
  auto xsf = static_cast<float*>(xs);
  switch (bn * 2 + vec) {
    case 128:
      return i8::run<64, false>(x, wq, wsf, b, out, pt, ar, xq8, xsf, M, N, K, kc,
                                parts, act, s);
    case 129:
      return i8::run<64, true>(x, wq, wsf, b, out, pt, ar, xq8, xsf, M, N, K, kc,
                               parts, act, s);
    case 256:
      return i8::run<128, false>(x, wq, wsf, b, out, pt, ar, xq8, xsf, M, N, K, kc,
                                 parts, act, s);
    case 257:
      return i8::run<128, true>(x, wq, wsf, b, out, pt, ar, xq8, xsf, M, N, K, kc,
                                parts, act, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
