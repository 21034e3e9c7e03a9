// Mamba selective scan (prefill): for every sequence b and channel d,
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t      (h: N fp32)
//   y_t = sum_n h_t[n] * C_t[n] + D[d] * u_t
// over t = 0 .. T-1, returning y [B, T, Din] in u's dtype and the final
// state h_T [B, Din, N] fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/ssm_scan.py
// (selective_scan_pallas -> _ssm_kernel). Same contract: u, dt [B, T, Din]
// and B, C [B, T, N] in the model dtype, A [Din, N] fp32, D [Din] fp32, an
// optional h0 [B, Din, N] fp32 (zeros when absent).
//
// Bound on the H100: each layer's prefill reads u, dt and writes y once
// (3 * T * Din values) plus the fp32 state and A, ~7.4 MB at T = 120, Din =
// 8192 in bf16 (~2.2 us at 3.35 TB/s), and does ~9 * T * Din * N fp32
// operations (~2.1 us at 67 TFLOP/s; the exp runs on the SFU). The
// recurrence is sequential in T and its accurate exp takes 8 instructions:
// what bounds the kernel is the instructions issued a step and how many
// independent chains hide their latency.
//
// Design: the state is spread over lanes. A thread owns kNPer = 4 of a
// channel's N state values (four threads a channel), with its h and A in
// registers through the whole time loop: at B = 1, Din = 8192 that is
// 32768 threads instead of 8192 (two values a thread, twice the threads,
// was no faster on the card, one slower). A block of 32 channels walks t
// in chunks of 16 steps with one barrier a chunk: iteration k stages chunk
// k + 1's u, dt (coalesced across channels), B_t and C_t by 16-byte
// cp.async (a ring of three chunks), then runs chunk k's recurrence and
// chunk k - 1's sums. T is not padded: the last chunk is short. A group
// of 8 steps' inputs is read from shared memory before any of them runs:
// the h_t stores to shared memory would otherwise hold each next read
// back. The recurrence writes every h_t to shared memory (float4 slots
// swizzled by channel: no bank conflict on either side; two chunks'
// worth); one thread a (t, channel) then sums n = 0 .. N-1 from 0 in the
// fixed order, adds D u and stores y, coalesced across channels. The
// arithmetic is written out with intrinsics as the previous kernel's compiler
// contracted it (dt u rounded once; fma(exp(dt a), h, (dt u) B); fma(h, C,
// acc); fma(D, u, acc)), so y and h_T keep that kernel's bits, and a
// step's arithmetic does not depend on where the chunk boundaries fall: a
// scan of T1 tokens then T2 tokens with the state carried gives bitwise
// the scan of T1 + T2. Accurate expf; no fast-math.
#include <stdint.h>

#include "common.cuh"

constexpr int N = 16;                    // d_state (Jamba's)
constexpr int kNPer = 4;                 // state values a thread: a float4
constexpr int kLanes = N / kNPer;        // threads a channel
constexpr int kChannels = 32;            // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 16;               // time steps a chunk
constexpr int kGroup = 8;                // steps whose inputs load together

static_assert(N == 16 && kNPer == 4,
              "h_t is staged as four float4 slots a channel");

template <typename T>
struct Stage {                           // one chunk's inputs, as read
  alignas(16) T u[kChunk][kChannels];
  alignas(16) T dt[kChunk][kChannels];
  alignas(16) T b[kChunk][N];
  alignas(16) T c[kChunk][N];
};

// a step's inputs: dt, u and this thread's B values, as floats
struct StepIn {
  float dt, u, b[kNPer];
};

// The float4 slot of h_t[4 j .. 4 j + 3] of channel c: slots rotate with c
// so that both the recurrence's stores and the sum's float4 loads of a
// quarter warp fall on distinct banks.
__device__ __forceinline__ int slot(int c, int j) {
  return j ^ ((c >> 1) & 3);
}

// K = 4 or 8 consecutive values at p (aligned to K values), as floats
template <int K>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}
template <int K>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (K == 8) {                // one 16-byte load
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(w[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_chunk(Stage<T>& st, const T* u,
                                            const T* dt, const T* Bm,
                                            const T* Cm, size_t row0,
                                            int nt, int d0, int Din) {
  constexpr int kVec = 16 / sizeof(T);             // values a 16-byte copy
  constexpr int kRowVecs = kChannels / kVec;       // copies a u / dt row
  constexpr int kStateVecs = N / kVec;             // copies a B / C row
  constexpr int kUV = kChunk * kRowVecs, kBC = kChunk * kStateVecs;
  // compile-time trip count and divisors: no integer division at run time
#pragma unroll
  for (int i0 = 0; i0 < 2 * kUV + 2 * kBC; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (i < 2 * kUV) {
      const int which = i / kUV, k = i % kUV;
      const int tt = k / kRowVecs, v = k % kRowVecs;
      const int dd = d0 + v * kVec;
      const T* src = which ? dt : u;
      T* dst = which ? &st.dt[tt][v * kVec] : &st.u[tt][v * kVec];
      const bool in = dd < Din;
      if (tt < nt)
        cp_async16(dst, in ? src + (row0 + tt) * Din + dd : src, in);
    } else if (i < 2 * kUV + 2 * kBC) {
      const int k = i - 2 * kUV;
      const int which = k / kBC, kk = k % kBC;
      const int tt = kk / kStateVecs, v = kk % kStateVecs;
      if (tt < nt)
        cp_async16(which ? &st.c[tt][v * kVec] : &st.b[tt][v * kVec],
                   (which ? Cm : Bm) + (row0 + tt) * N + v * kVec, true);
    }
  }
}

// Shared memory of a block: three stages of inputs (chunk k + 1 lands
// while chunk k runs its recurrence and chunk k - 1 its sums) and two
// chunks of h_t (the recurrence writes one while the sums read the other).
template <typename T>
struct Smem {
  Stage<T> stage[3];
  float4 hs[2][kChunk][kChannels][N / 4];   // h_t, swizzled slots
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hT, int Tlen, int Din) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = tid / kLanes, q = tid % kLanes;     // recurrence: (c, q)
  const int d = d0 + c;
  const bool on = d < Din;
  const size_t row0 = (size_t)b * Tlen;             // row of (b, t = 0)
  const int nchunks = (Tlen + kChunk - 1) / kChunk;

  if (nchunks > 0) {
    stage_chunk(sm.stage[0], u, dt, Bm, Cm, row0, min(kChunk, Tlen), d0,
                Din);
    cp_async_commit();
  }
  float a[kNPer], h[kNPer];
  const size_t off = ((size_t)(on ? d : 0)) * N + q * kNPer;
  load_vals<kNPer>(A + off, a);
  if (h0 != nullptr) {
    load_vals<kNPer>(h0 + (size_t)b * Din * N + off, h);
  }
#pragma unroll
  for (int e = 0; e < kNPer; ++e) {
    if (!on) a[e] = 0.f;
    if (!on || h0 == nullptr) h[e] = 0.f;
  }
  // where this thread's h_t go in a chunk of hs: its slot, at its offset
  const int hoff = (c * (N / 4) + slot(c, q * kNPer / 4)) * 4
                   + (q * kNPer) % 4;
  // the sum's thread: channel cy, steps ty, ty + kThreads / kChannels, ...
  const int cy = tid % kChannels, ty = tid / kChannels;
  const bool on_y = d0 + cy < Din;
  const float dskip = on_y ? D[d0 + cy] : 0.f;

  // iteration k: the recurrence of chunk k and the sums of chunk k - 1,
  // after one barrier
  for (int k = 0; k <= nchunks; ++k) {
    cp_async_wait<0>();
    __syncthreads();   // chunk k staged, chunk k - 1's h_t written, the
                       // buffers of chunk k - 2 read
    if (k + 1 < nchunks) {
      const int t1 = (k + 1) * kChunk;
      stage_chunk(sm.stage[(k + 1) % 3], u, dt, Bm, Cm, row0 + t1,
                  min(kChunk, Tlen - t1), d0, Din);
      cp_async_commit();
    }
    if (k < nchunks) {
      const Stage<T>& st = sm.stage[k % 3];
      float* const hk = reinterpret_cast<float*>(&sm.hs[k & 1][0][0][0])
                        + hoff;
      const int nt = min(kChunk, Tlen - k * kChunk);
      auto load = [&](int tt) {
        StepIn in;
        in.dt = to_f32(st.dt[tt][c]);
        in.u = to_f32(st.u[tt][c]);
        load_vals<kNPer>(&st.b[tt][q * kNPer], in.b);
        return in;
      };
      auto step = [&](int tt, const StepIn& in) {
        const float dtu = __fmul_rn(in.dt, in.u);
#pragma unroll
        for (int e = 0; e < kNPer; ++e) {
          const float da = expf(__fmul_rn(in.dt, a[e]));
          h[e] = __fmaf_rn(da, h[e], __fmul_rn(dtu, in.b[e]));
        }
        float* hp = hk + tt * (kChannels * N);
        *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
      };
      // the shared-memory stores of h_t keep the compiler from moving later
      // loads above them: a group's inputs are all loaded first
      if (nt == kChunk) {
#pragma unroll
        for (int g0 = 0; g0 < kChunk; g0 += kGroup) {
          StepIn in[kGroup];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) in[i] = load(g0 + i);
#pragma unroll
          for (int i = 0; i < kGroup; ++i) step(g0 + i, in[i]);
        }
      } else {
        for (int tt = 0; tt < nt; ++tt) step(tt, load(tt));
      }
    }
    if (k >= 1 && on_y) {
      const int kp = k - 1, t0 = kp * kChunk;
      const int nt = min(kChunk, Tlen - t0);
      const Stage<T>& st = sm.stage[kp % 3];
      for (int tt = ty; tt < nt; tt += kThreads / kChannels) {
        float cv[N];
        load_vals<N / 2>(&st.c[tt][0], cv);
        load_vals<N / 2>(&st.c[tt][N / 2], cv + N / 2);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          const float4 hv = sm.hs[kp & 1][tt][cy][slot(cy, j)];
          acc = __fmaf_rn(hv.x, cv[4 * j], acc);
          acc = __fmaf_rn(hv.y, cv[4 * j + 1], acc);
          acc = __fmaf_rn(hv.z, cv[4 * j + 2], acc);
          acc = __fmaf_rn(hv.w, cv[4 * j + 3], acc);
        }
        const float uv = to_f32(st.u[tt][cy]);
        y[(row0 + t0 + tt) * Din + d0 + cy] =
            from_f32<T>(__fmaf_rn(dskip, uv, acc));
      }
    }
  }
  if (on) {
    float* hp = hT + ((size_t)b * Din + d) * N + q * kNPer;
    *reinterpret_cast<float4*>(hp) = make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <typename T>
static int launch(const void* u, const void* dt, const float* A,
                  const void* Bm, const void* Cm, const float* D,
                  const float* h0, void* y, float* hT, int B, int Tlen,
                  int Din, cudaStream_t s) {
  if (Din % (16 / (int)sizeof(T))) return (int)cudaErrorInvalidValue;
  auto kern = ssm_scan_kernel<T>;
  static bool attr = false;  // once per instance
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem<T>));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((Din + kChannels - 1) / kChannels, B);
  kern<<<grid, kThreads, sizeof(Smem<T>), s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, h0,
      static_cast<T*>(y), hT, Tlen, Din);
  return (int)cudaGetLastError();
}

KERNEL_API int ssm_scan_launch(const void* u, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* hT, int B,
                               int Tlen, int Din, int n_state, int dtype,
                               void* stream) {
  if (n_state != N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(A);
  auto dd = static_cast<const float*>(D);
  auto h = static_cast<const float*>(h0);
  auto ht = static_cast<float*>(hT);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(u, dt, a, Bm, Cm, dd, h, y, ht, B, Tlen,
                                 Din, s);
  return launch<float>(u, dt, a, Bm, Cm, dd, h, y, ht, B, Tlen, Din, s);
}
