// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_pallas -> _rmsnorm_kernel). x [M, d] in the model dtype, scale
// [d] in fp32 (layer norms) or the model dtype (exit heads), output in x's
// dtype.
//
// Bound on the H100: bytes. It reads each row once and writes it once, at
// a few flops per element. At decode (M = 4 rows of 512-4096) the bytes
// take well under a microsecond, so what a launch costs is its chain of
// dependent steps: one trip to memory, the reduction, the store.
//
// Design: one pass, in registers. A row is 16-byte vectors (8 bf16 or 4
// fp32 values); thread t of the row's T threads owns vectors t, t + T, ...
// It loads its first 4 vectors of x and of scale up front, without a
// branch (a vector past the row reads the row's last one and a dead row
// the last live one, both masked), so all of them are in flight together,
// and keeps them in registers (a row longer than 4 T vectors reads the
// rest again after the reduction). The thread sums its squares in element
// order (fma), a butterfly of shuffles sums the warp, and the row's warps
// are added in ascending order through shared memory; then each thread
// scales its vectors and stores them. The thread map comes from (d,
// dtype) alone (``rmsnorm_threads_per_row``): T is the fewest warps, a
// power of two up to 512, that hold the row in 4 vectors a thread, and
// rows of fewer than 256 threads share a block. It never depends on M, so
// a row's bits are the same at any M. A pointer that is not 16-byte
// aligned, or a d that is not a multiple of the vector width, takes scalar
// loads and stores in the same element-to-thread map and order, so a
// row's bits do not depend on its alignment either.
#include <stdint.h>

#include "common.cuh"

constexpr int kCache = 4;            // vectors of a row a thread keeps
constexpr int kMaxRowThreads = 512;  // threads a row at most
constexpr int kBlockThreads = 256;   // shorter rows share a block

// Values of x's dtype in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / (int)sizeof(T); }

KERNEL_API int rmsnorm_threads_per_row(int d, int dtype) {
  const int w = dtype == kBF16 ? vec_width<__nv_bfloat16>()
                               : vec_width<float>();
  const int nv = (d + w - 1) / w;
  int t = 32;
  while (t < kMaxRowThreads && t * kCache < nv) t *= 2;
  return t;
}

// Element i of V values of type E packed in 32-bit words.
__device__ __forceinline__ float word_elem(const uint32_t* w, int i, float) {
  return __uint_as_float(w[i]);
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int i,
                                           __nv_bfloat16) {
  const uint32_t x = w[i >> 1];
  return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
}

// Vector j of a row (V values of E from element V * j) as floats. kVec:
// one or two 16-byte loads (8 bytes for a bf16 scale beside fp32 x);
// otherwise element by element, the elements past d as 0.
template <bool kVec, int V, typename E>
__device__ __forceinline__ void load_vec(const E* p, int j, int d,
                                         float (&f)[V]) {
  if constexpr (kVec) {
    constexpr int kWords = V * (int)sizeof(E) / 4;
    uint32_t w[kWords];
    const E* src = p + (size_t)V * j;
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      w[0] = u.x;
      w[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = word_elem(w, i, E());
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = V * j + i;
      f[i] = e < d ? to_f32(p[e]) : 0.f;
    }
  }
}

template <bool kVec, int V, typename T>
__device__ __forceinline__ void store_vec(T* p, int j, int d,
                                          const float (&f)[V]) {
  if constexpr (kVec) {
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < V; ++i) w[i] = __float_as_uint(f[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 2)
        w[i / 2] = (uint32_t)__bfloat16_as_ushort(from_f32<T>(f[i])) |
                   ((uint32_t)__bfloat16_as_ushort(from_f32<T>(f[i + 1]))
                    << 16);
    }
    *reinterpret_cast<uint4*>(p + (size_t)V * j) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int e = V * j + i;
      if (e < d) p[e] = from_f32<T>(f[i]);
    }
  }
}

// The sum of squares of vector j's elements, added in element order; a
// vector past the row (j >= nv) or an element past d adds 0 * 0 (ss
// unchanged).
template <bool kVec, int V>
__device__ __forceinline__ float add_squares(const float (&f)[V], int j,
                                             int nv, int d, float ss) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float e = j < nv && (kVec || V * j + i < d) ? f[i] : 0.f;
    ss = __fmaf_rn(e, e, ss);
  }
  return ss;
}

template <int V>
__device__ __forceinline__ void normalize(float (&f)[V], const float (&s)[V],
                                          float r) {
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = f[i] * r * s[i];
}

// Block (T, R): R rows of T threads; grid ceil(M / R).
template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kMaxRowThreads)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ out, int m, int d, float eps) {
  constexpr int V = vec_width<T>();
  __shared__ float part[kMaxRowThreads / 32];
  const int tpr = blockDim.x, t = threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < m;
  const int nv = (d + V - 1) / V;
  // every thread loads its kCache vectors of x and scale unconditionally
  // (a dead row reads row m - 1, a vector past the row the last one, both
  // masked below), so the loads carry no branch and are all in flight
  // before the first is used
  const T* xr = x + (size_t)(live ? row : m - 1) * d;
  T* orow = out + (size_t)row * d;

  float xv[kCache][V], sv[kCache][V];
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int j = min(t + tpr * i, nv - 1);
    load_vec<kVec>(xr, j, d, xv[i]);
    load_vec<kVec>(scale, j, d, sv[i]);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kCache; ++i)
    ss = add_squares<kVec>(xv[i], t + tpr * i, nv, d, ss);
  // a row longer than kCache * tpr vectors: the rest, read here and again
  // for the store
  for (int j = t + tpr * kCache; live && j < nv; j += tpr) {
    float f[V];
    load_vec<kVec>(xr, j, d, f);
    ss = add_squares<kVec>(f, j, nv, d, ss);
  }
  ss = warp_sum(ss);
  if (tpr > 32) {                  // the row's warps, in ascending order
    const int nw = tpr / 32, base = threadIdx.y * nw;
    if ((t & 31) == 0) part[base + t / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < nw; ++w) ss += part[base + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < kCache; ++i) {
    const int j = t + tpr * i;
    if (j < nv) {
      normalize(xv[i], sv[i], r);
      store_vec<kVec>(orow, j, d, xv[i]);
    }
  }
  for (int j = t + tpr * kCache; j < nv; j += tpr) {
    float f[V], s[V];
    load_vec<kVec>(xr, j, d, f);
    load_vec<kVec>(scale, j, d, s);
    normalize(f, s, r);
    store_vec<kVec>(orow, j, d, f);
  }
}

template <typename T, typename S>
static void launch(const void* x, const void* scale, void* out, int m, int d,
                   float eps, int tpr, cudaStream_t s) {
  const int rows = tpr >= kBlockThreads ? 1 : kBlockThreads / tpr;
  const dim3 block(tpr, rows), grid((m + rows - 1) / rows);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (d % vec_width<T>() == 0 && aligned(x) && aligned(scale) &&
      aligned(out))
    rmsnorm_kernel<T, S, true><<<grid, block, 0, s>>>(xp, sp, op, m, d, eps);
  else
    rmsnorm_kernel<T, S, false><<<grid, block, 0, s>>>(xp, sp, op, m, d, eps);
}

KERNEL_API int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int m, int d, float eps, int dtype,
                              int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = rmsnorm_threads_per_row(d, dtype);
  if (dtype == kBF16) {
    if (scale_dtype == kBF16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, m, d, eps, tpr, s);
    else
      launch<__nv_bfloat16, float>(x, scale, out, m, d, eps, tpr, s);
  } else {
    if (scale_dtype == kBF16)
      launch<float, __nv_bfloat16>(x, scale, out, m, d, eps, tpr, s);
    else
      launch<float, float>(x, scale, out, m, d, eps, tpr, s);
  }
  return static_cast<int>(cudaGetLastError());
}
