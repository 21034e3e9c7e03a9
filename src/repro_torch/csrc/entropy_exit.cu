// Normalized softmax entropy per row: H(softmax(logits)) / log(V), fp32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/entropy_exit/entropy_exit.py (entropy_pallas ->
// _entropy_kernel): the early-exit confidence check. logits [M, V] in the
// model dtype, output fp32 [M].
//
// Bound on the H100: bytes. The logits are read once (512 KB at yi-9b's
// [4, 64000] bf16: 0.15 us at 3.35 TB/s); one exp per element is far below
// the card's arithmetic rate. At decode M is the number of live slots, so
// what a launch costs is its chain of dependent steps: one trip to memory,
// the reductions, the store.
//
// Design. A row is split over a thread-block cluster of c blocks (grid
// c * M, cluster (c, 1, 1)). Block r of a cluster takes one contiguous span
// of the row's 16-byte vectors (8 bf16 or 4 fp32 values); thread t of the
// block takes vectors t, t + 256, ... of the span. The plan comes from (V,
// dtype) alone, never from M (``entropy_cluster_blocks``,
// ``entropy_loads_per_thread``): c is the fewest blocks, up to 8, that leave
// each thread at most 2 vectors, and K (4 or 8) the loads a thread issues
// in a pass. yi-9b's [4, 64000] bf16 runs 32 blocks of 4 loads a thread.
// A thread issues the K loads of a pass before any arithmetic, without a
// branch (a vector past the span reads the span's last one again and is
// masked), as streaming loads: the logits are read once. Then its max over
// the pass, with no branch per element, and one pass of s = sum exp(x - m)
// and u = sum exp(x - m) x: one accurate expf an element. The triples (m, s,
// u) are merged by rescaling to the larger m, in one fixed order: a
// butterfly of shuffles in each warp, the 8 warps through shared memory (a
// butterfly over lanes 0-7 of warp 0), then the cluster's blocks: each
// block pushes its triple into slot r of rank 0's shared memory with one
// st.async (distributed shared memory), which completes on an mbarrier of
// rank 0, and rank 0's warp 0 merges the slots, lane r holding rank r, by
// the same butterfly. The mbarrier is initialised before a cluster barrier
// that every thread arrives at before its loads and waits on after its
// block's merge, so the barrier's latency hides behind the loads; a cluster
// barrier with release semantics around the merge instead (a GPU-wide
// memory barrier, then an L1 invalidation) took 3.40 us a launch on the
// H100 at [4, 64000] bf16, against 2.85.
// No global scratch and no atomics: one launch, which a CUDA graph
// captures as it is. H = m + log s - u / s, over log V.
// The max drops a NaN (fmaxf), so a NaN reaches its row's result through s
// and u; rows read nothing of each other, so a row's bits depend neither
// on M nor on another row's values. An input that is not 16-byte aligned,
// or a V that is not a multiple of the vector width, takes scalar loads in
// the same element map and order, so its bits equal its aligned copy's.
// Every product-sum is written as an explicit fma, so both instances round
// alike. Accurate expf and logf; no fast-math.
#include <cooperative_groups.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kTarget = 2;        // vectors a thread before a row takes a
                                  // block more

// Values of the logits' dtype in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / (int)sizeof(T); }

static int row_vectors(int v, int dtype) {
  const int w = dtype == kBF16 ? vec_width<__nv_bfloat16>()
                               : vec_width<float>();
  return (v + w - 1) / w;
}

KERNEL_API int entropy_cluster_blocks(int v, int dtype) {
  const int per = kThreads * kTarget;
  const int c = (row_vectors(v, dtype) + per - 1) / per;
  return c < 1 ? 1 : c > kMaxCluster ? kMaxCluster : c;
}

// The vectors of a row that each block of its cluster takes (the last
// block's may be fewer).
static int block_span(int v, int dtype) {
  const int c = entropy_cluster_blocks(v, dtype);
  return (row_vectors(v, dtype) + c - 1) / c;
}

KERNEL_API int entropy_loads_per_thread(int v, int dtype) {
  return block_span(v, dtype) <= 4 * kThreads ? 4 : 8;
}

struct Triple {
  float m, s, u;
};

__device__ __forceinline__ Triple empty() { return {-INFINITY, 0.f, 0.f}; }

// The triple of the union of a's and b's elements, rescaled to the larger
// m. An empty triple is (-inf, 0, 0). m is never NaN (fmaxf drops NaN), and
// a NaN in s or u survives any scale (NaN * 0 = NaN). The scales' exponents
// are selected (0 where a.m is the larger, so -inf - -inf never arises), not
// their expf: a select of an expf compiles to a branch around it.
__device__ __forceinline__ Triple merge(Triple a, Triple b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = expf(a.m == m ? 0.f : a.m - m);
  const float fb = expf(b.m == m ? 0.f : b.m - m);
  return {m, __fmaf_rn(a.s, fa, b.s * fb), __fmaf_rn(a.u, fa, b.u * fb)};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address in rank 0's shared memory of this block's shared address a.
__device__ __forceinline__ unsigned rank0_addr(unsigned a) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(r) : "r"(a));
  return r;
}

// Butterfly over groups of kLanes lanes: lane 0 ends with its group's
// merge, in an order fixed by the lanes alone. Every lane of the warp
// takes part.
template <int kLanes>
__device__ __forceinline__ Triple warp_merge(Triple t) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const Triple b = {__shfl_xor_sync(0xffffffffu, t.m, o),
                      __shfl_xor_sync(0xffffffffu, t.s, o),
                      __shfl_xor_sync(0xffffffffu, t.u, o)};
    t = merge(t, b);
  }
  return t;
}

__device__ __forceinline__ float load_stream(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float load_stream(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// Vector j of a row (W values of T from element W * j) as floats: one
// 16-byte streaming load, or W scalar ones (an element past V reads
// element V - 1; the caller masks it).
template <bool kVec, int W, typename T>
__device__ __forceinline__ void load_vec(const T* row, int j, int V,
                                         float (&f)[W]) {
  if constexpr (kVec) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row) + j);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (W == 4)
        f[i] = __uint_as_float(w[i]);
      else
        f[i] = __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                       : (w[i >> 1] << 16));
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      f[i] = load_stream(row + min(W * j + i, V - 1));
  }
}

// Grid c * M (rows on x, so M is not held to 65535), clusters of c blocks:
// a cluster a row; span = block_span(V, dtype).
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    entropy_kernel(const T* __restrict__ logits, float* __restrict__ out,
                   int V, int c, int span, float log_v) {
  constexpr int W = vec_width<T>();
  __shared__ Triple warps[kWarps];
  __shared__ alignas(16) float4 slots[kMaxCluster];  // rank 0's: (m, s, u)
  __shared__ alignas(8) unsigned long long bar;      // rank 0's: the slots
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / c;
  const T* x = logits + row * V;
  const int nv = (V + W - 1) / W;
  const int v0 = rank * span;
  const int v1 = min(nv, v0 + span);    // this block's vectors: [v0, v1)
  const int last = max(v1 - 1, 0);
  if (rank == 0 && tid == 0) {   // one phase: the other c - 1 slots' bytes
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bar)) : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(&bar)), "r"(16 * (c - 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();

  Triple t = empty();
  for (int j0 = v0 + tid; j0 < v1; j0 += K * kThreads) {
    float f[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k)
      load_vec<kVec>(x, min(j0 + k * kThreads, last), V, f[k]);
    // element i of load k: in this block's span and in the row
    const auto live = [&](int k, int i) {
      const int j = j0 + k * kThreads;
      return j < v1 && (kVec || W * j + i < V);
    };
    // a masked element becomes -inf: it adds nothing to the max, and its
    // expf is 0 with no branch around it (a select of the expf would be one)
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (!live(k, i)) f[k][i] = -INFINITY;
        m = fmaxf(m, f[k][i]);
      }
    // every live element NaN (or none): exponents against 0, so a NaN
    // still reaches s and u
    const float mb = m == -INFINITY ? 0.f : m;
    float s = 0.f, u = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float e = expf(f[k][i] - mb);
        s += e;
        u = __fmaf_rn(e, live(k, i) ? f[k][i] : 0.f, u);
      }
    t = merge(t, {m, s, u});
  }

  t = warp_merge<32>(t);
  if (lane == 0) warps[tid >> 5] = t;
  __syncthreads();
  if (tid < 32) t = warp_merge<kWarps>(lane < kWarps ? warps[lane] : empty());
  cluster_wait();                      // rank 0's mbarrier is initialised
  if (tid >= 32) return;
  if (rank != 0) {
    if (lane == 0)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
          "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
              rank0_addr(smem_u32(&slots[rank]))),
          "f"(t.m), "f"(t.s), "f"(t.u), "f"(0.f),
          "r"(rank0_addr(smem_u32(&bar))) : "memory");
    return;
  }
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(&bar)) : "memory");
  Triple q = empty();
  if (lane == 0)
    q = t;
  else if (lane < c)
    q = {slots[lane].x, slots[lane].y, slots[lane].z};
  t = warp_merge<kMaxCluster>(q);
  if (lane == 0) out[row] = (t.m + logf(t.s) - t.u / t.s) / log_v;
}

template <typename T, int K>
static cudaError_t launch(const void* logits, void* out, int m, int v,
                          float log_v, int c, int span, cudaStream_t s) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * m);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const T* x = static_cast<const T*>(logits);
  float* o = static_cast<float*>(out);
  if (v % vec_width<T>() == 0 &&
      reinterpret_cast<uintptr_t>(logits) % 16 == 0)
    return cudaLaunchKernelEx(&cfg, entropy_kernel<T, K, true>, x, o, v, c,
                              span, log_v);
  return cudaLaunchKernelEx(&cfg, entropy_kernel<T, K, false>, x, o, v, c,
                            span, log_v);
}

template <typename T>
static cudaError_t launch_k(const void* logits, void* out, int m, int v,
                            float log_v, int c, int span, int k,
                            cudaStream_t s) {
  return k == 4 ? launch<T, 4>(logits, out, m, v, log_v, c, span, s)
                : launch<T, 8>(logits, out, m, v, log_v, c, span, s);
}

KERNEL_API int entropy_launch(const void* logits, void* out, int m, int v,
                              float log_v, int dtype, void* stream) {
  const int c = entropy_cluster_blocks(v, dtype);
  const int span = block_span(v, dtype);
  const int k = entropy_loads_per_thread(v, dtype);
  if ((long long)c * m > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == kBF16
          ? launch_k<__nv_bfloat16>(logits, out, m, v, log_v, c, span, k, s)
          : launch_k<float>(logits, out, m, v, log_v, c, span, k, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
