// mLSTM decode step: one token of the matrix-LSTM cell for every sequence b
// and head, all fp32:
//   m' = max(lf + m, li);  f = exp(lf + m - m');  i = exp(li - m')
//   C'[r, j] = f C[r, j] + i (k[r] v[j]);   n'[r] = f n[r] + i k[r]
//   h[j]     = (sum_r q[r] C'[r, j]) / max(|q . n'|, exp(-m'))
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_decode/ssm_decode.py
// (mlstm_decode_pallas -> _mlstm_kernel), the mLSTM mode of the ssm_decode
// op. Same contract: q, k, v [B, H, dh]; li, lf, m [B, H]; C [B, H, dh, dh];
// n [B, H, dh]; returns h [B, H, dh] and (C', n', m'). C' may be C itself
// (the cell updated in place: each element of C is read, then C' written,
// by one thread, so neither pointer is __restrict__); n' and m' are new
// tensors, since other blocks read n and m while the first writes them.
//
// Bound on the H100: bytes. C is read once and C' written once, 2 * B * H
// * dh^2 * 4 bytes (33.6 MB at B = H = 4, dh = 512: 10 us at 3.35 TB/s);
// the ~5 * B * H * dh^2 operations are far below the compute bound.
//
// Design. The Pallas grid is (B,): one program holds a row's whole [H, dh, dh]
// cell, which fits a TPU's VMEM at dh <= 128 but is 4 MiB at xlstm-350m's dh =
// 512. Here the grid is (column block of 128, row quarter, b * H + head): 4 x 4
// x 16 = 256 blocks of 256 threads at the serving shape, all resident at once
// (~2 an SM). The four row quarters of a column block form a thread-block
// cluster. A warp spans a column block (a thread owns 4 neighbouring columns:
// the warp reads 512 contiguous bytes of a row) and the block's 8 warps are row
// groups; a block walks its 128 rows in passes of 32, each thread's 4 rows of C
// loaded with streaming loads (C and C' are touched once) before it reads its
// gates and, in the cluster's first block, reduces q . n'. Each element of C is
// read and C' written by one thread, once, as fma(f, c, i * (k[r] * v[j])) and
// n' as fma(f, n, i * k), written out: nvcc contracts f * c + i * (k * v) so in
// one schedule and as fma(i, k * v, f * c) in another, and the state's bits
// must not follow the schedule. h[j] is summed over r in one fixed order: in
// the thread by ascending row, then the 8 row groups in ascending order through
// shared memory, then the four quarters in cluster-rank order, read by the
// first block from the others' shared memory (distributed shared memory); no
// atomics. A block publishes its sums (a cluster barrier with release
// semantics) before it stores its last pass of C', so the release does not wait
// for those stores. The first block of a cluster computes the dh-long q . n' in
// a fixed order (thread strides, a butterfly in each warp, the 8 warps in
// order), and the first column block writes n' and m'. The plan depends on dh
// alone; a row b reads nothing of another, so row b of a launch is bitwise the
// same at any batch size. Accurate expf; no fast-math.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kColThreads = 32;           // a warp across columns
constexpr int kCols = 4 * kColThreads;    // 128 columns a block
constexpr int kRowGroups = kThreads / kColThreads;  // 8
constexpr int kSplit = 4;                 // row quarters: blocks a cluster
constexpr int kUnroll = 4;                // rows of C a thread reads a pass
constexpr int kPass = kRowGroups * kUnroll;  // 32 rows a pass of a block

__global__ void __cluster_dims__(1, kSplit, 1) __launch_bounds__(kThreads, 4)
    mlstm_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ li,
                        const float* __restrict__ lf,
                        const float* __restrict__ m,
                        const float* C, const float* __restrict__ n,
                        float* __restrict__ h, float* C_new,
                        float* __restrict__ n_new,
                        float* __restrict__ m_new, int dh) {
  __shared__ float part[kThreads / 32];
  __shared__ float red[kRowGroups][kCols];
  __shared__ float colsum[kCols];   // this quarter's column sums
  __shared__ float kq[2][kPass];    // k and q of a pass's rows
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int quarter = (int)cluster.block_rank();
  const size_t bh = blockIdx.z;
  const int rows = dh / kSplit;
  const int r0 = quarter * rows;
  const int cg_ = tid % kColThreads, rg = tid / kColThreads;
  const int j = blockIdx.x * kCols + 4 * cg_;
  const bool col = j < dh;
  const float* cb = C + (bh * dh + r0) * dh + j;
  float* cn = C_new + (bh * dh + r0) * dh + j;

  // the first pass's rows of C, before anything else
  float4 c[kUnroll];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + rg + kRowGroups * u;
      if (col && r < rows)
        c[u] = __ldcs(reinterpret_cast<const float4*>(cb + (size_t)r * dh));
    }
  };
  load(0);

  const float m_old = m[bh], lfv = lf[bh], liv = li[bh];
  const float mn = fmaxf(lfv + m_old, liv);
  const float fw = expf(lfv + m_old - mn);
  const float iw = expf(liv - mn);
  const float* qv = q + bh * dh;
  const float* kv = k + bh * dh;

  // the cluster's first block: q . n' in one fixed order (the same in
  // every column block of this head)
  const float* nv = n + bh * dh;
  float denom = 0.f;
  if (quarter == 0) {
    float dot = 0.f;
    for (int r = tid; r < dh; r += kThreads)
      dot += qv[r] * __fmaf_rn(fw, nv[r], iw * kv[r]);
    dot = warp_sum(dot);
    if ((tid & 31) == 0) part[tid >> 5] = dot;
    __syncthreads();
    float qn = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) qn += part[w];
    denom = fmaxf(fabsf(qn), expf(-mn));
  }

  // C' (in place of C in registers) and the partial column sums of q^T C'
  // over this thread's rows; a pass's C' is stored before the next pass's
  // C is loaded, the last pass's once this block's sums are published
  const float4 vj = col ? *reinterpret_cast<const float4*>(v + bh * dh + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  auto store = [&](int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + rg + kRowGroups * u;
      if (col && r < rows)
        __stcs(reinterpret_cast<float4*>(cn + (size_t)r * dh), c[u]);
    }
  };
  int base = 0;
  for (;;) {
    __syncthreads();                      // the last pass is done with kq
    if (tid < kPass) {
      const int r = base + tid;
      kq[0][tid] = r < rows ? kv[r0 + r] : 0.f;
      kq[1][tid] = r < rows ? qv[r0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = rg + kRowGroups * u;
      if (col && base + rr < rows) {
        const float kr = kq[0][rr], qr = kq[1][rr];
        float4& o = c[u];
        o.x = __fmaf_rn(fw, o.x, iw * (kr * vj.x));
        o.y = __fmaf_rn(fw, o.y, iw * (kr * vj.y));
        o.z = __fmaf_rn(fw, o.z, iw * (kr * vj.z));
        o.w = __fmaf_rn(fw, o.w, iw * (kr * vj.w));
        acc[0] += qr * o.x;
        acc[1] += qr * o.y;
        acc[2] += qr * o.z;
        acc[3] += qr * o.w;
      }
    }
    if (base + kPass >= rows) break;
    store(base);
    base += kPass;
    load(base);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[rg][4 * cg_ + e] = acc[e];
  __syncthreads();
  if (tid < kCols) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) s += red[g][tid];
    colsum[tid] = s;
  }
  // publish the sums before the last pass's stores: the release waits for
  // this thread's earlier memory operations, and those stores follow it
  cluster_arrive_release();
  store(base);
  if (quarter == 0 && blockIdx.x == 0) {  // n' and m', once per (b, head)
    for (int r = tid; r < dh; r += kThreads)
      n_new[bh * dh + r] = __fmaf_rn(fw, nv[r], iw * kv[r]);
    if (tid == 0) m_new[bh] = mn;
  }
  cluster_wait();                         // every quarter's sums published
  if (quarter == 0 && tid < kCols) {
    const int jj = blockIdx.x * kCols + tid;
    if (jj < dh) {
      float s = 0.f;
#pragma unroll
      for (int rk = 0; rk < kSplit; ++rk)
        s += cluster.map_shared_rank(&colsum[0], rk)[tid];
      h[bh * dh + jj] = s / denom;
    }
  }
  // the others' shared memory outlives the first block's reads (their
  // values are consumed before it arrives: no fence needed)
  cluster_arrive_relaxed();
  cluster_wait();
}

KERNEL_API int mlstm_decode_launch(const void* q, const void* k,
                                   const void* v, const void* li,
                                   const void* lf, const void* m,
                                   const void* C, const void* n, void* h,
                                   void* C_new, void* n_new, void* m_new,
                                   int B, int H, int dh, void* stream) {
  if (dh % 4) return (int)cudaErrorInvalidValue;   // 16-byte row pieces
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const dim3 grid((dh + kCols - 1) / kCols, kSplit, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlstm_decode_kernel<<<grid, kThreads, 0, s>>>(
      f(q), f(k), f(v), f(li), f(lf), f(m), f(C), f(n), o(h), o(C_new),
      o(n_new), o(m_new), dh);
  return (int)cudaGetLastError();
}
