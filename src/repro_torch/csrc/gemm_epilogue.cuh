// The activations of the fused GEMMs' epilogues (csrc/gemm.cu,
// csrc/gemm_int8.cu), in fp32: the JAX package's ACTIVATIONS
// (kernels/gemm/ref.py), gelu in its tanh form as jax.nn.gelu.
#pragma once

#include <math.h>

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case kSilu:
      return v / (1.f + expf(-v));
    default:
      return v;
  }
}
