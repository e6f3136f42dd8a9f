// Building blocks of the flash-attention kernels: the forward
// (flash_attention_fwd.cu) and, for their bias and types, the two backward
// kernels (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu). Their
// tensor-core products come from tile_logits_tc.cuh.
//
// The additive bias is read in place through its own strides (0 on an axis
// it broadcasts over): nothing of size [Lq, Lk] is ever made in device
// memory. Keys past Lk score -inf, so they weigh exactly 0; masked keys carry
// the bias's own -1e9.

#pragma once

#include "tile_logits.cuh"

namespace care_flash {

using care::from_f32;
using care::round_as;
using care::to_f32;

// the running maximum starts here (the NEG_INF of the TPU kernel), not at
// -inf: a row whose keys all carry the -1e9 mask then gets the weights the
// dense softmax gives it
constexpr float MASKED = -1e9f;

struct BiasRef {
  const float* p;           // null: no bias
  long long sb, sh, sq, sk; // strides in elements over (batch, head, query, key)
};

// N consecutive elements of shared memory as f32, as wide as alignment
// allows (the start is N elements aligned, N a power of two)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      x[u] = v.x; x[u + 1] = v.y; x[u + 2] = v.z; x[u + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N % 2 == 0) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int u = 0; u < N / 2; ++u) {
      const float2 v = __bfloat1622float2(p2[u]);
      x[2 * u] = v.x; x[2 * u + 1] = v.y;
    }
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

}  // namespace care_flash
