// Device helpers shared by the fused LSTM kernels (fused_lstm_fwd.cu,
// fused_lstm_bwd.cu, fused_lstm_sparse.cu): the cell's activations and
// their derivatives, the recurrent-input quantizer, bf16 rounding, and
// the reductions that give the quantizer its per-step scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { ACT_TANH = 0, ACT_RELU = 1, ACT_HTANH = 2, ACT_LINEAR = 3 };

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case ACT_TANH: return tanhf(x);
    case ACT_RELU: return fmaxf(x, 0.f);
    case ACT_HTANH: return fminf(fmaxf(x, -1.f), 1.f);
    default: return x;
  }
}

// act'(x) from y = act(x)
__device__ __forceinline__ float dact_out(float y, int act) {
  switch (act) {
    case ACT_TANH: return 1.f - y * y;
    case ACT_RELU: return y > 0.f ? 1.f : 0.f;
    case ACT_HTANH: return (y > -1.f && y < 1.f) ? 1.f : 0.f;
    default: return 1.f;
  }
}

// act'(x) from x
__device__ __forceinline__ float dact_pre(float x, int act) {
  if (act == ACT_TANH) {
    const float t = tanhf(x);
    return 1.f - t * t;
  }
  return dact_out(x, act);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ceil(|x| / var * scale) / scale * var * sign(x); identity when var == 0
__device__ __forceinline__ float quant(float x, float var, float scale) {
  if (var == 0.f) return x;
  float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return ceilf(fabsf(x) / var * scale) / scale * var * s;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float load_w(const void* w, size_t i) {
  return BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
              : static_cast<const float*>(w)[i];
}

// *out = max(*out, max |x|) over n values, as float bits (the bit pattern
// of a non-negative float orders like its value).
__global__ void absmax_bits(const float* __restrict__ x, int n,
                            unsigned* __restrict__ out) {
  unsigned m = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    m = max(m, __float_as_uint(fabsf(x[i])));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(out, m);
}

// slots[t] = max |x[t]| over each step's n values (grid.y = steps).
__global__ void absmax_steps(const float* __restrict__ x, int n,
                             unsigned* __restrict__ slots) {
  const float* xt = x + (size_t)blockIdx.y * n;
  unsigned m = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    m = max(m, __float_as_uint(fabsf(xt[i])));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(slots + blockIdx.y, m);
}

}  // namespace
