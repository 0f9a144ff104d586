// Device helpers shared by the fused LSTM kernels (fused_lstm_fwd.cu,
// fused_lstm_bwd.cu, fused_lstm_sparse.cu): the cell's activations and
// their derivatives, the recurrent-input quantizer, bf16 rounding, the
// reductions that give the quantizer its per-step scale, and the pass
// that quantizes every step at once (the rebuilds of the sparse GRU's and
// the liGRU's BPTT).

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

// quant(x, var, scale) for an inner loop: the division by var as the
// product with inv = 1 / var and one FMA correction (Markstein), which
// gives the correctly rounded quotient for the normal operands a
// quantizer sees (tests/test_torch_persist.py holds it to IEEE division
// on random pairs), without the IEEE division's sequence and slow-path
// branch in the caller's loop; scale
// is a power of two (2^(bits-1)), so dividing by it is the product with
// inv_scale. Below the normal range the correction can round to 0 where
// the division does not (|x| the smallest subnormal at var 1.544: a carry
// that decays through z * h reaches it). There q() only asks whether the
// quotient rounds to 0, that is whether |x| > var * 2^-150, which
// |x| * 2^75 > var * 2^-75 decides exactly (|x| < 4 there, and where var *
// 2^-75 is not exact, var < 2^-51, every |x| > 0 passes); a division
// there took the dense GRU forward's call from 3.3 to 6.7 ms on inputs
// whose carry decays. The same bits as quant() for every |x| <= var
// (tests/test_torch_persist.py's cuda case, on the H100); identity when
// var == 0.
__device__ __forceinline__ float quant_rcp(float x, float var, float inv,
                                           float scale, float inv_scale) {
  if (var == 0.f) return x;
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  float q = a * inv;
  q = fmaf(fmaf(-q, var, a), inv, q);
  if (q < 0x1p-126f) q = a * 0x1p75f > var * 0x1p-75f ? 0x1p-126f : 0.f;
  return ceilf(q * scale) * inv_scale * var * s;
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

// out = q(v) of each step's (B, H) block (scale: max|v_t| bits, or null
// for none), rounded to bf16 under BF16 (grid.y = steps).
template <bool BF16>
__global__ void quant_steps(const float* __restrict__ v,
                            const unsigned* __restrict__ scale, float qscale,
                            float* __restrict__ out, int n) {
  const size_t base = (size_t)blockIdx.y * n;
  const float var = scale ? __uint_as_float(scale[blockIdx.y]) : 0.f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float x = v[base + i];
    if (scale) x = quant(x, var, qscale);
    out[base + i] = BF16 ? round_bf16(x) : x;
  }
}

}  // namespace
