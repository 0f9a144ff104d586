// Fused LSTM forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:_build_fwd
// in all its variants: with_init, cdt="bf16", qbits and stash (the
// training forward, which also writes the post-activation gates
// (f, i, o, act(c~)) of every step for the BPTT kernel in
// fused_lstm_bwd.cu). Per step t, gate order (f, i, o, c):
//
//   u = q(h_{t-1}) @ U^T                 U: (4H, H), f32 or bf16
//   f, i, o = sigmoid(g_t + u)
//   c_t = i * act(g_c + u_c) * drop + f * c_{t-1}
//   h_t = o * act(c_t)
//
// What bounds it on this card: at the serving shape (T=398, B=8, H=512)
// one layer does 6.68 GFLOP of float32 FMAs (bound 0.1 ms at 67 TFLOP/s)
// and moves 43 MB (13 us at 3.35 TB/s), so operations bound it; but the
// T steps depend on each other, and on the TPU the grid ran in order
// with U resident in VMEM. Here blocks run in parallel with no order,
// so this first design launches one kernel per step from the host loop
// below (the launch boundary is the grid-wide barrier between steps)
// and re-reads U from the 50 MB L2 each step. Its time is launch
// latency x T, far above the bound; a persistent kernel with U resident
// in shared memory across SMs and a grid barrier is later work.
//
// Per step, a block owns UNITS hidden units (all four gate rows of each,
// so the gate math stays local) and BT batch rows: it stages q(h_{t-1})
// for its rows in shared memory, each warp forms the dot products of
// one U row with every staged h row (f32 accumulation, lanes over k,
// then a shuffle reduction), and the epilogue writes h_t and c_t.
//
// qbits > 0: q() is the per-step activation quantizer whose scale is
// max|h_{t-1}| over the whole (B, H) block of that step. Step t's
// epilogue atomicMax-es |h_t| (the float bit pattern orders like the
// value for non-negative floats) into slot t+1, zeroed beforehand by
// cudaMemsetAsync; step t+1 reads it. Slot 0 holds max|h0|.
// bf16: U is bf16, q(h) is rounded to bf16 before the dot; products and
// sums are float32, as are the gate math and the carries.

#include <cmath>

#include "lstm_common.cuh"

namespace {

constexpr int UNITS = 4;            // hidden units per block
constexpr int ROWS = 4 * UNITS;     // U rows per block (4 gates)
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
lstm_step(const float* __restrict__ g_t,       // (B, 4H) gates of step t
          const void* __restrict__ Uv,         // (4H, H)
          const float* __restrict__ drop,      // (B, H)
          const float* __restrict__ h_prev,    // (B, H); nullptr = zeros
          const float* __restrict__ c_prev,    // (B, H); nullptr = zeros
          float* __restrict__ h_out,           // (B, H) of step t
          float* __restrict__ c_out,
          float* __restrict__ a_out,           // (B, 4H) stash or nullptr
          const unsigned* __restrict__ scale_in,  // max|h_prev| bits or nullptr
          unsigned* __restrict__ scale_out,       // max|h_t| slot or nullptr
          int B, int H, int act, float qscale) {
  extern __shared__ float hsm[];               // (BT, H) staged q(h_prev)
  __shared__ float usm[BT][ROWS];              // recurrent pre-activations
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const float var = scale_in ? __uint_as_float(*scale_in) : 0.f;

  for (int e = threadIdx.x; e < nb * H; e += THREADS) {
    const int b = e / H, k = e - b * H;
    float x = h_prev ? h_prev[(size_t)(b0 + b) * H + k] : 0.f;
    if (scale_in) x = quant(x, var, qscale);
    if (BF16) x = __bfloat162float(__float2bfloat16_rn(x));
    hsm[b * H + k] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int j = u0 + r % UNITS;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (j < H) {
      const size_t row = (size_t)((r / UNITS) * H + j) * H;
      for (int k = lane; k < H; k += 32) {
        const float u = BF16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(Uv)[row + k])
            : static_cast<const float*>(Uv)[row + k];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(hsm[b * H + k], u, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) usm[b][r] = v;
    }
  }
  __syncthreads();

  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t bb = (size_t)(b0 + b);
    const float* g = g_t + bb * 4 * H;
    const float f = sigmoid(g[j] + usm[b][jj]);
    const float i = sigmoid(g[H + j] + usm[b][UNITS + jj]);
    const float o = sigmoid(g[2 * H + j] + usm[b][2 * UNITS + jj]);
    const float cc = act_fn(g[3 * H + j] + usm[b][3 * UNITS + jj], act);
    const float cp = c_prev ? c_prev[bb * H + j] : 0.f;
    const float c = i * cc * drop[bb * H + j] + f * cp;
    const float h = o * act_fn(c, act);
    h_out[bb * H + j] = h;
    c_out[bb * H + j] = c;
    if (a_out) {
      float* a = a_out + bb * 4 * H;
      a[j] = f;
      a[H + j] = i;
      a[2 * H + j] = o;
      a[3 * H + j] = cc;
    }
    m = max(m, __float_as_uint(fabsf(h)));
  }
  if (scale_out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0 && m) atomicMax(scale_out, m);
  }
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the whole layer on `stream`: T step kernels (plus one small
// reduction over h0 when qbits > 0 and h0 is given). Returns the first
// cudaError_t seen, 0 on success. h0/c0 may both be null (zero state).
// acts: (T, B, 4H) stash output, or null. qslots: T+1 unsigned ints of
// scratch, used when qbits > 0.
int fused_lstm_fwd(const float* gates, const void* U, const float* drop,
                   const float* h0, const float* c0, float* hs, float* cs,
                   float* acts, unsigned* qslots, int T, int B, int H,
                   int act, int qbits, int u_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto kern = u_bf16 ? lstm_step<true> : lstm_step<false>;
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(T + 1) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
    if (h0) {
      absmax_bits<<<(B * H + 255) / 256, 256, 0, stream>>>(h0, B * H, qslots);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    kern<<<grid, THREADS, smem, stream>>>(
        gates + (size_t)t * 4 * bh, U, drop,
        t ? hs + (t - 1) * bh : h0, t ? cs + (t - 1) * bh : c0,
        hs + t * bh, cs + t * bh, acts ? acts + (size_t)t * 4 * bh : nullptr,
        q ? qslots + t : nullptr, q ? qslots + t + 1 : nullptr,
        B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
