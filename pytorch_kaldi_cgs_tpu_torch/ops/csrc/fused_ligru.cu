// Fused liGRU recurrence for Hopper (sm_90a), forward and BPTT, plain C
// interface.
//
// Replaces three TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_ligru_fwd (fused_ligru_fwd): the forward, in all its variants:
//     the seeded carry h0 (with_init, the streaming forward) and stash (the
//     training forward, which also writes [act(a_h), z] of every step);
//   _build_ligru_bwd_stash (fused_ligru_bwd, stash=1): the reverse
//     recurrence over that stash;
//   _build_ligru_bwd (fused_ligru_bwd, stash=0): the same, rebuilding the
//     gates per step from u = q(h_{t-1}) @ U^T (the default backward).
// Gates are ordered [h | z] (candidate first), U = [Uh; Uz] is (2H, H).
// Per step t:
//
//   u   = q(h_{t-1}) @ U^T
//   a   = act(g_h + u_h),  z = sigmoid(g_z + u_z)
//   h_t = z * h_{t-1} + (1 - z) * a * drop
//
// and in reverse, from dh_carry = 0 at t = T-1:
//
//   dh   = dh_carry + dhs[t]
//   dz   = dh * (h_{t-1} - a * drop)          h_{t-1} unquantized
//   dg_z = dz * z (1 - z)
//   dg_h = dh * (1 - z) * drop * act'
//   dh_carry = dh * z + dg_t @ U
//
// act' comes from the activation's output (stash) or its input
// (recompute), as the TPU kernels take it: for relu the two differ where
// a pre-activation sits within an ulp of 0. dU is not formed here: the
// caller computes it as one (2H, T*B) @ (T*B, H) product. Everything is
// float32 (the TPU kernel has no bf16 variant).
//
// What bounds it on this card: at the training shape (T=300, B=8,
// H=1024) one (B, 2H) x (2H, H) product per step is 10.07 GFLOP of
// float32 FMAs over the layer (0.150 ms at 67 TFLOP/s); the forward with
// the stash moves ~58 MB (0.017 ms at 3.35 TB/s), so operations bound it;
// the recompute backward does two products (0.300 ms). But each step
// needs all of h_{t-1} (forward) or all of dg_{t+1} (backward), written
// by every block of the step before, and on Hopper blocks run in no
// order: as the LSTM kernels do, this first design launches one kernel
// per step from the host loop (the launch boundary is the grid-wide
// barrier) and re-reads U (8 MB at H=1024, resident in the 50 MB L2)
// each step. Its time is ~T launches of several microseconds, far above
// the bound; a persistent kernel with U split across the SMs' shared
// memory is later work.
//
// Per step, a block owns UNITS hidden units (both gate rows of each, so
// the gate math stays local) and BT batch rows:
//   * forward: it stages q(h_{t-1}) for its rows in shared memory; each
//     warp forms the dot of one U row with every staged row (lanes over
//     k, then a shuffle reduction); the epilogue writes h_t (and the
//     stash) and atomicMax-es |h_t| into the next step's scale slot;
//   * backward: it stages dg_{t+1} for its rows (BT x 2H floats, 64 KB at
//     H=1024) and each warp forms the dot of one row of U^T (passed in
//     transposed, (H, 2H), so lanes read consecutive addresses) with
//     them; recompute also stages q(h_{t-1}) and forms the forward's row
//     dots; the epilogue runs the chain above, writes dg_t and keeps
//     dh * z in place in `carry` (each block owns its units' entries).
// Widths need not be multiples of 32 or of UNITS: every loop masks.
//
// qbits > 0: q() scales by max|h_{t-1}| over the whole (B, H) block of
// the step. Forward: step t's epilogue atomicMax-es |h_t| (the float bit
// pattern orders like the value for non-negative floats) into slot t+1,
// zeroed by cudaMemsetAsync; slot 0 holds max|h0|. Recompute backward:
// h_prev is an input, so one reduction kernel writes all T scales first.
// The stash backward takes no quantizer (its straight-through gradient
// is the identity for dh).

#include <cmath>

#include "lstm_common.cuh"

namespace {

constexpr int UNITS = 8;            // hidden units per block
constexpr int ROWS = 2 * UNITS;     // U rows per block (2 gates)
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// Stage nb rows of q(h) (B, H) from row b0 into hsm (scale bits in
// scale_in, or no quantizer when null); nullptr h = zeros.
__device__ __forceinline__ void stage_h(const float* __restrict__ h, int b0,
                                        int nb, int H,
                                        const unsigned* __restrict__ scale_in,
                                        float qscale, float* hsm) {
  const float var = scale_in ? __uint_as_float(*scale_in) : 0.f;
  for (int e = threadIdx.x; e < nb * H; e += THREADS) {
    float x = h ? h[(size_t)b0 * H + e] : 0.f;
    if (scale_in) x = quant(x, var, qscale);
    hsm[e] = x;
  }
}

// usm[b][r] = sum_k hsm[b][k] * U[row(r)][k] for the block's ROWS rows:
// r < UNITS is Uh's row u0 + r, r >= UNITS Uz's row u0 + r - UNITS.
__device__ __forceinline__ void row_dots(const float* __restrict__ U,
                                         const float* hsm, int u0, int nb,
                                         int H, float (*usm)[ROWS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int j = u0 + r % UNITS;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (j < H) {
      const float* row = U + (size_t)((r / UNITS) * H + j) * H;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float u = row[k];
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
}

template <bool STASH>
__global__ void __launch_bounds__(THREADS)
ligru_step(const float* __restrict__ g_t,       // (B, 2H) gates of step t
           const float* __restrict__ U,         // (2H, H)
           const float* __restrict__ drop,      // (B, H)
           const float* __restrict__ h_prev,    // (B, H); nullptr = zeros
           float* __restrict__ h_out,           // (B, H) of step t
           float* __restrict__ a_out,           // (B, 2H) stash of step t
           const unsigned* __restrict__ scale_in,  // max|h_prev| bits or null
           unsigned* __restrict__ scale_out,       // max|h_t| slot or null
           int B, int H, int act, float qscale) {
  extern __shared__ float hsm[];                // (BT, H) staged q(h_prev)
  __shared__ float usm[BT][ROWS];               // recurrent pre-activations
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  stage_h(h_prev, b0, nb, H, scale_in, qscale, hsm);
  __syncthreads();
  row_dots(U, hsm, u0, nb, H, usm);
  __syncthreads();

  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + j;
    const float* g = g_t + bb * 2 * H;
    const float a = act_fn(g[j] + usm[b][jj], act);
    const float z = sigmoid(g[H + j] + usm[b][UNITS + jj]);
    const float hp = h_prev ? h_prev[ih] : 0.f;
    const float h = z * hp + (1.f - z) * (a * drop[ih]);
    h_out[ih] = h;
    if (STASH) {
      a_out[bb * 2 * H + j] = a;
      a_out[bb * 2 * H + H + j] = z;
    }
    m = max(m, __float_as_uint(fabsf(h)));
  }
  if (scale_out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(scale_out, m);
  }
}

template <bool STASH>
__global__ void __launch_bounds__(THREADS)
ligru_bwd_step(const float* __restrict__ a_t,     // STASH: (B, 2H) [a, z]
                                                  // else the gates g_t
               const float* __restrict__ U,       // (2H, H), recompute dots
               const float* __restrict__ Ut,      // (H, 2H), carry dots
               const float* __restrict__ drop,    // (B, H)
               const float* __restrict__ h_prev,  // (B, H) h_{t-1}
               const float* __restrict__ dh_in,   // (B, H) dhs[t]
               const float* __restrict__ dg_next, // (B, 2H) dg_{t+1} or null
               float* __restrict__ carry,         // (B, H) dh * z, in place
               float* __restrict__ dg_out,        // (B, 2H) dg_t
               const unsigned* __restrict__ scale_in,  // max|h_{t-1}| bits
               int B, int H, int act, float qscale) {
  extern __shared__ float smem[];   // dg_{t+1} rows (BT x 2H), q(h) (BT x H)
  __shared__ float dhsm[BT][UNITS];
  __shared__ float usm[BT][ROWS];
  const int G = 2 * H;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float* dgsm = smem;
  float* hsm = smem + BT * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (dg_next)
    for (int e = threadIdx.x; e < nb * G; e += THREADS)
      dgsm[e] = dg_next[(size_t)b0 * G + e];
  if (!STASH) stage_h(h_prev, b0, nb, H, scale_in, qscale, hsm);
  __syncthreads();

  if (dg_next) {
    // dhsm[b][jj] = sum_r dg_{t+1}[b][r] * U[r][u0 + jj]: one warp per unit
    for (int jj = warp; jj < UNITS; jj += WARPS) {
      const int j = u0 + jj;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      if (j < H) {
        const float* row = Ut + (size_t)j * G;
#pragma unroll 4
        for (int k = lane; k < G; k += 32) {
          const float u = row[k];
#pragma unroll
          for (int b = 0; b < BT; ++b)
            if (b < nb) acc[b] = fmaf(dgsm[b * G + k], u, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        float v = acc[b];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) dhsm[b][jj] = v;
      }
    }
  }
  if (!STASH) row_dots(U, hsm, u0, nb, H, usm);
  __syncthreads();

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + j;
    const float* g = a_t + bb * G;
    // dh_carry = dh_{t+1} * z_{t+1} + dg_{t+1} @ U (0 at t = T-1)
    const float dh = (dg_next ? carry[ih] + dhsm[b][jj] : 0.f) + dh_in[ih];
    const float dr = drop[ih];
    float a, z, da;
    if (STASH) {
      a = g[j];
      z = g[H + j];
      da = dact_out(a, act);
    } else {
      const float ac = g[j] + usm[b][jj];
      a = act_fn(ac, act);
      z = sigmoid(g[H + j] + usm[b][UNITS + jj]);
      da = dact_pre(ac, act);
    }
    const float dz = dh * (h_prev[ih] - a * dr);
    float* d = dg_out + bb * G;
    d[j] = dh * (1.f - z) * dr * da;
    d[H + j] = dz * z * (1.f - z);
    carry[ih] = dh * z;
  }
}

template <bool STASH>
cudaError_t run_fwd(const float* gates, const float* U, const float* drop,
                    const float* h0, float* hs, float* acts, unsigned* qslots,
                    int T, int B, int H, int act, int qbits,
                    cudaStream_t stream) {
  auto kern = ligru_step<STASH>;
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
        gates + (size_t)t * 2 * bh, U, drop, t ? hs + (t - 1) * bh : h0,
        hs + t * bh, STASH ? acts + (size_t)t * 2 * bh : nullptr,
        q ? qslots + t : nullptr, q ? qslots + t + 1 : nullptr, B, H, act,
        qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool STASH>
cudaError_t run_bwd(const float* a, const float* U, const float* Ut,
                    const float* drop, const float* h_prev, const float* dhs,
                    float* carry, float* dg, unsigned* qslots, int T, int B,
                    int H, int act, int qbits, cudaStream_t stream) {
  auto kern = ligru_bwd_step<STASH>;
  const int G = 2 * H;
  const size_t smem = (size_t)BT * (G + (STASH ? 0 : H)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool q = !STASH && qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  const size_t bh = (size_t)B * H;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)T * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const int nblk = (int)((bh + 255) / 256 < 16 ? (bh + 255) / 256 : 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  for (int t = T - 1; t >= 0; --t) {
    kern<<<grid, THREADS, smem, stream>>>(
        a + (size_t)t * G * B, U, Ut, drop, h_prev + t * bh, dhs + t * bh,
        t + 1 < T ? dg + (size_t)(t + 1) * G * B : nullptr, carry,
        dg + (size_t)t * G * B, q ? qslots + t : nullptr, B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the whole forward on `stream`: T step kernels (plus one small
// reduction over h0 when qbits > 0 and h0 is given). Returns the first
// cudaError_t seen, 0 on success.
//   gates: (T, B, 2H) [h | z];  U: (2H, H);  drop: (B, H)
//   h0:    (B, H) seed carry, or null for zeros
//   hs:    (T, B, H) output;  acts: (T, B, 2H) stash output, or null
//   qslots: T+1 unsigned ints of scratch, used when qbits > 0
int fused_ligru_fwd(const float* gates, const float* U, const float* drop,
                    const float* h0, float* hs, float* acts, unsigned* qslots,
                    int T, int B, int H, int act, int qbits,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = acts ? run_fwd<true> : run_fwd<false>;
  return fn(gates, U, drop, h0, hs, acts, qslots, T, B, H, act, qbits, stream);
}

// Launches the whole backward on `stream`: T step kernels in reverse time
// (and, for the recompute backward with qbits > 0, one reduction for the
// T quantizer scales first). Returns the first cudaError_t seen.
//   a:      (T, B, 2H) stash [act(a_h), z] (stash=1) or gates (stash=0)
//   U, Ut:  (2H, H) and its transpose (H, 2H)
//   h_prev: (T, B, H) carries entering each step;  dhs: (T, B, H)
//   carry:  (B, H) scratch, zeroed by the caller
//   dg:     (T, B, 2H) output
//   qslots: T unsigned ints of scratch when stash=0 and qbits > 0
int fused_ligru_bwd(const float* a, const float* U, const float* Ut,
                    const float* drop, const float* h_prev, const float* dhs,
                    float* carry, float* dg, unsigned* qslots, int T, int B,
                    int H, int act, int qbits, int stash, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = stash ? run_bwd<true> : run_bwd<false>;
  return fn(a, U, Ut, drop, h_prev, dhs, carry, dg, qslots, T, B, H, act,
            qbits, stream);
}

}  // extern "C"
