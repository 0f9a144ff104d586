// Fused torch-semantics GRU recurrence for Hopper (sm_90a), forward and
// BPTT, plain C interface: the recurrence of the GRU_cudnn wrapper (torch's
// nn.GRU).
//
// Replaces two TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_gru_torch_fwd (fused_gru_torch_fwd): the forward, from the zero
//     state or, for streaming, from a seed carry h0 (the JAX package
//     streams this model on lax.scan: the same math);
//   _build_gru_torch_bwd (fused_gru_torch_bwd): BPTT rebuilding the
//     recurrent pre-activations.
// Unlike the cell GRU's (r*h) @ U_h, the reset gate multiplies the already
// projected candidate, so a step is ONE (B, H) x (H, 3H) product. Gates
// are (T, B, 3H) = x @ W_ih^T + b_ih in torch's order [r | z | n]; W_hh is
// (3H, H), b_hh (3H,). Per step t:
//
//   u    = h_{t-1} @ W_hh^T + b_hh
//   r, z = sigmoid(g_r + u_r), sigmoid(g_z + u_z)
//   n    = tanh(g_n + r * u_n)
//   h_t  = (1 - z) * n + z * h_{t-1}
//
// and in reverse, from dh_carry = 0 at t = T-1:
//
//   dh   = dh_carry + dhs[t]
//   da_n = dh * (1 - z) * (1 - n^2);  dm = da_n * r
//   da_r = da_n * u_n * r (1 - r);    da_z = dh * (h_{t-1} - n) * z (1 - z)
//   dh_carry = dh * z + [da_r | da_z | dm] @ W_hh
//
// It emits dg = [da_r | da_z | da_n] (the projection's cotangent) and dm
// (the cotangent of u_n); dW_hh = du^T h_prev and db_hh = sum du, du =
// [da_r | da_z | dm], are one product and one sum over (T*B) outside, as
// in the JAX package. Every value is float32.
//
// What bounds it on this card: at the TIMIT width (T=300, B=8, H=550) the
// forward's products are 2*T*B*3H*H = 4.36 GFLOP of float32 FMAs, 0.065
// ms at 67 TFLOP/s; it moves ~24 MB (0.007 ms): operations bound it; the
// backward does them twice (0.130 ms). But each step needs all of h_{t-1}
// (forward) or all of du_{t+1} (backward), written by every block of the
// step before, and blocks run in no order: one launch per step from the
// host loop (the launch boundary is the grid-wide barrier), re-reading
// W_hh (3.6 MB at H=550) from the 50 MB L2. Its time is T launches, far
// above the bound; a persistent kernel is later work.
//
// The backward's pre-activations u do not depend on dh, so one launch
// rebuilds them for all T (grid.z = steps) before the reverse loop; the
// reverse chain then has one dependent product per step, against rows of
// W_hh^T (passed in, (H, 3H)) so that the lanes read consecutive
// addresses.
//
// Per step, a forward block owns UNITS hidden units (3*UNITS rows of W_hh:
// their r, z and n rows) and BT batch rows: it stages the rows' h_{t-1}
// (BT x H floats) in shared memory and each warp forms the dot of one row
// of W_hh with every staged row (lanes over k, then a shuffle reduction).
// A backward block owns BWD_UNITS units and stages du_{t+1} (BT x 3H
// floats, 53 KB at H=550). Widths need not be multiples of 32 or of the
// units (H=550): every loop masks.

#include <cmath>

#include "lstm_common.cuh"

namespace {

constexpr int UNITS = 4;            // hidden units per forward block
constexpr int BWD_UNITS = 8;        // hidden units per backward block
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// acc[b] = sum_k sm[b][k] * row[k] over K, for one warp: lanes over k,
// then a shuffle reduction (every lane ends with the sums).
__device__ __forceinline__ void warp_dot(const float* __restrict__ row,
                                         const float* sm, int K, int nb,
                                         float (&acc)[BT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const float w = row[k];
#pragma unroll
    for (int b = 0; b < BT; ++b)
      if (b < nb) acc[b] = fmaf(sm[b * K + k], w, acc[b]);
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
  }
}

// One forward step (blockIdx.z = step within the launch: the forward
// launches one step, the backward's rebuild all T). With h_out (the
// forward): h_t into h_out. Without (the rebuild): u = h_prev @ W_hh^T +
// b_hh into u_out.
__global__ void __launch_bounds__(THREADS)
gru_torch_step(const float* __restrict__ g,        // (B, 3H) [r | z | n]
               const float* __restrict__ W,        // (3H, H) W_hh
               const float* __restrict__ bh,       // (3H,) b_hh
               const float* __restrict__ h_prev,   // (B, H); nullptr = zeros
               float* __restrict__ h_out,          // (B, H) or nullptr
               float* __restrict__ u_out,          // (B, 3H) or nullptr
               int B, int H) {
  extern __shared__ float sm[];                    // (BT, H) h_prev
  __shared__ float usm[BT][3 * UNITS];
  const size_t t = blockIdx.z, bh3 = (size_t)B * 3 * H;
  g += t * bh3;
  if (u_out) u_out += t * bh3;
  if (h_prev) h_prev += t * (size_t)B * H;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  for (int e = threadIdx.x; e < nb * H; e += THREADS)
    sm[e] = h_prev ? h_prev[(size_t)b0 * H + e] : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < 3 * UNITS; r += WARPS) {
    const int gate = r / UNITS, unit = u0 + r % UNITS;
    float acc[BT];
    if (unit < H) {
      warp_dot(W + ((size_t)gate * H + unit) * H, sm, H, nb, acc);
      if (lane == 0)
        for (int b = 0; b < BT; ++b) usm[b][r] = acc[b];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ig = bb * 3 * H;
    const float ur = usm[b][jj] + bh[u];
    const float uz = usm[b][UNITS + jj] + bh[H + u];
    const float un = usm[b][2 * UNITS + jj] + bh[2 * H + u];
    if (h_out) {
      const float r = sigmoid(g[ig + u] + ur);
      const float z = sigmoid(g[ig + H + u] + uz);
      const float n = tanhf(g[ig + 2 * H + u] + r * un);
      const float hp = h_prev ? h_prev[bb * H + u] : 0.f;
      h_out[bb * H + u] = (1.f - z) * n + z * hp;
    } else {
      u_out[ig + u] = ur;
      u_out[ig + H + u] = uz;
      u_out[ig + 2 * H + u] = un;
    }
  }
}

// Reverse step t: dh_t = dh_{t+1} * z_{t+1} + du_{t+1} @ W_hh + dhs[t]
// (dhs[t] alone at t = T-1), then dg_t and dm_t. dh (B, H) holds dh_{t+1}
// on entry and dh_t on exit (each unit's own entry).
__global__ void __launch_bounds__(THREADS)
gru_torch_bwd_step(const float* __restrict__ g_t,     // (B, 3H)
                   const float* __restrict__ u_t,     // (B, 3H), b_hh in
                   const float* __restrict__ g_next,  // step t+1's, or null
                   const float* __restrict__ u_next,
                   const float* __restrict__ Wt,      // (H, 3H) = W_hh^T
                   const float* __restrict__ h_prev,  // (B, H) h_{t-1}
                   const float* __restrict__ dh_in,   // (B, H) dhs[t]
                   const float* __restrict__ dg_next,  // (B, 3H) or null
                   const float* __restrict__ dm_next,  // (B, H) or null
                   float* __restrict__ dh,             // (B, H)
                   float* __restrict__ dg_t,           // (B, 3H)
                   float* __restrict__ dm_t,           // (B, H)
                   int B, int H) {
  extern __shared__ float sm[];                  // (BT, 3H) du_{t+1}
  __shared__ float csm[BT][BWD_UNITS];
  const int H3 = 3 * H;
  const int u0 = blockIdx.x * BWD_UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  if (dg_next) {
    for (int e = threadIdx.x; e < nb * H3; e += THREADS) {
      const int b = e / H3, k = e - b * H3;
      const size_t bb = (size_t)(b0 + b);
      sm[e] = k < 2 * H ? dg_next[bb * H3 + k] : dm_next[bb * H + k - 2 * H];
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int jj = warp; jj < BWD_UNITS; jj += WARPS) {
      float acc[BT];
      if (u0 + jj < H) {
        warp_dot(Wt + (size_t)(u0 + jj) * H3, sm, H3, nb, acc);
        if (lane == 0)
          for (int b = 0; b < BT; ++b) csm[b][jj] = acc[b];
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nb * BWD_UNITS; e += THREADS) {
    const int b = e / BWD_UNITS, jj = e - b * BWD_UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u, ig = bb * H3;
    float carry = 0.f;
    if (dg_next) {
      const float z_next = sigmoid(g_next[ig + H + u] + u_next[ig + H + u]);
      carry = dh[ih] * z_next + csm[b][jj];
    }
    const float dhv = carry + dh_in[ih];
    const float r = sigmoid(g_t[ig + u] + u_t[ig + u]);
    const float z = sigmoid(g_t[ig + H + u] + u_t[ig + H + u]);
    const float un = u_t[ig + 2 * H + u];
    const float n = tanhf(g_t[ig + 2 * H + u] + r * un);
    const float dz = dhv * (h_prev[ih] - n);
    const float da_n = dhv * (1.f - z) * (1.f - n * n);
    dg_t[ig + u] = da_n * un * r * (1.f - r);
    dg_t[ig + H + u] = dz * z * (1.f - z);
    dg_t[ig + 2 * H + u] = da_n;
    dm_t[ih] = da_n * r;
    dh[ih] = dhv;
  }
}

cudaError_t allow_smem(const void* kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward on `stream`: T step kernels. Returns the first cudaError_t
// seen, 0 on success.
//   gates: (T, B, 3H) [r | z | n];  W: (3H, H);  bh: (3H,)
//   h0:    (B, H) seed carry, or null for zeros
//   hs:    (T, B, H) output
int fused_gru_torch_fwd(const float* gates, const float* W, const float* bh,
                        const float* h0, float* hs, int T, int B, int H,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = allow_smem((const void*)gru_torch_step, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  const size_t bh1 = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    gru_torch_step<<<grid, THREADS, smem, stream>>>(
        gates + t * 3 * bh1, W, bh, t ? hs + (t - 1) * bh1 : h0, hs + t * bh1,
        nullptr, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The backward on `stream`: one kernel rebuilds u for all steps, then T
// step kernels run in reverse time. Returns the first cudaError_t seen, 0
// on success.
//   gates: (T, B, 3H);  W, Wt: (3H, H) and its transpose (H, 3H)
//   bh: (3H,);  h_prev, dhs: (T, B, H)
//   u: (T, B, 3H) scratch;  dh: (B, H) scratch
//   dg: (T, B, 3H) output [da_r | da_z | da_n];  dm: (T, B, H) output
int fused_gru_torch_bwd(const float* gates, const float* W, const float* Wt,
                        const float* bh, const float* h_prev, const float* dhs,
                        float* u, float* dh, float* dg, float* dm, int T,
                        int B, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem_f = (size_t)BT * H * sizeof(float);
  const size_t smem_b = (size_t)BT * 3 * H * sizeof(float);
  cudaError_t err = allow_smem((const void*)gru_torch_step, smem_f);
  if (err == cudaSuccess)
    err = allow_smem((const void*)gru_torch_bwd_step, smem_b);
  if (err != cudaSuccess) return err;
  const dim3 fgrid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT, T);
  gru_torch_step<<<fgrid, THREADS, smem_f, stream>>>(gates, W, bh, h_prev,
                                                     nullptr, u, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  const size_t bh1 = (size_t)B * H, bh3 = 3 * bh1;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t + 1 == T;
    gru_torch_bwd_step<<<grid, THREADS, smem_b, stream>>>(
        gates + t * bh3, u + t * bh3, last ? nullptr : gates + (t + 1) * bh3,
        last ? nullptr : u + (t + 1) * bh3, Wt, h_prev + t * bh1,
        dhs + t * bh1, last ? nullptr : dg + (t + 1) * bh3,
        last ? nullptr : dm + (t + 1) * bh1, dh, dg + t * bh3, dm + t * bh1,
        B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
