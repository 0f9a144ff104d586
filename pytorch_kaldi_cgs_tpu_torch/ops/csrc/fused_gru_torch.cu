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
// step before, and blocks run in no order.
//
// The forward launches one kernel per step from the host loop (the launch
// boundary is the grid-wide barrier), re-reading W_hh (3.6 MB at H=550)
// from the 50 MB L2; its time is T launches, far above the bound.
//
// The backward's pre-activations u do not depend on dh, so one launch
// rebuilds them for all T before the reverse chain: u = h_prev @ W_hh^T +
// b_hh as one (T*B, H) x (H, 3H) GEMM on bs_gemm.cuh's register-blocked
// tile (rec_gemm.cuh's rec_u_gemm, which the liGRU's recompute BPTT
// shares: 2.18 GFMA at the TIMIT shape, 247 blocks of 128 x 128 outputs).
// The chain then has one dependent product per step, du_{t+1} @ W_hh,
// against the columns of W_hh. Two routes, picked by the
// caller before the launch from the shapes and the occupancy query
// (fused_rnn.gru_torch_bwd_route):
//
//   - "persist" (TPU row 23's redesign): ONE cooperative launch runs the
//     whole chain (persist.cuh). A block owns UNITS = 8 units and 8 (B <=
//     8) or 32 batch rows for the whole call; it copies its units' columns
//     of W_hh into shared memory once (3H floats a unit, 52.8 KB at
//     H=550), and per reverse step stages du_{t+1} of its rows (3H floats a
//     row, from an exchange buffer the blocks write with 16-byte aligned
//     rows, two of them by the step's parity), forms its 8 x BT dots, writes
//     its units' dg_t, dm_t and du_t, and waits at one grid barrier. At the
//     TIMIT shape that is ceil(550/8) = 69 blocks, one an SM (114 KB).
//   - "step" (a shape whose blocks do not fit or are not co-resident): one
//     launch per reverse step (gru_torch_bwd_step); the launch boundary is
//     the barrier, each block re-staging du_{t+1} (8 x 3H floats) and
//     re-reading its rows of W_hh^T (passed in, (H, 3H), so that the lanes
//     read consecutive addresses) every step.
//
// Per step, a forward block owns UNITS hidden units (3*UNITS rows of W_hh:
// their r, z and n rows) and BT batch rows: it stages the rows' h_{t-1}
// (BT x H floats) in shared memory and each warp forms the dot of one row
// of W_hh with every staged row (lanes over k, then a shuffle reduction).
// A per-step backward block owns BWD_UNITS units and stages du_{t+1} (BT x
// 3H floats, 53 KB at H=550). Widths need not be multiples of 32 or of the
// units (H=550): every loop masks.

#include <cmath>

#include "rec_gemm.cuh"
#include "lstm_common.cuh"
#include "persist.cuh"

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

// One forward step: h_t = the GRU cell of g_t and h_{t-1} into h_out.
__global__ void __launch_bounds__(THREADS)
gru_torch_step(const float* __restrict__ g,        // (B, 3H) [r | z | n]
               const float* __restrict__ W,        // (3H, H) W_hh
               const float* __restrict__ bh,       // (3H,) b_hh
               const float* __restrict__ h_prev,   // (B, H); nullptr = zeros
               float* __restrict__ h_out,          // (B, H)
               int B, int H) {
  extern __shared__ float sm[];                    // (BT, H) h_prev
  __shared__ float usm[BT][3 * UNITS];
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
    const float r = sigmoid(g[ig + u] + ur);
    const float z = sigmoid(g[ig + H + u] + uz);
    const float n = tanhf(g[ig + 2 * H + u] + r * un);
    const float hp = h_prev ? h_prev[bb * H + u] : 0.f;
    h_out[bb * H + u] = (1.f - z) * n + z * hp;
  }
}

namespace gm = bs_gemm;

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

// The whole reverse chain in one cooperative launch (route "persist"):
// block c owns units u0 = (c % ceil(H/UNITS)) * UNITS.. and the BT = 8 *
// BI batch rows from b0 = (c / ceil(H/UNITS)) * BT. Its thread o = b *
// UNITS + j keeps dh and z of unit u0 + j, row b0 + b, in registers across
// the steps, and loads the next step's gates, u, dhs and h_prev before the
// grid barrier (they do not depend on the chain), so that their latency
// overlaps the barrier and the staging. xbuf (2, B, XS) is the exchange
// buffer of du = [da_r | da_z | dm], XS = 3H rounded up to 8, by the
// step's parity.
template <int BI>
__global__ void __launch_bounds__(persist::THREADS, 1)
gru_torch_bwd_persist(const float* __restrict__ gates,   // (T, B, 3H)
                      const float* __restrict__ u,       // (T, B, 3H)
                      const float* __restrict__ W,       // (3H, H)
                      const float* __restrict__ h_prev,  // (T, B, H)
                      const float* __restrict__ dhs,     // (T, B, H)
                      float* dg, float* dm, float* xbuf, int T, int B,
                      int H) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, U = P::UNITS;
  extern __shared__ __align__(16) float psm[];
  const int K = 3 * H, XS = (K + 7) / 8 * 8, SK = P::row_stride(K);
  float* ws = psm;                                // (K, U) W's columns
  float* xs = ws + (size_t)K * U;                 // (BT, SK) du_{t+1}
  float* red = xs + (size_t)BT * SK;              // the dots' partials
  const int ug = (H + U - 1) / U;
  const int u0 = (blockIdx.x % ug) * U, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int e = threadIdx.x; e < K * U; e += P::THREADS) {
    const int k = e / U, j = e - k * U;
    ws[e] = u0 + j < H ? W[(size_t)k * H + u0 + j] : 0.f;
  }
  const int o = threadIdx.x, ob = o / U, ou = u0 + o % U;
  const bool mine = o < BT * U && ob < nb && ou < H;
  const size_t bh1 = (size_t)B * H, bh3 = 3 * bh1, xstep = (size_t)B * XS;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * K;
  // step t's inputs of this thread's (row, unit)
  struct In {
    float g[3], u[3], dh, hp;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v.g[q] = gates[t * bh3 + ig + q * H + ou];
        v.u[q] = u[t * bh3 + ig + q * H + ou];
      }
      v.dh = dhs[t * bh1 + ih];
      v.hp = h_prev[t * bh1 + ih];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dh = 0.f, zn = 0.f;
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float dot = 0.f;
    if (t + 1 < T) {
      const float* src = xbuf + ((t + 1) & 1) * xstep + (size_t)b0 * XS;
      P::stage_rows(nb, XS, [&](int row) { return src + (size_t)row * XS; },
                    [&](int row) { return xs + (size_t)row * SK; });
      P::cp_async_wait_all();
      __syncthreads();
      P::unit_dots<BI>(xs, SK, ws, K, red);
      if (o < BT * U) dot = P::unit_sum<BI>(red, o);
    }
    if (mine) {
      const float carry = t + 1 < T ? dh * zn + dot : 0.f;
      const float dhv = carry + cur.dh;
      const float r = sigmoid(cur.g[0] + cur.u[0]);
      const float z = sigmoid(cur.g[1] + cur.u[1]);
      const float un = cur.u[2];
      const float nn = tanhf(cur.g[2] + r * un);
      const float dz = dhv * (cur.hp - nn);
      const float da_n = dhv * (1.f - z) * (1.f - nn * nn);
      const float da_r = da_n * un * r * (1.f - r);
      const float da_z = dz * z * (1.f - z), dmv = da_n * r;
      float* d = dg + t * bh3;
      d[ig + ou] = da_r;
      d[ig + H + ou] = da_z;
      d[ig + 2 * H + ou] = da_n;
      dm[t * bh1 + ih] = dmv;
      float* x = xbuf + (t & 1) * xstep + (size_t)(b0 + ob) * XS;
      x[ou] = da_r;
      x[H + ou] = da_z;
      x[2 * H + ou] = dmv;
      dh = dhv;
      zn = z;
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
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
        B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The backward on `stream`: one kernel rebuilds u for all steps
// (rec_gemm.cuh's rec_u_gemm), then the reverse chain: with grid > 0 one
// cooperative launch of grid blocks (route "persist", BT = 8 * bi batch
// rows a block, smem bytes of dynamic shared memory:
// fused_rnn.gru_torch_bwd_plan), else T step kernels in reverse time.
// Returns the first cudaError_t seen, 0 on success.
//   gates: (T, B, 3H);  W, Wt: (3H, H) and its transpose (H, 3H)
//   bh: (3H,);  h_prev, dhs: (T, B, H)
//   u: (T, B, 3H) scratch;  dh: (B, H) scratch (the step route)
//   xbuf: (2, B, 3H rounded up to 8) scratch (the persistent route)
//   dg: (T, B, 3H) output [da_r | da_z | da_n];  dm: (T, B, H) output
int fused_gru_torch_bwd(const float* gates, const float* W, const float* Wt,
                        const float* bh, const float* h_prev, const float* dhs,
                        float* u, float* dh, float* xbuf, float* dg,
                        float* dm, int T, int B, int H, int grid, int bi,
                        int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem_b = (size_t)BT * 3 * H * sizeof(float);
  cudaError_t err = gm::rec_u_gemm_launch(h_prev, Wt, bh, nullptr, u, T * B,
                                          H, 3 * H, stream);
  if (err != cudaSuccess) return err;
  if (grid > 0) {
    if (bi == 1)
      return persist::launch<gru_torch_bwd_persist<1>>(
          grid, smem, stream, gates, u, W, h_prev, dhs, dg, dm, xbuf, T, B,
          H);
    return persist::launch<gru_torch_bwd_persist<4>>(
        grid, smem, stream, gates, u, W, h_prev, dhs, dg, dm, xbuf, T, B, H);
  }
  err = allow_smem((const void*)gru_torch_bwd_step, smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_s((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  const size_t bh1 = (size_t)B * H, bh3 = 3 * bh1;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t + 1 == T;
    gru_torch_bwd_step<<<grid_s, THREADS, smem_b, stream>>>(
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

// out[0..2]: the persistent chain's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (bi as above), the SM count, and whether
// the device takes cooperative launches.
int fused_gru_torch_bwd_occupancy(int bi, int smem, int* out) {
  return bi == 1 ? persist::occupancy<gru_torch_bwd_persist<1>>(smem, out)
                 : persist::occupancy<gru_torch_bwd_persist<4>>(smem, out);
}

}  // extern "C"
