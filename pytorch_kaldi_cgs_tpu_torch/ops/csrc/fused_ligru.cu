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
// What bounds it on this card: at the TIMIT training shape (T=300, B=8,
// H=1024) one (B, 2H) x (2H, H) product per step is 10.07 GFLOP of
// float32 FMAs over the layer (0.150 ms at 67 TFLOP/s); the forward with
// the stash moves ~58 MB (0.017 ms at 3.35 TB/s), so operations bound it;
// the recompute backward does two products (0.300 ms; 0.80 ms at the
// LibriSpeech shape, T=200, B=32). But each step needs all of h_{t-1}
// (forward) or all of dg_{t+1} (backward), written by every block of the
// step before, and on Hopper blocks run in no order. The stash backward
// launches one kernel per step from the host loop (the launch boundary is
// the grid-wide barrier) and re-reads U (8 MB at H=1024, resident in the
// 50 MB L2) each step; its time is ~T launches of several microseconds,
// far above the bound.
//
// The forward (TPU row 16) takes one of two routes, picked by the caller
// before the launch from the shapes and the occupancy query
// (fused_rnn.ligru_fwd_route):
//
//   - "persist": ONE cooperative launch runs all T steps, seeded or not
//     (ligru_fwd_persist, persist.cuh): a block owns 8 units and BT (8,
//     16 or 32) batch rows for the whole call, its units' rows
//     of [Uh; Uz] resident in shared memory, and per step stages
//     q(h_{t-1}) of its rows, forms its dots, runs the gate math and waits
//     at one grid barrier; h_t and the per-block max|h_t| go through two
//     exchange buffers picked by the step's parity. Its sums are the step
//     kernel's, so both routes give the same bits.
//   - "step" (a shape whose blocks do not fit or are not co-resident): T
//     launches of ligru_step, as below.
//
// Per step on the step routes, a block owns UNITS hidden units (both gate
// rows of each, so the gate math stays local) and BT batch rows:
//   * forward: it stages q(h_{t-1}) for its rows in shared memory; each
//     warp forms the dot of one U row with every staged row (lanes over
//     k, then a shuffle reduction); the epilogue writes h_t (and the
//     stash) and atomicMax-es |h_t| into the next step's scale slot;
//   * backward (ligru_bwd_step): it stages dg_{t+1} for its rows (BT x 2H
//     floats, 64 KB at H=1024) and each warp forms the dot of one row of
//     U^T (passed in transposed, (H, 2H), so lanes read consecutive
//     addresses) with them; recompute also stages q(h_{t-1}) and forms
//     the forward's row dots; the epilogue runs the chain above, writes
//     dg_t and keeps dh * z in place in `carry` (each block owns its
//     units' entries).
// Widths need not be multiples of 32 or of UNITS: every loop masks.
//
// The recompute backward (TPU row 18) takes one of two routes, picked by
// the caller before the launch from the shapes and the occupancy query
// (fused_rnn.ligru_bwd_route):
//
//   - "persist". The forward quantities do not depend on dh, so they are
//     rebuilt for all M = T*B rows first: with qbits > 0 absmax_steps (the
//     T scales) and quant_steps (q(h_prev)), then ONE GEMM, rec_gemm.cuh's
//     rec_u_gemm, pre = gates + q(h_prev) @ U^T, (M, H) x (H, 2H), whose
//     epilogue adds the gates, so pre is each step's pre-activation (the
//     sum the step kernel forms, in another order). Then the whole reverse
//     chain is ONE cooperative launch of ligru_bwd_persist (persist.cuh): a
//     block owns UN (8 or 16) units and BT (8, 16 or 32) batch rows for all
//     steps, its units' columns of U resident in shared memory (2H floats a
//     unit: 64 KB at UN=8, H=1024), and per reverse step stages dg_{t+1}
//     of its rows (from an exchange buffer of 16-byte aligned rows, two by
//     the step's parity), forms its UN x BT carry dots, runs the
//     elementwise chain on pre, writes dg_t and waits at one grid barrier.
//     Where BT rows of 2H floats do not fit beside the weights (the
//     LibriSpeech shape, B=32: 256 KB at BT=32), the rows are staged in
//     slabs of the contraction, two in flight (persist::slab_dots); the
//     plan (fused_rnn.ligru_bwd_plan) picks the block and the slab.
//   - "step" (a shape whose blocks do not fit or are not co-resident): T
//     launches of ligru_bwd_step<false>, each re-staging q(h_{t-1}) and
//     re-forming the forward's dots beside the carry's.
//
// qbits > 0: q() scales by max|h_{t-1}| over the whole (B, H) block of
// the step. Forward, step route: step t's epilogue atomicMax-es |h_t| (the
// float bit pattern orders like the value for non-negative floats) into
// slot t+1, zeroed by cudaMemsetAsync; slot 0 holds max|h0|. Persistent
// route: each block writes its own max, and the blocks of the next step
// take the max of those. Recompute backward: h_prev is an input, so one
// reduction kernel writes all T scales first. The stash backward takes no
// quantizer (its straight-through gradient is the identity for dh).

#include <cmath>

#include "rec_gemm.cuh"
#include "lstm_common.cuh"
#include "persist.cuh"

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

// The recompute backward's reverse chain in one cooperative launch (route
// "persist", TPU row 18's redesign; persist.cuh). Block c owns the UN
// units from u0 = (c % ceil(H/UN)) * UN and the BT = 8 * BI batch rows
// from b0 = (c / ceil(H/UN)) * BT. It copies its units' columns of U into
// shared memory once (ws: 2H rows of UN, w_stride(UN) apart). Its thread o
// = b * UN + j keeps dh * z of its (row, unit) in a register across the
// steps and loads the next step's pre-activations, h_prev and dhs before
// the grid barrier (they do not depend on the chain). Per reverse step it
// stages dg_{t+1} of its rows from xbuf (2, B, XS), XS = 2H rounded up to
// 8, by the step's parity, in slabs of KS values (KS >= 2H: at once),
// forms dh_carry = dh * z + dg_{t+1} @ U for its units, runs the
// elementwise chain, writes dg_t to dg and xbuf, and waits at the barrier.
template <int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
ligru_bwd_persist(const float* __restrict__ pre,     // (T, B, 2H) g + u
                  const float* __restrict__ U,       // (2H, H)
                  const float* __restrict__ drop,    // (B, H)
                  const float* __restrict__ h_prev,  // (T, B, H)
                  const float* __restrict__ dhs,     // (T, B, H)
                  float* dg, float* xbuf, int T, int B, int H, int act,
                  int KS) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, WS = P::w_stride(UN);
  extern __shared__ __align__(16) float psm[];
  const int K = 2 * H, XS = (K + 7) / 8 * 8, SK = P::row_stride(KS);
  float* ws = psm;                                 // (K, WS) U's columns
  float* xs = ws + (size_t)K * WS;                 // 1 or 2 x (BT, SK)
  float* red = xs + (size_t)(KS < K ? 2 : 1) * BT * SK;
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int e = threadIdx.x; e < K * UN; e += P::THREADS) {
    const int k = e / UN, j = e - k * UN;
    ws[k * WS + j] = u0 + j < H ? U[(size_t)k * H + u0 + j] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, ou = u0 + o % UN;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, bk = (size_t)B * K, xstep = (size_t)B * XS;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * K;
  const float dr = mine ? drop[ih] : 0.f;
  // step t's inputs of this thread's (row, unit)
  struct In {
    float ph, pz, hp, dh;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      v.ph = pre[t * bk + ig + ou];
      v.pz = pre[t * bk + ig + H + ou];
      v.hp = h_prev[t * bh + ih];
      v.dh = dhs[t * bh + ih];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dhz = 0.f;                    // dh * z of step t+1
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float dot = 0.f;
    if (t + 1 < T) {
      const float* src = xbuf + ((t + 1) & 1) * xstep + (size_t)b0 * XS;
      P::slab_dots<BI, UN>([&](int r) { return src + (size_t)r * XS; }, nb,
                           K, XS, KS, xs, SK, ws, red);
      if (o < BT * UN) dot = P::unit_sum<BI, UN>(red, o);
    }
    if (mine) {
      // the step kernel's arithmetic, on the rebuilt pre-activations
      const float dh = (t + 1 < T ? dhz + dot : 0.f) + cur.dh;
      const float a = act_fn(cur.ph, act);
      const float z = sigmoid(cur.pz);
      const float dz = dh * (cur.hp - a * dr);
      const float dgh = dh * (1.f - z) * dr * dact_pre(cur.ph, act);
      const float dgz = dz * z * (1.f - z);
      float* d = dg + t * bk + ig;
      d[ou] = dgh;
      d[H + ou] = dgz;
      float* x = xbuf + (t & 1) * xstep + (size_t)(b0 + ob) * XS;
      x[ou] = dgh;
      x[H + ou] = dgz;
      dhz = dh * z;
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
  }
}

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU row 16's redesign; persist.cuh). Block c owns the UN
// units from u0 = (c % ug) * UN (ug = ceil(H / UN); units past H get zero
// weights and no output) and the BT = 8 * BI batch rows from b0 = (c /
// ug) * BT. It copies into shared memory once its units' rows of U, Uh's
// UN then Uz's UN, H floats each (ws). Its thread o = b * UN + jj keeps
// h_{t-1} of its (row, unit) in a register and loads the next step's gates
// before the barrier. The step has one grid-wide dependency, h_{t-1} of
// every unit, so one grid barrier a step: stage h_{t-1} from the exchange
// buffer of step t-1's parity, q() at the max over that parity's block
// maxima, the dots against ws, the gate math, h_t into hs and into the
// buffer of step t's parity, the stash, the block's max|h_t| into its
// entry of that parity's maxima; barrier (none after the last step).
// With one barrier a step the exchange needs two buffers (2, B, HP) and
// two rows of block maxima (2, grid): a block past the barrier writes h_t
// while a slower one may still stage h_{t-1}. With a seed h0 each thread
// first copies its entry into buffer 1 (step -1's) and its block's max|h0|
// into maxima row 1, then one barrier; without one, step 0's carry is
// zero: no staging and no dots. HP = H rounded up to 4 floats, so that
// each staged row starts 16-byte aligned; the padding is copied, never
// summed. Each dot is one warp's, lanes over k and a shuffle reduction, in
// ligru_step's row_dots order (persist::resident_dots), and q() (quant_rcp:
// quant()'s bits) runs once over the staged values (persist::stage_quant):
// both routes give the same bits, so the dense stream of a sparse
// layer keeps the sparse forward's.
template <int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
ligru_fwd_persist(const float* __restrict__ gates,  // (T, B, 2H)
                  const float* __restrict__ U,      // (2H, H)
                  const float* __restrict__ drop,   // (B, H)
                  const float* __restrict__ h0,     // (B, H) or null
                  float* __restrict__ hs,           // (T, B, H) output
                  float* __restrict__ acts,         // (T, B, 2H) or null
                  float* xh,                        // (2, B, HP) exchange
                  unsigned* bmax,                   // (2, grid), or null
                  int T, int B, int H, int act, float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, NR = 2 * UN;
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int SK = P::row_stride(H), HP = (H + 3) / 4 * 4;
  float* ws = psm;                                 // (NR, H)
  float* xsm = ws + (size_t)NR * H;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[NR]>(xsm + (size_t)BT * SK);
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int i = threadIdx.x; i < NR * H; i += P::THREADS) {
    const int r = i / H, k = i - r * H, u = u0 + r % UN;
    ws[i] = u < H ? U[((size_t)(r / UN) * H + u) * H + k] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, xstep = (size_t)B * HP;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * 2 * H;
  const size_t ix = (size_t)(b0 + ob) * HP + ou;
  const float dr = mine ? drop[ih] : 0.f;
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  struct In {
    float gh, gz;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      v.gh = gates[t * 2 * bh + ig + ou];
      v.gz = gates[t * 2 * bh + ig + H + ou];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float hp = 0.f;                                  // h_{t-1} of (row, unit)
  const bool seeded = h0 != nullptr;
  if (seeded) {
    unsigned m = 0;
    if (mine) {
      hp = h0[ih];
      xh[xstep + ix] = hp;
      m = __float_as_uint(fabsf(hp));
    }
    if (bmax) P::block_max(m, bmax + gridDim.x, wmax);
    grid.sync();
  }
  In cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int prev = (t + 1) & 1, now = t & 1;      // parities of t-1, t
    float uh = 0.f, uz = 0.f;
    if (t > 0 || seeded) {
      P::stage_quant(xh + prev * xstep, HP, b0, nb, xsm, SK,
                     bmax ? bmax + prev * gridDim.x : nullptr, gridDim.x,
                     &gmax, qscale, iscale);
      P::resident_dots<BT, NR, NR>(ws, xsm, SK, H, nb, usm);
      __syncthreads();
      if (mine) {
        uh = usm[ob][oj];
        uz = usm[ob][UN + oj];
      }
    }
    unsigned m = 0;
    if (mine) {
      // ligru_step's arithmetic
      const float a = act_fn(cur.gh + uh, act);
      const float z = sigmoid(cur.gz + uz);
      const float h = z * hp + (1.f - z) * (a * dr);
      hs[t * bh + ih] = h;
      xh[now * xstep + ix] = h;
      if (acts) {
        acts[t * 2 * bh + ig + ou] = a;
        acts[t * 2 * bh + ig + H + ou] = z;
      }
      hp = h;
      m = __float_as_uint(fabsf(h));
    }
    if (t + 1 < T) {
      if (bmax) P::block_max(m, bmax + now * gridDim.x, wmax);
      cur = fetch(t + 1);
      grid.sync();
    }
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

// one cooperative launch of the chain at block shape (BI, UN)
template <int BI, int UN>
cudaError_t launch_chain(int grid, int smem, cudaStream_t stream,
                         const float* pre, const float* U, const float* drop,
                         const float* h_prev, const float* dhs, float* dg,
                         float* xbuf, int T, int B, int H, int act, int KS) {
  return persist::launch<ligru_bwd_persist<BI, UN>>(
      grid, smem, stream, pre, U, drop, h_prev, dhs, dg, xbuf, T, B, H, act,
      KS);
}

// one cooperative launch of the persistent forward at block shape (BI, UN)
template <int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const float* U,
                               const float* drop, const float* h0, float* hs,
                               float* acts, float* xh, unsigned* bmax, int T,
                               int B, int H, int act, float qscale) {
  return persist::launch<ligru_fwd_persist<BI, UN>>(
      grid, smem, stream, gates, U, drop, h0, hs, acts, xh, bmax, T, B, H,
      act, qscale);
}

// The block shapes (bi, units) of the persistent forward: the plan's (1,
// 8), (2, 8) and (4, 8), and (2, 16), which a forced plan times at 32
// rows. -> the launcher and the occupancy query of one, or nulls for
// another shape.
using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const float*, const float*, const float*,
                                  float*, float*, float*, unsigned*, int, int,
                                  int, int, float);
using FwdOccupancy = cudaError_t (*)(int, int*);

void fwd_shape_of(int bi, int units, FwdLaunch* launch, FwdOccupancy* occ) {
#define PK_FWD_SHAPE(BI_, UN_)                                            \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BI_, UN_>;                               \
    *occ = persist::occupancy<ligru_fwd_persist<BI_, UN_>>;               \
    return;                                                               \
  }
  PK_FWD_SHAPE(1, 8)
  PK_FWD_SHAPE(2, 8)
  PK_FWD_SHAPE(4, 8)
  PK_FWD_SHAPE(2, 16)
#undef PK_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the whole forward on `stream` on the step route: T step
// kernels (plus one small reduction over h0 when qbits > 0 and h0 is
// given). Returns the first cudaError_t seen, 0 on success.
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

// The forward on the persistent route on `stream`: one cooperative launch
// of `grid` blocks of ligru_fwd_persist (bi: BT = 8 * bi rows a block;
// units: 8 or 16; smem bytes of dynamic shared memory:
// fused_rnn.ligru_fwd_plan sizes all three), seeded or not. Returns its
// cudaError_t; cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, 2H);  U: (2H, H);  drop: (B, H);  h0: (B, H) or null
//   hs: (T, B, H) output;  acts: (T, B, 2H) stash output, or null
//   xh: (2, B, HP) scratch, HP = H rounded up to a multiple of 4
//   bmax: 2 * grid unsigned ints of scratch when qbits > 0
int ligru_fwd_persist_run(const float* gates, const float* U,
                          const float* drop, const float* h0, float* hs,
                          float* acts, float* xh, unsigned* bmax, int T,
                          int B, int H, int act, int qbits, int grid, int bi,
                          int units, int smem, void* stream_ptr) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates, U,
            drop, h0, hs, acts, xh, q ? bmax : nullptr, T, B, H, act,
            qscale);
}

// out[0..2]: the persistent forward's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int fused_ligru_fwd_occupancy(int bi, int units, int smem, int* out) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

// Launches the whole backward on `stream` on the step route: T step
// kernels in reverse time (and, for the recompute backward with qbits >
// 0, one reduction for the T quantizer scales first). Returns the first
// cudaError_t seen.
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

// The recompute backward on the persistent route on `stream`: with qbits >
// 0 the T scales of q(h_prev) (qslots, zeroed here) and q(h_prev) into qh;
// pre = gates + q(h_prev) @ U^T as one GEMM (rec_u_gemm, Ut the (H, 2H)
// transpose of U); then one cooperative launch of `grid` blocks of
// ligru_bwd_persist (bi: BT = 8 * bi rows a block; units: 8 or 16; slab:
// the contraction values staged at once; smem bytes of dynamic shared
// memory: fused_rnn.ligru_bwd_plan). Returns the first cudaError_t seen.
//   gates, pre, dg: (T, B, 2H);  h_prev, dhs, qh: (T, B, H);  drop: (B, H)
//   xbuf: (2, B, 2H rounded up to 8) scratch;  qslots: T unsigned ints
int ligru_bwd_persist_run(const float* gates, const float* U, const float* Ut,
                          const float* drop, const float* h_prev,
                          const float* dhs, float* qh, float* pre,
                          float* xbuf, float* dg, unsigned* qslots, int T,
                          int B, int H, int act, int qbits, int grid, int bi,
                          int units, int slab, int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bi != 2 && units != 8) return cudaErrorInvalidValue;
  const size_t bh = (size_t)B * H;
  const float* x = h_prev;
  cudaError_t err = cudaSuccess;
  if (qbits > 0) {
    err = cudaMemsetAsync(qslots, 0, (size_t)T * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const int nblk = (int)((bh + 255) / 256 < 16 ? (bh + 255) / 256 : 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    quant_steps<false><<<dim3(nblk, T), 256, 0, stream>>>(
        h_prev, qslots, std::ldexp(1.f, qbits - 1), qh, (int)bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = qh;
  }
  err = bs_gemm::rec_u_gemm_launch(x, Ut, nullptr, gates, pre, T * B, H,
                                   2 * H, stream);
  if (err != cudaSuccess) return err;
  auto fn = bi == 1      ? launch_chain<1, 8>
            : bi == 4    ? launch_chain<4, 8>
            : units == 16 ? launch_chain<2, 16>
                          : launch_chain<2, 8>;
  return fn(grid, smem, stream, pre, U, drop, h_prev, dhs, dg, xbuf, T, B, H,
            act, slab);
}

// out[0..2]: the chain's co-resident blocks per SM at `smem` bytes of
// dynamic shared memory (bi and units as above), the SM count, and
// whether the device takes cooperative launches.
int fused_ligru_bwd_occupancy(int bi, int units, int smem, int* out) {
  if (bi == 1) return persist::occupancy<ligru_bwd_persist<1, 8>>(smem, out);
  if (bi == 4) return persist::occupancy<ligru_bwd_persist<4, 8>>(smem, out);
  return units == 16 ? persist::occupancy<ligru_bwd_persist<2, 16>>(smem, out)
                     : persist::occupancy<ligru_bwd_persist<2, 8>>(smem, out);
}

}  // extern "C"
