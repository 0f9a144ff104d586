// Fused GRU and minimalGRU recurrences for Hopper (sm_90a), forward and
// BPTT, plain C interface. The two cells share every kernel: the cell is
// the template parameter G, its number of gates (3: the GRU, 2: the
// minimalGRU), fixed at compile time.
//
// Replaces six TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_gru_fwd (fused_gru_fwd) and _build_mgru_fwd (fused_mgru_fwd):
//     the forward, in all its variants: the seeded carry h0 (with_init,
//     the streaming forward) and stash (the training forward, which also
//     writes [act(a_h), z, r] or [act(a_h), z] of every step);
//   _build_gru_bwd_stash and _build_mgru_bwd_stash (fused_gru_bwd /
//     fused_mgru_bwd, stash=1): the reverse recurrence over that stash;
//   _build_gru_bwd and _build_mgru_bwd (stash=0): the same, rebuilding the
//     forward's quantities from the gates and h_{t-1} (q per step).
// Gates are ordered [h | z | r] (GRU) or [h | z] (minimalGRU), candidate
// first; U = [Uh; Uz; Ur] is (3H, H), or [Uh; Uz] (2H, H). Per step t:
//
//   z    = sigmoid(g_z + q(h_{t-1}) @ Uz^T)
//   r    = sigmoid(g_r + q(h_{t-1}) @ Ur^T)              (GRU)
//   s    = r * h_{t-1} (GRU),  z * h_{t-1} (minimalGRU)
//   a    = act(g_h + q(s) @ Uh^T)
//   h_t  = z * h_{t-1} + (1 - z) * a * drop
//
// and in reverse, from dh_carry = 0 at t = T-1 (q passes the gradient
// straight through, as the TPU kernels' does). The GRU:
//
//   dh   = dh_carry + dhs[t]
//   dg_h = dh * (1 - z) * drop * act'
//   dg_z = dh * (h_{t-1} - a * drop) * z (1 - z)
//   ds   = dg_h @ Uh
//   dg_r = ds * h_{t-1} * r (1 - r)
//   dh_carry = dh * z + ds * r + [dg_z | dg_r] @ [Uz; Ur]
//
// The minimalGRU's z also gates s, so dg_z needs ds, which needs dg_h of
// every unit:
//
//   dh   = dh_carry + dhs[t]
//   dg_h = dh * (1 - z) * drop * act'
//   ds   = dg_h @ Uh
//   dg_z = (dh * (h_{t-1} - a * drop) + ds * h_{t-1}) * z (1 - z)
//   dh_carry = dh * z + ds * z + dg_z @ Uz
//
// act' comes from the activation's output (stash) or its input
// (recompute), as the TPU kernels take it. dU is not formed here: the
// caller computes it as two products over the unrolled (T*B) batch. Every
// value is float32 (the TPU kernels get U in float32 whatever the compute
// dtype).
//
// What bounds it on this card: at the TIMIT GRU's training shape (T=300,
// B=8, H=550) the forward's products are 2*T*B*3H*H = 4.36 GFLOP of
// float32 FMAs, 0.065 ms at 67 TFLOP/s; the stash forward moves ~23 MB
// (0.007 ms at 3.35 TB/s), so operations bound it; the recompute backward
// does the forward's products and their transposes (0.130 ms). The
// minimalGRU at the TIMIT Li-GRU cfg's 2x1024 (T=300, B=8) does 2*T*B*2H*H
// = 10.07 GFLOP (0.150 ms), the recompute backward twice that. But each
// step has TWO grid-wide dependencies: s needs r (z) of every unit, and
// the quantizer scale max|s| (per step over the whole (B, H) block) needs
// all of s; in reverse, ds needs dg_h of every unit before the carry's
// product (the GRU) or before dg_z (the minimalGRU). On Hopper blocks run
// in no order, so, as in fused_gru_sparse.cu, the forward launches two
// kernels per step from the host loop (the launch boundaries are the
// grid-wide barriers): gru_zr_step (z, r, s and max|s|) then gru_h_step
// (the candidate and h_t, max|h_t| for the next step's quantizer); each
// re-reads its rows of U (3.6 MB at H=550, 12.6 MB for the GRU at H=1024,
// 8.4 MB for the minimalGRU, resident in the 50 MB L2) every step. Its
// time is 2T launches, far above the bound; a persistent kernel with U
// split across the SMs' shared memory is later work.
//
// The recompute backward's forward quantities do not depend on dh, so they
// are rebuilt for all T at once before the reverse loop: one reduction for
// the T scales of q(h_{t-1}), then the same two step kernels over a grid
// with one z-slice per step, writing [a_pre | z | r] (or [a_pre | z]) to
// scratch. The reverse chain keeps two dependent steps per time step, so
// two kernels per step: gru_bwd_carry (dh from step t+1's [dg_z | dg_r]
// (dg_z) against [Uz; Ur] (Uz), then dg_h, and the GRU's dg_z) and
// gru_bwd_ds (ds from dg_h against Uh, then dg_r, or the minimalGRU's
// dg_z). Both products read rows of U^T (H, G*H), passed in, so the lanes
// read consecutive addresses.
//
// Per step, a block owns a few hidden units and BT batch rows: it stages
// the rows' q(h_{t-1}), q(s) or cotangents (BT x H or BT x 2H floats, 64 KB
// at H=1024) in shared memory, and each warp forms the dot of one row of U
// (or U^T) with every staged row (lanes over k, then a shuffle reduction).
// Widths need not be multiples of 32 or of the units per block (H=550):
// every loop masks.
//
// qbits > 0: q() scales by max|v| over the step's whole (B, H) block,
// taken with an atomicMax on the float bits (a non-negative float's bits
// order like its value) into a per-step slot zeroed first; var == 0 (the
// zero state) leaves v unquantized. The stash backward takes no quantizer.

#include <cmath>

#include "lstm_common.cuh"

namespace {

constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ZR_ROWS = 8;          // rows of [Uz; Ur] (Uz) per zr block
constexpr int H_UNITS = 8;          // units per candidate block: 8 rows of Uh
constexpr int BWD_UNITS = 8;        // units per backward block

// Units per zr block of a G-gate cell: 4 for the GRU, 8 for the
// minimalGRU.
__host__ __device__ constexpr int zr_units(int G) { return ZR_ROWS / (G - 1); }

// Stage nb rows of q(v) (rows of K floats, `ld` apart, from column c0)
// from row b0 into sm (BT x K); no quantizer when scale is null; nullptr v
// stages zeros.
__device__ __forceinline__ void stage_rows(const float* __restrict__ v,
                                           int ld, int c0, int b0, int nb,
                                           int K,
                                           const unsigned* __restrict__ scale,
                                           float qscale, float* sm) {
  const float var = scale ? __uint_as_float(*scale) : 0.f;
  for (int e = threadIdx.x; e < nb * K; e += THREADS) {
    const int b = e / K, k = e - b * K;
    float x = v ? v[(size_t)(b0 + b) * ld + c0 + k] : 0.f;
    if (scale) x = quant(x, var, qscale);
    sm[e] = x;
  }
}

// usm[b][r] = sum_k sm[b][k] * W[row(r)][c0 + k] over K columns, for the
// NR rows of a block: row(r) = (gate0 + r / UNITS) * H + u0 + r % UNITS,
// rows `ldw` floats apart. One warp per row, lanes over k, then a shuffle
// reduction.
template <int UNITS, int NR>
__device__ __forceinline__ void row_dots(const float* __restrict__ W, int ldw,
                                         int c0, const float* sm, int K,
                                         int u0, int gate0, int nb, int H,
                                         float (*usm)[NR]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < NR; r += WARPS) {
    const int unit = u0 + r % UNITS;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (unit < H) {
      const float* row =
          W + (size_t)((gate0 + r / UNITS) * H + unit) * ldw + c0;
#pragma unroll 4
      for (int k = lane; k < K; k += 32) {
        const float w = row[k];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(sm[b * K + k], w, acc[b]);
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

// Fold this thread's max bits into *slot (one atomic per warp).
__device__ __forceinline__ void slot_max(unsigned m, unsigned* slot) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(slot, m);
}

// z (and the GRU's r) and s of one step (blockIdx.z = step within the
// launch: the forward launches one step, the recompute backward all T).
// Writes z (and r) into fw (B, G*H) at H.. (and 2H..), s into s_out
// (B, H), max|s| bits into scale_s.
template <int G>
__global__ void __launch_bounds__(THREADS)
gru_zr_step(const float* __restrict__ gates,   // (B, G*H) [h | z (| r)]
            const float* __restrict__ U,       // (G*H, H) [Uh; Uz (; Ur)]
            const float* __restrict__ h_prev,  // (B, H); nullptr = zeros
            float* __restrict__ fw,            // (B, G*H) [a | z (| r)]
            float* __restrict__ s_out,         // (B, H)
            const unsigned* __restrict__ scale_h,  // max|h_prev| bits or null
            unsigned* __restrict__ scale_s,        // max|s| slot or null
            int B, int H, float qscale) {
  constexpr int UNITS = zr_units(G), NR = ZR_ROWS;
  extern __shared__ float sm[];                  // (BT, H) q(h_{t-1})
  __shared__ float usm[BT][NR];
  const size_t t = blockIdx.z, bh = (size_t)B * H, GH = (size_t)G * H;
  gates += t * G * bh;
  fw += t * G * bh;
  s_out += t * bh;
  if (h_prev) h_prev += t * bh;
  if (scale_h) scale_h += t;
  if (scale_s) scale_s += t;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_rows(h_prev, H, 0, b0, nb, H, scale_h, qscale, sm);
  __syncthreads();
  row_dots<UNITS, NR>(U, H, 0, sm, H, u0, 1, nb, H, usm);
  __syncthreads();

  unsigned m = 0;
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b);
    const float* g = gates + bb * GH;
    const float z = sigmoid(g[H + u] + usm[b][jj]);
    const float hp = h_prev ? h_prev[bb * H + u] : 0.f;
    float s = z * hp;
    if constexpr (G == 3) {
      const float r = sigmoid(g[2 * H + u] + usm[b][UNITS + jj]);
      fw[bb * GH + 2 * H + u] = r;
      s = r * hp;
    }
    fw[bb * GH + H + u] = z;
    s_out[bb * H + u] = s;
    m = max(m, __float_as_uint(fabsf(s)));
  }
  if (scale_s) slot_max(m, scale_s);
}

// The candidate of one step (blockIdx.z as above): a_pre = g_h + q(s) @
// Uh^T. With h_out (the forward): h_t = z * h_{t-1} + (1 - z) * act(a_pre)
// * drop into h_out, act(a_pre) into fw at 0.. and max|h_t| bits into
// scale_h_next. Without (the recompute backward's rebuild): a_pre into fw.
template <int G>
__global__ void __launch_bounds__(THREADS)
gru_h_step(const float* __restrict__ gates, const float* __restrict__ U,
           const float* __restrict__ drop,
           const float* __restrict__ h_prev,   // (B, H); nullptr = zeros
           const float* __restrict__ s,        // (B, H)
           float* __restrict__ fw,             // (B, G*H): z in, a out
           float* __restrict__ h_out,          // (B, H) or nullptr
           const unsigned* __restrict__ scale_s,   // max|s| bits or null
           unsigned* __restrict__ scale_h_next,    // max|h_t| slot or null
           int B, int H, int act, float qscale) {
  constexpr int UNITS = H_UNITS, NR = UNITS;
  extern __shared__ float sm[];                  // (BT, H) q(s)
  __shared__ float usm[BT][NR];
  const size_t t = blockIdx.z, bh = (size_t)B * H, GH = (size_t)G * H;
  gates += t * G * bh;
  fw += t * G * bh;
  s += t * bh;
  if (scale_s) scale_s += t;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_rows(s, H, 0, b0, nb, H, scale_s, qscale, sm);
  __syncthreads();
  row_dots<UNITS, NR>(U, H, 0, sm, H, u0, 0, nb, H, usm);
  __syncthreads();

  unsigned m = 0;
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u;
    const float a_pre = gates[bb * GH + u] + usm[b][jj];
    if (h_out) {
      const float a = act_fn(a_pre, act);
      const float z = fw[bb * GH + H + u];
      const float hp = h_prev ? h_prev[ih] : 0.f;
      const float h = z * hp + (1.f - z) * (a * drop[ih]);
      fw[bb * GH + u] = a;
      h_out[ih] = h;
      m = max(m, __float_as_uint(fabsf(h)));
    } else {
      fw[bb * GH + u] = a_pre;
    }
  }
  if (h_out && scale_h_next) slot_max(m, scale_h_next);
}

// act(a) and act'(a) of one unit from fw's candidate entry: a_pre under
// PRE (the recompute: act and act' from it), else act(a_pre) (the stash:
// act' from the output).
template <bool PRE>
__device__ __forceinline__ void cand(float f, int act, float* a, float* da) {
  if (PRE) {
    *a = act_fn(f, act);
    *da = dact_pre(f, act);
  } else {
    *a = f;
    *da = dact_out(f, act);
  }
}

// Reverse step t, first half: dh_t = dh_carry + dhs[t], with dh_carry =
// dh_{t+1} * z_{t+1} + ds_{t+1} * r_{t+1} + [dg_z | dg_r]_{t+1} @ [Uz; Ur]
// (the minimalGRU: (dh_{t+1} + ds_{t+1}) * z_{t+1} + dg_z_{t+1} @ Uz; 0 at
// t = T-1), then dg_h (and the GRU's dg_z) of step t. dh (B, H) holds
// dh_{t+1} on entry, dh_t on exit.
template <bool PRE, int G>
__global__ void __launch_bounds__(THREADS)
gru_bwd_carry(const float* __restrict__ fw_t,     // (B, G*H) [a | z (| r)]
              const float* __restrict__ fw_next,  // step t+1's, or null
              const float* __restrict__ Ut,       // (H, G*H) = U^T
              const float* __restrict__ drop,
              const float* __restrict__ h_prev,   // (B, H) h_{t-1}
              const float* __restrict__ dh_in,    // (B, H) dhs[t]
              const float* __restrict__ dg_next,  // (B, G*H) dg_{t+1} or null
              const float* __restrict__ ds,       // (B, H) ds_{t+1}
              float* __restrict__ dh, float* __restrict__ dg_t, int B, int H,
              int act) {
  constexpr int UNITS = BWD_UNITS;
  extern __shared__ float sm[];              // (BT, (G-1)H) [dg_z (| dg_r)]
  __shared__ float dsm[BT][UNITS];
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  if (dg_next) {
    stage_rows(dg_next, G * H, H, b0, nb, (G - 1) * H, nullptr, 0.f, sm);
    __syncthreads();
    row_dots<UNITS, UNITS>(Ut, G * H, H, sm, (G - 1) * H, u0, 0, nb, H, dsm);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u, ig = bb * G * H;
    float carry = 0.f;
    if (dg_next) {
      const float zn = fw_next[ig + H + u];
      const float gate_s = G == 3 ? fw_next[ig + 2 * H + u] : zn;
      carry = dh[ih] * zn + ds[ih] * gate_s + dsm[b][jj];
    }
    const float dhv = carry + dh_in[ih];
    const float z = fw_t[ig + H + u];
    float a, da;
    cand<PRE>(fw_t[ig + u], act, &a, &da);
    const float dr = drop[ih];
    dg_t[ig + u] = dhv * (1.f - z) * dr * da;
    if constexpr (G == 3) {
      const float dz = dhv * (h_prev[ih] - a * dr);
      dg_t[ig + H + u] = dz * z * (1.f - z);
    }
    dh[ih] = dhv;
  }
}

// Reverse step t, second half: ds_t = dg_h @ Uh (all units' dg_h, from
// gru_bwd_carry), then the GRU's dg_r or the minimalGRU's dg_z (from dh_t,
// which gru_bwd_carry left in dh); ds (B, H) <- ds_t.
template <bool PRE, int G>
__global__ void __launch_bounds__(THREADS)
gru_bwd_ds(const float* __restrict__ fw_t, const float* __restrict__ Ut,
           const float* __restrict__ drop, const float* __restrict__ h_prev,
           const float* __restrict__ dh, float* __restrict__ ds,
           float* __restrict__ dg_t, int B, int H, int act) {
  constexpr int UNITS = BWD_UNITS;
  extern __shared__ float sm[];                  // (BT, H) dg_h
  __shared__ float dsm[BT][UNITS];
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  stage_rows(dg_t, G * H, 0, b0, nb, H, nullptr, 0.f, sm);
  __syncthreads();
  row_dots<UNITS, UNITS>(Ut, G * H, 0, sm, H, u0, 0, nb, H, dsm);
  __syncthreads();

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u, ig = bb * G * H;
    const float dsv = dsm[b][jj];
    const float hp = h_prev[ih];
    if constexpr (G == 3) {
      const float r = fw_t[ig + 2 * H + u];
      dg_t[ig + 2 * H + u] = dsv * hp * r * (1.f - r);
    } else {
      const float z = fw_t[ig + H + u];
      float a, da;
      cand<PRE>(fw_t[ig + u], act, &a, &da);
      const float dz = dh[ih] * (hp - a * drop[ih]) + dsv * hp;
      dg_t[ig + H + u] = dz * z * (1.f - z);
    }
    ds[ih] = dsv;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int G>
cudaError_t run_fwd(const float* gates, const float* U, const float* drop,
                    const float* h0, float* hs, float* acts, float* fw,
                    float* s, unsigned* qslots, int T, int B, int H, int act,
                    int qbits, cudaStream_t stream) {
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = allow_smem(gru_zr_step<G>, smem);
  if (err == cudaSuccess) err = allow_smem(gru_h_step<G>, smem);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  // slots: max|h| of steps 0..T (slot 0 = the seed carry's, 0 for zeros)
  // and max|s| of steps 0..T-1
  unsigned* sh = qslots;
  unsigned* ss = qslots + T + 1;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T + 1) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
    if (h0) {
      absmax_bits<<<(B * H + 255) / 256, 256, 0, stream>>>(h0, B * H, sh);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  constexpr int ZU = zr_units(G);
  const dim3 zr_grid((H + ZU - 1) / ZU, (B + BT - 1) / BT);
  const dim3 h_grid((H + H_UNITS - 1) / H_UNITS, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* g = gates + (size_t)t * G * bh;
    const float* hp = t ? hs + (t - 1) * bh : h0;
    float* f = acts ? acts + (size_t)t * G * bh : fw;
    gru_zr_step<G><<<zr_grid, THREADS, smem, stream>>>(
        g, U, hp, f, s, q ? sh + t : nullptr, q ? ss + t : nullptr, B, H,
        qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gru_h_step<G><<<h_grid, THREADS, smem, stream>>>(
        g, U, drop, hp, s, f, hs + t * bh, q ? ss + t : nullptr,
        q ? sh + t + 1 : nullptr, B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool PRE, int G>
cudaError_t run_bwd(const float* lead, const float* U, const float* Ut,
                    const float* drop, const float* h_prev, const float* dhs,
                    float* fw, float* s_seq, float* dh, float* ds, float* dg,
                    unsigned* qslots, int T, int B, int H, int act, int qbits,
                    cudaStream_t stream) {
  const size_t smem_h = (size_t)BT * H * sizeof(float);
  const size_t smem_c = (size_t)BT * (G - 1) * H * sizeof(float);
  cudaError_t err = allow_smem(gru_bwd_carry<PRE, G>, smem_c);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_ds<PRE, G>, smem_h);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  const float* a = lead;
  if (PRE) {
    // the forward quantities of every step at once, from the gates
    err = allow_smem(gru_zr_step<G>, smem_h);
    if (err == cudaSuccess) err = allow_smem(gru_h_step<G>, smem_h);
    if (err != cudaSuccess) return err;
    const bool q = qbits > 0;
    const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
    unsigned* sh = qslots;
    unsigned* ss = qslots + T;
    if (q) {
      err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T) * sizeof(unsigned),
                            stream);
      if (err != cudaSuccess) return err;
      const int nblk = (int)((bh + 255) / 256 < 16 ? (bh + 255) / 256 : 16);
      absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, sh);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    constexpr int ZU = zr_units(G);
    const dim3 zr_grid((H + ZU - 1) / ZU, (B + BT - 1) / BT, T);
    gru_zr_step<G><<<zr_grid, THREADS, smem_h, stream>>>(
        lead, U, h_prev, fw, s_seq, q ? sh : nullptr, q ? ss : nullptr, B, H,
        qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 h_grid((H + H_UNITS - 1) / H_UNITS, (B + BT - 1) / BT, T);
    gru_h_step<G><<<h_grid, THREADS, smem_h, stream>>>(
        lead, U, drop, nullptr, s_seq, fw, nullptr, q ? ss : nullptr, nullptr,
        B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a = fw;
  }
  // the reverse chain, two kernels per step
  const dim3 grid((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  const size_t GB = (size_t)G * bh;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t + 1 == T;
    gru_bwd_carry<PRE, G><<<grid, THREADS, smem_c, stream>>>(
        a + t * GB, last ? nullptr : a + (t + 1) * GB, Ut, drop,
        h_prev + t * bh, dhs + t * bh, last ? nullptr : dg + (t + 1) * GB, ds,
        dh, dg + t * GB, B, H, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gru_bwd_ds<PRE, G><<<grid, THREADS, smem_h, stream>>>(
        a + t * GB, Ut, drop, h_prev + t * bh, dh, ds, dg + t * GB, B, H,
        act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int G>
int launch_bwd(const float* lead, const float* U, const float* Ut,
               const float* drop, const float* h_prev, const float* dhs,
               float* fw, float* s_seq, float* dh, float* ds, float* dg,
               unsigned* qslots, int T, int B, int H, int act, int qbits,
               int stash, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = stash ? run_bwd<false, G> : run_bwd<true, G>;
  return fn(lead, U, Ut, drop, h_prev, dhs, fw, s_seq, dh, ds, dg, qslots, T,
            B, H, act, qbits, stream);
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The GRU forward on `stream`: 2T step kernels (plus one small reduction
// over h0 when qbits > 0 and h0 is given). Returns the first cudaError_t
// seen, 0 on success.
//   gates: (T, B, 3H) [h | z | r];  U: (3H, H) [Uh; Uz; Ur];  drop: (B, H)
//   h0:    (B, H) seed carry, or null for zeros
//   hs:    (T, B, H) output;  acts: (T, B, 3H) stash output, or null
//   fw:    (B, 3H) scratch when acts is null;  s: (B, H) scratch
//   qslots: 2T+1 unsigned ints of scratch, used when qbits > 0
int fused_gru_fwd(const float* gates, const float* U, const float* drop,
                  const float* h0, float* hs, float* acts, float* fw, float* s,
                  unsigned* qslots, int T, int B, int H, int act, int qbits,
                  void* stream_ptr) {
  return run_fwd<3>(gates, U, drop, h0, hs, acts, fw, s, qslots, T, B, H, act,
                    qbits, static_cast<cudaStream_t>(stream_ptr));
}

// The GRU backward on `stream`: 2T step kernels in reverse time; the
// recompute backward (stash=0) first rebuilds the forward's quantities of
// all steps in two launches (after one reduction for the T scales of
// q(h_{t-1}) when qbits > 0). Returns the first cudaError_t seen, 0 on
// success.
//   lead:   (T, B, 3H) stash [act(a_h), z, r] (stash=1) or gates (stash=0)
//   U, Ut:  (3H, H) and its transpose (H, 3H)
//   h_prev: (T, B, H) carries entering each step;  dhs: (T, B, H)
//   fw:     (T, B, 3H) and s_seq: (T, B, H) scratch when stash=0
//   dh, ds: (B, H) scratch;  dg: (T, B, 3H) output
//   qslots: 2T unsigned ints of scratch when stash=0 and qbits > 0
int fused_gru_bwd(const float* lead, const float* U, const float* Ut,
                  const float* drop, const float* h_prev, const float* dhs,
                  float* fw, float* s_seq, float* dh, float* ds, float* dg,
                  unsigned* qslots, int T, int B, int H, int act, int qbits,
                  int stash, void* stream_ptr) {
  return launch_bwd<3>(lead, U, Ut, drop, h_prev, dhs, fw, s_seq, dh, ds, dg,
                       qslots, T, B, H, act, qbits, stash, stream_ptr);
}

// The minimalGRU forward: as fused_gru_fwd with gates (T, B, 2H) [h | z],
// U (2H, H) [Uh; Uz], acts (T, B, 2H) [act(a_h), z] and fw (B, 2H).
int fused_mgru_fwd(const float* gates, const float* U, const float* drop,
                   const float* h0, float* hs, float* acts, float* fw,
                   float* s, unsigned* qslots, int T, int B, int H, int act,
                   int qbits, void* stream_ptr) {
  return run_fwd<2>(gates, U, drop, h0, hs, acts, fw, s, qslots, T, B, H, act,
                    qbits, static_cast<cudaStream_t>(stream_ptr));
}

// The minimalGRU backward: as fused_gru_bwd with lead (T, B, 2H) (the stash
// [act(a_h), z] or the gates), U (2H, H), Ut (H, 2H), fw and dg
// (T, B, 2H).
int fused_mgru_bwd(const float* lead, const float* U, const float* Ut,
                   const float* drop, const float* h_prev, const float* dhs,
                   float* fw, float* s_seq, float* dh, float* ds, float* dg,
                   unsigned* qslots, int T, int B, int H, int act, int qbits,
                   int stash, void* stream_ptr) {
  return launch_bwd<2>(lead, U, Ut, drop, h_prev, dhs, fw, s_seq, dh, ds, dg,
                       qslots, T, B, H, act, qbits, stash, stream_ptr);
}

}  // extern "C"
