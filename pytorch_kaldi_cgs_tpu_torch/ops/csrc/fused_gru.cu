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
// product (the GRU) or before dg_z (the minimalGRU). The forward takes one
// of two routes, picked by the caller before the launch from the shapes
// and the occupancy query (fused_rnn.gru_fwd_route):
//
//   - "persist" (TPU rows 19 and 24's redesign): ONE cooperative launch
//     runs all T steps (gru_dense_fwd_persist, persist.cuh). A block owns
//     UN units (the last group masked where UN does not divide H) and BT
//     = 8 * BI batch rows for the whole call, its units' H-long rows of U
//     resident in shared memory ([Uz; Ur] as (G-1)*UN columns, Uh as UN),
//     and per step runs two phases with one grid barrier after each, the
//     two grid-wide dependencies: A stages q(h_{t-1}), forms the z (and r)
//     dots, writes s and its block's max|s|; B stages q(s), forms the
//     candidate's dots, writes h_t and its block's max|h_t|. The blocks
//     exchange h_t and s through two (B, HP) buffers whose rows are padded
//     to HP = H rounded up to 4 floats, since cp.async copies 16-byte
//     aligned chunks and a row of hs at H=550 is not aligned. A seeded
//     carry h0 is copied there (with its block maxima) before one extra
//     barrier, so a call is one launch with or without it.
//   - "step" (a shape whose blocks do not fit or are not co-resident):
//     two kernels per step from the host loop (the launch boundaries are
//     the grid-wide barriers): gru_zr_step (z, r, s and max|s|) then
//     gru_h_step (the candidate and h_t, max|h_t| for the next step's
//     quantizer); each re-reads its rows of U (3.6 MB at H=550, 12.6 MB
//     for the GRU at H=1024, 8.4 MB for the minimalGRU, resident in the
//     50 MB L2) every step. Its time is 2T launches, far above the bound.
//
// The recompute backward's forward quantities do not depend on dh, so they
// are rebuilt for all T at once before the reverse loop. The minimalGRU's
// (TPU row 26) takes one of two routes, picked by the caller before the
// launch (fused_rnn.mgru_bwd_route):
//
//   - "persist": the rebuild over all M = T*B rows as two products
//     (rows_dots: one gate's rows of U resident in a block, the rows of
//     every step streamed through it, each dot in the forward's order, the
//     gates added) around one elementwise pass: with qbits > 0 the T
//     scales and q(h_{t-1}), z's pre-activations, z, s = z * h_{t-1} and
//     the T scales of q(s) (mgru_z_rebuild), q(s), a_pre: the forward's
//     bits, so act' takes the forward's branch;
//     then the whole reverse chain is ONE cooperative launch of
//     gru_dense_bwd_persist (persist.cuh): a block owns 8 units and BT =
//     8 * BI rows (8, 16 or 32) for all steps, its units' columns of Uz
//     and Uh resident in shared memory, and per reverse step runs two
//     phases with a grid barrier after each (ds = dg_h @ Uh needs dg_h of
//     every unit before dg_z). Its chain's sums run in another order than
//     the step route's (its warps split the contraction). The chain is a
//     template over G and the stash.
//   - "step" (a shape whose blocks do not fit or are not co-resident):
//     one reduction for the T scales of q(h_{t-1}), then the same two
//     step kernels as the forward's over a grid with one z-slice per
//     step, writing [a_pre | z | r] (or [a_pre | z]) to scratch, then the
//     reverse chain's two step kernels a step, as below.
//
// The GRU's stash backward (TPU row 20, the TIMIT GRU's default) takes
// one of two routes, picked by the caller before the launch
// (fused_rnn.gru_bwd_stash_route):
//
//   - "persist": the same chain, gru_dense_bwd_persist<3, BI, UN, false>,
//     over the stash [act(a_h) | z | r] as the forward wrote it: ONE
//     cooperative launch, a block's units' columns of [Uz; Ur] (2H rows)
//     and of Uh (H rows) resident, two grid barriers a reverse step (phase
//     1 stages [dg_z | dg_r] of step t+1, 2H floats a row; phase 2 dg_h of
//     step t). 8 units and 8, 16 or 32 rows (4 units x 8 rows, two blocks
//     an SM, is instantiated too: slower at the TIMIT GRU's shape). Where a
//     block's rows of 2H floats do not fit beside its weights (H=1024 at 16
//     rows and above), "step".
//   - "step": the two step kernels a reverse step below.
//
// The GRU's recompute backward and the minimalGRU's stash one run on the
// step kernels only. The reverse chain keeps two dependent steps per time
// step, so two kernels per step:
//     gru_bwd_carry (dh from step t+1's [dg_z | dg_r] (dg_z) against [Uz;
//     Ur] (Uz), then dg_h, and the GRU's dg_z) and gru_bwd_ds (ds from
//     dg_h against Uh, then dg_r, or the minimalGRU's dg_z). Both products
//     read rows of U^T (H, G*H), passed in, so the lanes read consecutive
//     addresses.
//
// On the step routes, a block owns a few hidden units and BT batch rows
// per step: it stages
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
#include "persist.cuh"

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

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU rows 19 and 24's redesign; persist.cuh), for a G-gate
// cell. Block c owns the UN units from u0 = (c % ug) * UN (ug = ceil(H /
// UN); units past H get zero weights and no output) and the BT = 8 * BI
// batch rows from b0 = (c / ug) * BT. It copies into shared memory once
// its units' rows of U: [Uz; Ur] ([Uz]) as the (G-1)*UN rows of wzr and
// Uh as the UN rows of wh, H floats each. Its thread o = b * UN + jj
// keeps h_{t-1} of its (row, unit) in a register and loads the next
// step's gates before the barrier. With a seed h0, each thread first
// copies its entry into xh and its block's max|h0| into bmax[0], then one
// barrier. Per step t (at t = 0 without a seed the carry is zero: no
// staging and no dots, and no barrier after phase A):
//   A. stage h_{t-1} from xh, q() at the max over bmax[0], dots against
//      wzr, z (and r), the stash's z (and r), s = r * h_{t-1} (z *
//      h_{t-1}) into xs, the block's max|s| into its entry of bmax[1];
//      barrier;
//   B. stage s from xs the same way, q() at the max over bmax[1], dots
//      against wh, a = act(g_h + dot), h_t into hs and xh, a into the
//      stash, the block's max|h_t| into its entry of bmax[0]; barrier
//      (none after the last step).
// xh and xs are (B, HP) with HP = H rounded up to 4 floats, so that each
// staged row starts 16-byte aligned; the padding is copied, never summed.
// Each dot is one warp's, lanes over k and a shuffle reduction, as in the
// step kernels' row_dots (persist::resident_dots), and q() (quant_rcp:
// quant()'s bits, with the reciprocal of the scale taken once a phase)
// runs once over the staged values (persist::stage_quant): the
// persistent route gives the step route's bits, and so the dense stream
// of a sparse layer the sparse forward's, as before. (The sparse chain's
// persist::unit_dots, whose warps split the contraction, was as fast
// here, but its sums moved the CGS-16x minimalGRU's stream, relu behind
// two 16-bit ceil quantizers and a x10000 head, past chip_smoke.py's
// bound against the sparse forward.)
template <int G, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
gru_dense_fwd_persist(const float* __restrict__ gates,  // (T, B, G*H)
                      const float* __restrict__ U,      // (G*H, H)
                      const float* __restrict__ drop,   // (B, H)
                      const float* __restrict__ h0,     // (B, H) or null
                      float* __restrict__ hs,           // (T, B, H) output
                      float* __restrict__ acts,         // (T, B, G*H) or null
                      float* xh, float* xs,             // (B, HP) exchange
                      unsigned* bmax,                   // (2, grid), or null
                      int T, int B, int H, int act, float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, ZC = (G - 1) * UN;
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int SK = P::row_stride(H), HP = (H + 3) / 4 * 4;
  float* wzr = psm;                                // (ZC, H)
  float* wh = wzr + (size_t)ZC * H;                // (UN, H)
  float* xsm = wh + (size_t)UN * H;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[ZC]>(xsm + (size_t)BT * SK);
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int i = threadIdx.x; i < ZC * H; i += P::THREADS) {
    const int r = i / H, k = i - r * H, u = u0 + r % UN;
    wzr[i] = u < H ? U[((size_t)(1 + r / UN) * H + u) * H + k] : 0.f;
  }
  for (int i = threadIdx.x; i < UN * H; i += P::THREADS) {
    const int r = i / H, k = i - r * H, u = u0 + r;
    wh[i] = u < H ? U[(size_t)u * H + k] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, gbh = (size_t)G * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * G * H;
  const size_t ix = (size_t)(b0 + ob) * HP + ou;
  const float dr = mine ? drop[ih] : 0.f;
  unsigned* hmax = bmax;                            // max|h_t| by block
  unsigned* smax = bmax ? bmax + gridDim.x : nullptr;   // max|s_t|
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  // stage this block's rows of v (B, HP), q() at the grid's max of
  // `maxes` (persist::stage_quant)
  auto stage = [&](const float* v, const unsigned* maxes) {
    return P::stage_quant(v, HP, b0, nb, xsm, SK, maxes, gridDim.x, &gmax,
                          qscale, iscale);
  };
  auto block_max = [&](unsigned m, unsigned* out) {
    P::block_max(m, out, wmax);
  };
  struct In {
    float gh, gz, gr;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* g = gates + t * gbh + ig;
      v.gh = g[ou];
      v.gz = g[H + ou];
      if (G == 3) v.gr = g[2 * H + ou];
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
      xh[ix] = hp;
      m = __float_as_uint(fabsf(hp));
    }
    if (hmax) block_max(m, hmax);
    grid.sync();
  }
  In cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const bool dots = t > 0 || seeded;
    // A: z (and r), s
    float dz = 0.f, dq = 0.f;
    if (dots) {
      stage(xh, hmax);
      P::resident_dots<BT, ZC, ZC>(wzr, xsm, SK, H, nb, usm);
      __syncthreads();
      if (mine) {
        dz = usm[ob][oj];
        if (G == 3) dq = usm[ob][UN + oj];
      }
    }
    float z = 0.f;
    unsigned m = 0;
    if (mine) {
      z = sigmoid(cur.gz + dz);
      float s = z * hp;
      if (G == 3) {
        const float r = sigmoid(cur.gr + dq);
        s = r * hp;
        if (acts) acts[t * gbh + ig + 2 * H + ou] = r;
      }
      if (acts) acts[t * gbh + ig + H + ou] = z;
      xs[ix] = s;
      m = __float_as_uint(fabsf(s));
    }
    if (dots) {
      if (smax) block_max(m, smax);
      grid.sync();
    }
    // B: the candidate and h_t
    float da = 0.f;
    if (dots) {
      stage(xs, smax);
      P::resident_dots<BT, UN, ZC>(wh, xsm, SK, H, nb, usm);
      __syncthreads();
      if (mine) da = usm[ob][oj];
    }
    m = 0;
    if (mine) {
      const float a = act_fn(cur.gh + da, act);
      const float h = z * hp + (1.f - z) * (a * dr);
      hs[t * bh + ih] = h;
      xh[ix] = h;
      if (acts) acts[t * gbh + ig + ou] = a;
      hp = h;
      m = __float_as_uint(fabsf(h));
    }
    if (t + 1 < T) {
      if (hmax) block_max(m, hmax);
      cur = fetch(t + 1);
      grid.sync();
    }
  }
}

// one cooperative launch of the persistent forward at block shape (BI, UN)
template <int G, int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const float* U,
                               const float* drop, const float* h0, float* hs,
                               float* acts, float* xh, float* xs,
                               unsigned* bmax, int T, int B, int H, int act,
                               float qscale) {
  return persist::launch<gru_dense_fwd_persist<G, BI, UN>>(
      grid, smem, stream, gates, U, drop, h0, hs, acts, xh, xs, bmax, T, B,
      H, act, qscale);
}

// The block shapes (bi, units) of the persistent forward: the plan's
// (1, 8), (2, 8) and (2, 16), and (1, 4) and (1, 16), which a forced plan
// times at 8 rows. -> the launcher and the occupancy query of one, or
// nulls for another shape.
using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const float*, const float*, const float*,
                                  float*, float*, float*, float*, unsigned*,
                                  int, int, int, int, float);
using FwdOccupancy = cudaError_t (*)(int, int*);

template <int G>
void fwd_shape(int bi, int units, FwdLaunch* launch, FwdOccupancy* occ) {
#define PK_FWD_SHAPE(BI_, UN_)                                            \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<G, BI_, UN_>;                            \
    *occ = persist::occupancy<gru_dense_fwd_persist<G, BI_, UN_>>;        \
    return;                                                               \
  }
  PK_FWD_SHAPE(1, 4)
  PK_FWD_SHAPE(1, 8)
  PK_FWD_SHAPE(2, 8)
  PK_FWD_SHAPE(1, 16)
  PK_FWD_SHAPE(2, 16)
#undef PK_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void fwd_shape_of(int G, int bi, int units, FwdLaunch* launch,
                  FwdOccupancy* occ) {
  if (G == 3)
    fwd_shape<3>(bi, units, launch, occ);
  else if (G == 2)
    fwd_shape<2>(bi, units, launch, occ);
  else
    *launch = nullptr, *occ = nullptr;
}

// The rows of the minimalGRU recompute backward's rebuild staged at once
// by a block of rows_dots, and its weight rows.
constexpr int REBUILD_UNITS = 16;

// u[m * ldo + n] = add[m * ldo + n] + sum_k x[m][k] * W[n][k] for all M
// rows of x (M, K) and the N rows of W (N, K): one gate's recurrent
// pre-activations of every step at once (route "persist" of the
// minimalGRU's recompute backward), each dot summed in the forward's order
// (persist::resident_dots: the step kernels' row_dots order), so the
// rebuilt z and a_pre have the forward's bits and act' the forward's
// branch (a GEMM's order moved a relu pre-activation within 1e-7 of 0
// across the kink between the stash and the recompute backward). Block c
// owns REBUILD_UNITS rows of W from n0 = (c % ug) * REBUILD_UNITS,
// resident in shared memory, and the tiles of BT rows of x c / ug, c / ug
// + chunks, ...; per tile it stages the rows (float4 loads where K is a
// multiple of 4 and x 16-byte aligned), forms the dots and adds `add`.
template <int BT>
__global__ void __launch_bounds__(persist::THREADS, 1)
rows_dots(const float* __restrict__ x, const float* __restrict__ W,
          const float* __restrict__ add, float* __restrict__ u, int M, int K,
          int N, int ldo, int chunks) {
  namespace P = persist;
  constexpr int NR = REBUILD_UNITS;
  extern __shared__ __align__(16) float psm[];
  const int SK = P::row_stride(K);
  float* ws = psm;                                 // (NR, K)
  float* xs = ws + (size_t)NR * K;                 // (BT, SK)
  auto usm = reinterpret_cast<float (*)[NR]>(xs + (size_t)BT * SK);
  const int ug = (N + NR - 1) / NR;
  const int n0 = (blockIdx.x % ug) * NR, c0 = blockIdx.x / ug;
  for (int i = threadIdx.x; i < NR * K; i += P::THREADS) {
    const int r = i / K, k = i - r * K;
    ws[i] = n0 + r < N ? W[(size_t)(n0 + r) * K + k] : 0.f;
  }
  const bool vec = (K & 3) == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  for (int m0 = c0 * BT; m0 < M; m0 += chunks * BT) {
    const int nb = min(BT, M - m0);
    if (vec) {
      const int cpr = K / 4;
      for (int e = threadIdx.x; e < nb * cpr; e += P::THREADS) {
        const int b = e / cpr, j = e - b * cpr;
        reinterpret_cast<float4*>(xs + (size_t)b * SK)[j] =
            reinterpret_cast<const float4*>(x + (size_t)(m0 + b) * K)[j];
      }
    } else {
      for (int e = threadIdx.x; e < nb * K; e += P::THREADS) {
        const int b = e / K, k = e - b * K;
        xs[(size_t)b * SK + k] = x[(size_t)(m0 + b) * K + k];
      }
    }
    __syncthreads();
    P::resident_dots<BT, NR, NR>(ws, xs, SK, K, nb, usm);
    __syncthreads();
    for (int e = threadIdx.x; e < nb * NR; e += P::THREADS) {
      const int b = e / NR, r = e - b * NR;
      if (n0 + r < N) {
        const size_t at = (size_t)(m0 + b) * ldo + n0 + r;
        u[at] = add[at] + usm[b][r];
      }
    }
    __syncthreads();
  }
}

// rows_dots on `stream` with the largest tile of rows (bt: 32, 16 or 8,
// fused_rnn.mgru_rebuild_rows) that fits beside the weight rows, over
// about one block an SM.
cudaError_t rows_dots_launch(const float* x, const float* W,
                             const float* add, float* u, int M, int K, int N,
                             int ldo, int bt, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ug = (N + REBUILD_UNITS - 1) / REBUILD_UNITS;
  const int tiles = (M + bt - 1) / bt;
  const int fit = sms / ug > 1 ? sms / ug : 1;
  const int chunks = fit < tiles ? fit : tiles;
  const int smem = (REBUILD_UNITS * K + bt * persist::row_stride(K) +
                    bt * REBUILD_UNITS) * (int)sizeof(float);
#define PK_ROWS_DOTS(BT_)                                                 \
  if (bt == BT_) {                                                        \
    err = persist::allow_once<rows_dots<BT_>>(smem);                      \
    if (err != cudaSuccess) return err;                                   \
    rows_dots<BT_><<<ug * chunks, persist::THREADS, smem, stream>>>(      \
        x, W, add, u, M, K, N, ldo, chunks);                              \
    return cudaGetLastError();                                            \
  }
  PK_ROWS_DOTS(32)
  PK_ROWS_DOTS(16)
  PK_ROWS_DOTS(8)
#undef PK_ROWS_DOTS
  return cudaErrorInvalidValue;
}

// The minimalGRU recompute backward's rebuild between its two products
// (route "persist"): fw's z half holds each row's z pre-activation g_z +
// q(h_{t-1}) @ Uz^T; z = sigmoid(it) in its place, s = z * h_{t-1} into
// s_out and max|s| of each step into scale_s (null: none). Blocks over
// (the H units, rows).
__global__ void mgru_z_rebuild(float* __restrict__ fw,
                               const float* __restrict__ h_prev,
                               float* __restrict__ s_out,
                               unsigned* __restrict__ scale_s, int M, int B,
                               int H) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    unsigned m = 0;
    if (u < H) {
      const size_t ih = (size_t)row * H + u, iz = (size_t)row * 2 * H + H + u;
      const float z = sigmoid(fw[iz]);
      const float sv = z * h_prev[ih];
      fw[iz] = z;
      s_out[ih] = sv;
      m = __float_as_uint(fabsf(sv));
    }
    if (scale_s) slot_max(m, scale_s + row / B);
  }
}

// The dense reverse chain in one cooperative launch (route "persist", TPU
// row 26's redesign; persist.cuh), for a G-gate cell over fw, every step's
// [a_pre | z (| r)] (PRE: the recompute backward's rebuild) or the stash
// [act(a_h) | z (| r)]. Block c owns the UN units from u0 = (c % ug) * UN
// (ug = ceil(H / UN); units past H get zero weights and no output) and the
// BT = 8 * BI batch rows from b0 = (c / ug) * BT. It copies into shared
// memory once its units' columns of U: [Uz; Ur] ([Uz]) as the (G-1)H rows
// of ws1, Uh as the H rows of ws2, w_stride(UN) floats apart. Its thread
// o = b * UN + jj keeps dh, ds and step t+1's gates of its (row, unit) in
// registers and loads the next step's inputs (fw, h_prev, dhs) before the
// second barrier. Per reverse step t, two dependent products, so two grid
// barriers (the second skipped at t = 0):
//   1. stage [dg_z (| dg_r)]_{t+1} from xzr, dots against ws1: dh_t =
//      (dh_{t+1} + ds_{t+1}) z_{t+1} + dg_z_{t+1} @ Uz + dhs[t] (the
//      GRU: dh_{t+1} z_{t+1} + ds_{t+1} r_{t+1} + [dg_z | dg_r]_{t+1} @
//      [Uz; Ur] + dhs[t]); dg_h of step t (and the GRU's dg_z) into dg
//      and dg_h into xh; barrier (ds needs every unit's dg_h);
//   2. stage dg_h of step t from xh, dots against ws2: ds_t = dg_h @ Uh,
//      then the minimalGRU's dg_z (the GRU's dg_r) into dg and xzr;
//      barrier.
// The step kernels' arithmetic (gru_bwd_carry, gru_bwd_ds) on each
// (row, unit); the dots are persist::unit_dots' (warps split the
// contraction). xh (B, HP) and xzr (2, B, ZP) have rows padded to 4
// floats (HP = H, ZP = (G-1)H rounded up) for cp.async; xzr is two
// buffers picked by the step's parity, since the GRU writes dg_z of step t
// in phase 1 while a slower block may still stage step t+1's.
template <int G, int BI, int UN, bool PRE>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
gru_dense_bwd_persist(const float* __restrict__ fw,      // (T, B, G*H)
                      const float* __restrict__ U,       // (G*H, H)
                      const float* __restrict__ drop,    // (B, H)
                      const float* __restrict__ h_prev,  // (T, B, H)
                      const float* __restrict__ dhs,     // (T, B, H)
                      float* __restrict__ dg,            // (T, B, G*H)
                      float* xh, float* xzr,             // exchange
                      int T, int B, int H, int act) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, WS = P::w_stride(UN);
  extern __shared__ __align__(16) float psm[];
  const int K1 = (G - 1) * H, HP = (H + 3) / 4 * 4, ZP = (K1 + 3) / 4 * 4;
  const int SK = P::row_stride(K1);
  float* ws1 = psm;                                // (K1, WS)
  float* ws2 = ws1 + (size_t)K1 * WS;              // (H, WS)
  float* xs = ws2 + (size_t)H * WS;                // (BT, SK)
  float* red = xs + (size_t)BT * SK;
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int e = threadIdx.x; e < K1 * UN; e += P::THREADS) {
    const int k = e / UN, j = e - k * UN;
    ws1[k * WS + j] = u0 + j < H ? U[(size_t)(H + k) * H + u0 + j] : 0.f;
  }
  for (int e = threadIdx.x; e < H * UN; e += P::THREADS) {
    const int k = e / UN, j = e - k * UN;
    ws2[k * WS + j] = u0 + j < H ? U[(size_t)k * H + u0 + j] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, ou = u0 + o % UN;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, gbh = (size_t)G * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * G * H;
  const size_t zstep = (size_t)B * ZP, iz = (size_t)(b0 + ob) * ZP + ou;
  const float dr = mine ? drop[ih] : 0.f;
  // stage `len` floats of this block's rows of x (rows `ld` apart)
  auto stage = [&](const float* x, int ld, int len) {
    P::stage_rows(nb, len, [&](int b) { return x + (size_t)(b0 + b) * ld; },
                  [&](int b) { return xs + (size_t)b * SK; });
    P::cp_async_wait_all();
    __syncthreads();
  };
  // step t's inputs of this thread's (row, unit), loaded a step ahead
  struct In {
    float f, z, r, hp, dh;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* f = fw + t * gbh + ig;
      v.f = f[ou];
      v.z = f[H + ou];
      if (G == 3) v.r = f[2 * H + ou];
      v.hp = h_prev[t * bh + ih];
      v.dh = dhs[t * bh + ih];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dh = 0.f, ds = 0.f, zn = 0.f, rn = 0.f;
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float* xz = xzr + (t & 1) * zstep;
    float dot = 0.f;
    if (t + 1 < T) {
      stage(xzr + ((t + 1) & 1) * zstep, ZP, ZP);
      P::unit_dots<BI, UN>(xs, SK, ws1, K1, red);
      if (o < BT * UN) dot = P::unit_sum<BI, UN>(red, o);
    }
    float a = 0.f, da = 0.f;
    if (mine) {
      const float gate_s = G == 3 ? rn : zn;
      const float carry = t + 1 < T ? dh * zn + ds * gate_s + dot : 0.f;
      const float dhv = carry + cur.dh;
      const float z = cur.z;
      cand<PRE>(cur.f, act, &a, &da);
      const float dgh = dhv * (1.f - z) * dr * da;
      float* d = dg + t * gbh + ig;
      d[ou] = dgh;
      xh[(size_t)(b0 + ob) * HP + ou] = dgh;
      if constexpr (G == 3) {
        const float dz = dhv * (cur.hp - a * dr);
        const float dgz = dz * z * (1.f - z);
        d[H + ou] = dgz;
        xz[iz] = dgz;
      }
      dh = dhv;
      zn = z;
      rn = cur.r;
    }
    grid.sync();
    stage(xh, HP, HP);
    P::unit_dots<BI, UN>(xs, SK, ws2, H, red);
    if (mine) {
      ds = P::unit_sum<BI, UN>(red, o);
      const float hp = cur.hp;
      float* d = dg + t * gbh + ig;
      if constexpr (G == 3) {
        const float r = cur.r;
        const float dgr = ds * hp * r * (1.f - r);
        d[2 * H + ou] = dgr;
        xz[iz + H] = dgr;
      } else {
        const float z = cur.z;
        const float dz = dh * (hp - a * dr) + ds * hp;
        const float dgz = dz * z * (1.f - z);
        d[H + ou] = dgz;
        xz[iz] = dgz;
      }
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
  }
}

// one cooperative launch of the dense reverse chain at block shape (BI, UN)
template <int G, int BI, int UN, bool PRE>
cudaError_t launch_bwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* fw, const float* U,
                               const float* drop, const float* h_prev,
                               const float* dhs, float* dg, float* xh,
                               float* xzr, int T, int B, int H, int act) {
  return persist::launch<gru_dense_bwd_persist<G, BI, UN, PRE>>(
      grid, smem, stream, fw, U, drop, h_prev, dhs, dg, xh, xzr, T, B, H,
      act);
}

// The block shapes (bi, units) of the dense reverse chain: for the
// minimalGRU's recompute backward (G=2, PRE) the plan's (1, 8), (2, 8) and
// (4, 8); for the GRU's stash backward (G=3, the stash) those and (1, 4),
// two blocks an SM, which a forced plan times. -> the launcher and the
// occupancy query of one, or nulls for another shape or cell.
using BwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const float*, const float*, const float*,
                                  const float*, float*, float*, float*, int,
                                  int, int, int);

void bwd_shape_of(int G, int bi, int units, BwdLaunch* launch,
                  FwdOccupancy* occ) {
  *launch = nullptr;
  *occ = nullptr;
  if (G == 2) {
#define PK_BWD_SHAPE(BI_, UN_)                                            \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_bwd_persist<2, BI_, UN_, true>;                      \
    *occ = persist::occupancy<gru_dense_bwd_persist<2, BI_, UN_, true>>;  \
    return;                                                               \
  }
  PK_BWD_SHAPE(1, 8)
  PK_BWD_SHAPE(2, 8)
  PK_BWD_SHAPE(4, 8)
#undef PK_BWD_SHAPE
  } else if (G == 3) {
#define PK_GRU_BWD_SHAPE(BI_, UN_)                                        \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_bwd_persist<3, BI_, UN_, false>;                     \
    *occ = persist::occupancy<gru_dense_bwd_persist<3, BI_, UN_, false>>; \
    return;                                                               \
  }
  PK_GRU_BWD_SHAPE(1, 4)
  PK_GRU_BWD_SHAPE(1, 8)
  PK_GRU_BWD_SHAPE(2, 8)
  PK_GRU_BWD_SHAPE(4, 8)
#undef PK_GRU_BWD_SHAPE
  }
}

dim3 rows_grid(int M, int H) {
  return dim3((H + 255) / 256, M < 65535 ? M : 65535);
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

// The GRU forward on the step route on `stream`: 2T step kernels (plus
// one small reduction over h0 when qbits > 0 and h0 is given). Returns the first cudaError_t
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

// The GRU (G=3) or minimalGRU (G=2) forward on the persistent route on
// `stream`: one cooperative launch of `grid` blocks of
// gru_dense_fwd_persist (bi: BT = 8 * bi rows a block; units: 4, 8 or
// 16; smem bytes of dynamic shared memory: fused_rnn.gru_fwd_plan sizes
// all three). Returns its cudaError_t; cudaErrorInvalidValue for a shape
// not instantiated.
//   gates: (T, B, G*H);  U: (G*H, H);  drop: (B, H);  h0: (B, H) or null
//   hs: (T, B, H) output;  acts: (T, B, G*H) stash output, or null
//   xh, xs: (B, HP) scratch, HP = H rounded up to a multiple of 4
//   bmax: 2 * grid unsigned ints of scratch when qbits > 0
int gru_fwd_dense_persist(const float* gates, const float* U,
                          const float* drop, const float* h0, float* hs,
                          float* acts, float* xh, float* xs, unsigned* bmax,
                          int G, int T, int B, int H, int act, int qbits,
                          int grid, int bi, int units, int smem,
                          void* stream_ptr) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(G, bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates, U,
            drop, h0, hs, acts, xh, xs, q ? bmax : nullptr, T, B, H, act,
            qscale);
}

// out[0..2]: the persistent forward's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (G, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int gru_fwd_dense_occupancy(int G, int bi, int units, int smem, int* out) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(G, bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
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

// The minimalGRU recompute backward on the persistent route on `stream`:
// the forward quantities of all M = T*B rows first (with qbits > 0 the T
// scales of q(h_prev) into qslots[0, T), zeroed here, and q(h_prev) into
// qh), z's pre-activations g_z + q(h_prev) @ Uz^T into fw's z half, z, s
// = z * h_prev (s_seq) and the T scales of q(s) (mgru_z_rebuild), q(s)
// into qs, a_pre = g_h + q(s) @ Uh^T into fw's candidate half (both
// products rows_dots, tiles of `rb` rows: 32, 16 or 8); then one
// cooperative launch of `grid` blocks of gru_dense_bwd_persist<2, ., .,
// true> (bi: BT = 8 * bi rows a block; units: 8; smem bytes of dynamic
// shared memory: fused_rnn.mgru_bwd_plan sizes all three). Returns the
// first cudaError_t seen; cudaErrorInvalidValue for a shape not
// instantiated.
//   gates, fw, dg: (T, B, 2H);  U: (2H, H);  drop: (B, H)
//   h_prev, dhs, qh, s_seq, qs: (T, B, H)
//   xh: (B, HP), xzr: (2, B, HP) scratch, HP = H rounded up to 4
//   qslots: 2T unsigned ints of scratch when qbits > 0
int mgru_bwd_persist_run(const float* gates, const float* U,
                         const float* drop, const float* h_prev,
                         const float* dhs, float* qh, float* fw, float* s_seq,
                         float* qs, float* xh, float* xzr, float* dg,
                         unsigned* qslots, int T, int B, int H, int act,
                         int qbits, int rb, int grid, int bi, int units,
                         int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  BwdLaunch fn;
  FwdOccupancy occ;
  bwd_shape_of(2, bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  const size_t bh = (size_t)B * H;
  const int M = T * B, nblk = (int)((bh + 255) / 256 < 16 ? (bh + 255) / 256
                                                           : 16);
  const float* x = h_prev;
  cudaError_t err = cudaSuccess;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    quant_steps<false><<<dim3(nblk, T), 256, 0, stream>>>(
        h_prev, qslots, qscale, qh, (int)bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = qh;
  }
  err = rows_dots_launch(x, U + (size_t)H * H, gates + H, fw + H, M, H, H,
                         2 * H, rb, stream);
  if (err != cudaSuccess) return err;
  mgru_z_rebuild<<<rows_grid(M, H), 256, 0, stream>>>(
      fw, h_prev, s_seq, q ? qslots + T : nullptr, M, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* s = s_seq;
  if (q) {
    quant_steps<false><<<dim3(nblk, T), 256, 0, stream>>>(
        s_seq, qslots + T, qscale, qs, (int)bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s = qs;
  }
  err = rows_dots_launch(s, U, gates, fw, M, H, H, 2 * H, rb, stream);
  if (err != cudaSuccess) return err;
  return fn(grid, smem, stream, fw, U, drop, h_prev, dhs, dg, xh, xzr, T, B,
            H, act);
}

// The GRU's stash backward on the persistent route on `stream`: one
// cooperative launch of `grid` blocks of gru_dense_bwd_persist<3, ., .,
// false> over the stash (bi: BT = 8 * bi rows a block; units: 4 or 8;
// smem bytes of dynamic shared memory: fused_rnn.gru_bwd_stash_plan sizes
// all three). Returns its cudaError_t; cudaErrorInvalidValue for a shape
// not instantiated.
//   acts, dg: (T, B, 3H) the stash [act(a_h), z, r] and the output
//   U: (3H, H);  drop: (B, H);  h_prev, dhs: (T, B, H)
//   xh: (B, HP), xzr: (2, B, ZP) scratch, HP = H and ZP = 2H rounded up
//   to a multiple of 4
int gru_bwd_stash_persist_run(const float* acts, const float* U,
                              const float* drop, const float* h_prev,
                              const float* dhs, float* xh, float* xzr,
                              float* dg, int T, int B, int H, int act,
                              int grid, int bi, int units, int smem,
                              void* stream_ptr) {
  BwdLaunch fn;
  FwdOccupancy occ;
  bwd_shape_of(3, bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), acts, U, drop,
            h_prev, dhs, dg, xh, xzr, T, B, H, act);
}

// out[0..2]: the dense reverse chain's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (G: 2 the minimalGRU's recompute chain, 3
// the GRU's stash chain; bi and units as above), the SM count, and whether
// the device takes cooperative launches.
int gru_bwd_dense_occupancy(int G, int bi, int units, int smem, int* out) {
  BwdLaunch fn;
  FwdOccupancy occ;
  bwd_shape_of(G, bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
