// Block-sparse fused GRU and minimalGRU recurrences for Hopper (sm_90a),
// forward and BPTT, plain C interface. The two cells share every kernel:
// the cell is the template parameter G, its number of gates (3: the GRU,
// 2: the minimalGRU), fixed at compile time.
//
// Replaces four TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_gru_fwd_sparse (fused_gru_fwd_sparse) and _build_mgru_fwd_sparse
//     (fused_mgru_fwd_sparse): the forward recurrence;
//   _build_gru_bwd_sparse (fused_gru_bwd_sparse) and _build_mgru_bwd_sparse
//     (fused_mgru_bwd_sparse): BPTT rebuilding the forward's quantities
//     (there is no stash variant), which also returns the candidate's
//     recurrent input s_t (r_t * h_{t-1}, or z_t * h_{t-1}) for the dU.
// The recurrent matrices U_h, U_z (and the GRU's U_r) (H, H) share one HCGS
// mask with R kept bs x bs blocks per block row, packed as w3g (Nb, G*bs,
// R*bs): out-block j holds gate g's rows at g*bs.. in the order [h | z | r]
// ([h | z]), its R kept column blocks side by side (col_idx[j*R + k] is
// the k-th one's column block). Gates are (T, B, G*H) in the same order.
// Per step t, only kept blocks touched ("@" a product over them):
//
//   z    = sigmoid(g_z + q(h_{t-1}) @ U_z^T)
//   r    = sigmoid(g_r + q(h_{t-1}) @ U_r^T)            (GRU)
//   s    = r * h_{t-1} (GRU),  z * h_{t-1} (minimalGRU)
//   a    = act(g_h + q(s) @ U_h^T)
//   h_t  = z * h_{t-1} + (1 - z) * a * drop
//
// and in reverse, from dh_carry = 0 at t = T-1 (q passes the gradient
// straight through, as the TPU kernel's does):
//
//   dh   = dh_carry + dhs[t]
//   dg_h = dh * (1 - z) * drop * act'(a_pre)
//   ds   = dg_h @ U_h                       (over the kept blocks)
//   GRU:        dg_z = dh * (h_{t-1} - a * drop) * z (1 - z)
//               dg_r = ds * h_{t-1} * r (1 - r)
//               dh_carry = dh * z + ds * r + [dg_z | dg_r] @ [U_z; U_r]
//   minimalGRU: dg_z = (dh * (h_{t-1} - a * drop) + ds * h_{t-1}) z (1 - z)
//               dh_carry = dh * z + ds * z + dg_z @ U_z
//
// dU is not formed here: block_sparse_dw.cu computes it over (T*B) from
// q(s_t) (U_h's rows) and q(h_{t-1}) (U_z's and U_r's).
//
// What bounds it on this card: at the LibriSpeech GRU's training shape
// (T=200, B=32, H=1024, bs=128, R=2) the forward's products are 2*T*B*
// 3H*R*bs = 10.07 GFLOP of float32 FMAs, 0.150 ms at 67 TFLOP/s (it moves
// ~42 MB, 0.013 ms): operations bound it; the backward does them twice
// (0.300 ms). The CGS-16x minimalGRU (T=300, B=8, H=1024, R=2) does 2*T*B*
// 2H*R*bs = 2.52 GFLOP, 0.038 ms. But each step has TWO grid-wide
// dependencies: the candidate's input s needs r (z) of every unit, and its
// quantizer scale max|s| (per step over the whole (B, H) block) needs all
// of s. The forward of either cell takes one of two routes, picked by the
// caller before the launch from the shapes and the occupancy query
// (fused_rnn.gru_fwd_sparse_route):
//
//   - "persist" (TPU rows 32 (G=3) and 34 (G=2)'s redesign): ONE
//     cooperative launch runs all T steps (gru_fwd_persist, persist.cuh).
//     A block owns UN (8 or 16) units of one out-block and BT (8, 16 or
//     32) batch rows for the whole call, its units' rows of w3g resident
//     in shared memory (G R*bs floats a unit: 24 KB at G=3, UN=8 and the
//     libri layout R=2, bs=128; 16 KB for the CGS-16x minimalGRU), and per
//     step runs two phases with one grid barrier after each, the two
//     grid-wide dependencies: A stages q(h_{t-1}) at its out-block's kept
//     columns, forms the z (and r) dots, writes s = r * h_{t-1} (z *
//     h_{t-1}) and folds max|s| into the step's slot; B stages q(s) there
//     (the slot now final), forms the candidate's dots, writes h_t and
//     folds max|h_t| into the next step's slot. h_{t-1} stays in the
//     thread that owns its (row, unit); the next step's gates load before
//     the barrier. The minimalGRU's dots sum in the step kernels' order, so
//     its two routes give the same bits.
//   - "step" (a shape whose blocks do not fit or are not co-resident, e.g.
//     256 rows of 1024): two kernels per step from the host loop (the
//     launch boundaries are the grid-wide barriers): gru_zr_step (z, r, s
//     and max|s|) then gru_h_step (the candidate and h_t, max|h_t| for the
//     next step's quantizer), re-reading w3g (6.3 MB at the GRU's shape)
//     from the 50 MB L2 each step; its time is 2T launches.

// The backward's forward quantities (z, r, s, the candidate's
// pre-activation and both quantizer scales) do not depend on dh. The
// backward of either cell takes one of two routes, picked by the caller
// before the launch from the shapes and the occupancy query
// (fused_rnn.gru_bwd_sparse_route, fused_rnn.mgru_bwd_sparse_route):
//
//   - "persist", the GRU (TPU row 33's redesign). The forward quantities
//     of all M = T*B rows at once, as GEMMs: absmax_steps (the T scales of
//     q(h_{t-1})) and quant_steps write q(h_prev); the caller's
//     block_sparse_v3_fwd (block_sparse_v3.cu, row 13's tile) forms u_z
//     and u_r against [U_z; U_r]; gru_zr_rebuild writes z, r, s and each
//     step's max|s|; quant_steps writes q(s); block_sparse_v3_fwd forms
//     u_h against U_h; gru_apre_rebuild writes a_pre. Under bf16 the
//     GEMMs' operands are bf16 values in float32 (q(h), q(s) rounded, w3g
//     widened), so each product is the step kernels' and only the order
//     of the sums differs. Then the whole reverse chain is ONE cooperative
//     launch of gru_bwd_persist (persist.cuh): a block owns 16 units of one
//     block column and 16 batch rows (8 and 8 at B <= 8; 8 and 32 where bs
//     is not a multiple of 16) for all steps, its columns of U resident in
//     shared memory, two grid barriers a step. The blocks of one column
//     stage the same cotangents from L2, so 16 x 16 outputs a block stage
//     half the bytes of 8 x 32, and the staging is what the chain waits
//     for most.
//   - "persist", the minimalGRU (TPU row 35's redesign): the forward
//     quantities as on the step route (run_rebuild: the forward's sums, so
//     relu' takes the forward's branch; a GEMM's order had flipped it for
//     the dense minimalGRU's recompute BPTT), then the same chain at G=2:
//     2bs floats a unit and an entry resident, two grid barriers a step.
//   - "step" (a shape whose chain does not fit or is not co-resident):
//     the forward quantities by the two forward step kernels over a grid
//     with one z-slice per step (run_rebuild), writing [a_pre | z | r]
//     ([a_pre | z]) to scratch and s_t to the output; then two kernels per
//     reverse step: gru_bwd_carry (dh from step t+1's [dg_z | dg_r] (dg_z)
//     against [U_z; U_r] (U_z) transposed, then dg_h, and the GRU's dg_z)
//     and gru_bwd_ds (ds from dg_h against U_h transposed, then dg_r or the
//     minimalGRU's dg_z).
//
// A transposed product gathers per block column from the layout's column
// lists (t_row_idx, t_perm; a pad entry has t_perm == nnz), so no float
// atomics are needed and its sum is deterministic.

// Forward step blocks own UNITS hidden units of one out-block j and BT
// batch rows: they stage the R*bs gathered columns of q(h_{t-1}) (or
// q(s)) for their rows in shared memory and each warp forms the dots of
// one w3g row with every staged row. Backward step blocks own BWD_UNITS
// units of one block column: they stage the cotangents of the kept blocks
// of that column and each warp forms one unit's dot with a row of w3g
// transposed ((Nb, R*bs, G*bs), passed in, so the lanes read consecutive
// addresses).
//
// qbits > 0: q() scales by max|v| over the step's whole (B, H) block,
// taken with an atomicMax on the float bits (a non-negative float's bits
// order like its value) into a per-step slot zeroed first; var == 0 (h0
// and s at t = 0) leaves v unquantized.
//
// bf16 (w3g in bf16, where the JAX package's size rule says so): the
// staged q(h), q(s) and the staged cotangents are rounded to bf16 before
// the dots; products, sums, the gate math and the carries stay float32.

#include <algorithm>
#include <cmath>

#include "persist.cuh"
#include "sparse_rec.cuh"

namespace {

constexpr int ZR_ROWS = 8;          // w3g rows of [U_z; U_r] (U_z) per block
constexpr int H_UNITS = 8;          // units per candidate block: 8 rows

// Units per zr block of a G-gate cell: 4 for the GRU, 8 for the
// minimalGRU (both divide bs).
__host__ __device__ constexpr int zr_units(int G) { return ZR_ROWS / (G - 1); }

// z (and the GRU's r) and s of one step (blockIdx.z = step within the
// launch: the forward launches one step, the backward all T). Writes z
// (and r) into fw (B, G*H) at H.. (and 2H..), s into s_out (B, H), max|s|
// bits into scale_s.
template <bool BF16, int G>
__global__ void __launch_bounds__(THREADS)
gru_zr_step(const float* __restrict__ gates,   // (B, G*H) [h | z (| r)]
            const void* __restrict__ w3g,      // (Nb, G*bs, R*bs)
            const int* __restrict__ col_idx,   // (Nb*R,)
            const float* __restrict__ h_prev,  // (B, H); nullptr = zeros
            float* __restrict__ fw,            // (B, G*H) [a_pre | z (| r)]
            float* __restrict__ s_out,         // (B, H)
            const unsigned* __restrict__ scale_h,  // max|h_prev| bits or null
            unsigned* __restrict__ scale_s,        // max|s| slot or null
            int B, int H, int R, int bs, float qscale) {
  constexpr int UNITS = zr_units(G), NR = ZR_ROWS;
  extern __shared__ float sm[];                  // (BT, R*bs)
  __shared__ float usm[BT][NR];
  const size_t t = blockIdx.z, bh = (size_t)B * H, GH = (size_t)G * H;
  gates += t * G * bh;
  fw += t * G * bh;
  s_out += t * bh;
  if (h_prev) h_prev += t * bh;
  if (scale_h) scale_h += t;
  if (scale_s) scale_s += t;
  const int K3 = R * bs;
  const int u0 = blockIdx.x * UNITS, j = u0 / bs;   // UNITS divides bs
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_cols<BF16>(h_prev, col_idx, j, b0, nb, H, R, bs, scale_h, qscale, sm);
  __syncthreads();
  row_dots<BF16, G, UNITS, NR>(w3g, sm, j, u0, 1, nb, H, K3, bs, usm);
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
// U_h^T into fw at 0..; with h_out, also h_t = z * h_{t-1} + (1 - z) *
// act(a_pre) * drop and its max|h_t| bits into scale_h_next.
template <bool BF16, int G>
__global__ void __launch_bounds__(THREADS)
gru_h_step(const float* __restrict__ gates, const void* __restrict__ w3g,
           const int* __restrict__ col_idx, const float* __restrict__ drop,
           const float* __restrict__ h_prev,   // (B, H); nullptr = zeros
           const float* __restrict__ s,        // (B, H)
           float* __restrict__ fw,             // (B, G*H): z in, a_pre out
           float* __restrict__ h_out,          // (B, H) or nullptr
           const unsigned* __restrict__ scale_s,   // max|s| bits or null
           unsigned* __restrict__ scale_h_next,    // max|h_t| slot or null
           int B, int H, int R, int bs, int act, float qscale) {
  constexpr int UNITS = H_UNITS, NR = UNITS;
  extern __shared__ float sm[];
  __shared__ float usm[BT][NR];
  const size_t t = blockIdx.z, bh = (size_t)B * H, GH = (size_t)G * H;
  gates += t * G * bh;
  fw += t * G * bh;
  s += t * bh;
  if (scale_s) scale_s += t;
  const int K3 = R * bs;
  const int u0 = blockIdx.x * UNITS, j = u0 / bs;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_cols<BF16>(s, col_idx, j, b0, nb, H, R, bs, scale_s, qscale, sm);
  __syncthreads();
  row_dots<BF16, G, UNITS, NR>(w3g, sm, j, u0, 0, nb, H, K3, bs, usm);
  __syncthreads();

  unsigned m = 0;
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u;
    const float a_pre = gates[bb * GH + u] + usm[b][jj];
    fw[bb * GH + u] = a_pre;
    if (h_out) {
      const float z = fw[bb * GH + H + u];
      const float hp = h_prev ? h_prev[ih] : 0.f;
      const float h = z * hp + (1.f - z) * (act_fn(a_pre, act) * drop[ih]);
      h_out[ih] = h;
      m = max(m, __float_as_uint(fabsf(h)));
    }
  }
  if (h_out && scale_h_next) slot_max(m, scale_h_next);
}

// Reverse step t, first half: dh_t from the carry of step t+1, then dg_h
// (and the GRU's dg_z) of step t. dh (B, H) holds dh_{t+1} on entry, dh_t
// on exit.
template <bool BF16, int G>
__global__ void __launch_bounds__(THREADS)
gru_bwd_carry(const float* __restrict__ fw_t,     // (B, G*H) [a_pre | z ..]
              const float* __restrict__ fw_next,  // step t+1's, or null
              const void* __restrict__ w3t,       // (Nb, R*bs, G*bs)
              const int* __restrict__ t_row_idx, const int* __restrict__ t_perm,
              const float* __restrict__ drop, const float* __restrict__ h_prev,
              const float* __restrict__ dh_in,    // dhs[t]
              const float* __restrict__ dg_next,  // dg_{t+1} or null
              const float* __restrict__ ds,       // ds_{t+1}
              float* __restrict__ dh, float* __restrict__ dg_t,
              int B, int H, int R, int bs, int C, int nnz, int act) {
  constexpr int UNITS = BWD_UNITS;
  extern __shared__ float dgsm[];                // (BT, C * (G-1)bs)
  __shared__ float dsm[BT][UNITS];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int u0 = blockIdx.x * UNITS, blk = u0 / bs;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  const int nv = dg_next ? column_entries(t_row_idx, t_perm, blk, C, R, nnz,
                                          ent_j, ent_k)
                         : 0;
  __syncthreads();
  if (dg_next) {
    stage_dg<BF16, G, G - 1>(dg_next, ent_j, nv, C, 1, b0, nb, H, bs, dgsm);
    __syncthreads();
    col_dots<BF16, G, G - 1>(w3t, dgsm, ent_j, ent_k, nv, C, blk, u0, 1, nb,
                             H, R * bs, bs, dsm);
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
    const float a_pre = fw_t[ig + u], z = fw_t[ig + H + u];
    const float dr = drop[ih];
    dg_t[ig + u] = dhv * (1.f - z) * dr * dact_pre(a_pre, act);
    if constexpr (G == 3) {
      const float dz = dhv * (h_prev[ih] - act_fn(a_pre, act) * dr);
      dg_t[ig + H + u] = dz * z * (1.f - z);
    }
    dh[ih] = dhv;
  }
}

// Reverse step t, second half: ds_t = dg_h @ U_h over the kept blocks
// (all units' dg_h, from gru_bwd_carry), then the GRU's dg_r or the
// minimalGRU's dg_z (from dh_t, which gru_bwd_carry left in dh); ds (B, H)
// <- ds_t.
template <bool BF16, int G>
__global__ void __launch_bounds__(THREADS)
gru_bwd_ds(const float* __restrict__ fw_t, const void* __restrict__ w3t,
           const int* __restrict__ t_row_idx, const int* __restrict__ t_perm,
           const float* __restrict__ drop, const float* __restrict__ h_prev,
           const float* __restrict__ dh, float* __restrict__ ds,
           float* __restrict__ dg_t, int B, int H, int R, int bs, int C,
           int nnz, int act) {
  constexpr int UNITS = BWD_UNITS;
  extern __shared__ float dgsm[];                // (BT, C * bs)
  __shared__ float dsm[BT][UNITS];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int u0 = blockIdx.x * UNITS, blk = u0 / bs;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  const int nv = column_entries(t_row_idx, t_perm, blk, C, R, nnz, ent_j,
                                ent_k);
  __syncthreads();
  stage_dg<BF16, G, 1>(dg_t, ent_j, nv, C, 0, b0, nb, H, bs, dgsm);
  __syncthreads();
  col_dots<BF16, G, 1>(w3t, dgsm, ent_j, ent_k, nv, C, blk, u0, 0, nb, H,
                       R * bs, bs, dsm);
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
      const float hc = act_fn(fw_t[ig + u], act) * drop[ih];
      const float dz = dh[ih] * (hp - hc) + dsv * hp;
      dg_t[ig + H + u] = dz * z * (1.f - z);
    }
    ds[ih] = dsv;
  }
}

// The GRU's backward forward quantities over all M = T*B rows at once
// (route "persist"; the products are block_sparse_v3.cu's GEMM, called by
// the wrapper between these passes):

// (quant_steps, lstm_common.cuh, writes q(h_prev) and q(s))

// z = sigmoid(g_z + u_z), r = sigmoid(g_r + u_r) into fw at H.. and 2H..,
// s = r * h_prev into s_out and max|s| of each step into scale_s (or
// nothing when null); uzr (2, M, H) = [u_z; u_r]. Blocks over (the H
// units, rows).
__global__ void gru_zr_rebuild(const float* __restrict__ gates,
                               const float* __restrict__ uzr,
                               const float* __restrict__ h_prev,
                               float* __restrict__ fw,
                               float* __restrict__ s_out,
                               unsigned* __restrict__ scale_s, int M, int B,
                               int H) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t MH = (size_t)M * H;
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    unsigned m = 0;
    if (u < H) {
      const size_t ih = (size_t)row * H + u, ig = (size_t)row * 3 * H;
      const float z = sigmoid(gates[ig + H + u] + uzr[ih]);
      const float r = sigmoid(gates[ig + 2 * H + u] + uzr[MH + ih]);
      const float sv = r * h_prev[ih];
      fw[ig + H + u] = z;
      fw[ig + 2 * H + u] = r;
      s_out[ih] = sv;
      m = __float_as_uint(fabsf(sv));
    }
    if (scale_s) slot_max(m, scale_s + row / B);
  }
}

// a_pre = g_h + u_h into fw at 0.. (uh (M, H)).
__global__ void gru_apre_rebuild(const float* __restrict__ gates,
                                 const float* __restrict__ uh,
                                 float* __restrict__ fw, int M, int H) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= H) return;
  for (int row = blockIdx.y; row < M; row += gridDim.y)
    fw[(size_t)row * 3 * H + u] =
        gates[(size_t)row * 3 * H + u] + uh[(size_t)row * H + u];
}

// The whole reverse chain of a G-gate cell in one cooperative launch
// (route "persist", TPU rows 33 (G=3) and 35 (G=2)'s redesign;
// persist.cuh). Block c owns the UN (8 or 16) units from u0 = (c % (H/UN))
// * UN, all in block column blk = u0 / bs, and the BT = 8 * BI batch rows
// from b0 = (c / (H/UN)) * BT. It copies into shared memory once, per
// kept block (j, k) of its column (nv of them), its units' columns of U_z
// and U_r (ws1: U_z's of every entry, then U_r's; the minimalGRU's U_z
// alone) and of U_h (ws2): G*bs floats a unit and an entry (12 KB an
// entry at G=3, bs=128; a bf16 w3g widened exactly). Its thread o = b *
// UNITS + jj keeps dh, ds, z (and r) of its (row, unit) in registers
// across the steps and loads the next step's inputs (fw, dhs, h_prev) a
// step ahead. Per reverse step, two dependent products, two grid barriers
// (the second skipped at t = 0):
//   1. [dg_z | dg_r]_{t+1} ([dg_z]_{t+1}) of the kept out-blocks, staged
//      as a row of nv*bs dg_z (then nv*bs dg_r), dots against ws1, then
//      dh, dg_h (and the GRU's dg_z) of step t; barrier (every unit's dg_h
//      written);
//   2. dg_h of step t at the kept out-blocks (staged into the GRU's dg_r
//      half), dots against ws2: ds_t, then the GRU's dg_r or the
//      minimalGRU's dg_z = (dh (h_{t-1} - a drop) + ds h_{t-1}) z (1 - z);
//      barrier.
// The GRU's dg_z of step t, complete at the first barrier, is staged for
// the next step's product 1 right after it, so that its copy overlaps
// product 2, and only dg_r is staged after the second; the minimalGRU's
// is complete only after product 2, so it is staged after the second
// barrier. A column with no entries forms zero dots. Under BF16 the
// staged cotangents are rounded to bf16 before the dots, as in the step
// kernels. The dots are persist::unit_dots' (the warps split the
// contraction): another order than the step kernels' col_dots.
template <bool BF16, int G, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
gru_bwd_persist(const float* __restrict__ fw,    // (T, B, G*H) [a_pre|z..]
                const void* __restrict__ w3g,    // (Nb, G*bs, R*bs)
                const int* __restrict__ t_row_idx,
                const int* __restrict__ t_perm,
                const float* __restrict__ drop,  // (B, H)
                const float* __restrict__ h_prev, const float* __restrict__ dhs,
                float* dg, int T, int B, int H, int R, int bs, int C, int nnz,
                int act) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  constexpr int WS = P::w_stride(UN);
  extern __shared__ __align__(16) float psm[];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int K1c = C * (G - 1) * bs, K2c = C * bs, SK = P::row_stride(K1c);
  float* ws1 = psm;                                // (C*(G-1)bs, WS)
  float* ws2 = ws1 + (size_t)K1c * WS;             // (C*bs, WS)
  float* xs = ws2 + (size_t)K2c * WS;              // (BT, SK)
  float* red = xs + (size_t)BT * SK;
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int blk = u0 / bs, cc0 = u0 - blk * bs;
  const int nv = column_entries(t_row_idx, t_perm, blk, C, R, nnz, ent_j,
                                ent_k);
  __syncthreads();
  const int NB = nv * bs, K1 = (G - 1) * NB, K2 = NB, RB = R * bs;
  const int GB = G * bs;
  for (int i = threadIdx.x; i < K1 * UN; i += P::THREADS) {
    // k = g * NB + e * bs + q: gate z (g = 0) or r (g = 1) of entry e
    const int k = i / UN, jj = i - k * UN, g = k / NB, e = (k - g * NB) / bs;
    const int q = k - g * NB - e * bs;
    const size_t row = (size_t)ent_j[e] * GB + (1 + g) * bs + q;
    ws1[k * WS + jj] = load_w<BF16>(w3g, row * RB + ent_k[e] * bs + cc0 + jj);
  }
  for (int i = threadIdx.x; i < K2 * UN; i += P::THREADS) {
    const int k = i / UN, jj = i - k * UN, e = k / bs, q = k - e * bs;
    ws2[k * WS + jj] = load_w<BF16>(
        w3g, ((size_t)ent_j[e] * GB + q) * RB + ent_k[e] * bs + cc0 + jj);
  }
  const int o = threadIdx.x, ob = o / UN, ou = u0 + o % UN;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H, gbh = (size_t)G * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * G * H;
  const float dr = mine ? drop[ih] : 0.f;
  // stage gate `gate` of step t's dg at the kept out-blocks, row b's entry
  // e at xs[b][off + e*bs]
  auto stage = [&](int t, int gate, int off) {
    const float* src = dg + t * gbh + (size_t)b0 * G * H + gate * H;
    P::stage_rows(
        nb * nv, bs,
        [&](int row) {
          const int b = row / nv, e = row - b * nv;
          return src + (size_t)b * G * H + ent_j[e] * bs;
        },
        [&](int row) {
          const int b = row / nv, e = row - b * nv;
          return xs + (size_t)b * SK + off + e * bs;
        });
  };
  // step t's inputs of this thread's (row, unit), loaded a step ahead
  struct In {
    float a_pre, z, r, dh, hp;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* f = fw + t * gbh + ig;
      v.a_pre = f[ou];
      v.z = f[H + ou];
      if (G == 3) v.r = f[2 * H + ou];
      v.dh = dhs[t * bh + ih];
      v.hp = h_prev[t * bh + ih];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dh = 0.f, ds = 0.f, zn = 0.f, rn = 0.f;
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float dot = 0.f;
    if (t + 1 < T) {
      // the GRU's dg_r (its dg_z has been in flight since the last first
      // barrier), the minimalGRU's dg_z (complete at the last second one)
      stage(t + 1, G - 1, G == 3 ? NB : 0);
      P::cp_async_wait_all();
      __syncthreads();
      P::unit_dots<BI, UN, BF16>(xs, SK, ws1, K1, red);
      if (o < BT * UN) dot = P::unit_sum<BI, UN>(red, o);
    }
    const float hp = cur.hp, r = cur.r;
    if (mine) {
      const float gate_s = G == 3 ? rn : zn;
      const float carry = t + 1 < T ? dh * zn + ds * gate_s + dot : 0.f;
      const float dhv = carry + cur.dh;
      const float a_pre = cur.a_pre, z = cur.z;
      float* d = dg + t * gbh;
      d[ig + ou] = dhv * (1.f - z) * dr * dact_pre(a_pre, act);
      if constexpr (G == 3) {
        const float dz = dhv * (hp - act_fn(a_pre, act) * dr);
        d[ig + H + ou] = dz * z * (1.f - z);
      }
      dh = dhv;
      zn = z;
      rn = r;
    }
    grid.sync();
    if constexpr (G == 3) {
      stage(t, 0, NB);          // dg_h into the dg_r half
      P::cp_async_commit();
      if (t > 0) {
        stage(t, 1, 0);         // dg_z for the next step's product 1
        P::cp_async_commit();
        P::cp_async_wait<1>();
      } else {
        P::cp_async_wait<0>();
      }
    } else {
      stage(t, 0, 0);
      P::cp_async_wait_all();
    }
    __syncthreads();
    P::unit_dots<BI, UN, BF16>(xs + (G == 3 ? NB : 0), SK, ws2, K2, red);
    if (mine) {
      ds = P::unit_sum<BI, UN>(red, o);
      if constexpr (G == 3) {
        dg[t * gbh + ig + 2 * H + ou] = ds * hp * r * (1.f - r);
      } else {
        const float z = cur.z;
        const float dz = dh * (hp - act_fn(cur.a_pre, act) * dr) + ds * hp;
        dg[t * gbh + ig + H + ou] = dz * z * (1.f - z);
      }
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
  }
}

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU rows 32 and 34's redesign; persist.cuh), for a G-gate
// cell: the GRU's G=3 and the minimalGRU's G=2. Block c owns the UN units
// from u0 = (c % (H/UN)) * UN, all in out-block j = u0 / bs (UN divides
// bs), and the BT = 8 * BI batch rows from b0 = (c / (H/UN)) * BT. It
// copies into shared memory once its units' rows of w3g, widened to
// float32: [z | r] ([z]) as (G-1)*UN weight rows of wzr and the
// candidate's as UN of wh, R*bs values each. Its thread o = b * UN + jj
// keeps h_{t-1} of its (row, unit) in a register and loads the next
// step's gates before the barrier. Per step t (at t = 0 the carry is
// zero: no staging and no dots, and no barrier after phase A):
//   A. stage h_{t-1} (hs[t-1], other blocks' rows) at the kept columns,
//      dots against wzr with q() at the max over bmax[0] of each staged
//      value (and bf16 rounding under BF16), z and r, s = r *
//      h_{t-1} (z * h_{t-1}) into sbuf, the block's max|s| into its entry
//      of bmax[1]; barrier;
//   B. stage s from sbuf the same way, q() at the max over bmax[1], dots
//      against wh, a_pre = g_h + dot, h_t into hs, the block's max|h_t|
//      into its entry of bmax[0]; barrier (none after the last step).
// The quantizer's per-step scale is a max over the grid: each block
// stores its own (a warp reduction, then one over the warps), and after
// the barrier each block's first warp reads the grid's entries through
// L2 (__ldcg) while its staging copies are in flight. Each staged value
// is quantized in the dots' loop by quant_rcp, quant()'s bits with a
// reciprocal taken once a phase: quant()'s IEEE division there took the
// libri call from 1.9 to 4.0 ms on the H100, and the same division in a
// pass over the staged values before the dots to 4.8 (variants timed on
// the card, not kept). At t = 1 the scale of h_0 is its max; at t = 0
// h_{-1} = 0 and s = 0 need none (a scale of 0 leaves v unquantized, as
// in quant()).
// The two cells' dots sum in different orders. The GRU's are
// persist::unit_dots' (wzr and wh k-major, the warps splitting the
// contraction, q() and the bf16 rounding in the FMA loop). The
// minimalGRU's are the step kernels' row_dots order (wzr and wh as rows,
// one pass of q() and the bf16 rounding over the staged values,
// persist::quant_staged, then persist::resident_dots: a warp a dot, lanes
// over k, the shuffle tree), so that its persistent route gives its step
// route's bits, and the dense seeded forward (TPU row 24, the same order)
// a sparse minimalGRU's stream the bits of its sparse forward on the kept
// columns. (A row 24 on unit_dots moved that stream past chip_smoke.py's
// bound against the sparse forward.)
template <bool BF16, int G, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
gru_fwd_persist(const float* __restrict__ gates,   // (T, B, G*H)
                const void* __restrict__ w3g,      // (Nb, G*bs, R*bs)
                const int* __restrict__ col_idx,   // (Nb*R,)
                const float* __restrict__ drop,    // (B, H)
                float* hs,                         // (T, B, H) output
                float* sbuf,                       // (B, H) s of the step
                unsigned* bmax,                    // (2, grid), or null
                int T, int B, int H, int R, int bs, int act, float qscale) {
  namespace P = persist;
  constexpr bool ROWS = G == 2;                    // row_dots' order
  constexpr int BT = P::BLANES * BI, ZC = (G - 1) * UN;
  constexpr int WZ = ROWS ? ZC : P::w_stride(ZC);
  constexpr int WH = ROWS ? UN : P::w_stride(UN);
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int K3 = R * bs, SK = P::row_stride(K3);
  float* wzr = psm;                                // (K3, WZ) or (ZC, K3)
  float* wh = wzr + (size_t)K3 * WZ;               // (K3, WH) or (UN, K3)
  float* xs = wh + (size_t)K3 * WH;                // (BT, SK)
  float* red = xs + (size_t)BT * SK;               // partials, or (BT, ZC)
  auto usm = reinterpret_cast<float (*)[ZC]>(red);
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int j = u0 / bs, cc0 = u0 - j * bs;
  const size_t row0 = (size_t)j * G * bs + cc0;    // w3g row of unit u0, h
  for (int i = threadIdx.x; i < ZC * K3; i += P::THREADS) {
    const int c = i / K3, k = i - c * K3, g = 1 + c / UN;
    wzr[ROWS ? i : k * WZ + c] = load_w<BF16>(
        w3g, (row0 + g * bs + (c - (g - 1) * UN)) * K3 + k);
  }
  for (int i = threadIdx.x; i < UN * K3; i += P::THREADS) {
    const int c = i / K3, k = i - c * K3;
    wh[ROWS ? i : k * WH + c] = load_w<BF16>(w3g, (row0 + c) * K3 + k);
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H, gbh = (size_t)G * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * G * H;
  const float dr = mine ? drop[ih] : 0.f;
  unsigned* hmax = bmax;                            // max|h_t| by block
  unsigned* smax = bmax ? bmax + gridDim.x : nullptr;   // max|s_t|
  // stage v's kept columns of out-block j for this block's rows; with
  // `maxes`, the grid's max of them into gmax meanwhile -> the scale
  auto stage = [&](const float* v, const unsigned* maxes) {
    P::stage_rows(
        nb * R, bs,
        [&](int row) {
          const int b = row / R, k = row - b * R;
          return v + (size_t)(b0 + b) * H + (size_t)col_idx[j * R + k] * bs;
        },
        [&](int row) {
          const int b = row / R, k = row - b * R;
          return xs + (size_t)b * SK + k * bs;
        });
    if (maxes && threadIdx.x < 32) {
      unsigned m = 0;
      for (int i = threadIdx.x; i < gridDim.x; i += 32)
        m = max(m, __ldcg(maxes + i));
      m = __reduce_max_sync(0xffffffffu, m);
      if (threadIdx.x == 0) gmax = m;
    }
    P::cp_async_wait_all();
    __syncthreads();
    return maxes ? __uint_as_float(gmax) : 0.f;
  };
  // q() at scale var (0: none; quant_rcp, quant()'s bits without its
  // division), then bf16: applied to each staged value in the dots' loop
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  auto qf = [&](float var) {
    const float inv = var != 0.f ? 1.f / var : 0.f, sc = qscale,
                isc = iscale;
    return [var, inv, sc, isc](float x) {
      const float y = quant_rcp(x, var, inv, sc, isc);
      return BF16 ? round_bf16(y) : y;
    };
  };
  // this block's max of the threads' bits m into out[blockIdx.x]
  auto block_max = [&](unsigned m, unsigned* out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned v = 0;
      for (int w = 0; w < P::WARPS; ++w) v = max(v, wmax[w]);
      out[blockIdx.x] = v;
    }
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
  In cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    // A: z (and r), s
    float dz = 0.f, dq = 0.f;
    if (t > 0) {
      const float var = stage(hs + (t - 1) * bh, hmax);
      if constexpr (ROWS) {
        P::quant_staged<BF16>(xs, SK, nb, K3, var, qscale, iscale);
        P::resident_dots<BT, ZC, ZC>(wzr, xs, SK, K3, nb, usm);
        __syncthreads();
        if (mine) dz = usm[ob][oj];
      } else {
        P::unit_dots<BI, ZC>(xs, SK, wzr, K3, red, qf(var));
        if (mine) {
          dz = P::unit_sum<BI, ZC>(red, ob * ZC + oj);
          dq = P::unit_sum<BI, ZC>(red, ob * ZC + UN + oj);
        }
      }
    }
    float z = 0.f;
    unsigned m = 0;
    if (mine) {
      z = sigmoid(cur.gz + dz);
      float s = z * hp;
      if (G == 3) s = sigmoid(cur.gr + dq) * hp;
      sbuf[ih] = s;
      m = __float_as_uint(fabsf(s));
    }
    if (t > 0) {
      if (smax) block_max(m, smax);
      grid.sync();
    }
    // B: the candidate and h_t
    float da = 0.f;
    if (t > 0) {
      const float var = stage(sbuf, smax);
      if constexpr (ROWS) {
        P::quant_staged<BF16>(xs, SK, nb, K3, var, qscale, iscale);
        P::resident_dots<BT, UN, ZC>(wh, xs, SK, K3, nb, usm);
        __syncthreads();
        if (mine) da = usm[ob][oj];
      } else {
        P::unit_dots<BI, UN>(xs, SK, wh, K3, red, qf(var));
        if (mine) da = P::unit_sum<BI, UN>(red, o);
      }
    }
    m = 0;
    if (mine) {
      const float a_pre = cur.gh + da;
      const float h = z * hp + (1.f - z) * (act_fn(a_pre, act) * dr);
      hs[t * bh + ih] = h;
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

template <bool BF16, int G>
cudaError_t run_fwd(const float* gates, const void* w3g, const int* col_idx,
                    const float* drop, float* hs, float* fw, float* s,
                    unsigned* qslots, int T, int B, int H, int R, int bs,
                    int act, int qbits, cudaStream_t stream) {
  const size_t smem = (size_t)BT * R * bs * sizeof(float);
  cudaError_t err = allow_smem(gru_zr_step<BF16, G>, smem);
  if (err == cudaSuccess) err = allow_smem(gru_h_step<BF16, G>, smem);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  // slots: max|h| of steps 0..T (slot 0 = the zero state) and max|s| of
  // steps 0..T-1
  unsigned* sh = qslots;
  unsigned* ss = qslots + T + 1;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T + 1) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
  }
  constexpr int ZU = zr_units(G);
  const dim3 zr_grid((H + ZU - 1) / ZU, (B + BT - 1) / BT);
  const dim3 h_grid((H + H_UNITS - 1) / H_UNITS, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* g = gates + (size_t)t * G * bh;
    const float* hp = t ? hs + (t - 1) * bh : nullptr;
    gru_zr_step<BF16, G><<<zr_grid, THREADS, smem, stream>>>(
        g, w3g, col_idx, hp, fw, s, q ? sh + t : nullptr, q ? ss + t : nullptr,
        B, H, R, bs, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gru_h_step<BF16, G><<<h_grid, THREADS, smem, stream>>>(
        g, w3g, col_idx, drop, hp, s, fw, hs + t * bh, q ? ss + t : nullptr,
        q ? sh + t + 1 : nullptr, B, H, R, bs, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The backward's forward quantities of every step at once (both cells'
// step routes and the minimalGRU's persistent one): with qbits > 0 the T
// scales of q(h_{t-1}) into slots 0..T-1 (and those of q(s) into T..2T-1,
// all zeroed first), then the two forward step kernels over a grid with
// one z-slice per step, writing [a_pre | z (| r)] into fw and s_t into
// s_seq: the forward's sums, so act' takes the forward's branch.
template <bool BF16, int G>
cudaError_t run_rebuild(const float* gates, const void* w3g,
                        const int* col_idx, const float* drop,
                        const float* h_prev, float* fw, float* s_seq,
                        unsigned* qslots, int T, int B, int H, int R, int bs,
                        int act, int qbits, cudaStream_t stream) {
  const size_t smem_f = (size_t)BT * R * bs * sizeof(float);
  cudaError_t err = allow_smem(gru_zr_step<BF16, G>, smem_f);
  if (err == cudaSuccess) err = allow_smem(gru_h_step<BF16, G>, smem_f);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  const size_t bh = (size_t)B * H;
  unsigned* sh = qslots;
  unsigned* ss = qslots + T;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
    const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr int ZU = zr_units(G);
  const dim3 zr_grid((H + ZU - 1) / ZU, (B + BT - 1) / BT, T);
  gru_zr_step<BF16, G><<<zr_grid, THREADS, smem_f, stream>>>(
      gates, w3g, col_idx, h_prev, fw, s_seq, q ? sh : nullptr,
      q ? ss : nullptr, B, H, R, bs, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 h_grid((H + H_UNITS - 1) / H_UNITS, (B + BT - 1) / BT, T);
  gru_h_step<BF16, G><<<h_grid, THREADS, smem_f, stream>>>(
      gates, w3g, col_idx, drop, nullptr, s_seq, fw, nullptr,
      q ? ss : nullptr, nullptr, B, H, R, bs, act, qscale);
  return cudaGetLastError();
}

template <bool BF16, int G>
cudaError_t run_bwd(const float* gates, const void* w3g, const void* w3t,
                    const int* col_idx, const int* t_row_idx,
                    const int* t_perm, const float* drop, const float* h_prev,
                    const float* dhs, float* fw, float* s_seq, float* dh,
                    float* ds, float* dg, unsigned* qslots, int T, int B,
                    int H, int R, int bs, int C, int nnz, int act, int qbits,
                    cudaStream_t stream) {
  const size_t smem_c = (size_t)BT * C * (G - 1) * bs * sizeof(float);
  const size_t smem_d = (size_t)BT * C * bs * sizeof(float);
  cudaError_t err = allow_smem(gru_bwd_carry<BF16, G>, smem_c);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_ds<BF16, G>, smem_d);
  if (err == cudaSuccess)
    err = run_rebuild<BF16, G>(gates, w3g, col_idx, drop, h_prev, fw, s_seq,
                               qslots, T, B, H, R, bs, act, qbits, stream);
  if (err != cudaSuccess) return err;
  // the reverse chain, two kernels per step
  const size_t bh = (size_t)B * H;
  const dim3 grid((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  const size_t GB = (size_t)G * bh;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t + 1 == T;
    gru_bwd_carry<BF16, G><<<grid, THREADS, smem_c, stream>>>(
        fw + t * GB, last ? nullptr : fw + (t + 1) * GB, w3t, t_row_idx,
        t_perm, drop, h_prev + t * bh, dhs + t * bh,
        last ? nullptr : dg + (t + 1) * GB, ds, dh, dg + t * GB, B, H, R, bs,
        C, nnz, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gru_bwd_ds<BF16, G><<<grid, THREADS, smem_d, stream>>>(
        fw + t * GB, w3t, t_row_idx, t_perm, drop, h_prev + t * bh, dh, ds,
        dg + t * GB, B, H, R, bs, C, nnz, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int G>
int launch_fwd(const float* gates, const void* w3g, const int* col_idx,
               const float* drop, float* hs, float* fw, float* s,
               unsigned* qslots, int T, int B, int H, int R, int bs, int act,
               int qbits, int w_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = w_bf16 ? run_fwd<true, G> : run_fwd<false, G>;
  return fn(gates, w3g, col_idx, drop, hs, fw, s, qslots, T, B, H, R, bs, act,
            qbits, stream);
}

template <int G>
int launch_bwd(const float* gates, const void* w3g, const void* w3t,
               const int* col_idx, const int* t_row_idx, const int* t_perm,
               const float* drop, const float* h_prev, const float* dhs,
               float* fw, float* s_seq, float* dh, float* ds, float* dg,
               unsigned* qslots, int T, int B, int H, int R, int bs, int C,
               int nnz, int act, int qbits, int w_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C > MAX_C) return cudaErrorInvalidValue;
  auto fn = w_bf16 ? run_bwd<true, G> : run_bwd<false, G>;
  return fn(gates, w3g, w3t, col_idx, t_row_idx, t_perm, drop, h_prev, dhs,
            fw, s_seq, dh, ds, dg, qslots, T, B, H, R, bs, C, nnz, act, qbits,
            stream);
}

// one cooperative launch of the forward at block shape (BI, UN)
template <bool BF16, int G, int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const void* w3g,
                               const int* col_idx, const float* drop,
                               float* hs, float* s, unsigned* bmax, int T,
                               int B, int H, int R, int bs, int act,
                               float qscale) {
  return persist::launch<gru_fwd_persist<BF16, G, BI, UN>>(
      grid, smem, stream, gates, w3g, col_idx, drop, hs, s, bmax, T, B, H,
      R, bs, act, qscale);
}

// one cooperative launch of the reverse chain at block shape (BI, UN)
template <bool BF16, int G, int BI, int UN>
cudaError_t launch_bwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* fw, const void* w3g,
                               const int* t_row_idx, const int* t_perm,
                               const float* drop, const float* h_prev,
                               const float* dhs, float* dg, int T, int B,
                               int H, int R, int bs, int C, int nnz,
                               int act) {
  return persist::launch<gru_bwd_persist<BF16, G, BI, UN>>(
      grid, smem, stream, fw, w3g, t_row_idx, t_perm, drop, h_prev, dhs, dg,
      T, B, H, R, bs, C, nnz, act);
}

using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const float*,
                                  float*, float*, unsigned*, int, int, int,
                                  int, int, int, float);
using BwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const int*,
                                  const float*, const float*, const float*,
                                  float*, int, int, int, int, int, int, int,
                                  int);
using Occupancy = cudaError_t (*)(int, int*);

// The forward's block shapes (bi, units), both cells: the plan's
// (fused_rnn.GRU_FWD_SPARSE_SHAPES). -> the launcher and the occupancy
// query of one, or nulls for another shape.
template <bool BF16, int G>
void fwd_shape(int bi, int units, FwdLaunch* launch, Occupancy* occ) {
#define PK_SPARSE_FWD_SHAPE(BI_, UN_)                                     \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BF16, G, BI_, UN_>;                      \
    *occ = persist::occupancy<gru_fwd_persist<BF16, G, BI_, UN_>>;        \
    return;                                                               \
  }
  PK_SPARSE_FWD_SHAPE(1, 8)
  PK_SPARSE_FWD_SHAPE(2, 8)
  PK_SPARSE_FWD_SHAPE(4, 8)
  PK_SPARSE_FWD_SHAPE(2, 16)
#undef PK_SPARSE_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void fwd_shape_of(int G, int w_bf16, int bi, int units, FwdLaunch* launch,
                  Occupancy* occ) {
  auto fn = G == 3 ? (w_bf16 ? fwd_shape<true, 3> : fwd_shape<false, 3>)
                   : (w_bf16 ? fwd_shape<true, 2> : fwd_shape<false, 2>);
  fn(bi, units, launch, occ);
}

// The reverse chain's block shapes (bi, units), both cells, told apart by
// bi: the plan's (fused_rnn.GRU_BWD_SPARSE_SHAPES). -> the launcher and
// the occupancy query of one, or nulls for another shape.
template <bool BF16, int G>
void bwd_shape(int bi, BwdLaunch* launch, Occupancy* occ) {
#define PK_SPARSE_BWD_SHAPE(BI_, UN_)                                     \
  if (bi == BI_) {                                                        \
    *launch = launch_bwd_persist<BF16, G, BI_, UN_>;                      \
    *occ = persist::occupancy<gru_bwd_persist<BF16, G, BI_, UN_>>;        \
    return;                                                               \
  }
  PK_SPARSE_BWD_SHAPE(1, 8)
  PK_SPARSE_BWD_SHAPE(2, 16)
  PK_SPARSE_BWD_SHAPE(4, 8)
#undef PK_SPARSE_BWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void bwd_shape_of(int G, int w_bf16, int bi, BwdLaunch* launch,
                  Occupancy* occ) {
  auto fn = G == 3 ? (w_bf16 ? bwd_shape<true, 3> : bwd_shape<false, 3>)
                   : (w_bf16 ? bwd_shape<true, 2> : bwd_shape<false, 2>);
  fn(bi, launch, occ);
}

// the forward at G gates on the persistent route (the entry points below)
int fwd_persist(int G, const float* gates, const void* w3g,
                const int* col_idx, const float* drop, float* hs, float* s,
                unsigned* bmax, int T, int B, int H, int R, int bs, int act,
                int qbits, int w_bf16, int grid, int bi, int units, int smem,
                void* stream_ptr) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(G, w_bf16, bi, units, &launch, &occ);
  if (!launch || bs % units || H % units) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return launch(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates,
                w3g, col_idx, drop, hs, s, q ? bmax : nullptr, T, B, H, R,
                bs, act, qscale);
}

int fwd_occupancy(int G, int w_bf16, int bi, int units, int smem, int* out) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(G, w_bf16, bi, units, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

int bwd_occupancy(int G, int w_bf16, int bi, int smem, int* out) {
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(G, w_bf16, bi, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

// grid (units in blocks of 256, rows) of the elementwise rebuild passes
dim3 rows_grid(int M, int H) {
  return dim3((H + 255) / 256, std::min(M, 65535));
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The GRU forward on `stream` on the step route: 2T step kernels from the
// zero state.
// Returns the first cudaError_t seen, 0 on success.
//   gates: (T, B, 3H) [h | z | r]; w3g: (Nb, 3bs, R*bs) float32 or bf16
//   (w_bf16); col_idx: (Nb*R,) int32 on the device; drop: (B, H);
//   hs: (T, B, H) output; fw: (B, 3H) and s: (B, H) scratch;
//   qslots: 2T+1 unsigned ints of scratch when qbits > 0.
// bs must be a multiple of 8 (a block's units share one out-block).
int fused_gru_fwd_sparse(const float* gates, const void* w3g,
                         const int* col_idx, const float* drop, float* hs,
                         float* fw, float* s, unsigned* qslots, int T, int B,
                         int H, int R, int bs, int act, int qbits, int w_bf16,
                         void* stream_ptr) {
  return launch_fwd<3>(gates, w3g, col_idx, drop, hs, fw, s, qslots, T, B, H,
                       R, bs, act, qbits, w_bf16, stream_ptr);
}

// The GRU forward on the persistent route on `stream`: one cooperative
// launch of `grid` blocks of gru_fwd_persist<., 3, bi, units> (bi: BT = 8
// * bi rows a block; units: 8 or 16, a divisor of bs; a shape of
// PK_SPARSE_FWD_SHAPE; smem bytes of dynamic shared memory:
// fused_rnn.gru_fwd_sparse_plan). Returns its cudaError_t.
//   gates: (T, B, 3H); w3g: (Nb, 3bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx: (Nb*R,); drop: (B, H); hs: (T, B, H) output; s: (B, H)
//   scratch; bmax: 2 * grid unsigned ints of scratch when qbits > 0.
int gru_fwd_sparse_persist(const float* gates, const void* w3g,
                           const int* col_idx, const float* drop, float* hs,
                           float* s, unsigned* bmax, int T, int B, int H,
                           int R, int bs, int act, int qbits, int w_bf16,
                           int grid, int bi, int units, int smem,
                           void* stream_ptr) {
  return fwd_persist(3, gates, w3g, col_idx, drop, hs, s, bmax, T, B, H, R,
                     bs, act, qbits, w_bf16, grid, bi, units, smem,
                     stream_ptr);
}

// out[0..2]: the forward chain's co-resident blocks per SM at `smem` bytes
// of dynamic shared memory (w_bf16, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int gru_fwd_sparse_occupancy(int w_bf16, int bi, int units, int smem,
                             int* out) {
  return fwd_occupancy(3, w_bf16, bi, units, smem, out);
}

// The GRU backward on `stream`: (with qbits > 0, one reduction for the T
// scales of q(h_{t-1})), two kernels for the forward quantities of all
// steps, then 2T step kernels in reverse time. Returns the first
// cudaError_t seen, 0 on success.
//   gates: (T, B, 3H); w3g, w3t: (Nb, 3bs, R*bs) and its per-block
//   transpose (Nb, R*bs, 3bs); col_idx, t_row_idx, t_perm: the layout's
//   int32 index arrays on the device (C entries per column list, t_perm ==
//   nnz a pad); drop: (B, H); h_prev, dhs: (T, B, H);
//   fw: (T, B, 3H) scratch; s_seq: (T, B, H) output (r_t * h_{t-1});
//   dh, ds: (B, H) scratch; dg: (T, B, 3H) output; qslots: 2T unsigned
//   ints of scratch when qbits > 0.
int fused_gru_bwd_sparse(const float* gates, const void* w3g, const void* w3t,
                         const int* col_idx, const int* t_row_idx,
                         const int* t_perm, const float* drop,
                         const float* h_prev, const float* dhs, float* fw,
                         float* s_seq, float* dh, float* ds, float* dg,
                         unsigned* qslots, int T, int B, int H, int R, int bs,
                         int C, int nnz, int act, int qbits, int w_bf16,
                         void* stream_ptr) {
  return launch_bwd<3>(gates, w3g, w3t, col_idx, t_row_idx, t_perm, drop,
                       h_prev, dhs, fw, s_seq, dh, ds, dg, qslots, T, B, H, R,
                       bs, C, nnz, act, qbits, w_bf16, stream_ptr);
}

// The GRU backward's forward quantities on the persistent route, first
// pass: with qbits > 0, zero the 2T scale slots and take max|h_prev| of
// each step into slots 0..T-1; then qh = q(h_prev) (bf16-rounded under
// w_bf16). Nothing runs with qbits == 0 in float32 (the wrapper hands
// h_prev itself to the GEMM). Returns the first cudaError_t, 0 on success.
//   h_prev: (T, B, H); qh: (T, B, H) output; qslots: 2T unsigned ints
int gru_bwd_sparse_rebuild_h(const float* h_prev, float* qh, unsigned* qslots,
                             int T, int B, int H, int qbits, int w_bf16,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool q = qbits > 0;
  const size_t bh = (size_t)B * H;
  const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
  cudaError_t err = cudaSuccess;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(2 * T) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (q || w_bf16) {
    const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
    auto k = w_bf16 ? quant_steps<true> : quant_steps<false>;
    k<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, q ? qslots : nullptr, qscale,
                                         qh, (int)bh);
    err = cudaGetLastError();
  }
  return err;
}

// Second pass, after the wrapper's v3 GEMM of qh against [U_z; U_r]: z, r
// into fw (at H.. and 2H..), s = r * h_prev into s_seq, max|s| of each
// step into slots T..2T-1 (qbits > 0), then qs = q(s) (bf16-rounded under
// w_bf16; nothing where neither applies: the wrapper uses s_seq).
//   gates, fw: (T, B, 3H); uzr: (2, T*B, H) [u_z; u_r]; h_prev, s_seq,
//   qs: (T, B, H)
int gru_bwd_sparse_rebuild_zr(const float* gates, const float* uzr,
                              const float* h_prev, float* fw, float* s_seq,
                              float* qs, unsigned* qslots, int T, int B,
                              int H, int qbits, int w_bf16,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool q = qbits > 0;
  const int M = T * B;
  gru_zr_rebuild<<<rows_grid(M, H), 256, 0, stream>>>(
      gates, uzr, h_prev, fw, s_seq, q ? qslots + T : nullptr, M, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(q || w_bf16)) return err;
  const size_t bh = (size_t)B * H;
  const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  auto k = w_bf16 ? quant_steps<true> : quant_steps<false>;
  k<<<dim3(nblk, T), 256, 0, stream>>>(s_seq, q ? qslots + T : nullptr,
                                       qscale, qs, (int)bh);
  return cudaGetLastError();
}

// The chain, after the wrapper's v3 GEMM of qs against U_h: a_pre = g_h +
// u_h into fw, then one cooperative launch of `grid` blocks of
// gru_bwd_persist (bi: 1, 2 or 4, BT = 8 * bi batch rows a block, 16
// units at bi = 2, 8 else; smem bytes
// of dynamic shared memory; fused_rnn.gru_bwd_sparse_plan sizes all
// three).
//   gates, fw, dg: (T, B, 3H); uh: (T*B, H); w3g: (Nb, 3bs, R*bs) float32
//   or bf16 (w_bf16); t_row_idx, t_perm: the layout's column lists; drop:
//   (B, H); h_prev, dhs: (T, B, H)
int gru_bwd_sparse_persist(const float* gates, const float* uh,
                           const void* w3g, const int* t_row_idx,
                           const int* t_perm, const float* drop,
                           const float* h_prev, const float* dhs, float* fw,
                           float* dg, int T, int B, int H,
                           int R, int bs, int C, int nnz, int act, int w_bf16,
                           int grid, int bi, int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int units = bi == 2 ? 16 : 8;
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(3, w_bf16, bi, &launch, &occ);
  if (!launch || C > MAX_C || H % units || bs % units)
    return cudaErrorInvalidValue;
  const int M = T * B;
  gru_apre_rebuild<<<rows_grid(M, H), 256, 0, stream>>>(gates, uh, fw, M, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch(grid, smem, stream, fw, w3g, t_row_idx, t_perm, drop, h_prev,
                dhs, dg, T, B, H, R, bs, C, nnz, act);
}

// out[0..2]: the chain's co-resident blocks per SM at `smem` bytes of
// dynamic shared memory (w_bf16 and bi as above), the SM count, and
// whether the device takes cooperative launches.
int gru_bwd_sparse_occupancy(int w_bf16, int bi, int smem, int* out) {
  return bwd_occupancy(3, w_bf16, bi, smem, out);
}

// The minimalGRU forward on the step route: as fused_gru_fwd_sparse with
// gates (T, B, 2H) [h | z], w3g (Nb, 2bs, R*bs) and fw (B, 2H).
int fused_mgru_fwd_sparse(const float* gates, const void* w3g,
                          const int* col_idx, const float* drop, float* hs,
                          float* fw, float* s, unsigned* qslots, int T, int B,
                          int H, int R, int bs, int act, int qbits, int w_bf16,
                          void* stream_ptr) {
  return launch_fwd<2>(gates, w3g, col_idx, drop, hs, fw, s, qslots, T, B, H,
                       R, bs, act, qbits, w_bf16, stream_ptr);
}

// The minimalGRU forward on the persistent route: as
// gru_fwd_sparse_persist with gates (T, B, 2H) [h | z] and w3g (Nb, 2bs,
// R*bs), one cooperative launch of gru_fwd_persist<., 2, bi, units>,
// whose dots sum in the step kernels' order (the step route's bits).
int mgru_fwd_sparse_persist(const float* gates, const void* w3g,
                            const int* col_idx, const float* drop, float* hs,
                            float* s, unsigned* bmax, int T, int B, int H,
                            int R, int bs, int act, int qbits, int w_bf16,
                            int grid, int bi, int units, int smem,
                            void* stream_ptr) {
  return fwd_persist(2, gates, w3g, col_idx, drop, hs, s, bmax, T, B, H, R,
                     bs, act, qbits, w_bf16, grid, bi, units, smem,
                     stream_ptr);
}

// out[0..2] of the minimalGRU forward's kernel, as
// gru_fwd_sparse_occupancy.
int mgru_fwd_sparse_occupancy(int w_bf16, int bi, int units, int smem,
                              int* out) {
  return fwd_occupancy(2, w_bf16, bi, units, smem, out);
}

// The minimalGRU backward on the step route: as fused_gru_bwd_sparse with
// gates, fw and dg (T, B, 2H), w3g (Nb, 2bs, R*bs), w3t (Nb, R*bs, 2bs)
// and s_seq z_t * h_{t-1}.
int fused_mgru_bwd_sparse(const float* gates, const void* w3g,
                          const void* w3t, const int* col_idx,
                          const int* t_row_idx, const int* t_perm,
                          const float* drop, const float* h_prev,
                          const float* dhs, float* fw, float* s_seq, float* dh,
                          float* ds, float* dg, unsigned* qslots, int T, int B,
                          int H, int R, int bs, int C, int nnz, int act,
                          int qbits, int w_bf16, void* stream_ptr) {
  return launch_bwd<2>(gates, w3g, w3t, col_idx, t_row_idx, t_perm, drop,
                       h_prev, dhs, fw, s_seq, dh, ds, dg, qslots, T, B, H, R,
                       bs, C, nnz, act, qbits, w_bf16, stream_ptr);
}

// The minimalGRU backward on the persistent route on `stream`: the
// forward quantities of every step on the two forward step kernels (with
// qbits > 0 after the T scales of q(h_{t-1}): the forward's bits), then
// the reverse chain as one cooperative launch of `grid` blocks of
// gru_bwd_persist<., 2, bi, .> (bi: 1, 2 or 4, BT = 8 * bi batch rows a
// block, 16 units at bi = 2, 8 else; smem bytes of dynamic shared memory:
// fused_rnn.mgru_bwd_sparse_plan). Returns the first cudaError_t seen.
//   gates, fw, dg: (T, B, 2H); w3g: (Nb, 2bs, R*bs) float32 or bf16
//   (w_bf16); col_idx, t_row_idx, t_perm: the layout's index arrays; drop:
//   (B, H); h_prev, dhs: (T, B, H); s_seq: (T, B, H) output (z_t *
//   h_{t-1}); qslots: 2T unsigned ints of scratch when qbits > 0.
int mgru_bwd_sparse_persist(const float* gates, const void* w3g,
                            const int* col_idx, const int* t_row_idx,
                            const int* t_perm, const float* drop,
                            const float* h_prev, const float* dhs, float* fw,
                            float* s_seq, float* dg, unsigned* qslots, int T,
                            int B, int H, int R, int bs, int C, int nnz,
                            int act, int qbits, int w_bf16, int grid, int bi,
                            int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int units = bi == 2 ? 16 : 8;
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(2, w_bf16, bi, &launch, &occ);
  if (!launch || C > MAX_C || H % units || bs % units)
    return cudaErrorInvalidValue;
  auto rebuild = w_bf16 ? run_rebuild<true, 2> : run_rebuild<false, 2>;
  const cudaError_t err = rebuild(gates, w3g, col_idx, drop, h_prev, fw,
                                  s_seq, qslots, T, B, H, R, bs, act, qbits,
                                  stream);
  if (err != cudaSuccess) return err;
  return launch(grid, smem, stream, fw, w3g, t_row_idx, t_perm, drop, h_prev,
                dhs, dg, T, B, H, R, bs, C, nnz, act);
}

// out[0..2] of the minimalGRU's chain, as gru_bwd_sparse_occupancy.
int mgru_bwd_sparse_occupancy(int w_bf16, int bi, int smem, int* out) {
  return bwd_occupancy(2, w_bf16, bi, smem, out);
}

}  // extern "C"
