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
// of s. Blocks run in no order, so the forward launches two kernels per
// step from the host loop (the launch boundaries are the grid-wide
// barriers): gru_zr_step (z, r, s and max|s|) then gru_h_step (the
// candidate and h_t, max|h_t| for the next step's quantizer). It re-reads
// w3g (6.3 MB at the GRU's shape) from the 50 MB L2 each step; its time is
// 2T launches, far above the bound. A persistent kernel with w3g resident
// across the SMs is later work.
//
// The backward's forward quantities (z, r, s, the candidate's
// pre-activation and both quantizer scales) do not depend on dh, so they
// are rebuilt for all T at once before the reverse loop: one reduction
// for the T scales of q(h_{t-1}), then the same two step kernels over a
// grid with one z-slice per step, writing [a_pre | z | r] ([a_pre | z]) to
// scratch and s_t to the output. The reverse chain keeps two dependent
// steps per time step, so two kernels per step: gru_bwd_carry (dh from
// step t+1's [dg_z | dg_r] (dg_z) against [U_z; U_r] (U_z) transposed,
// then dg_h, and the GRU's dg_z) and gru_bwd_ds (ds from dg_h against U_h
// transposed, then dg_r or the minimalGRU's dg_z). A transposed product
// gathers per block column from the layout's column lists (t_row_idx,
// t_perm; a pad entry has t_perm == nnz), so no float atomics are needed
// and its sum is deterministic.
//
// Forward blocks own UNITS hidden units of one out-block j and BT batch
// rows: they stage the R*bs gathered columns of q(h_{t-1}) (or q(s)) for
// their rows in shared memory and each warp forms the dots of one w3g row
// with every staged row. Backward blocks own BWD_UNITS units of one block
// column: they stage the cotangents of the kept blocks of that column and
// each warp forms one unit's dot with a row of w3g transposed ((Nb, R*bs,
// G*bs), passed in, so the lanes read consecutive addresses).
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

template <bool BF16, int G>
cudaError_t run_bwd(const float* gates, const void* w3g, const void* w3t,
                    const int* col_idx, const int* t_row_idx,
                    const int* t_perm, const float* drop, const float* h_prev,
                    const float* dhs, float* fw, float* s_seq, float* dh,
                    float* ds, float* dg, unsigned* qslots, int T, int B,
                    int H, int R, int bs, int C, int nnz, int act, int qbits,
                    cudaStream_t stream) {
  const size_t smem_f = (size_t)BT * R * bs * sizeof(float);
  const size_t smem_c = (size_t)BT * C * (G - 1) * bs * sizeof(float);
  const size_t smem_d = (size_t)BT * C * bs * sizeof(float);
  cudaError_t err = allow_smem(gru_zr_step<BF16, G>, smem_f);
  if (err == cudaSuccess) err = allow_smem(gru_h_step<BF16, G>, smem_f);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_carry<BF16, G>, smem_c);
  if (err == cudaSuccess) err = allow_smem(gru_bwd_ds<BF16, G>, smem_d);
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
  // the forward quantities of every step at once
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
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the reverse chain, two kernels per step
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

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The GRU forward on `stream`: 2T step kernels from the zero state.
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

// The minimalGRU forward: as fused_gru_fwd_sparse with gates (T, B, 2H)
// [h | z], w3g (Nb, 2bs, R*bs) and fw (B, 2H).
int fused_mgru_fwd_sparse(const float* gates, const void* w3g,
                          const int* col_idx, const float* drop, float* hs,
                          float* fw, float* s, unsigned* qslots, int T, int B,
                          int H, int R, int bs, int act, int qbits, int w_bf16,
                          void* stream_ptr) {
  return launch_fwd<2>(gates, w3g, col_idx, drop, hs, fw, s, qslots, T, B, H,
                       R, bs, act, qbits, w_bf16, stream_ptr);
}

// The minimalGRU backward: as fused_gru_bwd_sparse with gates, fw and dg
// (T, B, 2H), w3g (Nb, 2bs, R*bs), w3t (Nb, R*bs, 2bs) and s_seq
// z_t * h_{t-1}.
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

}  // extern "C"
