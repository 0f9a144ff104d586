// Block-sparse fused vanilla-RNN recurrence for Hopper (sm_90a), forward
// and BPTT, plain C interface.
//
// Replaces two TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_rnn_fwd_sparse (fused_rnn_fwd_sparse): the forward recurrence
//     from the zero state;
//   _build_rnn_bwd_sparse (fused_rnn_bwd_sparse): BPTT rebuilding the
//     pre-activations (there is no stash variant).
// The recurrent matrix U (H, H) keeps R bs x bs blocks per block row of
// its HCGS mask, packed as w3g (Nb, bs, R*bs): out-block j's rows, its R
// kept column blocks side by side (col_idx[j*R + k] is the k-th one's
// column block). Per step t, only kept blocks touched ("@" a product over
// them):
//
//   h_t = act(g_t + q(h_{t-1}) @ U^T) * drop   dropout scales the state
//
// and in reverse, from carry = 0 at t = T-1 (q passes the gradient
// straight through, as the TPU kernel's does):
//
//   dh    = carry + dhs[t]
//   dg_t  = dh * drop * act'(a_pre)            relu'(0) = 0
//   carry = dg_t @ U
//
// dU is not formed here: block_sparse_dw.cu computes it over (T*B) from
// q(h_{t-1}) at G=1.
//
// What bounds it on this card: at the CGS-16x RNN's training shape
// (T=300, B=8, H=1024, bs=128, R=2) the forward's products are
// 2*T*B*H*R*bs = 1.26 GFLOP of float32 FMAs, 0.019 ms at 67 TFLOP/s (it
// moves ~20 MB, 0.006 ms): operations bound it; the backward does them
// twice. But each step needs all of h_{t-1} and its quantizer scale
// max|h_{t-1}| (per step over the whole (B, H) block), written by every
// block of the step before, and blocks run in no order: one launch per
// step from the host loop (the launch boundary is the grid-wide
// barrier), re-reading w3g (1 MB at that shape) from the 50 MB L2. Its
// time is T launches, far above the bound; a persistent kernel with w3g
// resident across the SMs is later work.
//
// The backward's pre-activations a_pre = g + q(h_{t-1}) @ U^T do not
// depend on dh, so they are rebuilt for all T at once before the reverse
// loop: one reduction for the T scales of q(h_{t-1}), then the forward's
// step kernel over a grid with one z-slice per step, writing a_pre
// (T, B, H) to scratch. The reverse chain has one dependent transposed
// product per step, so one kernel per step: the carry from dg_{t+1}
// against w3g transposed ((Nb, R*bs, bs), passed in, so the lanes read
// consecutive addresses), then dg of step t. Several row blocks share a
// column block: the transposed product gathers per block column from the
// layout's column lists (t_row_idx, t_perm; a pad entry has t_perm ==
// nnz), so no float atomics are needed and its sum is deterministic.
//
// Forward blocks own UNITS hidden units (UNITS rows of w3g) of one
// out-block j and BT batch rows: they stage the R*bs gathered columns of
// q(h_{t-1}) for their rows in shared memory and each warp forms the dots
// of one w3g row with every staged row. Backward blocks own BWD_UNITS
// units of one block column: they stage dg_{t+1} at the kept blocks of
// that column and each warp forms one unit's dot with a row of w3g
// transposed. The device helpers are sparse_rec.cuh's, at G=1.
//
// qbits > 0: q() scales by max|h| over the step's whole (B, H) block,
// taken with an atomicMax on the float bits (a non-negative float's bits
// order like its value) into a per-step slot zeroed first; var == 0 (the
// zero state at t = 0) leaves h unquantized.
//
// bf16 (w3g in bf16, where the JAX package's size rule says so): the
// staged q(h) and the staged cotangents are rounded to bf16 before the
// dots; products, sums, the activation and the carries stay float32.

#include <algorithm>
#include <cmath>

#include "sparse_rec.cuh"

namespace {

constexpr int UNITS = 8;            // units (w3g rows) per forward block

// One forward step (blockIdx.z = step within the launch: the forward
// launches one step, the backward's rebuild all T). With h_out (the
// forward): h_t = act(a_pre) * drop into h_out and its max|h_t| bits into
// scale_out. Without (the rebuild): a_pre into pre.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
rnn_sparse_step(const float* __restrict__ gates,   // (B, H)
                const void* __restrict__ w3g,      // (Nb, bs, R*bs)
                const int* __restrict__ col_idx,   // (Nb*R,)
                const float* __restrict__ drop,    // (B, H)
                const float* __restrict__ h_prev,  // (B, H); null = zeros
                float* __restrict__ h_out,         // (B, H) or null
                float* __restrict__ pre,           // (B, H) or null
                const unsigned* __restrict__ scale_in,  // max|h_prev| bits
                unsigned* __restrict__ scale_out,       // max|h_t| slot
                int B, int H, int R, int bs, int act, float qscale) {
  extern __shared__ float sm[];                  // (BT, R*bs)
  __shared__ float usm[BT][UNITS];
  const size_t t = blockIdx.z, bh = (size_t)B * H;
  gates += t * bh;
  if (pre) pre += t * bh;
  if (h_prev) h_prev += t * bh;
  if (scale_in) scale_in += t;
  const int K3 = R * bs;
  const int u0 = blockIdx.x * UNITS, j = u0 / bs;   // UNITS divides bs
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_cols<BF16>(h_prev, col_idx, j, b0, nb, H, R, bs, scale_in, qscale,
                   sm);
  __syncthreads();
  row_dots<BF16, 1, UNITS, UNITS>(w3g, sm, j, u0, 0, nb, H, K3, bs, usm);
  __syncthreads();

  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t ih = (size_t)(b0 + b) * H + u;
    const float a_pre = gates[ih] + usm[b][jj];
    if (h_out) {
      const float h = act_fn(a_pre, act) * drop[ih];
      h_out[ih] = h;
      m = max(m, __float_as_uint(fabsf(h)));
    } else {
      pre[ih] = a_pre;
    }
  }
  if (h_out && scale_out) slot_max(m, scale_out);
}

// Reverse step t: dh = dg_{t+1} @ U + dhs[t] (dg_{t+1} null at t = T-1:
// dh = dhs[t]), dg_t = dh * drop * act'(a_pre).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
rnn_sparse_bwd_step(const float* __restrict__ pre_t,    // (B, H) a_pre
                    const void* __restrict__ w3t,       // (Nb, R*bs, bs)
                    const int* __restrict__ t_row_idx,
                    const int* __restrict__ t_perm,
                    const float* __restrict__ drop,
                    const float* __restrict__ dh_in,    // dhs[t]
                    const float* __restrict__ dg_next,  // dg_{t+1} or null
                    float* __restrict__ dg_t, int B, int H, int R, int bs,
                    int C, int nnz, int act) {
  extern __shared__ float dgsm[];                // (BT, C * bs)
  __shared__ float dsm[BT][BWD_UNITS];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int u0 = blockIdx.x * BWD_UNITS, blk = u0 / bs;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  if (dg_next) {
    const int nv = column_entries(t_row_idx, t_perm, blk, C, R, nnz, ent_j,
                                  ent_k);
    __syncthreads();
    stage_dg<BF16, 1, 1>(dg_next, ent_j, nv, C, 0, b0, nb, H, bs, dgsm);
    __syncthreads();
    col_dots<BF16, 1, 1>(w3t, dgsm, ent_j, ent_k, nv, C, blk, u0, 0, nb, H,
                         R * bs, bs, dsm);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nb * BWD_UNITS; e += THREADS) {
    const int b = e / BWD_UNITS, jj = e - b * BWD_UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t ih = (size_t)(b0 + b) * H + u;
    const float dh = (dg_next ? dsm[b][jj] : 0.f) + dh_in[ih];
    dg_t[ih] = dh * drop[ih] * dact_pre(pre_t[ih], act);
  }
}

template <bool BF16>
cudaError_t run_fwd(const float* gates, const void* w3g, const int* col_idx,
                    const float* drop, float* hs, unsigned* qslots, int T,
                    int B, int H, int R, int bs, int act, int qbits,
                    cudaStream_t stream) {
  const size_t smem = (size_t)BT * R * bs * sizeof(float);
  cudaError_t err = allow_smem(rnn_sparse_step<BF16>, smem);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  // slots: max|h| of steps 0..T (slot 0 = the zero state)
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)(T + 1) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    rnn_sparse_step<BF16><<<grid, THREADS, smem, stream>>>(
        gates + t * bh, w3g, col_idx, drop, t ? hs + (t - 1) * bh : nullptr,
        hs + t * bh, nullptr, q ? qslots + t : nullptr,
        q ? qslots + t + 1 : nullptr, B, H, R, bs, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool BF16>
cudaError_t run_bwd(const float* gates, const void* w3g, const void* w3t,
                    const int* col_idx, const int* t_row_idx,
                    const int* t_perm, const float* drop, const float* h_prev,
                    const float* dhs, float* pre, float* dg, unsigned* qslots,
                    int T, int B, int H, int R, int bs, int C, int nnz,
                    int act, int qbits, cudaStream_t stream) {
  const size_t smem_f = (size_t)BT * R * bs * sizeof(float);
  const size_t smem_b = (size_t)BT * C * bs * sizeof(float);
  cudaError_t err = allow_smem(rnn_sparse_step<BF16>, smem_f);
  if (err == cudaSuccess) err = allow_smem(rnn_sparse_bwd_step<BF16>, smem_b);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  const size_t bh = (size_t)B * H;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)T * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the pre-activations of every step at once
  const dim3 fgrid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT, T);
  rnn_sparse_step<BF16><<<fgrid, THREADS, smem_f, stream>>>(
      gates, w3g, col_idx, drop, h_prev, nullptr, pre, q ? qslots : nullptr,
      nullptr, B, H, R, bs, act, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the reverse chain, one kernel per step
  const dim3 grid((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  for (int t = T - 1; t >= 0; --t) {
    rnn_sparse_bwd_step<BF16><<<grid, THREADS, smem_b, stream>>>(
        pre + t * bh, w3t, t_row_idx, t_perm, drop, dhs + t * bh,
        t + 1 < T ? dg + (t + 1) * bh : nullptr, dg + t * bh, B, H, R, bs, C,
        nnz, act);
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

// The forward on `stream`: T step kernels from the zero state. Returns the
// first cudaError_t seen, 0 on success.
//   gates: (T, B, H); w3g: (Nb, bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx: (Nb*R,) int32 on the device; drop: (B, H); hs: (T, B, H)
//   output; qslots: T+1 unsigned ints of scratch when qbits > 0.
// bs must be a multiple of UNITS (a block's units share one out-block).
int fused_rnn_fwd_sparse(const float* gates, const void* w3g,
                         const int* col_idx, const float* drop, float* hs,
                         unsigned* qslots, int T, int B, int H, int R, int bs,
                         int act, int qbits, int w_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bs % UNITS) return cudaErrorInvalidValue;
  auto fn = w_bf16 ? run_fwd<true> : run_fwd<false>;
  return fn(gates, w3g, col_idx, drop, hs, qslots, T, B, H, R, bs, act, qbits,
            stream);
}

// The backward on `stream`: (with qbits > 0, one reduction for the T
// scales of q(h_{t-1})), one kernel for the pre-activations of all steps,
// then T step kernels in reverse time. Returns the first cudaError_t
// seen, 0 on success.
//   gates: (T, B, H); w3g, w3t: (Nb, bs, R*bs) and its per-block transpose
//   (Nb, R*bs, bs); col_idx, t_row_idx, t_perm: the layout's int32 index
//   arrays on the device (C entries per column list, t_perm == nnz a
//   pad); drop: (B, H); h_prev, dhs: (T, B, H); pre: (T, B, H) scratch;
//   dg: (T, B, H) output; qslots: T unsigned ints of scratch when
//   qbits > 0.
int fused_rnn_bwd_sparse(const float* gates, const void* w3g,
                         const void* w3t, const int* col_idx,
                         const int* t_row_idx, const int* t_perm,
                         const float* drop, const float* h_prev,
                         const float* dhs, float* pre, float* dg,
                         unsigned* qslots, int T, int B, int H, int R, int bs,
                         int C, int nnz, int act, int qbits, int w_bf16,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C > MAX_C || bs % UNITS || bs % BWD_UNITS) return cudaErrorInvalidValue;
  auto fn = w_bf16 ? run_bwd<true> : run_bwd<false>;
  return fn(gates, w3g, w3t, col_idx, t_row_idx, t_perm, drop, h_prev, dhs,
            pre, dg, qslots, T, B, H, R, bs, C, nnz, act, qbits, stream);
}

}  // extern "C"
