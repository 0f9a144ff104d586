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
// block of the step before, and blocks run in no order. The forward
// takes one of two routes, picked by the caller before the launch from
// the shapes and the occupancy query (fused_rnn.rnn_fwd_sparse_route):
//
//   - "persist" (TPU row 36's redesign): ONE cooperative launch runs all
//     T steps (rnn_sparse_fwd_persist, persist.cuh). A block owns UN (8 or
//     16) units of one out-block and BT = 8 * BI batch rows for the whole
//     call, its units' R*bs-long rows of w3g resident in shared memory (8
//     KB at UN=8, R=2, bs=128), and per step stages h_{t-1} at the
//     out-block's R kept column blocks, takes the grid's max|h_{t-1}| from
//     the block maxima of step t-1's parity, quantizes the staged values
//     (persist::quant_staged), forms its dots, writes h_t and its block's
//     max|h_t|, and waits at one grid barrier (h_{t-1} is the step's only
//     grid-wide dependency). Its dots sum in rnn_sparse_step's row_dots
//     order (persist::resident_dots), so both routes give the same bits
//     (the CGS-16x RNN's dense stream is held to this forward).
//   - "step" (a shape whose blocks do not fit or are not co-resident, e.g.
//     256 rows of 1024, or bs not a multiple of the block's units): one
//     kernel per step from the host loop (the launch boundary is the
//     grid-wide barrier), re-reading w3g (1 MB at that shape) from the 50
//     MB L2: T launches.
//
// The backward's pre-activations a_pre = g + q(h_{t-1}) @ U^T do not
// depend on dh, so they are rebuilt for all T at once before the reverse
// chain, after one reduction for the T scales of q(h_{t-1}). The reverse
// chain has one dependent transposed product a step, the carry dg_{t+1}
// @ U. Several row blocks share a column block: the transposed product
// gathers per block column from the layout's column lists (t_row_idx,
// t_perm; a pad entry has t_perm == nnz), so no float atomics are needed
// and its sum is deterministic. The backward takes one of two routes,
// picked by the caller before the launch (fused_rnn.rnn_bwd_sparse_route):
//
//   - "persist" (TPU row 37's redesign). The rebuild: with the quantizer,
//     absmax_steps and quant_steps write q(h_prev) once (quant()'s bits);
//     then rnn_sparse_rebuild, the sparse counterpart of fused_gru.cu's
//     rows_dots: a block keeps 16 rows of w3g of one out-block resident
//     and runs through tiles of 32 rows of the unrolled batch M = T*B,
//     staging each tile's kept columns (rounded to bf16 under BF16) and
//     summing each dot in row_dots' order, so a_pre has the step route's
//     bits and relu' takes the forward's branch (a GEMM's order had
//     flipped it for the dense minimalGRU's rebuild). Then the whole
//     reverse chain in ONE cooperative launch (rnn_sparse_bwd_persist): a
//     block owns UN units of one block column and BT rows, its units'
//     columns of U at the column's nv kept blocks resident as rows of
//     nv*bs values, and per reverse step stages dg_{t+1} at those blocks'
//     out-blocks, forms carry = dg_{t+1} @ U for its units, writes dg_t =
//     (carry + dhs[t]) * drop * act'(a_pre[t]) and waits at one grid
//     barrier. With bs a multiple of 32, lane l of resident_dots over the
//     concatenated entries takes the k of col_dots' lane l in col_dots'
//     order, so both routes give the same bits.
//   - "step": the forward's step kernel over a grid with one z-slice per
//     step writes a_pre, then one kernel per reverse step: the carry from
//     dg_{t+1} against w3g transposed ((Nb, R*bs, bs), passed in, so the
//     lanes read consecutive addresses), then dg of step t: T + 1
//     launches.
//
// Forward step blocks own UNITS hidden units (UNITS rows of w3g) of one
// out-block j and BT batch rows: they stage the R*bs gathered columns of
// q(h_{t-1}) for their rows in shared memory and each warp forms the dots
// of one w3g row with every staged row. Backward step blocks own
// BWD_UNITS units of one block column: they stage dg_{t+1} at the kept
// blocks of that column and each warp forms one unit's dot with a row of
// w3g transposed. The device helpers are sparse_rec.cuh's, at G=1.
//
// qbits > 0: q() scales by max|h| over the step's whole (B, H) block.
// Step route: taken with an atomicMax on the float bits (a non-negative
// float's bits order like its value) into a per-step slot zeroed first;
// var == 0 (the zero state at t = 0) leaves h unquantized. Persistent
// forward: each block writes its own max, and the blocks of the next step
// take the max of those.
//
// bf16 (w3g in bf16, where the JAX package's size rule says so): the
// staged q(h) and the staged cotangents are rounded to bf16 before the
// dots; products, sums, the activation and the carries stay float32.

#include <algorithm>
#include <cmath>

#include "persist.cuh"
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

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU row 36's redesign; persist.cuh): the dense RNN forward's
// one-barrier chain (fused_rnn.cu's rnn_fwd_persist) over the sparse
// minimalGRU forward's staging (fused_gru_sparse.cu's gru_fwd_persist).
// Block c owns the UN units from u0 = (c % (H/UN)) * UN, all in out-block
// j = u0 / bs (UN divides bs), and the BT = 8 * BI batch rows from b0 =
// (c / (H/UN)) * BT. It copies its units' rows of w3g (R*bs values each)
// into shared memory once, widened to float32 (ws). Its thread o = b * UN
// + jj owns one (row, unit) and loads the next step's gate before the
// barrier. Per step t > 0: stage h_{t-1} (hs[t-1], other blocks' rows) at
// out-block j's R kept column blocks by cp.async while the block's first
// warp takes the grid's max|h_{t-1}| from the block maxima of step t-1's
// parity (bmax row (t-1) & 1, read through L2); q() at that scale
// (quant_rcp: quant()'s bits) and the bf16 rounding under BF16 in one pass
// over the staged values (persist::quant_staged); the dots against ws in
// rnn_sparse_step's row_dots order (persist::resident_dots); then h_t =
// act(g_t + dot) * drop into hs and the block's max|h_t| into its entry of
// bmax row t & 1; one grid barrier (none after the last step). At t = 0
// the carry is zero: no staging and no dots, as the step kernel's zeros
// sum to 0. Two rows of maxima, since a block past the barrier writes
// step t's while a slower block may still read step t-1's. The step
// route's bits: the same staged values, products and sums.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
rnn_sparse_fwd_persist(const float* __restrict__ gates,  // (T, B, H)
                       const void* __restrict__ w3g,     // (Nb, bs, R*bs)
                       const int* __restrict__ col_idx,  // (Nb*R,)
                       const float* __restrict__ drop,   // (B, H)
                       float* hs,                        // (T, B, H) output
                       unsigned* bmax,                   // (2, grid), or null
                       int T, int B, int H, int R, int bs, int act,
                       float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int K3 = R * bs, SK = P::row_stride(K3);
  float* ws = psm;                                 // (UN, K3)
  float* xs = ws + (size_t)UN * K3;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[UN]>(xs + (size_t)BT * SK);
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int j = u0 / bs;
  // w3g's row of unit u is row u of the flat (H, K3) view
  for (int i = threadIdx.x; i < UN * K3; i += P::THREADS)
    ws[i] = load_w<BF16>(w3g, (size_t)u0 * K3 + i);
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H;
  const size_t ih = (size_t)(b0 + ob) * H + ou;
  const float dr = mine ? drop[ih] : 0.f;
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  auto fetch = [&](int t) { return mine ? gates[t * bh + ih] : 0.f; };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int prev = (t + 1) & 1, now = t & 1;      // parities of t-1, t
    float u = 0.f;
    if (t > 0) {
      const float* v = hs + (size_t)(t - 1) * bh;
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
      if (bmax && threadIdx.x < 32) {
        const unsigned* mx = bmax + prev * gridDim.x;
        unsigned m = 0;
        for (int i = threadIdx.x; i < gridDim.x; i += 32)
          m = max(m, __ldcg(mx + i));
        m = __reduce_max_sync(0xffffffffu, m);
        if (threadIdx.x == 0) gmax = m;
      }
      P::cp_async_wait_all();
      __syncthreads();
      const float var = bmax ? __uint_as_float(gmax) : 0.f;
      P::quant_staged<BF16>(xs, SK, nb, K3, var, qscale, iscale);
      P::resident_dots<BT, UN, UN>(ws, xs, SK, K3, nb, usm);
      __syncthreads();
      if (mine) u = usm[ob][oj];
    }
    unsigned m = 0;
    if (mine) {
      // rnn_sparse_step's arithmetic
      const float h = act_fn(cur + u, act) * dr;
      hs[t * bh + ih] = h;
      m = __float_as_uint(fabsf(h));
    }
    if (t + 1 < T) {
      if (bmax) P::block_max(m, bmax + now * gridDim.x, wmax);
      cur = fetch(t + 1);
      grid.sync();
    }
  }
}

// Rows of w3g a block of rnn_sparse_rebuild keeps resident (units of one
// out-block: 16 divides bs on the persistent route) and rows of the
// unrolled batch it stages at once.
constexpr int REBUILD_UNITS = 16;
constexpr int REBUILD_ROWS = 32;

// pre[m, n] = gates[m, n] + sum_k x[m, kept col k] * w3g[n, k] for all M =
// T*B rows m of x (M, H) (q(h_prev), or h_prev itself without the
// quantizer) and every unit n: the backward's pre-activations of all steps
// at once (route "persist", TPU row 37's redesign), the sparse
// counterpart of fused_gru.cu's rows_dots. Block c owns REBUILD_UNITS
// units from n0 = (c % ug) * REBUILD_UNITS, all in out-block j = n0 / bs,
// with their rows of w3g resident (widened to float32), and the tiles of
// REBUILD_ROWS rows c / ug, c / ug + chunks, ...; per tile it stages the
// rows' R kept column blocks of out-block j by cp.async, rounds them to
// bf16 under BF16 (persist::quant_staged at scale 0: rnn_sparse_step's
// staged values, q() having run before), forms the dots in row_dots'
// order (persist::resident_dots) and adds the gates: a_pre with the step
// route's bits, so relu' takes the forward's branch.
// Two blocks an SM in float32 (128 registers a thread, no spills); one
// under BF16, whose bf16 loads held at 128 registers spilled 88 bytes.
template <bool BF16>
__global__ void __launch_bounds__(persist::THREADS, BF16 ? 1 : 2)
rnn_sparse_rebuild(const float* __restrict__ x,      // (M, H)
                   const void* __restrict__ w3g,     // (Nb, bs, R*bs)
                   const int* __restrict__ col_idx,  // (Nb*R,)
                   const float* __restrict__ gates,  // (M, H)
                   float* __restrict__ pre,          // (M, H) output
                   int M, int H, int R, int bs, int chunks) {
  namespace P = persist;
  constexpr int NR = REBUILD_UNITS, BT = REBUILD_ROWS;
  extern __shared__ __align__(16) float psm[];
  const int K3 = R * bs, SK = P::row_stride(K3);
  float* ws = psm;                                 // (NR, K3)
  float* xs = ws + (size_t)NR * K3;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[NR]>(xs + (size_t)BT * SK);
  const int ug = H / NR;
  const int n0 = (blockIdx.x % ug) * NR, c0 = blockIdx.x / ug;
  const int j = n0 / bs;
  for (int i = threadIdx.x; i < NR * K3; i += P::THREADS)
    ws[i] = load_w<BF16>(w3g, (size_t)n0 * K3 + i);
  for (int m0 = c0 * BT; m0 < M; m0 += chunks * BT) {
    const int nb = min(BT, M - m0);
    P::stage_rows(
        nb * R, bs,
        [&](int row) {
          const int b = row / R, k = row - b * R;
          return x + (size_t)(m0 + b) * H + (size_t)col_idx[j * R + k] * bs;
        },
        [&](int row) {
          const int b = row / R, k = row - b * R;
          return xs + (size_t)b * SK + k * bs;
        });
    P::cp_async_wait_all();
    __syncthreads();
    P::quant_staged<BF16>(xs, SK, nb, K3, 0.f, 0.f, 0.f);
    P::resident_dots<BT, NR, NR>(ws, xs, SK, K3, nb, usm);
    __syncthreads();
    for (int e = threadIdx.x; e < nb * NR; e += P::THREADS) {
      const int b = e / NR, r = e - b * NR;
      const size_t at = (size_t)(m0 + b) * H + n0 + r;
      pre[at] = gates[at] + usm[b][r];
    }
    __syncthreads();
  }
}

// The BPTT's reverse chain in one cooperative launch (route "persist",
// TPU row 37's redesign; persist.cuh): the sparse minimalGRU chain's
// column lists and staging (fused_gru_sparse.cu's gru_bwd_persist) with
// one product, summed in rnn_sparse_bwd_step's col_dots order. Block c
// owns the UN units from u0 = (c % (H/UN)) * UN, all in block column blk
// = u0 / bs, and the BT = 8 * BI rows from b0 = (c / (H/UN)) * BT. It
// lists the column's nv kept blocks (ent_j, ent_k) and copies, per entry
// e, its units' columns of U into shared memory once as rows: ws[r][e * bs
// + q] = w3g[ent_j[e], q, ent_k[e] * bs + u0 - blk * bs + r], nv*bs values
// a unit (a bf16 w3g widened exactly). Its thread o = b * UN + jj owns one
// (row, unit) and loads the next reverse step's a_pre and dhs before the
// barrier. Per reverse step t (from T-1): stage dg_{t+1} (dg[t+1], other
// blocks' rows) at the nv kept out-blocks ent_j by cp.async, rounded to
// bf16 under BF16; carry = the dots against ws (none at T-1; zero for a
// column with no entries); dg_t = (carry + dhs[t]) * drop * act'(a_pre[t])
// into dg; one grid barrier (none after step 0). dg_{t+1} is dg's own
// step, which no block writes again in the call, so it needs no exchange
// buffer. With bs a multiple of 32, lane l of resident_dots over the
// concatenated entries takes k = e * bs + q for q = l, l + 32, ... entry
// by entry, the order in which col_dots' lane l takes them, and the same
// shuffle tree follows: the step route's bits.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, 1)
rnn_sparse_bwd_persist(const float* __restrict__ pre,    // (T, B, H) a_pre
                       const void* __restrict__ w3g,     // (Nb, bs, R*bs)
                       const int* __restrict__ t_row_idx,
                       const int* __restrict__ t_perm,
                       const float* __restrict__ drop,   // (B, H)
                       const float* __restrict__ dhs,    // (T, B, H)
                       float* dg,                        // (T, B, H) output
                       int T, int B, int H, int R, int bs, int C, int nnz,
                       int act) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  extern __shared__ __align__(16) float psm[];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int KC = C * bs, SK = P::row_stride(KC);
  float* ws = psm;                                 // (UN, nv*bs)
  float* xs = ws + (size_t)UN * KC;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[UN]>(xs + (size_t)BT * SK);
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int blk = u0 / bs, cc0 = u0 - blk * bs;
  const int nv = column_entries(t_row_idx, t_perm, blk, C, R, nnz, ent_j,
                                ent_k);
  __syncthreads();
  const int K = nv * bs, RB = R * bs;
  // UN neighbouring columns of one row of w3g at a time
  for (int i = threadIdx.x; i < K * UN; i += P::THREADS) {
    const int k = i / UN, r = i - k * UN, e = k / bs, q = k - e * bs;
    ws[(size_t)r * K + k] = load_w<BF16>(
        w3g, ((size_t)ent_j[e] * bs + q) * RB + ent_k[e] * bs + cc0 + r);
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H;
  const size_t ih = (size_t)(b0 + ob) * H + ou;
  const float dr = mine ? drop[ih] : 0.f;
  // step t's a_pre and dhs of this thread's (row, unit), a step ahead
  auto fetch = [&](int t) {
    return mine ? make_float2(pre[t * bh + ih], dhs[t * bh + ih])
                : make_float2(0.f, 0.f);
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float2 cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float dot = 0.f;
    if (t + 1 < T) {
      const float* src = dg + (size_t)(t + 1) * bh;
      P::stage_rows(
          nb * nv, bs,
          [&](int row) {
            const int b = row / nv, e = row - b * nv;
            return src + (size_t)(b0 + b) * H + (size_t)ent_j[e] * bs;
          },
          [&](int row) {
            const int b = row / nv, e = row - b * nv;
            return xs + (size_t)b * SK + e * bs;
          });
      P::cp_async_wait_all();
      __syncthreads();
      P::quant_staged<BF16>(xs, SK, nb, K, 0.f, 0.f, 0.f);
      P::resident_dots<BT, UN, UN>(ws, xs, SK, K, nb, usm);
      __syncthreads();
      if (mine) dot = usm[ob][oj];
    }
    if (mine) {
      // rnn_sparse_bwd_step's arithmetic
      const float dh = dot + cur.y;
      dg[t * bh + ih] = dh * dr * dact_pre(cur.x, act);
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
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

// one cooperative launch of the forward at block shape (BI, UN)
template <bool BF16, int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const void* w3g,
                               const int* col_idx, const float* drop,
                               float* hs, unsigned* bmax, int T, int B, int H,
                               int R, int bs, int act, float qscale) {
  return persist::launch<rnn_sparse_fwd_persist<BF16, BI, UN>>(
      grid, smem, stream, gates, w3g, col_idx, drop, hs, bmax, T, B, H, R,
      bs, act, qscale);
}

// one cooperative launch of the reverse chain at block shape (BI, UN)
template <bool BF16, int BI, int UN>
cudaError_t launch_bwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* pre, const void* w3g,
                               const int* t_row_idx, const int* t_perm,
                               const float* drop, const float* dhs, float* dg,
                               int T, int B, int H, int R, int bs, int C,
                               int nnz, int act) {
  return persist::launch<rnn_sparse_bwd_persist<BF16, BI, UN>>(
      grid, smem, stream, pre, w3g, t_row_idx, t_perm, drop, dhs, dg, T, B,
      H, R, bs, C, nnz, act);
}

using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const float*,
                                  float*, unsigned*, int, int, int, int, int,
                                  int, float);
using BwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const int*,
                                  const float*, const float*, float*, int,
                                  int, int, int, int, int, int, int);
using Occupancy = cudaError_t (*)(int, int*);

// The forward's block shapes (bi, units): the plan's
// (fused_rnn.RNN_FWD_SPARSE_SHAPES). -> the launcher and the occupancy
// query of one, or nulls for another shape.
template <bool BF16>
void fwd_shape(int bi, int units, FwdLaunch* launch, Occupancy* occ) {
#define PK_RNN_SPARSE_FWD_SHAPE(BI_, UN_)                                 \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BF16, BI_, UN_>;                         \
    *occ = persist::occupancy<rnn_sparse_fwd_persist<BF16, BI_, UN_>>;    \
    return;                                                               \
  }
  PK_RNN_SPARSE_FWD_SHAPE(1, 8)
  PK_RNN_SPARSE_FWD_SHAPE(2, 8)
  PK_RNN_SPARSE_FWD_SHAPE(4, 8)
  PK_RNN_SPARSE_FWD_SHAPE(2, 16)
#undef PK_RNN_SPARSE_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

// The reverse chain's block shapes (bi, units): the plan's
// (fused_rnn.RNN_BWD_SPARSE_SHAPES). -> the launcher and the occupancy
// query of one, or nulls for another shape.
template <bool BF16>
void bwd_shape(int bi, int units, BwdLaunch* launch, Occupancy* occ) {
#define PK_RNN_SPARSE_BWD_SHAPE(BI_, UN_)                                 \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_bwd_persist<BF16, BI_, UN_>;                         \
    *occ = persist::occupancy<rnn_sparse_bwd_persist<BF16, BI_, UN_>>;    \
    return;                                                               \
  }
  PK_RNN_SPARSE_BWD_SHAPE(1, 8)
  PK_RNN_SPARSE_BWD_SHAPE(2, 8)
  PK_RNN_SPARSE_BWD_SHAPE(4, 8)
  PK_RNN_SPARSE_BWD_SHAPE(2, 16)
#undef PK_RNN_SPARSE_BWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void fwd_shape_of(int w_bf16, int bi, int units, FwdLaunch* launch,
                  Occupancy* occ) {
  (w_bf16 ? fwd_shape<true> : fwd_shape<false>)(bi, units, launch, occ);
}

void bwd_shape_of(int w_bf16, int bi, int units, BwdLaunch* launch,
                  Occupancy* occ) {
  (w_bf16 ? bwd_shape<true> : bwd_shape<false>)(bi, units, launch, occ);
}

// rnn_sparse_rebuild over the M = T*B rows of x on `stream`: 16 units a
// block, about two blocks an SM (the tiles of rows dealt out in chunks).
template <bool BF16>
cudaError_t run_rebuild(const float* x, const void* w3g, const int* col_idx,
                        const float* gates, float* pre, int M, int H, int R,
                        int bs, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int K3 = R * bs;
  const int ug = H / REBUILD_UNITS;
  const int tiles = (M + REBUILD_ROWS - 1) / REBUILD_ROWS;
  const int fit = 2 * sms / ug > 1 ? 2 * sms / ug : 1;
  const int chunks = fit < tiles ? fit : tiles;
  const int smem = (REBUILD_UNITS * K3 + REBUILD_ROWS * persist::row_stride(K3)
                    + REBUILD_ROWS * REBUILD_UNITS) * (int)sizeof(float);
  err = persist::allow_once<rnn_sparse_rebuild<BF16>>(smem);
  if (err != cudaSuccess) return err;
  rnn_sparse_rebuild<BF16><<<ug * chunks, persist::THREADS, smem, stream>>>(
      x, w3g, col_idx, gates, pre, M, H, R, bs, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward on the step route on `stream`: T step kernels from the zero
// state. Returns the first cudaError_t seen, 0 on success.
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

// The backward on the step route on `stream`: (with qbits > 0, one
// reduction for the T scales of q(h_{t-1})), one kernel for the
// pre-activations of all steps, then T step kernels in reverse time.
// Returns the first cudaError_t seen, 0 on success.
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

// The forward on the persistent route on `stream`: one cooperative launch
// of `grid` blocks of rnn_sparse_fwd_persist<., bi, units> (bi: BT = 8 *
// bi rows a block; units: 8 or 16, a divisor of bs; a shape of
// PK_RNN_SPARSE_FWD_SHAPE; smem bytes of dynamic shared memory:
// fused_rnn.rnn_fwd_sparse_plan sizes all three), whose dots sum in the
// step kernel's order (the step route's bits). Returns its cudaError_t;
// cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, H); w3g: (Nb, bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx: (Nb*R,); drop: (B, H); hs: (T, B, H) output; bmax: 2 * grid
//   unsigned ints of scratch when qbits > 0.
int rnn_fwd_sparse_persist(const float* gates, const void* w3g,
                           const int* col_idx, const float* drop, float* hs,
                           unsigned* bmax, int T, int B, int H, int R, int bs,
                           int act, int qbits, int w_bf16, int grid, int bi,
                           int units, int smem, void* stream_ptr) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(w_bf16, bi, units, &launch, &occ);
  if (!launch || bs % units || H % units) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return launch(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates,
                w3g, col_idx, drop, hs, q ? bmax : nullptr, T, B, H, R, bs,
                act, qscale);
}

// out[0..2]: the forward chain's co-resident blocks per SM at `smem` bytes
// of dynamic shared memory (w_bf16, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int rnn_fwd_sparse_occupancy(int w_bf16, int bi, int units, int smem,
                             int* out) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(w_bf16, bi, units, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

// The backward on the persistent route on `stream`: with qbits > 0 the T
// scales of q(h_{t-1}) (absmax_steps into qslots, zeroed first) and
// qh = q(h_prev) (quant_steps: quant()'s bits); the rebuild of every
// step's pre-activations into pre (rnn_sparse_rebuild over qh, or h_prev
// without the quantizer: the step route's bits); then one cooperative
// launch of `grid` blocks of rnn_sparse_bwd_persist<., bi, units> (bi: BT
// = 8 * bi rows a block; units: 8 or 16; bs a multiple of 32; a shape of
// PK_RNN_SPARSE_BWD_SHAPE; smem bytes of dynamic shared memory:
// fused_rnn.rnn_bwd_sparse_plan sizes all three). Returns the first
// cudaError_t seen; cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, H); w3g: (Nb, bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx, t_row_idx, t_perm: the layout's int32 index arrays (C entries
//   per column list, t_perm == nnz a pad); drop: (B, H); h_prev, dhs:
//   (T, B, H); qh, pre: (T, B, H) scratch (qh read only when qbits > 0);
//   dg: (T, B, H) output; qslots: T unsigned ints of scratch when
//   qbits > 0.
int rnn_bwd_sparse_persist(const float* gates, const void* w3g,
                           const int* col_idx, const int* t_row_idx,
                           const int* t_perm, const float* drop,
                           const float* h_prev, const float* dhs, float* qh,
                           float* pre, float* dg, unsigned* qslots, int T,
                           int B, int H, int R, int bs, int C, int nnz,
                           int act, int qbits, int w_bf16, int grid, int bi,
                           int units, int smem, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(w_bf16, bi, units, &launch, &occ);
  if (!launch || C > MAX_C || bs % 32 || bs % units || H % units ||
      bs % REBUILD_UNITS)
    return cudaErrorInvalidValue;
  const size_t bh = (size_t)B * H;
  const float* x = h_prev;
  cudaError_t err = cudaSuccess;
  if (qbits > 0) {
    const float qscale = std::ldexp(1.f, qbits - 1);
    const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
    err = cudaMemsetAsync(qslots, 0, (size_t)T * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    quant_steps<false><<<dim3(nblk, T), 256, 0, stream>>>(
        h_prev, qslots, qscale, qh, (int)bh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    x = qh;
  }
  auto rebuild = w_bf16 ? run_rebuild<true> : run_rebuild<false>;
  err = rebuild(x, w3g, col_idx, gates, pre, T * B, H, R, bs, stream);
  if (err != cudaSuccess) return err;
  return launch(grid, smem, stream, pre, w3g, t_row_idx, t_perm, drop, dhs,
                dg, T, B, H, R, bs, C, nnz, act);
}

// out[0..2]: the reverse chain's co-resident blocks per SM at `smem` bytes
// of dynamic shared memory (w_bf16, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int rnn_bwd_sparse_occupancy(int w_bf16, int bi, int units, int smem,
                             int* out) {
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(w_bf16, bi, units, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
