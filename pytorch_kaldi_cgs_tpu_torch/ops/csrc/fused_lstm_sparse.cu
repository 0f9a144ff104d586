// Block-sparse fused LSTM recurrence for Hopper (sm_90a), plain C
// interface.
//
// Replaces three TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:
//   _build_fwd_sparse (stash or not): the forward recurrence;
//   _build_bwd_sparse_stash: BPTT over the stashed post-activation gates;
//   _build_bwd_sparse: BPTT rebuilding the gates per step (recompute).
// The four recurrent matrices U_g (H, H) share one HCGS mask with R kept
// bs x bs blocks per block row, packed as w3g (Nb, 4*bs, R*bs): out-block
// j holds gate g's rows at g*bs.., its R kept column blocks side by side
// (col_idx[j*R + k] is the k-th one's column block). Per step t, gate
// order (f, i, o, c), only kept blocks touched:
//
//   u[b, g*H + j*bs + r] = sum_k sum_c q(h_{t-1})[b, col_idx[j*R+k]*bs + c]
//                                      * w3g[j, g*bs + r, k*bs + c]
//   f, i, o = sigmoid(g_t + u);  c_t = i * act(g_c + u_c) * drop + f * c_{t-1}
//   h_t = o * act(c_t)
//
// and the backward chain of fused_lstm_bwd.cu, whose carry into step t-1
// is dh_{t-1}[b, col] = sum over the kept blocks (j, k) of column block
// col/bs of sum_{g,r} dg_t[b, g*H + j*bs + r] * w3g[j, g*bs + r, k*bs + col%bs].
// The TPU kernel scatter-adds those per (j, k); here each column gathers
// them from the layout's column lists (t_row_idx, t_perm; a pad entry has
// t_perm == nnz), so no float atomics and the sum is deterministic.
// dU is not formed here: block_sparse_dw.cu computes it over (T*B).
//
// What bounds it on this card: at the CGS-16x training shape (T=300,
// B=16, H=1024, bs=128, R=2) one sparse product pass is 2*T*B*4H*R*bs =
// 10.07 GFLOP of float32 FMAs, 0.150 ms at 67 TFLOP/s (the stash forward
// also moves ~201 MB, 0.060 ms): operations bound the forward and the
// stash backward, two passes (0.300 ms) the recompute one. But step t
// needs all of step t-1 (and its quantizer scale max|h_{t-1}| over the
// whole (B, H) step), and blocks run in no order. The forward and the
// stash BPTT each take one of two routes, picked by the caller before the
// launch from the shapes and the occupancy query
// (fused_lstm.lstm_fwd_sparse_route, lstm_bwd_sparse_stash_route):
//
//   - "persist" (TPU rows 4 and 5's redesign; persist.cuh): ONE cooperative
//     launch runs all T steps. The forward (lstm_sparse_fwd_persist) is
//     the dense forward's one-barrier chain over the sparse RNN forward's
//     gathered staging: a block owns UN (4 or 8) units of one out-block
//     and BT = 8 * BI batch rows, its units' 4 x UN rows of w3g resident
//     (R*bs floats each), c of its (row, unit) in a register; per step it
//     stages h_{t-1} at the out-block's R kept column blocks by cp.async
//     while it takes the grid's max|h_{t-1}| from the block maxima of step
//     t-1's parity, quantizes the staged values (persist::quant_staged:
//     quant()'s bits, then bf16 under bf16), forms its dots in
//     sparse_fwd_step's row_dots order (persist::resident_dots), runs the
//     step kernel's gate math and waits at one grid barrier. The stash
//     BPTT's reverse chain (lstm_sparse_bwd_stash_persist) is the sparse
//     RNN chain at four gates: a block owns UN units of one block column
//     with their columns of U at the column's nv kept blocks resident as
//     rows of nv*4bs values (loaded once from w3g, so no transposed copy
//     is made), keeps dc in a register, and per reverse step stages
//     dg_{t+1} at those blocks' out-blocks (whole rows, or one entry a
//     slab in two buffers where whole rows do not fit beside the weights),
//     forms the carries, runs the step kernel's stash epilogue and waits
//     at one grid barrier. With 4bs a multiple of 32, lane l of its dots
//     takes the (entry, q) products of the step kernel's carry loop in its
//     order, then the same shuffle tree. Both chains give the step
//     route's bits.
//   - "step" (blocks that do not fit or are not co-resident, e.g. 160 rows
//     of 1024, or bs not a multiple of the block's units, or of 8 for the
//     chain; and the recompute BPTT, which has only this route): one
//     kernel per step from the host loops below (the launch boundary is
//     the grid-wide barrier), re-reading w3g (4.2 MB at that shape) from
//     the 50 MB L2 every step: T launches.
//
// Forward step kernel: a block owns UNITS hidden units of one out-block j
// (all four gate rows of each) and BT batch rows; it stages the R*bs
// gathered columns of q(h_{t-1}) for its rows in shared memory, each warp
// forms the dots of one w3g row with every staged row, the epilogue
// writes h_t, c_t (and the stash). qbits > 0: the scale of q() is
// max|h_{t-1}| over the whole (B, H) step, an atomicMax on the float bits
// in the previous step's epilogue (slot t), as in fused_lstm_fwd.cu.
//
// Backward step kernel (reverse): a block owns UNITS units of one block
// column c and BT batch rows; it stages, for each kept block (j, k) of
// column c, the 4*bs values of dg_{t+1} at rows g*H + j*bs.. (bf16-rounded
// under bf16); each warp forms one unit's dh_carry from w3g transposed
// ((Nb, R*bs, 4*bs), passed in, so the lanes read consecutive addresses).
// Recompute also stages the block's gathered q(h_{t-1}) and forms u for
// its units' gate rows (the forward's dots); the T quantizer scales come
// from one reduction over h_prev before the loop. The epilogue runs the
// cotangent chain and keeps dc in place (a block owns its units).
//
// bf16 (w3g in bf16): the gathered q(h) (forward, recompute) and dg
// (carry) are rounded to bf16 before the dots, products and sums are
// float32, as are the gate math and the carries (the TPU kernels cast the
// gathered operand to w3g's type with preferred_element_type=float32).

#include <algorithm>
#include <cmath>

#include "lstm_common.cuh"
#include "persist.cuh"

namespace {

constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FWD_UNITS = 4;        // hidden units per forward block
constexpr int BWD_UNITS = 8;        // hidden units per backward block
constexpr int MAX_C = 64;           // entries per column list

// The cell of one (row, unit) from its four pre-activations (gates plus
// dots), c_{t-1} and its dropout: both forward routes' arithmetic.
struct Cell {
  float f, i, o, cc, c, h;
};

__device__ __forceinline__ Cell cell_fwd(float pf, float pi, float po,
                                         float pc, float cp, float dr,
                                         int act) {
  Cell v;
  v.f = sigmoid(pf);
  v.i = sigmoid(pi);
  v.o = sigmoid(po);
  v.cc = act_fn(pc, act);
  v.c = v.i * v.cc * dr + v.f * cp;
  v.h = v.o * act_fn(v.c, act);
  return v;
}

// The cotangents of one (row, unit)'s four gates and its dc into step t-1,
// from the gates' activations (f, i, o, act(c~) = gc), act(c_t) = ac and
// its derivatives, c_{t-1}, the dropout, dh and the dc carried in.
struct Grads {
  float f, i, o, c, dc;
};

__device__ __forceinline__ Grads cell_grads(float gf, float gi, float go,
                                            float gc, float ac, float dact_c,
                                            float dact_gc, float cp, float dr,
                                            float dh, float dc) {
  const float dcv = dc + dh * go * dact_c;
  return {dcv * cp * gf * (1.f - gf), dcv * gc * dr * gi * (1.f - gi),
          dh * ac * go * (1.f - go), dcv * gi * dr * dact_gc, dcv * gf};
}

// cell_grads over the stash (f, i, o, act(c~)) and c_t: both stash BPTT
// routes' arithmetic.
__device__ __forceinline__ Grads stash_grads(float gf, float gi, float go,
                                             float gc, float ct, float cp,
                                             float dr, float dh, float dc,
                                             int act) {
  const float ac = act_fn(ct, act);
  return cell_grads(gf, gi, go, gc, ac, dact_out(ac, act), dact_out(gc, act),
                    cp, dr, dh, dc);
}

// List the kept blocks (j, k) of block column blk into ent_j / ent_k (the
// valid entries come first); returns their count.
__device__ __forceinline__ int column_entries(const int* __restrict__ t_row_idx,
                                              const int* __restrict__ t_perm,
                                              int blk, int C, int R, int nnz,
                                              int* ent_j, int* ent_k) {
  int nv = 0;
  for (int e = 0; e < C; ++e) {
    const int p = t_perm[blk * C + e];
    if (p == nnz) break;
    if (threadIdx.x == 0) {
      ent_j[e] = t_row_idx[blk * C + e];
      ent_k[e] = p - t_row_idx[blk * C + e] * R;
    }
    ++nv;
  }
  return nv;
}

// Stage q(h_prev) at the R*bs gathered columns of out-block j for nb batch
// rows from b0: hsm[b][k*bs + c] = q(h_prev[b0+b, col_idx[j*R+k]*bs + c]).
template <bool BF16>
__device__ __forceinline__ void stage_h(const float* __restrict__ h_prev,
                                        const int* __restrict__ col_idx,
                                        int j, int b0, int nb, int H, int R,
                                        int bs, const unsigned* scale_in,
                                        float qscale, float* hsm) {
  const int K3 = R * bs;
  const float var = scale_in ? __uint_as_float(*scale_in) : 0.f;
  for (int e = threadIdx.x; e < nb * K3; e += THREADS) {
    const int b = e / K3, kk = e - b * K3, k = kk / bs;
    const int col = col_idx[j * R + k] * bs + (kk - k * bs);
    float x = h_prev ? h_prev[(size_t)(b0 + b) * H + col] : 0.f;
    if (scale_in) x = quant(x, var, qscale);
    hsm[e] = BF16 ? round_bf16(x) : x;
  }
}

// usm[b][r] = dot(w3g row (j, g*bs + u0 - j*bs + jj), hsm[b]) for the
// 4*UNITS rows r = g*UNITS + jj of a block's units: one warp per row.
template <bool BF16, int UNITS>
__device__ __forceinline__ void row_dots(const void* __restrict__ w3g,
                                         const float* hsm, int j, int u0,
                                         int nb, int H, int K3, int bs,
                                         float (*usm)[4 * UNITS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < 4 * UNITS; r += WARPS) {
    const int g = r / UNITS, jj = r - g * UNITS, unit = u0 + jj;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (unit < H) {
      const size_t row =
          ((size_t)j * 4 * bs + g * bs + (unit - j * bs)) * K3;
      for (int kk = lane; kk < K3; kk += 32) {
        const float w = load_w<BF16>(w3g, row + kk);
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(hsm[b * K3 + kk], w, acc[b]);
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

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_step(const float* __restrict__ g_t,     // (B, 4H) gates of step t
                const void* __restrict__ w3g,      // (Nb, 4bs, R*bs)
                const int* __restrict__ col_idx,   // (Nb*R,)
                const float* __restrict__ drop,    // (B, H)
                const float* __restrict__ h_prev,  // (B, H); nullptr = zeros
                const float* __restrict__ c_prev,  // (B, H); nullptr = zeros
                float* __restrict__ h_out,         // (B, H) of step t
                float* __restrict__ c_out,
                float* __restrict__ a_out,         // (B, 4H) stash or nullptr
                const unsigned* __restrict__ scale_in,  // max|h_prev| bits
                unsigned* __restrict__ scale_out,       // max|h_t| slot
                int B, int H, int R, int bs, int act, float qscale) {
  constexpr int UNITS = FWD_UNITS;
  extern __shared__ float hsm[];                 // (BT, R*bs)
  __shared__ float usm[BT][4 * UNITS];
  const int K3 = R * bs;
  const int u0 = blockIdx.x * UNITS;
  const int j = u0 / bs;                         // UNITS divides bs
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);

  stage_h<BF16>(h_prev, col_idx, j, b0, nb, H, R, bs, scale_in, qscale, hsm);
  __syncthreads();
  row_dots<BF16, UNITS>(w3g, hsm, j, u0, nb, H, K3, bs, usm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b);
    const float* g = g_t + bb * 4 * H;
    const Cell v = cell_fwd(
        g[u] + usm[b][jj], g[H + u] + usm[b][UNITS + jj],
        g[2 * H + u] + usm[b][2 * UNITS + jj],
        g[3 * H + u] + usm[b][3 * UNITS + jj],
        c_prev ? c_prev[bb * H + u] : 0.f, drop[bb * H + u], act);
    h_out[bb * H + u] = v.h;
    c_out[bb * H + u] = v.c;
    if (a_out) {
      float* a = a_out + bb * 4 * H;
      a[u] = v.f;
      a[H + u] = v.i;
      a[2 * H + u] = v.o;
      a[3 * H + u] = v.cc;
    }
    m = max(m, __float_as_uint(fabsf(v.h)));
  }
  if (scale_out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0 && m) atomicMax(scale_out, m);
  }
}

template <bool BF16, bool STASH>
__global__ void __launch_bounds__(THREADS)
sparse_bwd_step(const float* __restrict__ a_t,     // STASH: acts (B, 4H)
                                                   // else the gates g_t
                const void* __restrict__ w3g,      // (Nb, 4bs, R*bs)
                const void* __restrict__ w3t,      // (Nb, R*bs, 4bs)
                const int* __restrict__ col_idx,   // (Nb*R,)
                const int* __restrict__ t_row_idx, // (Kb*C,)
                const int* __restrict__ t_perm,    // (Kb*C,), nnz = pad
                const float* __restrict__ drop,    // (B, H)
                const float* __restrict__ h_prev,  // recompute: h_{t-1}
                const float* __restrict__ c_t,     // STASH: c_t
                const float* __restrict__ c_prev,  // c_{t-1}
                const float* __restrict__ dh_in,   // dhs[t]
                const float* __restrict__ dg_next, // dg_{t+1} or nullptr
                float* __restrict__ dc,            // (B, H) carry, in place
                float* __restrict__ dg_out,        // (B, 4H) dg_t
                const unsigned* __restrict__ scale_in,  // max|h_{t-1}| bits
                int B, int H, int R, int bs, int C, int nnz, int act,
                float qscale) {
  constexpr int UNITS = BWD_UNITS;
  extern __shared__ float smem[];   // dg entries (BT x C*4bs), q(h) (BT x R*bs)
  __shared__ float dhsm[BT][UNITS];
  __shared__ float usm[BT][4 * UNITS];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int G = 4 * H, GB = 4 * bs, K3 = R * bs, W = C * GB;
  const int u0 = blockIdx.x * UNITS;
  const int blk = u0 / bs;            // column block (carry), out-block (u)
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float* dgsm = smem;
  float* hsm = smem + BT * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int nv = dg_next ? column_entries(t_row_idx, t_perm, blk, C, R, nnz,
                                          ent_j, ent_k)
                         : 0;
  __syncthreads();
  if (dg_next) {
    for (int e = threadIdx.x; e < nb * nv * GB; e += THREADS) {
      const int b = e / (nv * GB), r = e - b * nv * GB;
      const int kk = r / GB, q = r - kk * GB, g = q / bs;
      float v = dg_next[(size_t)(b0 + b) * G + g * H + ent_j[kk] * bs +
                        (q - g * bs)];
      dgsm[b * W + kk * GB + q] = BF16 ? round_bf16(v) : v;
    }
  }
  if (!STASH)
    stage_h<BF16>(h_prev, col_idx, blk, b0, nb, H, R, bs, scale_in, qscale,
                  hsm);
  __syncthreads();

  if (dg_next) {
    // dh_carry of unit u0 + jj: its column cc inside the block column
    for (int jj = warp; jj < UNITS; jj += WARPS) {
      const int cc = u0 + jj - blk * bs;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      if (u0 + jj < H) {
        for (int kk = 0; kk < nv; ++kk) {
          const size_t row =
              ((size_t)ent_j[kk] * K3 + ent_k[kk] * bs + cc) * GB;
          for (int q = lane; q < GB; q += 32) {
            const float w = load_w<BF16>(w3t, row + q);
#pragma unroll
            for (int b = 0; b < BT; ++b)
              if (b < nb) acc[b] = fmaf(dgsm[b * W + kk * GB + q], w, acc[b]);
          }
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
  if (!STASH) row_dots<BF16, UNITS>(w3g, hsm, blk, u0, nb, H, K3, bs, usm);
  __syncthreads();

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, u = u0 + jj;
    if (u >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + u;
    const float* a = a_t + bb * G;
    const float dh = (dg_next ? dhsm[b][jj] : 0.f) + dh_in[ih];
    const float cp = c_prev[ih];
    const float dr = drop[ih];
    Grads d;
    if (STASH) {
      d = stash_grads(a[u], a[H + u], a[2 * H + u], a[3 * H + u], c_t[ih], cp,
                      dr, dh, dc[ih], act);
    } else {
      const float gf = sigmoid(a[u] + usm[b][jj]);
      const float gi = sigmoid(a[H + u] + usm[b][UNITS + jj]);
      const float go = sigmoid(a[2 * H + u] + usm[b][2 * UNITS + jj]);
      const float gc_pre = a[3 * H + u] + usm[b][3 * UNITS + jj];
      const float gc = act_fn(gc_pre, act);
      const float c = gi * gc * dr + gf * cp;
      d = cell_grads(gf, gi, go, gc, act_fn(c, act), dact_pre(c, act),
                     dact_pre(gc_pre, act), cp, dr, dh, dc[ih]);
    }
    float* o = dg_out + bb * G;
    o[u] = d.f;
    o[H + u] = d.i;
    o[2 * H + u] = d.o;
    o[3 * H + u] = d.c;
    dc[ih] = d.dc;
  }
}

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU row 4's redesign; persist.cuh): the dense forward's
// one-barrier chain (fused_lstm_fwd.cu's lstm_fwd_persist) over the sparse
// RNN forward's gathered staging (fused_rnn_sparse.cu's
// rnn_sparse_fwd_persist), at four gates. Block c owns the UN units from
// u0 = (c % (H/UN)) * UN, all in out-block j = u0 / bs (UN divides bs),
// and the BT = 8 * BI batch rows from b0 = (c / (H/UN)) * BT. It copies
// into shared memory once its units' rows of w3g, the f gate's UN rows,
// then i's, o's and the candidate's, R*bs values each (ws, a bf16 w3g
// widened exactly): ws row g * UN + jj is w3g row (j, g*bs + u0 - j*bs +
// jj), as sparse_fwd_step's usm column. Its thread o = b * UN + jj keeps
// c_{t-1} of its (row, unit) in a register and loads the next step's gates
// before the barrier. Per step t > 0: stage h_{t-1} (hs[t-1], other
// blocks' rows) at out-block j's R kept column blocks by cp.async while
// the block's first warp takes the grid's max|h_{t-1}| from the block
// maxima of step t-1's parity (bmax row (t-1) & 1, read through L2); q()
// at that scale and the bf16 rounding under BF16 in one pass
// (persist::quant_staged: quant()'s bits); the dots against ws in
// sparse_fwd_step's row_dots order (persist::resident_dots); then
// the step kernel's gate math (cell_fwd), h_t and c_t into hs and cs, the
// stash into acts where asked, the block's max|h_t| into its entry of bmax
// row t & 1; one grid barrier (none after the last step). At t = 0 the
// carry is zero: no staging and no dots, as the step kernel's zeros sum to
// 0. hs[t-1] is written once in the call, so it needs no exchange buffer.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
lstm_sparse_fwd_persist(const float* __restrict__ gates,  // (T, B, 4H)
                        const void* __restrict__ w3g,     // (Nb, 4bs, R*bs)
                        const int* __restrict__ col_idx,  // (Nb*R,)
                        const float* __restrict__ drop,   // (B, H)
                        float* hs,                        // (T, B, H) output
                        float* __restrict__ cs,           // (T, B, H) output
                        float* __restrict__ acts,         // (T, B, 4H) or null
                        unsigned* bmax,                   // (2, grid), or null
                        int T, int B, int H, int R, int bs, int act,
                        float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, NR = 4 * UN;
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int K3 = R * bs, SK = P::row_stride(K3);
  float* ws = psm;                                 // (NR, K3)
  float* xs = ws + (size_t)NR * K3;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[NR]>(xs + (size_t)BT * SK);
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int j = u0 / bs, r0 = u0 - j * bs;
  for (int i = threadIdx.x; i < NR * K3; i += P::THREADS) {
    const int r = i / K3, k = i - r * K3, g = r / UN;
    ws[i] = load_w<BF16>(
        w3g, ((size_t)j * 4 * bs + g * bs + r0 + r - g * UN) * K3 + k);
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H, gbh = 4 * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * 4 * H;
  const float dr = mine ? drop[ih] : 0.f;
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  struct In {
    float f, i, o, c;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* g = gates + t * gbh + ig;
      v.f = g[ou];
      v.i = g[H + ou];
      v.o = g[2 * H + ou];
      v.c = g[3 * H + ou];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float cp = 0.f;                                  // c_{t-1} of (row, unit)
  In cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int prev = (t + 1) & 1, now = t & 1;      // parities of t-1, t
    float uf = 0.f, ui = 0.f, uo = 0.f, uc = 0.f;
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
      P::resident_dots<BT, NR, NR>(ws, xs, SK, K3, nb, usm);
      __syncthreads();
      if (mine) {
        uf = usm[ob][oj];
        ui = usm[ob][UN + oj];
        uo = usm[ob][2 * UN + oj];
        uc = usm[ob][3 * UN + oj];
      }
    }
    unsigned m = 0;
    if (mine) {
      const Cell v = cell_fwd(cur.f + uf, cur.i + ui, cur.o + uo, cur.c + uc,
                              cp, dr, act);
      hs[t * bh + ih] = v.h;
      cs[t * bh + ih] = v.c;
      if (acts) {
        float* a = acts + t * gbh + ig;
        a[ou] = v.f;
        a[H + ou] = v.i;
        a[2 * H + ou] = v.o;
        a[3 * H + ou] = v.cc;
      }
      cp = v.c;
      m = __float_as_uint(fabsf(v.h));
    }
    if (t + 1 < T) {
      if (bmax) P::block_max(m, bmax + now * gridDim.x, wmax);
      cur = fetch(t + 1);
      grid.sync();
    }
  }
}

// The stash BPTT's reverse chain in one cooperative launch (route
// "persist", TPU row 5's redesign; persist.cuh): the sparse RNN chain
// (fused_rnn_sparse.cu's rnn_sparse_bwd_persist) at four gates over the
// stash. Block c owns the UN units from u0 = (c % (H/UN)) * UN, all in
// block column blk = u0 / bs, and the BT = 8 * BI rows from b0 = (c /
// (H/UN)) * BT. It lists the column's nv kept blocks (ent_j, ent_k) and
// copies, per entry e, its units' columns of U into shared memory once as
// rows: ws[r][e * 4bs + g * bs + q] = w3g[ent_j[e], g * bs + q, ent_k[e] *
// bs + u0 - blk * bs + r], nv*4bs values a unit (the row w3t holds at
// (ent_j, ent_k * bs + cc) for sparse_bwd_step; a bf16 w3g widened
// exactly). Its thread o = b * UN + jj keeps dc of its (row, unit) in a
// register and loads the next reverse step's stash, c_t, c_{t-1} and dhs
// before the barrier. Per reverse step t (from T-1): stage dg_{t+1}
// (dg[t+1], other blocks' rows) at the entries' out-blocks, 4 segments of
// bs floats an entry and a row (g * H + ent_j * bs), by cp.async: in one
// buffer of whole rows where es >= nv, else es entries a slab through two
// buffers, the next slab's copy in flight while the current one is
// summed; round them to bf16 under BF16 (persist::quant_staged at scale
// 0); the carries against ws, each lane's sums kept across slabs
// (persist::resident_fma), none at T-1 and zero for a column with no
// entries; dh = carry + dhs[t] and sparse_bwd_step's stash epilogue
// (stash_grads) into dg[t]; one grid barrier (none after step 0). dg_{t+1}
// is dg's own step, which no block writes again in the call. With 4bs a
// multiple of 32 (bs of 8), lane l takes k = e * 4bs + q for q = l, l +
// 32, ... entry by entry, the order of sparse_bwd_step's carry loop, and
// the same shuffle tree follows (persist::resident_store): the step
// route's bits. Blocks of 8 rows are built for two an SM (128 registers a
// thread), the plan's pick where two such blocks hold the grid.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, BI == 1 ? 2 : 1)
lstm_sparse_bwd_stash_persist(const float* __restrict__ acts,   // (T, B, 4H)
                              const void* __restrict__ w3g,
                              const int* __restrict__ t_row_idx,
                              const int* __restrict__ t_perm,
                              const float* __restrict__ drop,   // (B, H)
                              const float* __restrict__ cs,     // (T, B, H)
                              const float* __restrict__ c_prev, // (T, B, H)
                              const float* __restrict__ dhs,    // (T, B, H)
                              float* dg,                        // (T, B, 4H)
                              int T, int B, int H, int R, int bs, int C,
                              int nnz, int act, int es) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  extern __shared__ __align__(16) float psm[];
  __shared__ int ent_j[MAX_C], ent_k[MAX_C];
  const int GB = 4 * bs, KC = C * GB, SK = P::row_stride(es * GB);
  float* ws = psm;                                 // (UN, nv*4bs)
  float* xs = ws + (size_t)UN * KC;                // 1 or 2 x (BT, SK)
  auto usm = reinterpret_cast<float (*)[UN]>(
      xs + (size_t)(es >= C ? 1 : 2) * BT * SK);
  const int ug = H / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  const int blk = u0 / bs, cc0 = u0 - blk * bs;
  const int nv = column_entries(t_row_idx, t_perm, blk, C, R, nnz, ent_j,
                                ent_k);
  __syncthreads();
  const int K = nv * GB, RB = R * bs;
  // UN neighbouring columns of one row of w3g at a time
  for (int i = threadIdx.x; i < K * UN; i += P::THREADS) {
    const int k = i / UN, r = i - k * UN, e = k / GB, q = k - e * GB;
    ws[(size_t)r * K + k] = load_w<BF16>(
        w3g, ((size_t)ent_j[e] * GB + q) * RB + ent_k[e] * bs + cc0 + r);
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb;
  const size_t bh = (size_t)B * H, gbh = 4 * bh;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * 4 * H;
  const float dr = mine ? drop[ih] : 0.f;
  struct In {
    float f, i, o, c, ct, cp, dh;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* a = acts + t * gbh + ig;
      v.f = a[ou];
      v.i = a[H + ou];
      v.o = a[2 * H + ou];
      v.c = a[3 * H + ou];
      v.ct = cs[t * bh + ih];
      v.cp = c_prev[t * bh + ih];
      v.dh = dhs[t * bh + ih];
    }
    return v;
  };
  const int ns = (nv + es - 1) / es;               // slabs a reverse step
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dc = 0.f;                                  // dc of (row, unit)
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float dot = 0.f;
    if (t + 1 < T && nv > 0) {
      const float* src = dg + (size_t)(t + 1) * gbh;
      // stage slab s (entries e0.. of this column) into buffer s & 1
      auto issue = [&](int s) {
        const int e0 = s * es, ne = min(es, nv - e0), per = 4 * ne;
        float* d = xs + (size_t)(s & 1) * BT * SK;
        P::stage_rows(
            nb * per, bs,
            [&](int row) {
              const int b = row / per, rr = row - b * per, g = rr & 3;
              return src + (size_t)(b0 + b) * 4 * H + (size_t)g * H +
                     (size_t)ent_j[e0 + (rr >> 2)] * bs;
            },
            [&](int row) {
              const int b = row / per, rr = row - b * per;
              return d + (size_t)b * SK + (rr >> 2) * GB + (rr & 3) * bs;
            });
        P::cp_async_commit();
      };
      float acc[BT / 2][UN / 4];
      P::resident_zero<BT, UN>(acc);
      issue(0);
      for (int s = 0; s < ns; ++s) {
        if (s + 1 < ns) {
          issue(s + 1);
          P::cp_async_wait<1>();
        } else {
          P::cp_async_wait<0>();
        }
        __syncthreads();
        const int e0 = s * es, n = min(es, nv - e0) * GB;
        float* x = xs + (size_t)(s & 1) * BT * SK;
        P::quant_staged<BF16>(x, SK, nb, n, 0.f, 0.f, 0.f);
        P::resident_fma<BT, UN>(ws, K, x, SK, e0 * GB, n, nb, acc);
        if (s + 2 < ns) __syncthreads();   // issue(s + 2) refills this buffer
      }
      P::resident_store<BT, UN, UN>(acc, usm);
      __syncthreads();
      if (mine) dot = usm[ob][oj];
    }
    if (mine) {
      const Grads d = stash_grads(cur.f, cur.i, cur.o, cur.c, cur.ct, cur.cp,
                                  dr, dot + cur.dh, dc, act);
      float* out = dg + t * gbh + ig;
      out[ou] = d.f;
      out[H + ou] = d.i;
      out[2 * H + ou] = d.o;
      out[3 * H + ou] = d.c;
      dc = d.dc;
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
  }
}

template <bool BF16>
cudaError_t run_fwd(const float* gates, const void* w3g, const int* col_idx,
                    const float* drop, float* hs, float* cs, float* acts,
                    unsigned* qslots, int T, int B, int H, int R, int bs,
                    int act, int qbits, cudaStream_t stream) {
  auto kern = sparse_fwd_step<BF16>;
  const size_t smem = (size_t)BT * R * bs * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  if (q) {   // slot 0 (max|h0| = 0 for the zero state) stays 0
    err = cudaMemsetAsync(qslots, 0, (size_t)(T + 1) * sizeof(unsigned),
                          stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + FWD_UNITS - 1) / FWD_UNITS, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    kern<<<grid, THREADS, smem, stream>>>(
        gates + (size_t)t * 4 * bh, w3g, col_idx, drop,
        t ? hs + (t - 1) * bh : nullptr, t ? cs + (t - 1) * bh : nullptr,
        hs + t * bh, cs + t * bh, acts ? acts + (size_t)t * 4 * bh : nullptr,
        q ? qslots + t : nullptr, q ? qslots + t + 1 : nullptr, B, H, R, bs,
        act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool BF16, bool STASH>
cudaError_t run_bwd(const float* a, const void* w3g, const void* w3t,
                    const int* col_idx, const int* t_row_idx,
                    const int* t_perm, const float* drop, const float* h_prev,
                    const float* cs, const float* c_prev, const float* dhs,
                    float* dc, float* dg, unsigned* qslots, int T, int B,
                    int H, int R, int bs, int C, int nnz, int act, int qbits,
                    cudaStream_t stream) {
  auto kern = sparse_bwd_step<BF16, STASH>;
  const size_t smem =
      (size_t)BT * (C * 4 * bs + (STASH ? 0 : R * bs)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool q = !STASH && qbits > 0;
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
  const dim3 grid((H + BWD_UNITS - 1) / BWD_UNITS, (B + BT - 1) / BT);
  const size_t G = (size_t)4 * H;
  for (int t = T - 1; t >= 0; --t) {
    kern<<<grid, THREADS, smem, stream>>>(
        a + (size_t)t * G * B, w3g, w3t, col_idx, t_row_idx, t_perm, drop,
        STASH ? nullptr : h_prev + t * bh, STASH ? cs + t * bh : nullptr,
        c_prev + t * bh, dhs + t * bh,
        t + 1 < T ? dg + (size_t)(t + 1) * G * B : nullptr, dc,
        dg + (size_t)t * G * B, q ? qslots + t : nullptr, B, H, R, bs, C, nnz,
        act, qscale);
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
                               float* hs, float* cs, float* acts,
                               unsigned* bmax, int T, int B, int H, int R,
                               int bs, int act, float qscale) {
  return persist::launch<lstm_sparse_fwd_persist<BF16, BI, UN>>(
      grid, smem, stream, gates, w3g, col_idx, drop, hs, cs, acts, bmax, T,
      B, H, R, bs, act, qscale);
}

// one cooperative launch of the stash BPTT's chain at block shape (BI, UN)
template <bool BF16, int BI, int UN>
cudaError_t launch_bwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* acts, const void* w3g,
                               const int* t_row_idx, const int* t_perm,
                               const float* drop, const float* cs,
                               const float* c_prev, const float* dhs,
                               float* dg, int T, int B, int H, int R, int bs,
                               int C, int nnz, int act, int es) {
  return persist::launch<lstm_sparse_bwd_stash_persist<BF16, BI, UN>>(
      grid, smem, stream, acts, w3g, t_row_idx, t_perm, drop, cs, c_prev,
      dhs, dg, T, B, H, R, bs, C, nnz, act, es);
}

using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const float*,
                                  float*, float*, float*, unsigned*, int, int,
                                  int, int, int, int, float);
using BwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const int*, const int*,
                                  const float*, const float*, const float*,
                                  const float*, float*, int, int, int, int,
                                  int, int, int, int, int);
using Occupancy = cudaError_t (*)(int, int*);

// The forward's block shapes (bi, units): the plan's
// (fused_lstm.LSTM_FWD_SPARSE_SHAPES). -> the launcher and the occupancy
// query of one, or nulls for another shape.
template <bool BF16>
void fwd_shape(int bi, int units, FwdLaunch* launch, Occupancy* occ) {
#define PK_LSTM_SPARSE_FWD_SHAPE(BI_, UN_)                                \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BF16, BI_, UN_>;                         \
    *occ = persist::occupancy<lstm_sparse_fwd_persist<BF16, BI_, UN_>>;   \
    return;                                                               \
  }
  PK_LSTM_SPARSE_FWD_SHAPE(1, 4)
  PK_LSTM_SPARSE_FWD_SHAPE(1, 8)
  PK_LSTM_SPARSE_FWD_SHAPE(2, 4)
  PK_LSTM_SPARSE_FWD_SHAPE(2, 8)
#undef PK_LSTM_SPARSE_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

// The stash BPTT chain's block shapes (bi, units): the plan's
// (fused_lstm.LSTM_BWD_SPARSE_SHAPES). -> the launcher and the occupancy
// query of one, or nulls for another shape.
template <bool BF16>
void bwd_shape(int bi, int units, BwdLaunch* launch, Occupancy* occ) {
#define PK_LSTM_SPARSE_BWD_SHAPE(BI_, UN_)                                \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_bwd_persist<BF16, BI_, UN_>;                         \
    *occ = persist::occupancy<                                            \
        lstm_sparse_bwd_stash_persist<BF16, BI_, UN_>>;                   \
    return;                                                               \
  }
  PK_LSTM_SPARSE_BWD_SHAPE(1, 4)
  PK_LSTM_SPARSE_BWD_SHAPE(1, 8)
  PK_LSTM_SPARSE_BWD_SHAPE(2, 8)
#undef PK_LSTM_SPARSE_BWD_SHAPE
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

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward on `stream`: T step kernels from the zero state. Returns the
// first cudaError_t seen, 0 on success.
//   gates: (T, B, 4H); w3g: (Nb, 4bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx: (Nb*R,) int32 on the device; drop: (B, H);
//   hs, cs: (T, B, H) outputs; acts: (T, B, 4H) stash output or null;
//   qslots: T+1 unsigned ints of scratch when qbits > 0.
// bs must be a multiple of 4 (a block's units share one out-block).
int fused_lstm_fwd_sparse(const float* gates, const void* w3g,
                          const int* col_idx, const float* drop, float* hs,
                          float* cs, float* acts, unsigned* qslots, int T,
                          int B, int H, int R, int bs, int act, int qbits,
                          int w_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = w_bf16 ? run_fwd<true> : run_fwd<false>;
  return fn(gates, w3g, col_idx, drop, hs, cs, acts, qslots, T, B, H, R, bs,
            act, qbits, stream);
}

// The backward on `stream`: T step kernels in reverse time (plus, for the
// recompute backward with qbits > 0, one reduction for the T quantizer
// scales first). Returns the first cudaError_t seen, 0 on success.
//   a:      (T, B, 4H) stashed activations (stash=1) or gates (stash=0)
//   w3g, w3t: (Nb, 4bs, R*bs) and its per-block transpose (Nb, R*bs, 4bs)
//   col_idx, t_row_idx, t_perm: the layout's int32 index arrays (device);
//           C = entries per column list, nnz = the pad value of t_perm
//   h_prev: (T, B, H) carries entering each step (stash=0 only)
//   cs:     (T, B, H) cell states (stash=1 only)
//   c_prev, dhs: (T, B, H);  dc: (B, H) zeros on entry, dc0 on exit
//   dg:     (T, B, 4H) output;  qslots: T unsigned ints of scratch
// bs must be a multiple of 8 (a block's units share one column block).
int fused_lstm_bwd_sparse(const float* a, const void* w3g, const void* w3t,
                          const int* col_idx, const int* t_row_idx,
                          const int* t_perm, const float* drop,
                          const float* h_prev, const float* cs,
                          const float* c_prev, const float* dhs, float* dc,
                          float* dg, unsigned* qslots, int T, int B, int H,
                          int R, int bs, int C, int nnz, int act, int qbits,
                          int stash, int w_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C > 64) return cudaErrorInvalidValue;
  auto fn = stash ? (w_bf16 ? run_bwd<true, true> : run_bwd<false, true>)
                  : (w_bf16 ? run_bwd<true, false> : run_bwd<false, false>);
  return fn(a, w3g, w3t, col_idx, t_row_idx, t_perm, drop, h_prev, cs, c_prev,
            dhs, dc, dg, qslots, T, B, H, R, bs, C, nnz, act, qbits, stream);
}

// The forward on the persistent route on `stream`: one cooperative launch
// of `grid` blocks of lstm_sparse_fwd_persist<., bi, units> (bi: BT = 8 *
// bi rows a block; units: 4 or 8, a divisor of bs; a shape of
// PK_LSTM_SPARSE_FWD_SHAPE; smem bytes of dynamic shared memory:
// fused_lstm.lstm_fwd_sparse_plan sizes all three), whose dots sum in the
// step kernel's order (the step route's bits). Returns its cudaError_t;
// cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, 4H); w3g: (Nb, 4bs, R*bs) float32 or bf16 (w_bf16);
//   col_idx: (Nb*R,); drop: (B, H); hs, cs: (T, B, H) outputs; acts:
//   (T, B, 4H) stash output or null; bmax: 2 * grid unsigned ints of
//   scratch when qbits > 0.
int lstm_fwd_sparse_persist(const float* gates, const void* w3g,
                            const int* col_idx, const float* drop, float* hs,
                            float* cs, float* acts, unsigned* bmax, int T,
                            int B, int H, int R, int bs, int act, int qbits,
                            int w_bf16, int grid, int bi, int units, int smem,
                            void* stream_ptr) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(w_bf16, bi, units, &launch, &occ);
  if (!launch || bs % units || bs % 4 || H % units)
    return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return launch(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates,
                w3g, col_idx, drop, hs, cs, acts, q ? bmax : nullptr, T, B, H,
                R, bs, act, qscale);
}

// out[0..2]: the forward chain's co-resident blocks per SM at `smem` bytes
// of dynamic shared memory (w_bf16, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int lstm_fwd_sparse_occupancy(int w_bf16, int bi, int units, int smem,
                              int* out) {
  FwdLaunch launch;
  Occupancy occ;
  fwd_shape_of(w_bf16, bi, units, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

// The stash BPTT on the persistent route on `stream`: one cooperative
// launch of `grid` blocks of lstm_sparse_bwd_stash_persist<., bi, units>
// (bi: BT = 8 * bi rows a block; units: 4 or 8, a divisor of bs; bs a
// multiple of 8, so 4bs of 32; es: the entries a block stages at once, C
// for whole rows in one buffer, fewer for slabs through two; a shape of
// PK_LSTM_SPARSE_BWD_SHAPE; smem bytes of dynamic shared memory:
// fused_lstm.lstm_bwd_sparse_stash_plan sizes all four), whose carries sum
// in the step kernel's order (the step route's bits). Returns its
// cudaError_t; cudaErrorInvalidValue for a shape not instantiated.
//   acts: (T, B, 4H) the stash; w3g: (Nb, 4bs, R*bs) float32 or bf16
//   (w_bf16); t_row_idx, t_perm: the layout's column lists (C entries
//   each, t_perm == nnz a pad); drop: (B, H); cs, c_prev, dhs: (T, B, H);
//   dg: (T, B, 4H) output.
int lstm_bwd_sparse_stash_persist(const float* acts, const void* w3g,
                                  const int* t_row_idx, const int* t_perm,
                                  const float* drop, const float* cs,
                                  const float* c_prev, const float* dhs,
                                  float* dg, int T, int B, int H, int R,
                                  int bs, int C, int nnz, int act, int w_bf16,
                                  int grid, int bi, int units, int es,
                                  int smem, void* stream_ptr) {
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(w_bf16, bi, units, &launch, &occ);
  if (!launch || C > MAX_C || es < 1 || bs % 8 || bs % units || H % units)
    return cudaErrorInvalidValue;
  return launch(grid, smem, static_cast<cudaStream_t>(stream_ptr), acts, w3g,
                t_row_idx, t_perm, drop, cs, c_prev, dhs, dg, T, B, H, R, bs,
                C, nnz, act, es);
}

// out[0..2]: the stash BPTT chain's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (w_bf16, bi and units as above), the SM
// count, and whether the device takes cooperative launches.
int lstm_bwd_sparse_stash_occupancy(int w_bf16, int bi, int units, int smem,
                                    int* out) {
  BwdLaunch launch;
  Occupancy occ;
  bwd_shape_of(w_bf16, bi, units, &launch, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
