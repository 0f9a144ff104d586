// Fused vanilla-RNN recurrence for Hopper (sm_90a), forward and BPTT,
// plain C interface.
//
// Replaces three TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:
//   _build_rnn_fwd (fused_rnn_fwd): the forward, in all its variants: the
//     seeded carry h0 (with_init, the streaming forward) and stash (the
//     training forward, which also writes the post-activation a of every
//     step, BEFORE the dropout: h / drop would divide by dropped zeros);
//   _build_rnn_bwd_stash (fused_rnn_bwd, stash=1): the reverse recurrence
//     over that stash;
//   _build_rnn_bwd (fused_rnn_bwd, stash=0): the same, rebuilding the
//     pre-activation from g and h_{t-1} (the default backward).
// U is (H, H). Per step t:
//
//   a   = act(g_t + q(h_{t-1}) @ U^T)
//   h_t = a * drop                   dropout scales the whole state
//
// and in reverse, from carry = 0 at t = T-1 (q passes the gradient
// straight through, as the TPU kernels' does):
//
//   dh    = carry + dhs[t]
//   dg_t  = dh * drop * act'
//   carry = dg_t @ U
//
// act' comes from the activation's output a (stash) or its input a_pre
// (recompute), as the TPU kernels take it; relu's is 1 where the value is
// > 0 in both. dU is not formed here: the caller computes it as one
// (H, T*B) @ (T*B, H) product. Every value is float32 (the TPU kernels
// get U in float32 whatever the compute dtype).
//
// What bounds it on this card: at the TIMIT RNN's training shape (T=300,
// B=8, H=550) the forward's products are 2*T*B*H*H = 1.45 GFLOP of
// float32 FMAs, 0.022 ms at 67 TFLOP/s; the stash forward moves ~17 MB
// (0.005 ms at 3.35 TB/s), so operations bound it; the recompute backward
// does the forward's products and their transposes (0.043 ms). But each
// step needs all of h_{t-1} (forward) or all of dg_{t+1} (backward),
// written by every block of the step before, and on Hopper blocks run in
// no order.
//
// The forward (TPU row 27) takes one of two routes, picked by the caller
// before the launch from the shapes and the occupancy query
// (fused_rnn.rnn_fwd_route):
//
//   - "persist": ONE cooperative launch runs all T steps, seeded or not
//     (rnn_fwd_persist, persist.cuh): a block owns UN units and BT = 8 *
//     BI batch rows for the whole call, its units' rows of U resident in
//     shared memory, and per step stages q(h_{t-1}) of its rows, forms its
//     dots, runs the activation and waits at one grid barrier (h_{t-1} is
//     the step's only grid-wide dependency); h_t and the per-block
//     max|h_t| go through two exchange buffers picked by the step's
//     parity. Its sums are rnn_step's, so both routes give the same bits
//     (the CGS-16x RNN's dense stream is held to its sparse forward).
//   - "step" (a shape whose blocks do not fit or are not co-resident): one
//     kernel per step from the host loop (the launch boundary is the
//     grid-wide barrier), re-reading U (1.2 MB at H=550, resident in the
//     50 MB L2) every step: T launches, far above the bound.
//
// The recompute backward's pre-activations a_pre = g + q(h_{t-1}) @ U^T
// do not depend on dh, so one launch rebuilds them for all T (grid.z =
// steps) before the reverse loop, after one reduction for the T scales of
// q(h_{t-1}) when qbits > 0; it sums in the forward's order, so relu' at
// the kink takes the forward's branch (a GEMM's order had moved a
// pre-activation across it in the minimalGRU's rebuild). The reverse
// chain then has one dependent product per step. The recompute backward
// (TPU row 29, the TIMIT RNN's default) runs it on one of two routes,
// picked by the caller before the launch (fused_rnn.rnn_bwd_route):
//
//   - "persist": ONE cooperative launch runs the whole reverse chain
//     (rnn_bwd_persist): the forward's persistent design against U's
//     columns instead of its rows. A block owns UN units and BT = 8 * BI
//     rows, its units' columns of U resident, and per reverse step stages
//     dg_{t+1} of its rows, forms carry = dg_{t+1} @ U for its units,
//     writes dg_t = (carry + dhs[t]) * drop * act'(a_pre[t]) and waits at
//     one grid barrier (dg_{t+1} is the only grid-wide dependency). Its
//     dots are the step kernel's sums (persist::resident_dots), so both
//     routes give the same bits. Two launches a call, three with the
//     quantizer's reduction.
//   - "step" (a shape whose blocks do not fit or are not co-resident):
//     one kernel a reverse step against rows of U^T (passed in, (H, H)) so
//     that the lanes read consecutive addresses: T + 1 launches.
//
// The stash backward (row 28) runs on the step kernels.
//
// Per step on the step routes, a block owns UNITS hidden units and BT
// batch rows: it stages
// the rows' q(h_{t-1}) or dg_{t+1} (BT x H floats, 32 KB at H=1024) in
// shared memory, and each warp forms the dot of one row of U (or U^T)
// with every staged row (lanes over k, then a shuffle reduction). Widths
// need not be multiples of 32 or of UNITS (H=550): every loop masks.
//
// qbits > 0: q() scales by max|h_{t-1}| over the step's whole (B, H)
// block. Step route: taken with an atomicMax on the float bits (a
// non-negative float's bits order like its value) into a per-step slot
// zeroed first; slot 0 holds max|h0| (0 for the zero state, which leaves h
// unquantized). Persistent route: each block writes its own max, and the
// blocks of the next step take the max of those. The stash backward takes
// no quantizer.

#include <cmath>

#include "lstm_common.cuh"
#include "persist.cuh"

namespace {

constexpr int UNITS = 8;            // hidden units per block
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// Stage nb rows of q(v) (B, H) from row b0 into sm (BT x H); no quantizer
// when scale is null; nullptr v stages zeros.
__device__ __forceinline__ void stage_rows(const float* __restrict__ v,
                                           int b0, int nb, int H,
                                           const unsigned* __restrict__ scale,
                                           float qscale, float* sm) {
  const float var = scale ? __uint_as_float(*scale) : 0.f;
  for (int e = threadIdx.x; e < nb * H; e += THREADS) {
    float x = v ? v[(size_t)b0 * H + e] : 0.f;
    if (scale) x = quant(x, var, qscale);
    sm[e] = x;
  }
}

// usm[b][r] = sum_k sm[b][k] * W[u0 + r][k] for the block's UNITS rows of
// the (H, H) matrix W: one warp per row, lanes over k, then a shuffle
// reduction.
__device__ __forceinline__ void row_dots(const float* __restrict__ W,
                                         const float* sm, int u0, int nb,
                                         int H, float (*usm)[UNITS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < UNITS; r += WARPS) {
    const int j = u0 + r;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (j < H) {
      const float* row = W + (size_t)j * H;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w = row[k];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(sm[b * H + k], w, acc[b]);
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

// One forward step (blockIdx.z = step within the launch: the forward
// launches one step, the recompute backward's rebuild all T). With h_out
// (the forward): a = act(g + q(h_prev) @ U^T), h_t = a * drop into h_out,
// a into a_out when it is given (the stash), max|h_t| bits into
// scale_out. Without (the rebuild): a_pre = g + q(h_prev) @ U^T into
// a_out.
__global__ void __launch_bounds__(THREADS)
rnn_step(const float* __restrict__ g,          // (B, H) gates of the step
         const float* __restrict__ U,          // (H, H)
         const float* __restrict__ drop,       // (B, H)
         const float* __restrict__ h_prev,     // (B, H); nullptr = zeros
         float* __restrict__ h_out,            // (B, H) or nullptr
         float* __restrict__ a_out,            // (B, H) or nullptr
         const unsigned* __restrict__ scale_in,  // max|h_prev| bits or null
         unsigned* __restrict__ scale_out,       // max|h_t| slot or null
         int B, int H, int act, float qscale) {
  extern __shared__ float sm[];                  // (BT, H) q(h_prev)
  __shared__ float usm[BT][UNITS];
  const size_t t = blockIdx.z, bh = (size_t)B * H;
  g += t * bh;
  if (a_out) a_out += t * bh;
  if (h_prev) h_prev += t * bh;
  if (scale_in) scale_in += t;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);

  stage_rows(h_prev, b0, nb, H, scale_in, qscale, sm);
  __syncthreads();
  row_dots(U, sm, u0, nb, H, usm);
  __syncthreads();

  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t ih = (size_t)(b0 + b) * H + j;
    const float a_pre = g[ih] + usm[b][jj];
    if (h_out) {
      const float a = act_fn(a_pre, act);
      const float h = a * drop[ih];
      h_out[ih] = h;
      if (a_out) a_out[ih] = a;
      m = max(m, __float_as_uint(fabsf(h)));
    } else {
      a_out[ih] = a_pre;
    }
  }
  if (h_out && scale_out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(scale_out, m);
  }
}

// Reverse step t: dh = dg_{t+1} @ U + dhs[t] (dg_{t+1} null at t = T-1:
// dh = dhs[t]), dg_t = dh * drop * act'. PRE: a_t holds a_pre (act' from
// the input), else the stashed a (act' from the output).
template <bool PRE>
__global__ void __launch_bounds__(THREADS)
rnn_bwd_step(const float* __restrict__ a_t,      // (B, H) a or a_pre
             const float* __restrict__ Ut,       // (H, H) = U^T
             const float* __restrict__ drop,     // (B, H)
             const float* __restrict__ dh_in,    // (B, H) dhs[t]
             const float* __restrict__ dg_next,  // (B, H) dg_{t+1} or null
             float* __restrict__ dg_out,         // (B, H) dg_t
             int B, int H, int act) {
  extern __shared__ float sm[];                  // (BT, H) dg_{t+1}
  __shared__ float csm[BT][UNITS];
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT, nb = min(BT, B - b0);
  if (dg_next) {
    stage_rows(dg_next, b0, nb, H, nullptr, 0.f, sm);
    __syncthreads();
    row_dots(Ut, sm, u0, nb, H, csm);
    __syncthreads();
  }

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t ih = (size_t)(b0 + b) * H + j;
    const float dh = (dg_next ? csm[b][jj] : 0.f) + dh_in[ih];
    const float da = PRE ? dact_pre(a_t[ih], act) : dact_out(a_t[ih], act);
    dg_out[ih] = dh * drop[ih] * da;
  }
}

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU row 27's redesign; persist.cuh): fused_ligru.cu's
// ligru_fwd_persist with one gate. Block c owns the UN units from u0 = (c
// % ug) * UN (ug = ceil(H / UN); units past H get zero weights and no
// output) and the BT = 8 * BI batch rows from b0 = (c / ug) * BT. It
// copies its units' rows of U (H floats each) into shared memory once
// (ws). Its thread o = b * UN + jj owns one (row, unit) and loads the
// next step's gate before the barrier. Per step: stage h_{t-1} from the
// exchange buffer of step t-1's parity, q() at the max over that parity's
// block maxima, the dots against ws, a = act(g + dot), h_t = a * drop into
// hs and into the buffer of step t's parity, a into the stash, the
// block's max|h_t| into its entry of that parity's maxima; one grid
// barrier (none after the last step). Two buffers (2, B, HP) and two rows
// of block maxima (2, grid), since a block past the barrier writes h_t
// while a slower one may still stage h_{t-1}. With a seed h0 each thread
// first copies its entry into buffer 1 (step -1's) and the block's max|h0|
// into maxima row 1, then one barrier; without one, step 0's carry is
// zero: no staging and no dots. HP = H rounded up to 4 floats, so that
// each staged row starts 16-byte aligned; the padding is copied, never
// summed. Each dot is one warp's, lanes over k and a shuffle reduction, in
// rnn_step's row_dots order (persist::resident_dots), and q() (quant_rcp:
// quant()'s bits) runs once over the staged values (persist::stage_quant):
// both routes give the same bits.
template <int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
rnn_fwd_persist(const float* __restrict__ gates,  // (T, B, H)
                const float* __restrict__ U,      // (H, H)
                const float* __restrict__ drop,   // (B, H)
                const float* __restrict__ h0,     // (B, H) or null
                float* __restrict__ hs,           // (T, B, H) output
                float* __restrict__ acts,         // (T, B, H) or null
                float* xh,                        // (2, B, HP) exchange
                unsigned* bmax,                   // (2, grid), or null
                int T, int B, int H, int act, float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int SK = P::row_stride(H), HP = (H + 3) / 4 * 4;
  float* ws = psm;                                 // (UN, H)
  float* xsm = ws + (size_t)UN * H;                // (BT, SK)
  auto usm = reinterpret_cast<float (*)[UN]>(xsm + (size_t)BT * SK);
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int i = threadIdx.x; i < UN * H; i += P::THREADS) {
    const int r = i / H, k = i - r * H, u = u0 + r;
    ws[i] = u < H ? U[(size_t)u * H + k] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, xstep = (size_t)B * HP;
  const size_t ih = (size_t)(b0 + ob) * H + ou;
  const size_t ix = (size_t)(b0 + ob) * HP + ou;
  const float dr = mine ? drop[ih] : 0.f;
  const float iscale = qscale != 0.f ? 1.f / qscale : 0.f;
  auto fetch = [&](int t) { return mine ? gates[t * bh + ih] : 0.f; };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool seeded = h0 != nullptr;
  if (seeded) {
    unsigned m = 0;
    if (mine) {
      const float hp = h0[ih];
      xh[xstep + ix] = hp;
      m = __float_as_uint(fabsf(hp));
    }
    if (bmax) P::block_max(m, bmax + gridDim.x, wmax);
    grid.sync();
  }
  float cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int prev = (t + 1) & 1, now = t & 1;      // parities of t-1, t
    float u = 0.f;
    if (t > 0 || seeded) {
      P::stage_quant(xh + prev * xstep, HP, b0, nb, xsm, SK,
                     bmax ? bmax + prev * gridDim.x : nullptr, gridDim.x,
                     &gmax, qscale, iscale);
      P::resident_dots<BT, UN, UN>(ws, xsm, SK, H, nb, usm);
      __syncthreads();
      if (mine) u = usm[ob][oj];
    }
    unsigned m = 0;
    if (mine) {
      // rnn_step's arithmetic
      const float a = act_fn(cur + u, act);
      const float h = a * dr;
      hs[t * bh + ih] = h;
      xh[now * xstep + ix] = h;
      if (acts) acts[t * bh + ih] = a;
      m = __float_as_uint(fabsf(h));
    }
    if (t + 1 < T) {
      if (bmax) P::block_max(m, bmax + now * gridDim.x, wmax);
      cur = fetch(t + 1);
      grid.sync();
    }
  }
}

// The BPTT's reverse chain in one cooperative launch (route "persist",
// TPU row 29's redesign; persist.cuh): rnn_fwd_persist run backwards
// against U's columns. Block c owns the UN units from u0 = (c % ug) * UN
// and the BT = 8 * BI rows from b0 = (c / ug) * BT; it copies its units'
// columns of U into shared memory once as rows (ws[r][k] = U[k][u0 + r],
// zeros past H), so that the dots are the step kernel's against U^T's
// rows. Its thread o = b * UN + jj owns one (row, unit) and loads the
// next reverse step's a and dhs before the barrier. Per reverse step t
// (from T-1): stage dg_{t+1} of its rows, carry = the dots against ws
// (none at T-1), dg_t = (carry + dhs[t]) * drop * act'(a[t]) into dg and
// into the exchange buffer of t's parity; one grid barrier (none after
// step 0). dg_{t+1} is staged by cp.async from xg, two (B, HP) buffers
// picked by the step's parity with rows padded to 4 floats (HP = H
// rounded up), since a row of dg at H=550 is not 16-byte aligned for
// cp.async and a block past the barrier writes dg_t while a slower one may
// still stage dg_{t+1}. (Staging from dg itself by 4-byte loads through L2
// took 1.29-1.30 ms a call against 1.08 at the TIMIT RNN's train shape,
// chip_smoke.py --rnn-times on an H100 at 700 W.) The dots are
// persist::resident_dots, rnn_bwd_step's row_dots sums (lane l takes k =
// l, l + 32, ... in turn, then the shuffle reduction), so both routes
// give the same bits. PRE: a holds a_pre (act' from the input, the
// recompute backward), else the stash a (act' from the output).
template <int BI, int UN, bool PRE>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
rnn_bwd_persist(const float* __restrict__ a_all,  // (T, B, H) a_pre or a
                const float* __restrict__ U,      // (H, H)
                const float* __restrict__ drop,   // (B, H)
                const float* __restrict__ dhs,    // (T, B, H)
                float* __restrict__ dg,           // (T, B, H) output
                float* xg,                        // (2, B, HP) exchange
                int T, int B, int H, int act) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI;
  extern __shared__ __align__(16) float psm[];
  const int SK = P::row_stride(H), HP = (H + 3) / 4 * 4;
  float* ws = psm;                                 // (UN, H)
  float* xsm = ws + (size_t)UN * H;                // (BT, SK)
  auto csm = reinterpret_cast<float (*)[UN]>(xsm + (size_t)BT * SK);
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  // U's rows k, UN neighbouring columns at a time
  for (int i = threadIdx.x; i < UN * H; i += P::THREADS) {
    const int k = i / UN, r = i - k * UN, u = u0 + r;
    ws[(size_t)r * H + k] = u < H ? U[(size_t)k * H + u] : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, xstep = (size_t)B * HP;
  const size_t ih = (size_t)(b0 + ob) * H + ou;
  const size_t ix = (size_t)(b0 + ob) * HP + ou;
  const float dr = mine ? drop[ih] : 0.f;
  // step t's a and dhs of this thread's (row, unit), loaded a step ahead
  auto fetch = [&](int t) {
    return mine ? make_float2(a_all[t * bh + ih], dhs[t * bh + ih])
                : make_float2(0.f, 0.f);
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float2 cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    float c = 0.f;
    if (t + 1 < T) {
      P::stage_quant(xg + ((t + 1) & 1) * xstep, HP, b0, nb, xsm, SK,
                     nullptr, 0, nullptr, 0.f, 0.f);
      P::resident_dots<BT, UN, UN>(ws, xsm, SK, H, nb, csm);
      __syncthreads();
      if (mine) c = csm[ob][oj];
    }
    if (mine) {
      // rnn_bwd_step's arithmetic
      const float da = PRE ? dact_pre(cur.x, act) : dact_out(cur.x, act);
      const float d = (c + cur.y) * dr * da;
      dg[t * bh + ih] = d;
      xg[(t & 1) * xstep + ix] = d;
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

cudaError_t run_fwd(const float* gates, const float* U, const float* drop,
                    const float* h0, float* hs, float* acts, unsigned* qslots,
                    int T, int B, int H, int act, int qbits,
                    cudaStream_t stream) {
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = allow_smem((const void*)rnn_step, smem);
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
    rnn_step<<<grid, THREADS, smem, stream>>>(
        gates + t * bh, U, drop, t ? hs + (t - 1) * bh : h0, hs + t * bh,
        acts ? acts + t * bh : nullptr, q ? qslots + t : nullptr,
        q ? qslots + t + 1 : nullptr, B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The recompute backward's rebuild into pre (T, B, H): one reduction for
// the T scales of q(h_{t-1}) when qbits > 0, then one rnn_step launch over
// all T steps (grid.z = T) writing a_pre = g + q(h_{t-1}) @ U^T.
cudaError_t rebuild_pre(const float* gates, const float* U, const float* drop,
                        const float* h_prev, float* pre, unsigned* qslots,
                        int T, int B, int H, int act, int qbits,
                        cudaStream_t stream) {
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = allow_smem((const void*)rnn_step, smem);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  if (q) {
    err = cudaMemsetAsync(qslots, 0, (size_t)T * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    const int nblk = (int)((bh + 255) / 256 < 16 ? (bh + 255) / 256 : 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT, T);
  rnn_step<<<grid, THREADS, smem, stream>>>(gates, U, drop, h_prev, nullptr,
                                            pre, q ? qslots : nullptr,
                                            nullptr, B, H, act, qscale);
  return cudaGetLastError();
}

template <bool PRE>
cudaError_t run_bwd(const float* lead, const float* U, const float* Ut,
                    const float* drop, const float* h_prev, const float* dhs,
                    float* pre, float* dg, unsigned* qslots, int T, int B,
                    int H, int act, int qbits, cudaStream_t stream) {
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = allow_smem((const void*)rnn_bwd_step<PRE>, smem);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  const float* a = lead;
  if (PRE) {
    // the pre-activations of every step at once, from the gates
    err = rebuild_pre(lead, U, drop, h_prev, pre, qslots, T, B, H, act,
                      qbits, stream);
    if (err != cudaSuccess) return err;
    a = pre;
  }
  // the reverse chain, one kernel per step
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  for (int t = T - 1; t >= 0; --t) {
    rnn_bwd_step<PRE><<<grid, THREADS, smem, stream>>>(
        a + t * bh, Ut, drop, dhs + t * bh,
        t + 1 < T ? dg + (t + 1) * bh : nullptr, dg + t * bh, B, H, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// one cooperative launch of the persistent forward at block shape (BI, UN)
template <int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const float* U,
                               const float* drop, const float* h0, float* hs,
                               float* acts, float* xh, unsigned* bmax, int T,
                               int B, int H, int act, float qscale) {
  return persist::launch<rnn_fwd_persist<BI, UN>>(
      grid, smem, stream, gates, U, drop, h0, hs, acts, xh, bmax, T, B, H,
      act, qscale);
}

// The block shapes (bi, units) of the persistent forward: the plan's (1,
// 4), (1, 8), (2, 8) and (2, 16), and (1, 16), which a forced plan times
// at 8 rows. -> the launcher and the occupancy query of one, or nulls for
// another shape.
using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const float*, const float*, const float*,
                                  float*, float*, float*, unsigned*, int, int,
                                  int, int, float);
using FwdOccupancy = cudaError_t (*)(int, int*);

void fwd_shape_of(int bi, int units, FwdLaunch* launch, FwdOccupancy* occ) {
#define PK_RNN_FWD_SHAPE(BI_, UN_)                                        \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BI_, UN_>;                               \
    *occ = persist::occupancy<rnn_fwd_persist<BI_, UN_>>;                 \
    return;                                                               \
  }
  PK_RNN_FWD_SHAPE(1, 4)
  PK_RNN_FWD_SHAPE(1, 8)
  PK_RNN_FWD_SHAPE(2, 8)
  PK_RNN_FWD_SHAPE(1, 16)
  PK_RNN_FWD_SHAPE(2, 16)
#undef PK_RNN_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

// one cooperative launch of the persistent reverse chain at block shape
// (BI, UN)
template <int BI, int UN, bool PRE>
cudaError_t launch_bwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* a, const float* U,
                               const float* drop, const float* dhs, float* dg,
                               float* xg, int T, int B, int H, int act) {
  return persist::launch<rnn_bwd_persist<BI, UN, PRE>>(
      grid, smem, stream, a, U, drop, dhs, dg, xg, T, B, H, act);
}

// The block shapes (bi, units) of the recompute backward's persistent
// chain (PRE): the forward's, whose plan it shares, the plan's (1, 8),
// (2, 8) and (2, 16) and the (1, 4) and (1, 16) a forced plan times at 8
// rows. -> the launcher and the occupancy query of one, or nulls for
// another shape.
using BwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const float*, const float*, const float*,
                                  float*, float*, int, int, int, int);

void bwd_shape_of(int bi, int units, BwdLaunch* launch, FwdOccupancy* occ) {
#define PK_RNN_BWD_SHAPE(BI_, UN_)                                        \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_bwd_persist<BI_, UN_, true>;                         \
    *occ = persist::occupancy<rnn_bwd_persist<BI_, UN_, true>>;           \
    return;                                                               \
  }
  PK_RNN_BWD_SHAPE(1, 4)
  PK_RNN_BWD_SHAPE(1, 8)
  PK_RNN_BWD_SHAPE(2, 8)
  PK_RNN_BWD_SHAPE(1, 16)
  PK_RNN_BWD_SHAPE(2, 16)
#undef PK_RNN_BWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The forward on the step route on `stream`: T step kernels (plus one
// small reduction over h0 when qbits > 0 and h0 is given). Returns the
// first cudaError_t seen, 0 on success.
//   gates: (T, B, H);  U: (H, H);  drop: (B, H)
//   h0:    (B, H) seed carry, or null for zeros
//   hs:    (T, B, H) output;  acts: (T, B, H) stash output (a), or null
//   qslots: T+1 unsigned ints of scratch, used when qbits > 0
int fused_rnn_fwd(const float* gates, const float* U, const float* drop,
                  const float* h0, float* hs, float* acts, unsigned* qslots,
                  int T, int B, int H, int act, int qbits, void* stream_ptr) {
  return run_fwd(gates, U, drop, h0, hs, acts, qslots, T, B, H, act, qbits,
                 static_cast<cudaStream_t>(stream_ptr));
}

// The forward on the persistent route on `stream`: one cooperative launch
// of `grid` blocks of rnn_fwd_persist (bi: BT = 8 * bi rows a block;
// units: 4, 8 or 16; smem bytes of dynamic shared memory:
// fused_rnn.rnn_fwd_plan sizes all three), seeded or not. Returns its
// cudaError_t; cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, H);  U: (H, H);  drop: (B, H);  h0: (B, H) or null
//   hs: (T, B, H) output;  acts: (T, B, H) stash output, or null
//   xh: (2, B, HP) scratch, HP = H rounded up to a multiple of 4
//   bmax: 2 * grid unsigned ints of scratch when qbits > 0
int rnn_fwd_persist_run(const float* gates, const float* U, const float* drop,
                        const float* h0, float* hs, float* acts, float* xh,
                        unsigned* bmax, int T, int B, int H, int act,
                        int qbits, int grid, int bi, int units, int smem,
                        void* stream_ptr) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates, U,
            drop, h0, hs, acts, xh, q ? bmax : nullptr, T, B, H, act, qscale);
}

// out[0..2]: the persistent forward's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int fused_rnn_fwd_occupancy(int bi, int units, int smem, int* out) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

// The backward on the step route on `stream`: T step kernels in reverse
// time; the recompute backward (stash=0) first rebuilds the
// pre-activations of all steps in one launch (after one reduction for the
// T scales of q(h_{t-1}) when qbits > 0). Returns the first cudaError_t
// seen, 0 on success.
//   lead:   (T, B, H) stash a (stash=1) or gates (stash=0)
//   U, Ut:  (H, H) and its transpose
//   h_prev: (T, B, H) carries entering each step (read when stash=0)
//   dhs:    (T, B, H);  pre: (T, B, H) scratch when stash=0
//   dg:     (T, B, H) output
//   qslots: T unsigned ints of scratch when stash=0 and qbits > 0
int fused_rnn_bwd(const float* lead, const float* U, const float* Ut,
                  const float* drop, const float* h_prev, const float* dhs,
                  float* pre, float* dg, unsigned* qslots, int T, int B,
                  int H, int act, int qbits, int stash, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = stash ? run_bwd<false> : run_bwd<true>;
  return fn(lead, U, Ut, drop, h_prev, dhs, pre, dg, qslots, T, B, H, act,
            qbits, stream);
}

// The recompute backward on the persistent route on `stream`: the rebuild
// of every step's pre-activations into pre (one launch, after the
// reduction for the T scales of q(h_{t-1}) when qbits > 0), then one
// cooperative launch of `grid` blocks of rnn_bwd_persist (bi: BT = 8 * bi
// rows a block; units: 4, 8 or 16; smem bytes of dynamic shared memory:
// fused_rnn.rnn_bwd_plan sizes all three). Returns the first cudaError_t
// seen; cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, H);  U: (H, H);  drop: (B, H)
//   h_prev, dhs: (T, B, H);  pre: (T, B, H) scratch;  dg: (T, B, H) output
//   xg: (2, B, HP) scratch, HP = H rounded up to a multiple of 4
//   qslots: T unsigned ints of scratch when qbits > 0
int rnn_bwd_persist_run(const float* gates, const float* U, const float* drop,
                        const float* h_prev, const float* dhs, float* pre,
                        float* dg, float* xg, unsigned* qslots, int T, int B,
                        int H, int act, int qbits, int grid, int bi,
                        int units, int smem, void* stream_ptr) {
  BwdLaunch fn;
  FwdOccupancy occ;
  bwd_shape_of(bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = rebuild_pre(gates, U, drop, h_prev, pre, qslots, T,
                                      B, H, act, qbits, stream);
  if (err != cudaSuccess) return err;
  return fn(grid, smem, stream, pre, U, drop, dhs, dg, xg, T, B, H, act);
}

// out[0..2]: the persistent reverse chain's co-resident blocks per SM at
// `smem` bytes of dynamic shared memory (bi and units as above), the SM
// count, and whether the device takes cooperative launches.
int fused_rnn_bwd_occupancy(int bi, int units, int smem, int* out) {
  BwdLaunch fn;
  FwdOccupancy occ;
  bwd_shape_of(bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
