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
// needs all of step t-1, and blocks run in no order, so as the dense
// kernels do, this first design launches one kernel per step from the
// host loops below (the launch boundary is the grid-wide barrier) and
// re-reads w3g (4.2 MB at that shape) from the 50 MB L2 every step: its
// time is T launches, far above the bound. A persistent kernel with w3g
// resident in shared memory across SMs is later work.
//
// Forward, per step: a block owns UNITS hidden units of one out-block j
// (all four gate rows of each) and BT batch rows; it stages the R*bs
// gathered columns of q(h_{t-1}) for its rows in shared memory, each warp
// forms the dots of one w3g row with every staged row, the epilogue
// writes h_t, c_t (and the stash). qbits > 0: the scale of q() is
// max|h_{t-1}| over the whole (B, H) step, an atomicMax on the float bits
// in the previous step's epilogue (slot t), as in fused_lstm_fwd.cu.
//
// Backward, per step (reverse): a block owns UNITS units of one block
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

namespace {

constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FWD_UNITS = 4;        // hidden units per forward block
constexpr int BWD_UNITS = 8;        // hidden units per backward block

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
    const float f = sigmoid(g[u] + usm[b][jj]);
    const float i = sigmoid(g[H + u] + usm[b][UNITS + jj]);
    const float o = sigmoid(g[2 * H + u] + usm[b][2 * UNITS + jj]);
    const float cc = act_fn(g[3 * H + u] + usm[b][3 * UNITS + jj], act);
    const float cp = c_prev ? c_prev[bb * H + u] : 0.f;
    const float c = i * cc * drop[bb * H + u] + f * cp;
    const float h = o * act_fn(c, act);
    h_out[bb * H + u] = h;
    c_out[bb * H + u] = c;
    if (a_out) {
      float* a = a_out + bb * 4 * H;
      a[u] = f;
      a[H + u] = i;
      a[2 * H + u] = o;
      a[3 * H + u] = cc;
    }
    m = max(m, __float_as_uint(fabsf(h)));
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
  __shared__ int ent_j[64], ent_k[64];
  const int G = 4 * H, GB = 4 * bs, K3 = R * bs, W = C * GB;
  const int u0 = blockIdx.x * UNITS;
  const int blk = u0 / bs;            // column block (carry), out-block (u)
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float* dgsm = smem;
  float* hsm = smem + BT * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the kept blocks of column blk: the valid entries come first
  int nv = 0;
  if (dg_next) {
    for (int e = 0; e < C; ++e) {
      const int p = t_perm[blk * C + e];
      if (p == nnz) break;
      if (threadIdx.x == 0) {
        ent_j[e] = t_row_idx[blk * C + e];
        ent_k[e] = p - t_row_idx[blk * C + e] * R;
      }
      ++nv;
    }
  }
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
    float gf, gi, go, gc, ac, dact_c, dact_gc;
    if (STASH) {
      gf = a[u];
      gi = a[H + u];
      go = a[2 * H + u];
      gc = a[3 * H + u];
      ac = act_fn(c_t[ih], act);
      dact_c = dact_out(ac, act);
      dact_gc = dact_out(gc, act);
    } else {
      gf = sigmoid(a[u] + usm[b][jj]);
      gi = sigmoid(a[H + u] + usm[b][UNITS + jj]);
      go = sigmoid(a[2 * H + u] + usm[b][2 * UNITS + jj]);
      const float gc_pre = a[3 * H + u] + usm[b][3 * UNITS + jj];
      gc = act_fn(gc_pre, act);
      const float c = gi * gc * dr + gf * cp;
      ac = act_fn(c, act);
      dact_c = dact_pre(c, act);
      dact_gc = dact_pre(gc_pre, act);
    }
    const float dcv = dc[ih] + dh * go * dact_c;
    float* d = dg_out + bb * G;
    d[u] = dcv * cp * gf * (1.f - gf);
    d[H + u] = dcv * gc * dr * gi * (1.f - gi);
    d[2 * H + u] = dh * ac * go * (1.f - go);
    d[3 * H + u] = dcv * gi * dr * dact_gc;
    dc[ih] = dcv * gf;
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

}  // extern "C"
