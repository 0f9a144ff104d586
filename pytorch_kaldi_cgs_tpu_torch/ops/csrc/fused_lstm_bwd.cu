// Fused LSTM BPTT for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:
//   _build_bwd_stash (stash=1): reverse recurrence over the post-activation
//     gates a_t = (f, i, o, act(c~)) that the stash forward wrote;
//   _build_bwd (stash=0): the same, rebuilding the gates per step from
//     u = q(h_{t-1}) @ U^T (the recompute backward).
// Both in their with_init variant too: (dhT, dcT) seed the reverse carry
// and (dh0, dc0) come out. Per step t, from the top (gate order f, i, o, c):
//
//   dh   = dh_carry + dhs[t]          dh_carry = dg_{t+1} @ U (dhT at T-1)
//   dc   = dc_carry + dh * o * act'(c_t)
//   dg_o = dh * act(c_t) * o (1 - o)
//   dg_f = dc * c_{t-1} * f (1 - f)
//   dg_i = dc * act(c~) * drop * i (1 - i)
//   dg_c = dc * i * drop * act'(c~)
//   dc_carry = dc * f
//
// act' comes from the activation's output (stash) or its input
// (recompute), as the TPU kernels take it. dU is not formed here: the
// caller computes it as one (4H, T*B) @ (T*B, H) product.
//
// What bounds it on this card: at the training shape (T=300, B=16,
// H=512) the stash backward does one (B, 4H) x (4H, H) product per step,
// 10.1 GFLOP of float32 FMAs (0.150 ms at 67 TFLOP/s), and moves ~112 MB
// (0.034 ms at 3.35 TB/s); recompute adds the forward's product (20.1
// GFLOP, 0.300 ms). So operations bound both. But step t needs all of
// dg_{t+1}, written by every block of the previous step, and on Hopper
// blocks run in no order. The stash backward takes one of two routes,
// picked by the caller before the launch from the shapes and the
// occupancy query (fused_lstm.lstm_bwd_stash_route):
//
//   - "persist" (TPU row 3's redesign): ONE cooperative launch runs the
//     whole reverse chain (lstm_bwd_stash_persist, persist.cuh). A block
//     owns UN (4 or 8) units and BT (8 or 16) batch rows for all steps,
//     its units' 4H-long columns of U resident in shared memory (128 KB
//     at H=1024, 8 units), keeps dc of its (row, unit) in a register, and
//     per reverse step stages dg_{t+1} of its rows from dg itself (a row
//     of 4H floats is 16-byte aligned), in slabs of the contraction, two
//     in flight, where its rows do not fit beside the weights
//     (persist::slab_dots: 6 slabs of 704 at B=16, H=1024), forms its
//     units' dh_carry, runs the stash chain below, writes dg_t and waits
//     at ONE grid barrier: dg_t and dg_{t+1} are distinct slots, so no
//     double buffer is needed. A seeded call forms dh0 = dg_0 @ U behind
//     one more barrier. Its sums run in another order than the step
//     route's (the warps split the contraction).
//   - "step" (a shape whose blocks do not fit or are not co-resident, and
//     the recompute backward at every shape): one kernel per step from
//     the host loop below (the launch boundary is the grid-wide barrier),
//     re-reading U from the L2 each step; its time is ~T launches of a
//     few microseconds, far above the bound.
//
// Per step on the step route, a block owns UNITS hidden units and BT
// batch rows:
//   * it stages dg_{t+1} for its rows in shared memory (BT x 4H floats,
//     64 KB at H=512), rounded to bf16 under bf16; each warp forms the
//     dot of one row of U^T (passed in transposed, (H, 4H), so the
//     lanes read consecutive addresses) with every staged row: dh_carry;
//   * recompute also stages q(h_{t-1}) (BT x H) and forms the forward's
//     row dots u for the 4 x UNITS rows of U its units own;
//   * the epilogue runs the chain above for its (b, j), writes dg_t and
//     keeps dc_carry in place (each block owns its units' dc).
// A final dot-only launch forms dh0 = dg_0 @ U when it is asked for.
//
// qbits > 0 (recompute only; the stash kernel has no quantizer, the
// recurrent-input quantizer being a straight-through identity for dh):
// q() scales by max|h_{t-1}| over the whole (B, H) block. Those T scales
// are known before the loop (h_prev is an input), so one reduction
// kernel writes them all first, with an atomicMax on the float bits.
// bf16: U (and U^T) are bf16; dg is rounded to bf16 before the dg @ U
// dot and q(h) before the recompute dot; products, sums, carries and
// the gate math are float32 (the TPU kernel's preferred_element_type).

#include <algorithm>
#include <cmath>

#include "lstm_common.cuh"
#include "persist.cuh"

namespace {

constexpr int UNITS = 8;            // hidden units per block
constexpr int ROWS = 4 * UNITS;     // U rows per block (recompute)
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// Stage nb rows of dg (B, 4H) from row b0 into dgsm (rounded under bf16).
template <bool BF16>
__device__ __forceinline__ void stage_dg(const float* __restrict__ dg, int b0,
                                         int nb, int G, float* dgsm) {
  const int n4 = nb * G / 4;               // G = 4H: rows are float4-aligned
  const float4* src = reinterpret_cast<const float4*>(dg + (size_t)b0 * G);
  float4* dst = reinterpret_cast<float4*>(dgsm);
  for (int e = threadIdx.x; e < n4; e += THREADS) {
    float4 v = src[e];
    if (BF16) {
      v.x = round_bf16(v.x); v.y = round_bf16(v.y);
      v.z = round_bf16(v.z); v.w = round_bf16(v.w);
    }
    dst[e] = v;
  }
}

// dhsm[b][jj] = sum_r dgsm[b][r] * Ut[u0 + jj][r]: one warp per unit.
template <bool BF16>
__device__ __forceinline__ void carry_dots(const void* __restrict__ Ut,
                                           const float* dgsm, int u0, int nb,
                                           int H, float (*dhsm)[UNITS]) {
  const int G = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int jj = warp; jj < UNITS; jj += WARPS) {
    const int j = u0 + jj;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (j < H) {
      const size_t row = (size_t)j * G;
#pragma unroll 4
      for (int k = lane; k < G; k += 32) {
        const float u = load_w<BF16>(Ut, row + k);
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(dgsm[b * G + k], u, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) dhsm[b][jj] = v;
    }
  }
}

template <bool BF16, bool STASH>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_step(const float* __restrict__ a_t,     // STASH: acts (B, 4H) of t
                                                 // else the gates g_t
              const void* __restrict__ U,        // (4H, H), recompute dots
              const void* __restrict__ Ut,       // (H, 4H), carry dots
              const float* __restrict__ drop,    // (B, H)
              const float* __restrict__ h_prev,  // recompute: (B, H) h_{t-1}
              const float* __restrict__ c_t,     // STASH: (B, H) c_t
              const float* __restrict__ c_prev,  // (B, H) c_{t-1}
              const float* __restrict__ dh_in,   // (B, H) dhs[t]
              const float* __restrict__ dg_next, // (B, 4H) dg_{t+1} or nullptr
              const float* __restrict__ dh_seed, // (B, H) dhT or nullptr
              float* __restrict__ dc,            // (B, H) carry, in place
              float* __restrict__ dg_out,        // (B, 4H) dg_t
              const unsigned* __restrict__ scale_in,  // max|h_{t-1}| bits
              int B, int H, int act, float qscale) {
  extern __shared__ float smem[];   // dg_{t+1} rows (BT x 4H), q(h) (BT x H)
  __shared__ float dhsm[BT][UNITS];
  __shared__ float usm[BT][ROWS];
  const int G = 4 * H;
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  float* dgsm = smem;
  float* hsm = smem + BT * G;

  if (dg_next) stage_dg<BF16>(dg_next, b0, nb, G, dgsm);
  if (!STASH) {
    const float var = scale_in ? __uint_as_float(*scale_in) : 0.f;
    for (int e = threadIdx.x; e < nb * H; e += THREADS) {
      float x = h_prev[(size_t)b0 * H + e];
      if (scale_in) x = quant(x, var, qscale);
      hsm[e] = BF16 ? round_bf16(x) : x;
    }
  }
  __syncthreads();

  if (dg_next) carry_dots<BF16>(Ut, dgsm, u0, nb, H, dhsm);
  if (!STASH) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < ROWS; r += WARPS) {
      const int j = u0 + r % UNITS;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      if (j < H) {
        const size_t row = (size_t)((r / UNITS) * H + j) * H;
#pragma unroll 4
        for (int k = lane; k < H; k += 32) {
          const float u = load_w<BF16>(U, row + k);
#pragma unroll
          for (int b = 0; b < BT; ++b)
            if (b < nb) acc[b] = fmaf(hsm[b * H + k], u, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        float v = acc[b];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) usm[b][r] = v;
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t bb = (size_t)(b0 + b), ih = bb * H + j;
    const float* a = a_t + bb * G;
    const float dh = (dg_next ? dhsm[b][jj] : (dh_seed ? dh_seed[ih] : 0.f))
                     + dh_in[ih];
    const float cp = c_prev ? c_prev[ih] : 0.f;
    const float dr = drop[ih];
    float gf, gi, go, gc, ac, dact_c, dact_gc;
    if (STASH) {
      gf = a[j];
      gi = a[H + j];
      go = a[2 * H + j];
      gc = a[3 * H + j];
      ac = act_fn(c_t[ih], act);
      dact_c = dact_out(ac, act);
      dact_gc = dact_out(gc, act);
    } else {
      gf = sigmoid(a[j] + usm[b][jj]);
      gi = sigmoid(a[H + j] + usm[b][UNITS + jj]);
      go = sigmoid(a[2 * H + j] + usm[b][2 * UNITS + jj]);
      const float gc_pre = a[3 * H + j] + usm[b][3 * UNITS + jj];
      gc = act_fn(gc_pre, act);
      const float c = gi * gc * dr + gf * cp;
      ac = act_fn(c, act);
      dact_c = dact_pre(c, act);
      dact_gc = dact_pre(gc_pre, act);
    }
    const float dcv = dc[ih] + dh * go * dact_c;
    float* d = dg_out + bb * G;
    d[j] = dcv * cp * gf * (1.f - gf);
    d[H + j] = dcv * gc * dr * gi * (1.f - gi);
    d[2 * H + j] = dh * ac * go * (1.f - go);
    d[3 * H + j] = dcv * gi * dr * dact_gc;
    dc[ih] = dcv * gf;
  }
}

// dh0 = dg_0 @ U for the seeded backward.
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_dh0(const float* __restrict__ dg0, const void* __restrict__ Ut,
             float* __restrict__ dh0, int B, int H) {
  extern __shared__ float smem[];
  __shared__ float dhsm[BT][UNITS];
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  stage_dg<BF16>(dg0, b0, nb, 4 * H, smem);
  __syncthreads();
  carry_dots<BF16>(Ut, smem, u0, nb, H, dhsm);
  __syncthreads();
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j < H) dh0[(size_t)(b0 + b) * H + j] = dhsm[b][jj];
  }
}

template <bool BF16, bool STASH>
cudaError_t run(const float* a, const void* U, const void* Ut,
                const float* drop, const float* h_prev, const float* cs,
                const float* c_prev, const float* dhs, const float* dhT,
                float* dc, float* dg, float* dh0, unsigned* qslots, int T,
                int B, int H, int act, int qbits, cudaStream_t stream) {
  auto kern = lstm_bwd_step<BF16, STASH>;
  const int G = 4 * H;
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
    const int nblk = (int)std::min<size_t>((bh + 255) / 256, 16);
    absmax_steps<<<dim3(nblk, T), 256, 0, stream>>>(h_prev, (int)bh, qslots);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + UNITS - 1) / UNITS, (B + BT - 1) / BT);
  for (int t = T - 1; t >= 0; --t) {
    kern<<<grid, THREADS, smem, stream>>>(
        a + (size_t)t * G * B, U, Ut, drop,
        STASH ? nullptr : h_prev + t * bh, STASH ? cs + t * bh : nullptr,
        c_prev + t * bh, dhs + t * bh,
        t + 1 < T ? dg + (size_t)(t + 1) * G * B : nullptr, dhT, dc,
        dg + (size_t)t * G * B, q ? qslots + t : nullptr, B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dh0) {
    auto dot = lstm_bwd_dh0<BF16>;
    const size_t smem0 = (size_t)BT * G * sizeof(float);
    err = cudaFuncSetAttribute(
        dot, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem0);
    if (err != cudaSuccess) return err;
    dot<<<grid, THREADS, smem0, stream>>>(dg, Ut, dh0, B, H);
    err = cudaGetLastError();
  }
  return err;
}

// The stash backward's reverse chain in one cooperative launch (route
// "persist", TPU row 3's redesign; persist.cuh). Block c owns the UN units
// from u0 = (c % ug) * UN (ug = ceil(H / UN)) and the BT = 8 * BI batch
// rows from b0 = (c / ug) * BT. It copies its units' columns of U into
// shared memory once (ws: 4H rows of UN, w_stride(UN) apart; a bf16 U
// converted exactly). Its thread o = b * UN + jj keeps dc of its (row,
// unit) in a register across the steps (dcT on entry, dc0 written back at
// the end) and loads the next step's stash, c_t, c_{t-1} and dhs before
// the grid barrier. Per reverse step it stages dg_{t+1} of its rows from
// dg in slabs of KS values (KS >= 4H: at once), rounded to bf16 under
// BF16 as stage_dg rounds them, forms dh_carry = dg_{t+1} @ U for its
// units (dhT, or 0, at T-1), runs lstm_bwd_step's stash arithmetic,
// writes dg_t and waits at the barrier (none after step 0). With dh0 it
// forms dh0 = dg_0 @ U the same way behind one more barrier.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
lstm_bwd_stash_persist(const float* __restrict__ a,       // (T, B, 4H)
                       const void* __restrict__ Uv,       // (4H, H)
                       const float* __restrict__ drop,    // (B, H)
                       const float* __restrict__ cs,      // (T, B, H)
                       const float* __restrict__ c_prev,  // (T, B, H)
                       const float* __restrict__ dhs,     // (T, B, H)
                       const float* __restrict__ dhT,     // (B, H) or null
                       float* __restrict__ dc,            // (B, H) in place
                       float* dg,                         // (T, B, 4H)
                       float* __restrict__ dh0,           // (B, H) or null
                       int T, int B, int H, int act, int KS) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, WS = P::w_stride(UN);
  extern __shared__ __align__(16) float psm[];
  const int K = 4 * H, SK = P::row_stride(KS);
  float* ws = psm;                                 // (K, WS) U's columns
  float* xs = ws + (size_t)K * WS;                 // 1 or 2 x (BT, SK)
  float* red = xs + (size_t)(KS < K ? 2 : 1) * BT * SK;
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int e = threadIdx.x; e < K * UN; e += P::THREADS) {
    const int k = e / UN, j = e - k * UN;
    ws[k * WS + j] = u0 + j < H ? load_w<BF16>(Uv, (size_t)k * H + u0 + j)
                                : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, ou = u0 + o % UN;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, bk = (size_t)B * K;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * K;
  const float dr = mine ? drop[ih] : 0.f;
  // this block's rows of the (B, 4H) cotangents of step t, rounded to
  // bf16 under BF16 as they are staged: -> each unit's sum (unit_sum)
  auto carry_dots = [&](int t) {
    const float* src = dg + t * bk + (size_t)b0 * K;
    P::slab_dots<BI, UN>([&](int r) { return src + (size_t)r * K; }, nb, K,
                         K, KS, xs, SK, ws, red, P::bf16_or_ident<BF16>());
    return o < BT * UN ? P::unit_sum<BI, UN>(red, o) : 0.f;
  };
  // step t's inputs of this thread's (row, unit)
  struct In {
    float f, i, o, c, ct, cp, dh;
  };
  auto fetch = [&](int t) {
    In v{};
    if (mine) {
      const float* at = a + t * bk + ig;
      v.f = at[ou];
      v.i = at[H + ou];
      v.o = at[2 * H + ou];
      v.c = at[3 * H + ou];
      v.ct = cs[t * bh + ih];
      v.cp = c_prev[t * bh + ih];
      v.dh = dhs[t * bh + ih];
    }
    return v;
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  float dcr = mine ? dc[ih] : 0.f;                 // dc carry of step t+1
  In cur = fetch(T - 1);
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const float dot = t + 1 < T ? carry_dots(t + 1) : 0.f;
    if (mine) {
      // lstm_bwd_step's stash arithmetic
      const float dh = (t + 1 < T ? dot : (dhT ? dhT[ih] : 0.f)) + cur.dh;
      const float ac = act_fn(cur.ct, act);
      const float dact_c = dact_out(ac, act), dact_gc = dact_out(cur.c, act);
      const float dcv = dcr + dh * cur.o * dact_c;
      float* d = dg + t * bk + ig;
      d[ou] = dcv * cur.cp * cur.f * (1.f - cur.f);
      d[H + ou] = dcv * cur.c * dr * cur.i * (1.f - cur.i);
      d[2 * H + ou] = dh * ac * cur.o * (1.f - cur.o);
      d[3 * H + ou] = dcv * cur.i * dr * dact_gc;
      dcr = dcv * cur.f;
    }
    if (t > 0) {
      cur = fetch(t - 1);
      grid.sync();
    }
  }
  if (mine) dc[ih] = dcr;
  if (dh0) {
    grid.sync();
    const float dot = carry_dots(0);
    if (mine) dh0[ih] = dot;
  }
}

// one cooperative launch of the chain at block shape (BI, UN)
template <bool BF16, int BI, int UN>
cudaError_t launch_chain(int grid, int smem, cudaStream_t stream,
                         const float* a, const void* U, const float* drop,
                         const float* cs, const float* c_prev,
                         const float* dhs, const float* dhT, float* dc,
                         float* dg, float* dh0, int T, int B, int H, int act,
                         int KS) {
  return persist::launch<lstm_bwd_stash_persist<BF16, BI, UN>>(
      grid, smem, stream, a, U, drop, cs, c_prev, dhs, dhT, dc, dg, dh0, T,
      B, H, act, KS);
}

// The block shapes (bi, units) of the persistent chain
// (fused_lstm.LSTM_BWD_SHAPES): 4 or 8 units and 8 or 16 rows. -> the
// launcher and the occupancy query of one, or nulls for another shape.
using ChainLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                    const void*, const float*, const float*,
                                    const float*, const float*, const float*,
                                    float*, float*, float*, int, int, int,
                                    int, int);
using ChainOccupancy = cudaError_t (*)(int, int*);

template <bool BF16>
void chain_shape(int bi, int units, ChainLaunch* launch,
                 ChainOccupancy* occ) {
#define PK_BWD_SHAPE(BI_, UN_)                                            \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_chain<BF16, BI_, UN_>;                               \
    *occ = persist::occupancy<lstm_bwd_stash_persist<BF16, BI_, UN_>>;    \
    return;                                                               \
  }
  PK_BWD_SHAPE(1, 4)
  PK_BWD_SHAPE(1, 8)
  PK_BWD_SHAPE(2, 4)
  PK_BWD_SHAPE(2, 8)
#undef PK_BWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void chain_shape_of(int u_bf16, int bi, int units, ChainLaunch* launch,
                    ChainOccupancy* occ) {
  if (u_bf16)
    chain_shape<true>(bi, units, launch, occ);
  else
    chain_shape<false>(bi, units, launch, occ);
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the whole backward on `stream` on the step route: T step
// kernels in reverse
// time, plus one dot kernel when dh0 is asked for (and, for the
// recompute backward with qbits > 0, one reduction for the T quantizer
// scales first). Returns the first cudaError_t seen, 0 on success.
//   a:      (T, B, 4H) stashed activations (stash=1) or gates (stash=0)
//   U, Ut:  (4H, H) and its transpose (H, 4H), float32 or bf16 (u_bf16)
//   h_prev: (T, B, H) carries entering each step (stash=0 only)
//   cs:     (T, B, H) cell states (stash=1 only)
//   c_prev: (T, B, H) cell states entering each step
//   dhs:    (T, B, H) upstream gradient of hs
//   dhT:    (B, H) seed of dh, or null for zeros
//   dc:     (B, H) holds the dc seed (dcT or zeros) on entry, dc0 on exit
//   dg:     (T, B, 4H) output;  dh0: (B, H) output or null
//   qslots: T unsigned ints of scratch when stash=0 and qbits > 0
int fused_lstm_bwd(const float* a, const void* U, const void* Ut,
                   const float* drop, const float* h_prev, const float* cs,
                   const float* c_prev, const float* dhs, const float* dhT,
                   float* dc, float* dg, float* dh0, unsigned* qslots, int T,
                   int B, int H, int act, int qbits, int stash, int u_bf16,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto fn = stash ? (u_bf16 ? run<true, true> : run<false, true>)
                  : (u_bf16 ? run<true, false> : run<false, false>);
  return fn(a, U, Ut, drop, h_prev, cs, c_prev, dhs, dhT, dc, dg, dh0,
            qslots, T, B, H, act, qbits, stream);
}

// The stash backward on the persistent route on `stream`: one cooperative
// launch of `grid` blocks of lstm_bwd_stash_persist (bi: BT = 8 * bi rows
// a block; units: 4 or 8; slab: the contraction values staged at once;
// smem bytes of dynamic shared memory: fused_lstm.lstm_bwd_stash_plan
// sizes all four). Returns its cudaError_t; cudaErrorInvalidValue for a
// shape not instantiated. The arguments as fused_lstm_bwd's with stash=1
// (no U^T: the block keeps its columns of U).
int lstm_bwd_stash_persist_run(const float* a, const void* U,
                               const float* drop, const float* cs,
                               const float* c_prev, const float* dhs,
                               const float* dhT, float* dc, float* dg,
                               float* dh0, int T, int B, int H, int act,
                               int u_bf16, int grid, int bi, int units,
                               int slab, int smem, void* stream_ptr) {
  ChainLaunch fn;
  ChainOccupancy occ;
  chain_shape_of(u_bf16, bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), a, U, drop,
            cs, c_prev, dhs, dhT, dc, dg, dh0, T, B, H, act, slab);
}

// out[0..2]: the chain's co-resident blocks per SM at `smem` bytes of
// dynamic shared memory (u_bf16, bi and units as above), the SM count,
// and whether the device takes cooperative launches.
int lstm_bwd_stash_occupancy(int u_bf16, int bi, int units, int smem,
                             int* out) {
  ChainLaunch fn;
  ChainOccupancy occ;
  chain_shape_of(u_bf16, bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
