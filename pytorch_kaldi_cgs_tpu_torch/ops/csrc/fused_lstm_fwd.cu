// Fused LSTM forward recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:_build_fwd
// in all its variants: with_init, cdt="bf16", qbits and stash (the
// training forward, which also writes the post-activation gates
// (f, i, o, act(c~)) of every step for the BPTT kernel in
// fused_lstm_bwd.cu). Per step t, gate order (f, i, o, c):
//
//   u = q(h_{t-1}) @ U^T                 U: (4H, H), f32 or bf16
//   f, i, o = sigmoid(g_t + u)
//   c_t = i * act(g_c + u_c) * drop + f * c_{t-1}
//   h_t = o * act(c_t)
//
// What bounds it on this card: at the serving shape (T=398, B=8, H=512)
// one layer does 6.68 GFLOP of float32 FMAs (bound 0.1 ms at 67 TFLOP/s)
// and moves 43 MB (13 us at 3.35 TB/s), so operations bound it; but the
// T steps depend on each other, and on the TPU the grid ran in order
// with U resident in VMEM. Here blocks run in parallel with no order.
// The only grid-wide dependency of a step is h_{t-1} (c_t is a unit's
// own), so the forward takes one of two routes, picked by the caller
// before the launch from the shapes and the occupancy query
// (fused_lstm.lstm_fwd_route):
//
//   - "persist" (TPU row 1's redesign): ONE cooperative launch runs all T
//     steps, seeded or not (lstm_fwd_persist, persist.cuh). A block owns
//     UN (4 or 8) units and BT (8 or 16) batch rows for the whole call,
//     its units' 4 x UN rows of U resident in shared memory (as float32,
//     a bf16 U converted exactly), keeps c of its (row, unit) in a
//     register and waits at ONE grid barrier a step; h_t and the block
//     maxima of |h_t| go through two buffers picked by the step's parity.
//     Its dots sum in lstm_step's order (persist::resident_dots; at 8
//     units persist::lane_dots, the same sums over rows in a lane-major
//     layout read 16 bytes at a time) over q(h_{t-1}) staged by
//     persist::stage_quant (quant()'s bits, then bf16 under bf16), so both
//     routes give the same bits.
//   - "step" (a shape whose blocks do not fit or are not co-resident):
//     one launch of lstm_step per step from the host loop below (the
//     launch boundary is the grid-wide barrier between steps), each
//     re-reading U from the 50 MB L2. Its time is launch latency x T.
//
// Per step on the step route, a block owns UNITS hidden units (all four
// gate rows of each, so the gate math stays local) and BT batch rows: it
// stages q(h_{t-1}) for its rows in shared memory, each warp forms the
// dot products of one U row with every staged h row (f32 accumulation,
// lanes over k, then a shuffle reduction), and the epilogue writes h_t
// and c_t.
//
// qbits > 0: q() is the per-step activation quantizer whose scale is
// max|h_{t-1}| over the whole (B, H) block of that step. Step route:
// step t's epilogue atomicMax-es |h_t| (the float bit pattern orders like
// the value for non-negative floats) into slot t+1, zeroed beforehand by
// cudaMemsetAsync; step t+1 reads it; slot 0 holds max|h0|. Persistent
// route: each block writes its own max, and the blocks of the next step
// take the max of those; a seed's comes in before one extra barrier.
// bf16: U is bf16, q(h) is rounded to bf16 before the dot; products and
// sums are float32, as are the gate math and the carries.

#include <cmath>

#include "lstm_common.cuh"
#include "persist.cuh"

namespace {

constexpr int UNITS = 4;            // hidden units per block
constexpr int ROWS = 4 * UNITS;     // U rows per block (4 gates)
constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
lstm_step(const float* __restrict__ g_t,       // (B, 4H) gates of step t
          const void* __restrict__ Uv,         // (4H, H)
          const float* __restrict__ drop,      // (B, H)
          const float* __restrict__ h_prev,    // (B, H); nullptr = zeros
          const float* __restrict__ c_prev,    // (B, H); nullptr = zeros
          float* __restrict__ h_out,           // (B, H) of step t
          float* __restrict__ c_out,
          float* __restrict__ a_out,           // (B, 4H) stash or nullptr
          const unsigned* __restrict__ scale_in,  // max|h_prev| bits or nullptr
          unsigned* __restrict__ scale_out,       // max|h_t| slot or nullptr
          int B, int H, int act, float qscale) {
  extern __shared__ float hsm[];               // (BT, H) staged q(h_prev)
  __shared__ float usm[BT][ROWS];              // recurrent pre-activations
  const int u0 = blockIdx.x * UNITS;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const float var = scale_in ? __uint_as_float(*scale_in) : 0.f;

  for (int e = threadIdx.x; e < nb * H; e += THREADS) {
    const int b = e / H, k = e - b * H;
    float x = h_prev ? h_prev[(size_t)(b0 + b) * H + k] : 0.f;
    if (scale_in) x = quant(x, var, qscale);
    if (BF16) x = __bfloat162float(__float2bfloat16_rn(x));
    hsm[b * H + k] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += WARPS) {
    const int j = u0 + r % UNITS;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (j < H) {
      const size_t row = (size_t)((r / UNITS) * H + j) * H;
      for (int k = lane; k < H; k += 32) {
        const float u = BF16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(Uv)[row + k])
            : static_cast<const float*>(Uv)[row + k];
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(hsm[b * H + k], u, acc[b]);
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
  __syncthreads();

  unsigned m = 0;  // max |h_t| bits seen by this thread
  for (int e = threadIdx.x; e < nb * UNITS; e += THREADS) {
    const int b = e / UNITS, jj = e - b * UNITS, j = u0 + jj;
    if (j >= H) continue;
    const size_t bb = (size_t)(b0 + b);
    const float* g = g_t + bb * 4 * H;
    const float f = sigmoid(g[j] + usm[b][jj]);
    const float i = sigmoid(g[H + j] + usm[b][UNITS + jj]);
    const float o = sigmoid(g[2 * H + j] + usm[b][2 * UNITS + jj]);
    const float cc = act_fn(g[3 * H + j] + usm[b][3 * UNITS + jj], act);
    const float cp = c_prev ? c_prev[bb * H + j] : 0.f;
    const float c = i * cc * drop[bb * H + j] + f * cp;
    const float h = o * act_fn(c, act);
    h_out[bb * H + j] = h;
    c_out[bb * H + j] = c;
    if (a_out) {
      float* a = a_out + bb * 4 * H;
      a[j] = f;
      a[H + j] = i;
      a[2 * H + j] = o;
      a[3 * H + j] = cc;
    }
    m = max(m, __float_as_uint(fabsf(h)));
  }
  if (scale_out) {
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0 && m) atomicMax(scale_out, m);
  }
}

// The forward's whole recurrence in one cooperative launch (route
// "persist", TPU row 1's redesign; persist.cuh). Block c owns the UN units
// from u0 = (c % ug) * UN (ug = ceil(H / UN); units past H get zero
// weights and no output) and the BT = 8 * BI batch rows from b0 = (c /
// ug) * BT. It copies into shared memory once its units' rows of U, the
// f gate's UN rows, then i's, o's and the candidate's, H floats each
// (ws): H floats each at 4 units (two blocks an SM), whose dots
// persist::resident_dots forms; at 8 units (one block an SM) in the
// lane-major layout of persist::lane_dots, rows of L = 32 x
// lane_stride(H) floats, zeros past H, whose 16-byte loads took the
// forward at 16 rows of 1024 from 4.87 to 4.14 ms a call (and 4-unit
// blocks from 2.22 to 3.13 at 8 rows: so only at 8 units; chip_smoke.py's
// lstm_turn_times, NVIDIA H100 80GB HBM3 at 700 W). Its thread o = b * UN + jj
// keeps c_{t-1} of its (row, unit) in a register and loads the next
// step's gates before the barrier. Per step: stage h_{t-1} from the
// exchange buffer of step t-1's parity, q() at the max over that parity's
// block maxima (then bf16 under BF16), the dots against ws, lstm_step's
// gate math, h_t and c_t into hs and cs, h_t into the buffer of step t's
// parity, the stash, the block's max|h_t| into its entry of that parity's
// maxima; barrier (none after the last step). With a seed h0 each thread
// first copies its entry into buffer 1 (step -1's) and its block's
// max|h0| into maxima row 1, then one barrier; without one, step 0's
// carry is zero: no staging and no dots. The exchange buffers hold h in
// the layout of ws, rows of HP = H rounded up to 4 floats (4 units) or L
// (8 units), 16-byte aligned (a row of hs at H=550 is not), zeroed by the
// caller: the padding stays 0 (q(0) = 0) and adds nothing to a dot.
template <bool BF16, int BI, int UN>
__global__ void __launch_bounds__(persist::THREADS, UN == 4 ? 2 : 1)
lstm_fwd_persist(const float* __restrict__ gates,  // (T, B, 4H)
                 const void* __restrict__ Uv,       // (4H, H)
                 const float* __restrict__ drop,    // (B, H)
                 const float* __restrict__ h0,      // (B, H) or null
                 const float* __restrict__ c0,      // (B, H) or null
                 float* __restrict__ hs,            // (T, B, H) output
                 float* __restrict__ cs,            // (T, B, H) output
                 float* __restrict__ acts,          // (T, B, 4H) or null
                 float* xh,                         // (2, B, row) exchange
                 unsigned* bmax,                    // (2, grid), or null
                 int T, int B, int H, int act, float qscale) {
  namespace P = persist;
  constexpr int BT = P::BLANES * BI, NR = 4 * UN;
  constexpr bool LANE = UN == 8;                   // the lane-major layout
  extern __shared__ __align__(16) float psm[];
  __shared__ unsigned wmax[P::WARPS], gmax;
  const int SJ = P::lane_stride(H);
  const int WL = LANE ? 32 * SJ : H;               // floats a row of ws
  const int HP = LANE ? WL : (H + 3) / 4 * 4;      // an exchange row
  const int SK = LANE ? WL : P::row_stride(H);     // a staged row
  float* ws = psm;                                 // (NR, WL)
  float* xsm = ws + (size_t)NR * WL;               // (BT, SK)
  auto usm = reinterpret_cast<float (*)[NR]>(xsm + (size_t)BT * SK);
  const int ug = (H + UN - 1) / UN;
  const int u0 = (blockIdx.x % ug) * UN, b0 = (blockIdx.x / ug) * BT;
  const int nb = min(BT, B - b0);
  for (int i = threadIdx.x; i < NR * WL; i += P::THREADS) {
    const int r = i / WL, e = i - r * WL, u = u0 + r % UN;
    const int k = LANE ? e / SJ + 32 * (e % SJ) : e;  // lane e / SJ's value
    ws[i] = u < H && k < H
                ? load_w<BF16>(Uv, ((size_t)(r / UN) * H + u) * H + k)
                : 0.f;
  }
  const int o = threadIdx.x, ob = o / UN, oj = o % UN, ou = u0 + oj;
  const bool mine = o < BT * UN && ob < nb && ou < H;
  const size_t bh = (size_t)B * H, gbh = 4 * bh, xstep = (size_t)B * HP;
  const size_t ih = (size_t)(b0 + ob) * H + ou, ig = (size_t)(b0 + ob) * 4 * H;
  const size_t ix = (size_t)(b0 + ob) * HP + (LANE ? (ou % 32) * SJ + ou / 32
                                                   : ou);
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
  const bool seeded = h0 != nullptr;
  if (seeded) {
    unsigned m = 0;
    if (mine) {
      const float hp = h0[ih];
      cp = c0[ih];
      xh[xstep + ix] = hp;
      m = __float_as_uint(fabsf(hp));
    }
    if (bmax) P::block_max(m, bmax + gridDim.x, wmax);
    grid.sync();
  }
  In cur = fetch(0);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int prev = (t + 1) & 1, now = t & 1;      // parities of t-1, t
    float uf = 0.f, ui = 0.f, uo = 0.f, uc = 0.f;
    if (t > 0 || seeded) {
      P::stage_quant<BF16>(xh + prev * xstep, HP, b0, nb, xsm, SK,
                           bmax ? bmax + prev * gridDim.x : nullptr,
                           gridDim.x, &gmax, qscale, iscale);
      if constexpr (LANE)
        P::lane_dots<BT, NR, NR>(ws, xsm, SK, H, nb, usm);
      else
        P::resident_dots<BT, NR, NR>(ws, xsm, SK, H, nb, usm);
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
      // lstm_step's arithmetic
      const float f = sigmoid(cur.f + uf);
      const float i = sigmoid(cur.i + ui);
      const float og = sigmoid(cur.o + uo);
      const float cc = act_fn(cur.c + uc, act);
      const float c = i * cc * dr + f * cp;
      const float h = og * act_fn(c, act);
      hs[t * bh + ih] = h;
      cs[t * bh + ih] = c;
      xh[now * xstep + ix] = h;
      if (acts) {
        float* a = acts + t * gbh + ig;
        a[ou] = f;
        a[H + ou] = i;
        a[2 * H + ou] = og;
        a[3 * H + ou] = cc;
      }
      cp = c;
      m = __float_as_uint(fabsf(h));
    }
    if (t + 1 < T) {
      if (bmax) P::block_max(m, bmax + now * gridDim.x, wmax);
      cur = fetch(t + 1);
      grid.sync();
    }
  }
}

// one cooperative launch of the persistent forward at block shape (BI, UN)
template <bool BF16, int BI, int UN>
cudaError_t launch_fwd_persist(int grid, int smem, cudaStream_t stream,
                               const float* gates, const void* U,
                               const float* drop, const float* h0,
                               const float* c0, float* hs, float* cs,
                               float* acts, float* xh, unsigned* bmax, int T,
                               int B, int H, int act, float qscale) {
  return persist::launch<lstm_fwd_persist<BF16, BI, UN>>(
      grid, smem, stream, gates, U, drop, h0, c0, hs, cs, acts, xh, bmax, T,
      B, H, act, qscale);
}

// The block shapes (bi, units) of the persistent forward
// (fused_lstm.LSTM_FWD_SHAPES): 4 or 8 units and 8 or 16 rows. -> the
// launcher and the occupancy query of one, or nulls for another shape.
using FwdLaunch = cudaError_t (*)(int, int, cudaStream_t, const float*,
                                  const void*, const float*, const float*,
                                  const float*, float*, float*, float*,
                                  float*, unsigned*, int, int, int, int,
                                  float);
using FwdOccupancy = cudaError_t (*)(int, int*);

template <bool BF16>
void fwd_shape(int bi, int units, FwdLaunch* launch, FwdOccupancy* occ) {
#define PK_FWD_SHAPE(BI_, UN_)                                            \
  if (bi == BI_ && units == UN_) {                                        \
    *launch = launch_fwd_persist<BF16, BI_, UN_>;                         \
    *occ = persist::occupancy<lstm_fwd_persist<BF16, BI_, UN_>>;          \
    return;                                                               \
  }
  PK_FWD_SHAPE(1, 4)
  PK_FWD_SHAPE(1, 8)
  PK_FWD_SHAPE(2, 4)
  PK_FWD_SHAPE(2, 8)
#undef PK_FWD_SHAPE
  *launch = nullptr;
  *occ = nullptr;
}

void fwd_shape_of(int u_bf16, int bi, int units, FwdLaunch* launch,
                  FwdOccupancy* occ) {
  if (u_bf16)
    fwd_shape<true>(bi, units, launch, occ);
  else
    fwd_shape<false>(bi, units, launch, occ);
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the whole layer on `stream` on the step route: T step kernels
// (plus one small
// reduction over h0 when qbits > 0 and h0 is given). Returns the first
// cudaError_t seen, 0 on success. h0/c0 may both be null (zero state).
// acts: (T, B, 4H) stash output, or null. qslots: T+1 unsigned ints of
// scratch, used when qbits > 0.
int fused_lstm_fwd(const float* gates, const void* U, const float* drop,
                   const float* h0, const float* c0, float* hs, float* cs,
                   float* acts, unsigned* qslots, int T, int B, int H,
                   int act, int qbits, int u_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto kern = u_bf16 ? lstm_step<true> : lstm_step<false>;
  const size_t smem = (size_t)BT * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
    kern<<<grid, THREADS, smem, stream>>>(
        gates + (size_t)t * 4 * bh, U, drop,
        t ? hs + (t - 1) * bh : h0, t ? cs + (t - 1) * bh : c0,
        hs + t * bh, cs + t * bh, acts ? acts + (size_t)t * 4 * bh : nullptr,
        q ? qslots + t : nullptr, q ? qslots + t + 1 : nullptr,
        B, H, act, qscale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The forward on the persistent route on `stream`: one cooperative launch
// of `grid` blocks of lstm_fwd_persist (bi: BT = 8 * bi rows a block;
// units: 4 or 8; smem bytes of dynamic shared memory:
// fused_lstm.lstm_fwd_plan sizes all three), seeded or not. Returns its
// cudaError_t; cudaErrorInvalidValue for a shape not instantiated.
//   gates: (T, B, 4H);  U: (4H, H), bf16 when u_bf16;  drop: (B, H)
//   h0, c0: (B, H) or both null;  hs, cs: (T, B, H) outputs
//   acts: (T, B, 4H) stash output, or null
//   xh: (2, B, row) scratch, zeroed: row = H rounded up to a multiple of
//       4 at 4 units, 32 x persist::lane_stride(H) at 8
//       (fused_lstm.lstm_fwd_exchange_row)
//   bmax: 2 * grid unsigned ints of scratch when qbits > 0
int lstm_fwd_persist_run(const float* gates, const void* U,
                         const float* drop, const float* h0, const float* c0,
                         float* hs, float* cs, float* acts, float* xh,
                         unsigned* bmax, int T, int B, int H, int act,
                         int qbits, int u_bf16, int grid, int bi, int units,
                         int smem, void* stream_ptr) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(u_bf16, bi, units, &fn, &occ);
  if (!fn) return cudaErrorInvalidValue;
  const bool q = qbits > 0;
  const float qscale = q ? std::ldexp(1.f, qbits - 1) : 0.f;
  return fn(grid, smem, static_cast<cudaStream_t>(stream_ptr), gates, U,
            drop, h0, c0, hs, cs, acts, xh, q ? bmax : nullptr, T, B, H, act,
            qscale);
}

// out[0..2]: the persistent forward's co-resident blocks per SM at `smem`
// bytes of dynamic shared memory (u_bf16, bi and units as above), the SM
// count, and whether the device takes cooperative launches.
int lstm_fwd_occupancy(int u_bf16, int bi, int units, int smem, int* out) {
  FwdLaunch fn;
  FwdOccupancy occ;
  fwd_shape_of(u_bf16, bi, units, &fn, &occ);
  return occ ? occ(smem, out) : cudaErrorInvalidValue;
}

}  // extern "C"
