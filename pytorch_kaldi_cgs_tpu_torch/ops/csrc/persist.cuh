// The persistent cooperative chains shared by the recurrences' kernels:
// the GRU BPTTs (fused_gru_torch.cu, fused_gru_sparse.cu), the liGRU's
// recompute BPTT and its forward (fused_ligru.cu), the sparse GRU's and
// minimalGRU's forward and the sparse minimalGRU's BPTT
// (fused_gru_sparse.cu), the dense GRU and minimalGRU forward and
// the dense minimalGRU's recompute BPTT (fused_gru.cu), the dense LSTM
// forward (fused_lstm_fwd.cu) and its stash BPTT (fused_lstm_bwd.cu), the
// sparse RNN forward and BPTT (fused_rnn_sparse.cu) and the sparse LSTM
// forward and stash BPTT (fused_lstm_sparse.cu).
// One launch runs every step, each block owning UN
// (4, 8 or 16) hidden units and BT batch rows for the whole call, the
// recurrent weights of its units resident in its shared memory, a
// grid-wide barrier where a step needs what the other blocks wrote.
//
// The launch is cooperative (cudaLaunchCooperativeKernel), so the driver
// refuses a grid that cannot be co-resident instead of letting the spin
// barrier hang; the caller sizes the grid from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor (queried after the dynamic
// shared-memory attribute is set) times the SM count, and picks the route
// before the launch.
//
// Per dependent product a block stages the vectors its units need (the
// cotangents, or the forward's carries), (BT, K) rows read from L2 by
// cp.async.cg (16 bytes, L1 bypassed: the other blocks wrote them in this
// launch, so the non-coherent path must not see them), and forms its
// units' dots against its weights, kept as ws[k][UN]: a warp takes a
// contiguous range of k, its lanes 8 batch lanes x 4 k lanes, a lane
// BT/8 rows x UN units in registers; the 4 k lanes are summed with
// shuffles and the 8 warps' partials in a fixed order, so the sums are
// the same in every call and no float atomics are used. A staged row is
// K rounded up to 8 plus 4 floats long, which puts the 32 lanes' reads on
// 32 banks. Where BT rows of K do not fit beside the weights, slab_dots
// stages them in slabs of the contraction, two in flight.
//
// The dense forwards (the GRU's, the minimalGRU's, the liGRU's and the
// LSTM's), the sparse minimalGRU's, RNN's and LSTM's forwards and the
// sparse RNN's and LSTM's chains sum their dots in the step kernels' order
// instead
// (resident_dots: a warp a dot, lanes over k; the LSTM's lane_dots, the
// same sums over a lane-major layout read 16 bytes at a time), and stage
// their quantized carries with stage_quant (rounded to bf16 after q()
// where the LSTM's dots are bf16), so that both of their routes give the
// same bits.
//
// The barrier is cooperative_groups' grid.sync(). Timed once on the H100
// against a hand-written counter barrier (release/acquire fences around one
// global atomic), it took 1.13-1.15 us a barrier over 69-132 blocks against
// the counter's 1.26-1.37 us, so the counter was not kept.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace persist {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 8;          // hidden units a block owns (or 16)
constexpr int KLANES = 4;         // lanes of a warp along the contraction
constexpr int BLANES = 8;         // lanes of a warp along the batch rows

// floats between two staged rows of K values: K rounded up to 8, plus 4
__host__ __device__ constexpr int row_stride(int K) {
  return (K + 7) / 8 * 8 + 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread's copies are in
// flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// Copy `rows` rows of `len` floats (len % 4 == 0, both ends 16-byte
// aligned) from global to shared memory, row r from src(r) to dst(r);
// every thread of the block takes part. Followed by cp_async_wait_all and
// a __syncthreads before the rows are read.
template <typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(int rows, int len, Src src,
                                           Dst dst) {
  const int chunks = len / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += WARPS) {
    const float* s = src(r);
    float* d = dst(r);
    for (int c = lane; c < chunks; c += 32) cp_async16(d + 4 * c, s + 4 * c);
  }
}

// floats between two units' weight rows k and k+1 of ws: UN, padded at 16
// and 32 so that the 4 k lanes' 16-byte reads fall on distinct banks
__host__ __device__ constexpr int w_stride(int UN) {
  return UN == 16 ? 20 : (UN == 32 ? 36 : UN);
}

// acc[i][u] += sum_k xf(xs[(bl + 8i) * SK + k]) * ws[k][u] over warp w's
// share [n w / WARPS, n (w+1) / WARPS) of the n staged columns, this
// lane's k lanes' part of it: the per-lane half of unit_dots, which a
// caller that stages the contraction in slabs (slab_dots) calls once a
// slab, ws and xs pointing at the slab's first column. xf transforms each
// staged value before its products (bf16 rounding, a quantizer): it runs
// inside the FMA loop, so it must not divide (an IEEE division there took
// the sparse GRU forward's libri call from 1.9 to 4.0 ms on the H100).
template <int BI, int UN, typename XF>
__device__ __forceinline__ void slab_fma(const float* xs, int SK,
                                         const float* ws, int n,
                                         float (&acc)[BI][UN], XF xf) {
  constexpr int WS = w_stride(UN), V = UN / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane & (KLANES - 1), bl = lane / KLANES;
  const int kb = n * warp / WARPS, ke = n * (warp + 1) / WARPS;
#pragma unroll 4
  for (int k = kb + kl; k < ke; k += KLANES) {
    float4 w[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      w[v] = *reinterpret_cast<const float4*>(ws + k * WS + 4 * v);
#pragma unroll
    for (int i = 0; i < BI; ++i) {
      const float x = xf(xs[(bl + BLANES * i) * SK + k]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[i][4 * v] = fmaf(x, w[v].x, acc[i][4 * v]);
        acc[i][4 * v + 1] = fmaf(x, w[v].y, acc[i][4 * v + 1]);
        acc[i][4 * v + 2] = fmaf(x, w[v].z, acc[i][4 * v + 2]);
        acc[i][4 * v + 3] = fmaf(x, w[v].w, acc[i][4 * v + 3]);
      }
    }
  }
}

// Sum the 4 k lanes of acc with shuffles and write each warp's partials
// to red[(w * BT + b) * UN + u]; followed by a __syncthreads, after which
// out(b, u) = unit_sum(red, b * UN + u).
template <int BI, int UN>
__device__ __forceinline__ void unit_reduce(float (&acc)[BI][UN],
                                            float* red) {
  constexpr int BT = BLANES * BI, V = UN / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane & (KLANES - 1), bl = lane / KLANES;
#pragma unroll
  for (int i = 0; i < BI; ++i)
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      acc[i][u] += __shfl_xor_sync(0xffffffffu, acc[i][u], 1);
      acc[i][u] += __shfl_xor_sync(0xffffffffu, acc[i][u], 2);
    }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < BI; ++i) {
      float* r = red + ((size_t)warp * BT + bl + BLANES * i) * UN;
#pragma unroll
      for (int v = 0; v < V; ++v)
        *reinterpret_cast<float4*>(r + 4 * v) =
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                        acc[i][4 * v + 3]);
    }
  }
  __syncthreads();
}

// each staged value as it is, or rounded to bf16 under RND
template <bool RND>
struct bf16_or_ident {
  __device__ __forceinline__ float operator()(float x) const {
    return RND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
  }
};

// red[(w * BT + b) * UN + u] = warp w's share of sum_k xs[b][k] *
// ws[k][u] for the BT = 8 * BI staged rows (row stride SK, at least
// row_stride(K) and 4 more than a multiple of 8) and UN (8, 16 or 32)
// units (ws rows w_stride(UN) apart), k over warp w's range of [0, K),
// each staged value rounded to bf16 first under RND (or transformed by
// xf where one is given, as slab_fma's); followed by a __syncthreads,
// after which out(b, u) = unit_sum(red, b * UN + u).
template <int BI, int UN = UNITS, bool RND = false,
          typename XF = bf16_or_ident<RND>>
__device__ __forceinline__ void unit_dots(const float* xs, int SK,
                                          const float* ws, int K, float* red,
                                          XF xf = XF()) {
  float acc[BI][UN];
#pragma unroll
  for (int i = 0; i < BI; ++i)
#pragma unroll
    for (int u = 0; u < UN; ++u) acc[i][u] = 0.f;
  slab_fma<BI, UN>(xs, SK, ws, K, acc, xf);
  unit_reduce<BI, UN>(acc, red);
}

// unit_dots over a contraction of K values that does not fit shared
// memory at once: the `rows` rows (row r's values from src(r), 16-byte
// aligned, KX >= K of them readable, KX a multiple of 4) are staged
// through two buffers of (BT, SK) floats at xs, xs + BT * SK in slabs of
// KS values (a multiple of 4; SK >= row_stride(KS)), the next slab's
// copy in flight while the current one is summed; with KS >= K it stages
// once into the first buffer. Each warp sums its share of each slab, so
// the order of the sums is fixed by K and KS; xf transforms each staged
// value before its products, as slab_fma's (the LSTM's bf16 rounding of
// dg). Every thread of the block takes part; no cp.async group may be
// pending on entry.
template <int BI, int UN, typename Src, typename XF = bf16_or_ident<false>>
__device__ __forceinline__ void slab_dots(Src src, int rows, int K, int KX,
                                          int KS, float* xs, int SK,
                                          const float* ws, float* red,
                                          XF xf = XF()) {
  constexpr int BT = BLANES * BI, WS = w_stride(UN);
  const int ns = (K + KS - 1) / KS;
  float acc[BI][UN];
#pragma unroll
  for (int i = 0; i < BI; ++i)
#pragma unroll
    for (int u = 0; u < UN; ++u) acc[i][u] = 0.f;
  auto issue = [&](int s) {
    const int k0 = s * KS;
    float* d = xs + (size_t)(s & 1) * BT * SK;
    stage_rows(rows, min(KS, KX - k0), [&](int r) { return src(r) + k0; },
               [&](int r) { return d + (size_t)r * SK; });
    cp_async_commit();
  };
  issue(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = s * KS;
    slab_fma<BI, UN>(xs + (size_t)(s & 1) * BT * SK, SK, ws + (size_t)k0 * WS,
                     min(KS, K - k0), acc, xf);
    if (s + 2 < ns) __syncthreads();    // issue(s + 2) refills this buffer
  }
  unit_reduce<BI, UN>(acc, red);
}

// out(b, u) for the thread of output o = b * UN + u (o < BT * UN)
template <int BI, int UN = UNITS>
__device__ __forceinline__ float unit_sum(const float* red, int o) {
  constexpr int BT = BLANES * BI;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w * BT * UN + o];
  return s;
}

namespace {

// 16-byte chunks a thread quantizes in flight in stage_quant's pass
constexpr int STAGE_CHUNKS = 8;

// The parts of resident_dots, for a caller that stages the contraction in
// slabs (the sparse LSTM's chain): acc (BT/2 rows x NR/4 weight rows a
// warp) zeroed; then per slab resident_fma adds, over its n columns from
// k0 (xs the slab, ws rows WK floats apart at absolute k), the products
// each lane takes (k = k0 + lane, k0 + lane + 32, ...: with every slab a
// multiple of 32 long, the order of the whole contraction's); then
// resident_store reduces each dot over the 32 lanes into usm.
template <int BT, int NR>
__device__ __forceinline__ void resident_zero(float (&acc)[BT / 2][NR / 4]) {
#pragma unroll
  for (int p = 0; p < BT / 2; ++p)
#pragma unroll
    for (int q = 0; q < NR / 4; ++q) acc[p][q] = 0.f;
}

template <int BT, int NR>
__device__ __forceinline__ void resident_fma(const float* ws, int WK,
                                             const float* xs, int SK, int k0,
                                             int n, int nb,
                                             float (&acc)[BT / 2][NR / 4]) {
  constexpr int BQ = BT / 2, RQ = NR / 4;
  static_assert(WARPS == 8 && NR % 4 == 0, "2 x 4 warps");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bq = (warp & 1) * BQ, rq = (warp >> 1) * RQ;
  const float* x = xs + (size_t)bq * SK;
  const float* w = ws + (size_t)rq * WK + k0;
#pragma unroll 4
  for (int k = lane; k < n; k += 32) {
    float wv[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q) wv[q] = w[(size_t)q * WK + k];
#pragma unroll
    for (int p = 0; p < BQ; ++p)
      if (bq + p < nb) {
        const float xv = x[(size_t)p * SK + k];
#pragma unroll
        for (int q = 0; q < RQ; ++q) acc[p][q] = fmaf(xv, wv[q], acc[p][q]);
      }
  }
}

template <int BT, int NR, int LD>
__device__ __forceinline__ void resident_store(
    float (&acc)[BT / 2][NR / 4], float (*usm)[LD]) {
  constexpr int BQ = BT / 2, RQ = NR / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bq = (warp & 1) * BQ, rq = (warp >> 1) * RQ;
#pragma unroll
  for (int p = 0; p < BQ; ++p)
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      float v = acc[p][q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) usm[bq + p][rq + q] = v;
    }
}

// usm[b][r] = sum_k xs[b * SK + k] * ws[r * K + k] over K columns for the
// NR resident rows r of ws and the staged rows b < nb of BT (usm rows LD
// floats apart): the dense forwards' dots. Each dot is summed in the step
// kernels' row_dots order (lane l takes k = l, l + 32, ... in turn, then a
// shuffle reduction over the 32 lanes), so that a persistent forward gives
// its step route's bits; warp w takes the BT/2 rows b from (w % 2) * BT/2
// and the NR/4 rows r from (w / 2) * NR/4, so that each value it loads
// serves several dots: shared memory's bandwidth, not the FMAs, sets their
// pace (one warp a row r, reloading every staged value for each, was
// slower; gru_fwd_variants.py times the other splits of the warps).
// Followed by a __syncthreads before usm is read.
template <int BT, int NR, int LD>
__device__ __forceinline__ void resident_dots(const float* ws,
                                              const float* xs, int SK,
                                              int K, int nb,
                                              float (*usm)[LD]) {
  float acc[BT / 2][NR / 4];
  resident_zero<BT, NR>(acc);
  resident_fma<BT, NR>(ws, K, xs, SK, 0, K, nb, acc);
  resident_store<BT, NR, LD>(acc, usm);
}

// floats between two lanes' segments of a lane-major row of K values
// (lane_dots): the ceil(K / 32) values lane l sums (k = l, l + 32, ...)
// rounded up to an odd number of float4s, so that the 8 lanes of each
// phase of a 16-byte load fall on 32 distinct banks
__host__ __device__ constexpr int lane_stride(int K) {
  return 4 * ((((K + 31) / 32) + 3) / 4 | 1);
}

// usm[b][r] = sum_k xs[b][k] * ws[r][k] summed as resident_dots sums it
// (a warp a dot, lane l taking k = l, l + 32, ... in turn, then the
// shuffle reduction over the 32 lanes: the step kernels' bits), over rows
// in the lane-major layout: value k at (k % 32) * SJ + k / 32, SJ =
// lane_stride(K), zeros past K (fmaf(0, 0, acc) is acc: a sum from +0
// never reaches -0), ws rows L = 32 * SJ floats apart, xs rows SK. A lane
// reads 4 of its values in one 16-byte load, a quarter of resident_dots'
// load instructions. Warps split as resident_dots'. Followed by a
// __syncthreads before usm is read.
template <int BT, int NR, int LD>
__device__ __forceinline__ void lane_dots(const float* ws, const float* xs,
                                          int SK, int K, int nb,
                                          float (*usm)[LD]) {
  constexpr int BQ = BT / 2, RQ = NR / 4;
  static_assert(WARPS == 8 && NR % 4 == 0, "2 x 4 warps");
  const int SJ = lane_stride(K), L = 32 * SJ, JV = ((K + 31) / 32 + 3) / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bq = (warp & 1) * BQ, rq = (warp >> 1) * RQ;
  const float* x = xs + (size_t)bq * SK + lane * SJ;
  const float* w = ws + (size_t)rq * L + lane * SJ;
  float acc[BQ][RQ];
#pragma unroll
  for (int p = 0; p < BQ; ++p)
#pragma unroll
    for (int q = 0; q < RQ; ++q) acc[p][q] = 0.f;
  for (int j = 0; j < JV; ++j) {
    float4 wv[RQ];
#pragma unroll
    for (int q = 0; q < RQ; ++q)
      wv[q] = *reinterpret_cast<const float4*>(w + (size_t)q * L + 4 * j);
#pragma unroll
    for (int p = 0; p < BQ; ++p)
      if (bq + p < nb) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + (size_t)p * SK + 4 * j);
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          float a = acc[p][q];
          a = fmaf(xv.x, wv[q].x, a);
          a = fmaf(xv.y, wv[q].y, a);
          a = fmaf(xv.z, wv[q].z, a);
          acc[p][q] = fmaf(xv.w, wv[q].w, a);
        }
      }
  }
#pragma unroll
  for (int p = 0; p < BQ; ++p)
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      float v = acc[p][q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) usm[bq + p][rq + q] = v;
    }
}

// Apply q() at scale var (quant_rcp: the reciprocal of var taken once;
// var == 0 leaves the values unquantized, as quant() does), then bf16
// rounding under RND, in place to the nb staged rows of `len` floats (a
// multiple of 4) at xsm, rows SK apart, STAGE_CHUNKS 16-byte chunks a
// thread in flight, since at one block of 8 warps an SM a pass one value
// at a time waits on each load in turn. Nothing runs where neither
// changes a value. Every thread takes part; a __syncthreads follows a
// pass, and one must precede the call (the rows staged).
template <bool RND = false>
__device__ __forceinline__ void quant_staged(float* xsm, int SK, int nb,
                                             int len, float var,
                                             float qscale, float iscale) {
  if (var == 0.f && !RND) return;
  constexpr int NC = STAGE_CHUNKS;
  const float inv = var != 0.f ? 1.f / var : 0.f;
  // q() (the identity at var == 0), then bf16 under RND
  auto q = [&](float x) {
    const float y = quant_rcp(x, var, inv, qscale, iscale);
    return RND ? round_bf16(y) : y;
  };
  const int cpr = len / 4, cn = nb * cpr;
  for (int c0 = 0; c0 < cn; c0 += THREADS * NC) {
    float4* x[NC];
    float4 r[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = c0 + i * THREADS + threadIdx.x;
      const int b = c / cpr, j = c - b * cpr;
      x[i] = reinterpret_cast<float4*>(xsm + (size_t)b * SK) + j;
      if (c < cn) r[i] = *x[i];
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (c0 + i * THREADS + threadIdx.x < cn)
        *x[i] = make_float4(q(r[i].x), q(r[i].y), q(r[i].z), q(r[i].w));
  }
  __syncthreads();
}

// Stage the nb rows from row b0 of v (rows HP floats apart, HP a multiple
// of 4, 16-byte aligned: the dense forwards' exchange buffers, written by
// other blocks in this launch) into xsm (rows SK apart) by cp.async. With
// `maxes`, the n blocks' max|v| bits of the step (read meanwhile) give the
// scale var of q(), applied to the staged rows in place (quant_staged).
// q() on the values as the dots load them costs more: the warps of
// one row group each load them (gru_fwd_variants.py). Under RND each
// staged value is then rounded to bf16 (the LSTM's bf16 dots), also
// where var == 0 or there are no maxes. Every thread takes part; gmax is
// a __shared__ word. -> var (0 without maxes).
template <bool RND = false>
__device__ __forceinline__ float stage_quant(const float* v, int HP, int b0,
                                             int nb, float* xsm, int SK,
                                             const unsigned* maxes, int n,
                                             unsigned* gmax, float qscale,
                                             float iscale) {
  stage_rows(nb, HP, [&](int b) { return v + (size_t)(b0 + b) * HP; },
             [&](int b) { return xsm + (size_t)b * SK; });
  if (maxes && threadIdx.x < 32) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < n; i += 32) m = max(m, __ldcg(maxes + i));
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) *gmax = m;
  }
  cp_async_wait_all();
  __syncthreads();
  const float var = maxes ? __uint_as_float(*gmax) : 0.f;
  quant_staged<RND>(xsm, SK, nb, HP, var, qscale, iscale);
  return var;
}

// out[blockIdx.x] = this block's max of its threads' bits m (wmax: WARPS
// __shared__ words); every thread takes part.
__device__ __forceinline__ void block_max(unsigned m, unsigned* out,
                                          unsigned* wmax) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v = 0;
    for (int w = 0; w < WARPS; ++w) v = max(v, wmax[w]);
    out[blockIdx.x] = v;
  }
}

}  // namespace

// Raise the kernel's dynamic shared-memory limit on the current device to
// `smem` where it is lower (never lower it: another shape may need more).
template <auto Kern>
cudaError_t allow_once(int smem) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev] >= smem)) return err;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = smem;
  return err;
}

// out[0..2]: the kernel's co-resident blocks per SM at `smem` bytes of
// dynamic shared memory (asked after the limit is raised to it), the SM
// count, and whether the device takes cooperative launches.
template <auto Kern>
cudaError_t occupancy(int smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_once<Kern>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, Kern, THREADS,
                                                        smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 2, cudaDevAttrCooperativeLaunch, dev);
  return err;
}

template <typename T>
struct ident {
  using type = T;
};

// The arguments converted to the kernel's own parameter types, whose
// addresses cudaLaunchCooperativeKernel reads.
template <typename... P>
cudaError_t coop_launch(void (*kern)(P...), int grid, int smem,
                        cudaStream_t stream, typename ident<P>::type... args) {
  void* ptrs[] = {static_cast<void*>(&args)...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                     dim3(grid), dim3(THREADS), ptrs,
                                     (size_t)smem, stream);
}

// A cooperative launch of Kern over `grid` blocks on `stream`; a grid that
// cannot be co-resident is refused (the error is returned, nothing runs).
template <auto Kern, typename... A>
cudaError_t launch(int grid, int smem, cudaStream_t stream, A... args) {
  const cudaError_t err = allow_once<Kern>(smem);
  if (err != cudaSuccess) return err;
  return coop_launch(Kern, grid, smem, stream, args...);
}

}  // namespace persist
