// The v3 block-sparse projection's forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel _make_fwd_v3 of
// pytorch_kaldi_cgs_tpu/ops/block_sparse.py (block_sparse_v3_fwd): for
// each out-block j of an HCGS layout with R kept column blocks per block
// row,
//       ys[g][m, j*bs + r] = sum_{k<R, c<bs} x[m, col_idx[j*R+k]*bs + c]
//                                           * w_eff[j, g*bs + r, k*bs + c]
// with w_eff = ceil_quant(w3) * sub3: the 8-bit weight quantizer (clip to
// [-1, 1], ceil of |w| * 2^(bits-1), sign restored; qscale = 0 skips it)
// and the level-2 submask (sub3, or none).
// x: (M, K), w3 and sub3: (Nb, G*bs, R*bs), ys: (G, M, N); all float32.
// The input gradient (_make_dx_v3) is block_sparse_dx.cu's, the weight
// gradient block_sparse_dw.cu's.
//
// It also replaces _make_fwd and _make_fwd_multi (block_sparse.py:198,
// :380), the legacy v1/v2 forward over packed blocks w (nnz, G*bs, bs),
// block p = j*R + k: that is the same product with w3[j][n, k*bs + c] =
// w[j*R + k][n, c] and no quantizer or submask (block_sparse_v3_fwd_packed).
// The wrapper picks the route before the launch (legacy_fwd_route):
//   - x float32, w float32 or bf16: packed_weight_t writes that w3
//     transposed, in float32, into the scratch wt (a bf16 weight widens
//     exactly, so this is the float32 product the TPU kernel computes for
//     such a pair), then the unchanged v3_fwd_gemm: row 13's two launches;
//   - x and w bf16, bs a multiple of 8, both 16-byte aligned: fwd_mma, one
//     launch on bs_mma.cuh's K-major tensor-core tile. Both operands are
//     K-major (A's line m runs along x's gathered columns, B's line n along
//     a packed block's row), wgmma's native layout, so both load straight
//     from global memory with 16-byte cp.async copies and no weight
//     prologue is needed. bf16 products are exact in float32 and wgmma sums
//     in float32, so one rounding of the sum to bf16 matches the TPU
//     kernel's dot_general(..., preferred_element_type=float32); TF32 on
//     float32 operands would not, and is not used;
//   - anything else (x bf16 with w float32, whose float32 product would
//     need w unrounded; bf16 at another bs or alignment) runs
//     block_sparse_legacy.cu's bsl_fwd_tile.
// fwd_mma's tile: 128 x 128 outputs a block of two warpgroups (wgmma
// m64n128k16, 64 float32 sums a thread), slabs of 64 k values (one 128-byte
// swizzled line an output row or column, 16 KB an operand), three resident
// and two loaded ahead, every slab's wgmma waited before the barrier that
// frees its stage; 97 KB of shared memory, so two blocks share an SM and
// one's loads and epilogue overlap the other's tensor-core work (one block
// an SM with four stages, or one wgmma group left in flight with one slab
// ahead, measured slower on the H100). The contraction is short (R*bs =
// 512 at the libri x-projection, 256 at the CGS-16x LSTM: 8 or 4 slabs),
// so the per-slab instructions outside the tensor cores count: a thread's
// lines, row masks and swizzled offset are set once, and a slab costs it
// one division and one col_idx read; the first slabs' w lines are in
// flight while the block reads its col_idx entries. The epilogue stages
// the bf16 tile in the idle ring and writes 16-byte chunks, a row's 256
// bytes by 16 neighbouring threads (the accumulator fragments' own 4-byte
// pairs, 8 rows a warp store, cost the call a quarter of its time). TMA, a
// producer warp and persistent blocks are later work. With a 128-wide N
// tile, x's gathered rows are read G times (from L2, the N tiles of one
// (M tile, out-block) being neighbours in the grid). In bf16 the bytes
// bound the call: 68 MB at the libri G=3 shape (0.0205 ms at
// 3.35 TB/s) against 20.1 GFLOP (0.0204 ms at 989 TFLOP/s).
//
// What bounds it on this card: at the LibriSpeech GRU's training shape
// (M = T*B = 6400, K = 2048, N = 1024, G = 3, Kb = 16, R = 4, bs = 128)
// the forward does 2*M*nnz*bs^2*G = 20.1 GFLOP of float32 FMAs (0.300 ms
// at 67 TFLOP/s without tensor cores; TF32 would break the 1e-5 parity
// with the JAX package) and moves ~137 MB (0.041 ms), so operations bound
// it. Per out-block the work is a dense (M x R*bs) @ (R*bs x G*bs)
// product over the gathered columns.
//
// The forward is two launches. v3_weight_t applies the quantizer and the
// submask once per call and writes w_eff transposed, (Nb, R*bs, G*bs),
// into scratch: 6.3 MB read and 6.3 MB written at the libri layout, about
// 0.004 ms at 3.35 TB/s, and it stays in the 50 MB L2 for the GEMM. (The
// TPU kernel fused this epilogue into each streamed weight block because
// a separate XLA pass re-wrote the whole weight every step; here the
// in-loop epilogue was recomputed by every one of the M tiles and cost
// the earlier tile kernel 34%.) v3_fwd_gemm is then bs_gemm.cuh's
// register-blocked tile: a block owns 128 rows of M and 128 of out-block
// j's G*bs columns (one gate's where bs is a multiple of 128), stages x's
// gathered columns row-major and wt k-major with cp.async (three slabs of
// 16 in flight; the block's R col_idx entries in shared memory), keeps
// an 8 x 8 register tile per thread and stores float4 rows into each
// gate's plane of ys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bs_gemm.cuh"
#include "bs_mma.cuh"

namespace {

// w_eff of out-block j, transposed: wt[j][kk][n] = w_eff[j][n][kk], so
// that the forward stages it k-major with 16-byte copies. A 32 x 32 tile
// through shared memory: reads along kk, writes along n, both coalesced.
__global__ void __launch_bounds__(256)
v3_weight_t(const float* __restrict__ w3, const float* __restrict__ sub3,
            float* __restrict__ wt, int GB, int RB, float qscale) {
  __shared__ float t[32][33];
  const int j = blockIdx.z, n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* wj = w3 + (size_t)j * GB * RB;
  const float* sj = sub3 ? sub3 + (size_t)j * GB * RB : nullptr;
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r, kk = k0 + tx;
    if (n < GB && kk < RB)
      t[r][tx] = bs_gemm::w_eff(wj, sj, (size_t)n * RB + kk, qscale);
  }
  __syncthreads();
  float* o = wt + (size_t)j * RB * GB;
  for (int r = ty; r < 32; r += 8) {
    const int kk = k0 + r, n = n0 + tx;
    if (n < GB && kk < RB) o[(size_t)kk * GB + n] = t[tx][r];
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);   // exact
}

// The legacy packed weight w (nnz, G*bs, bs), block p = j*R + k, as the
// forward GEMM's wt: wt[j][k*bs + c][n] = w[j*R + k][n][c], in float32
// (a bf16 weight widens exactly). v3_weight_t's tile with the packed
// layout's read index and no quantizer or submask.
template <typename TW>
__global__ void __launch_bounds__(256)
packed_weight_t(const TW* __restrict__ w, float* __restrict__ wt, int GB,
                int RB, int R, int bs) {
  __shared__ float t[32][33];
  const int j = blockIdx.z, n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r, kk = k0 + tx;
    if (n < GB && kk < RB)
      t[r][tx] = to_f(w[((size_t)(j * R + kk / bs) * GB + n) * bs + kk % bs]);
  }
  __syncthreads();
  float* o = wt + (size_t)j * RB * GB;
  for (int r = ty; r < 32; r += 8) {
    const int kk = k0 + r, n = n0 + tx;
    if (n < GB && kk < RB) o[(size_t)kk * GB + n] = t[tx][r];
  }
}

// The forward GEMM on bs_gemm.cuh's tile: a block owns rows [m0, m0+128)
// of M and columns [n0, n0+128) of out-block j's G*bs, and contracts over
// its R*bs gathered columns in slabs of 16: x's rows (gathered through
// the block's R col_idx entries in shared memory, 16-byte chunks inside
// one kept block) land row-major, wt's rows k-major.
namespace g = bs_gemm;
constexpr int FWD_SLAB_A = g::TILE * g::ALD;      // floats
constexpr int FWD_SLAB_B = g::BK * g::TILE;
constexpr int FWD_SMEM = g::STAGES * (FWD_SLAB_A + FWD_SLAB_B) * 4;

template <bool VEC>
__global__ void __launch_bounds__(g::THREADS, g::MIN_BLOCKS)
v3_fwd_gemm(const float* __restrict__ x, const float* __restrict__ wt,
            const int* __restrict__ col_idx, float* __restrict__ ys, int M,
            int K, int N, int R, int bs, int G) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][TILE][ALD]
  float* Bs = As + g::STAGES * FWD_SLAB_A;      // [STAGES][BK][TILE]
  int* cols = reinterpret_cast<int*>(Bs + g::STAGES * FWD_SLAB_B);  // [R]
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z;
  const int n0 = blockIdx.x * g::TILE, m0 = blockIdx.y * g::TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* wj = wt + (size_t)j * RB * GB;
  for (int k = tid; k < R; k += g::THREADS) cols[k] = col_idx[j * R + k] * bs;
  __syncthreads();

  auto load = [&](int stage, int slab) {
    const int k0 = slab * g::BK;
    float* as = As + stage * FWD_SLAB_A;
    float* bs_ = Bs + stage * FWD_SLAB_B;
    if (VEC) {
#pragma unroll
      for (int u = 0; u < g::TILE * g::BK / 4 / g::THREADS; ++u) {
        const int c = tid + u * g::THREADS;
        const int r = c / (g::BK / 4), e = (c % (g::BK / 4)) * 4;
        const int m = m0 + r, kk = k0 + e;
        const bool ok = m < M && kk < RB;
        g::cp_async16(as + r * g::ALD + e,
                      ok ? x + (size_t)m * K + cols[kk / bs] + kk % bs : x,
                      ok);
      }
#pragma unroll
      for (int u = 0; u < g::BK * g::TILE / 4 / g::THREADS; ++u) {
        const int c = tid + u * g::THREADS;
        const int r = c / (g::TILE / 4), e = (c % (g::TILE / 4)) * 4;
        const int kk = k0 + r, n = n0 + e;
        const bool ok = kk < RB && n < GB;
        g::cp_async16(bs_ + r * g::TILE + e,
                      ok ? wj + (size_t)kk * GB + n : wt, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < g::TILE * g::BK / g::THREADS; ++u) {
        const int c = tid + u * g::THREADS;
        const int r = c / g::BK, e = c % g::BK;
        const int m = m0 + r, kk = k0 + e;
        const bool ok = m < M && kk < RB;
        g::cp_async4(as + r * g::ALD + e,
                     ok ? x + (size_t)m * K + cols[kk / bs] + kk % bs : x, ok);
      }
#pragma unroll
      for (int u = 0; u < g::BK * g::TILE / g::THREADS; ++u) {
        const int c = tid + u * g::THREADS;
        const int r = c / g::TILE, e = c % g::TILE;
        const int kk = k0 + r, n = n0 + e;
        const bool ok = kk < RB && n < GB;
        g::cp_async4(bs_ + c, ok ? wj + (size_t)kk * GB + n : wt, ok);
      }
    }
  };

  float acc[8][8] = {};
  const int slabs = (RB + g::BK - 1) / g::BK;
#pragma unroll
  for (int st = 0; st < g::STAGES - 1; ++st) {
    if (st < slabs) load(st, st);
    g::cp_async_commit();
  }
  for (int it = 0; it < slabs; ++it) {
    g::cp_async_wait_slab();
    __syncthreads();          // slab `it` landed; slab it-1 is computed
    const int nxt = it + g::STAGES - 1;
    if (nxt < slabs) load(nxt % g::STAGES, nxt);
    g::cp_async_commit();
    const int st = it % g::STAGES;
    g::slab_fma_mk(As + st * FWD_SLAB_A, Bs + st * FWD_SLAB_B, ty, tx, acc);
  }

  // ys[g][m, j*bs + r] for column n = g*bs + r; with bs a multiple of 4 a
  // float4 of columns lies inside one gate
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + g::tile_at(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (VEC) {
        if (n >= GB) continue;
        const int gate = n / bs;
        float* o = ys + ((size_t)gate * M + m) * N + (size_t)j * bs
                   + (n - gate * bs);
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n + q >= GB) continue;
          const int gate = (n + q) / bs;
          ys[((size_t)gate * M + m) * N + (size_t)j * bs + (n + q - gate * bs)]
              = acc[i][h * 4 + q];
        }
      }
    }
  }
}

// The legacy forward in bf16 on the tensor cores (bs_mma.cuh's K-major
// half): a block of two warpgroups owns rows [m0, m0+128) of M and columns
// [n0, n0+128) of out-block j's G*bs, and contracts over its R*bs
// gathered columns in slabs of KM_BK = 64. Both operands are K-major:
// A's line m is x[m, col_idx[j*R + kk/bs]*bs + kk%bs] (the block's R
// col_idx entries in shared memory), B's line n is w[j*R + kk/bs][n][kk%bs];
// a 16-byte chunk is 8 k values of one kept block (bs a multiple of 8), so
// both load straight from global memory with cp.async into the swizzled
// layout, zeros past M, G*bs and R*bs. FM_STAGES slabs resident, FM_AHEAD
// loaded ahead; every warpgroup waits for its wgmma of a slab before the
// barrier that frees the stage. The float32 sums round once to bf16.
namespace mma = bs_mma;
constexpr int FM_STAGES = 3;      // slabs resident in shared memory
constexpr int FM_INFLIGHT = 0;    // wgmma groups left running past a slab
constexpr int FM_AHEAD = FM_STAGES - 1 - FM_INFLIGHT;   // slabs loaded ahead
constexpr int FM_MIN_BLOCKS = 2;  // resident blocks per SM
constexpr int FM_SLAB = mma::TILE * mma::KM_BK * 2;     // bytes: 16 KB
constexpr int FM_SMEM = 2 * FM_STAGES * FM_SLAB + mma::ALIGN_SLACK;
constexpr int FM_OUT_LD = mma::TILE * 2 + 16;  // bytes of a staged output row
static_assert(mma::TILE * FM_OUT_LD <= 2 * FM_STAGES * FM_SLAB,
              "the output tile is staged in the ring");

__global__ void __launch_bounds__(mma::THREADS, FM_MIN_BLOCKS)
fwd_mma(const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ w, const int* __restrict__ col_idx,
        __nv_bfloat16* __restrict__ ys, int M, int K, int N, int R, int bs,
        int G) {
  extern __shared__ float4 smem4[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const unsigned pad = (1024u - (raw & 1023u)) & 1023u;   // 1 KB atoms
  char* ring = reinterpret_cast<char*>(smem4) + pad;      // A, then B
  const unsigned sring = raw + pad;
  int* cols = reinterpret_cast<int*>(ring + 2 * FM_STAGES * FM_SLAB);  // [R]
  constexpr int CHUNKS = mma::KM_BK / 8;                 // 16 B chunks a line
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z;
  const int n0 = blockIdx.x * mma::TILE, m0 = blockIdx.y * mma::TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const __nv_bfloat16* wj = w + (size_t)j * R * GB * bs;

  // 8 neighbouring threads copy one line's 128 bytes: thread tid copies
  // chunk e of lines r0 + RSTEP*u (u < LINES) of both operands in every
  // slab, so its row pointers, row masks and swizzled offset are set once
  // and a slab costs one division (its kept block) and one col_idx read.
  // x's lines (A) go through the block's col_idx entries, w's (B) need none.
  constexpr int RSTEP = mma::THREADS / CHUNKS;           // 32 lines
  constexpr int LINES = mma::TILE / RSTEP;               // 4 a thread
  const int e = tid % CHUNKS, r0 = tid / CHUNKS;
  const __nv_bfloat16* xa = x + (size_t)(m0 + r0) * K;
  const __nv_bfloat16* wb = wj + (size_t)(n0 + r0) * bs;
  const size_t xstep = (size_t)RSTEP * K, wstep = (size_t)RSTEP * bs;
  const int off0 = mma::km_offset(r0, e);        // + u * RSTEP / 8 atoms
  unsigned a_rows = 0, b_rows = 0;               // bit u: line u in range
#pragma unroll
  for (int u = 0; u < LINES; ++u) {
    a_rows |= (m0 + r0 + RSTEP * u < M ? 1u : 0u) << u;
    b_rows |= (n0 + r0 + RSTEP * u < GB ? 1u : 0u) << u;
  }
  auto load = [&](int stage, int slab, bool a, bool b) {
    const int kk = slab * mma::KM_BK + e * 8;
    const bool in_k = kk < RB;
    const int kb = in_k ? kk / bs : 0, kc = kk - kb * bs;
    char* as = ring + stage * FM_SLAB + off0;
    char* bs_ = ring + (FM_STAGES + stage) * FM_SLAB + off0;
    const __nv_bfloat16* xs = xa + (a && in_k ? cols[kb] + kc : 0);
    const __nv_bfloat16* ws = wb + (size_t)kb * GB * bs + kc;
#pragma unroll
    for (int u = 0; u < LINES; ++u) {
      const int so = u * (RSTEP / 8) * mma::SW_GROUP;
      const bool a_ok = in_k && (a_rows >> u & 1u);
      const bool b_ok = in_k && (b_rows >> u & 1u);
      if (a) bs_gemm::cp_async16(as + so, a_ok ? xs + u * xstep : x, a_ok);
      if (b) bs_gemm::cp_async16(bs_ + so, b_ok ? ws + u * wstep : w, b_ok);
    }
  };

  // the first slabs' w lines are in flight while the col_idx entries load
  const int slabs = (RB + mma::KM_BK - 1) / mma::KM_BK;
#pragma unroll
  for (int st = 0; st < FM_AHEAD; ++st)
    if (st < slabs) load(st, st, false, true);
  for (int k = tid; k < R; k += mma::THREADS) cols[k] = col_idx[j * R + k] * bs;
  __syncthreads();
  // group st holds slab st's x lines (group 0 also the w lines above)
#pragma unroll
  for (int st = 0; st < FM_AHEAD; ++st) {
    if (st < slabs) load(st, st, true, false);
    bs_gemm::cp_async_commit();
  }

  float acc[64] = {};
  for (int it = 0; it < slabs; ++it) {
    mma::cp_async_wait<FM_AHEAD - 1>();
    mma::fence_async_shared();
    // slab `it` is visible to wgmma; every warpgroup is done with the
    // stage the next load overwrites (read INFLIGHT + 1 slabs ago)
    __syncthreads();
    const int nxt = it + FM_AHEAD;
    if (nxt < slabs) load(nxt % FM_STAGES, nxt, true, true);
    bs_gemm::cp_async_commit();
    const int st = it % FM_STAGES;
    mma::slab_mma_k<FM_INFLIGHT>(sring + st * FM_SLAB,
                                 sring + (FM_STAGES + st) * FM_SLAB, wg, acc);
  }
  mma::wgmma_wait<0>();
  mma::fence_operand(acc);

  // The tile, rounded once to bf16, through the idle ring (rows FM_OUT_LD
  // bytes apart: a warp's pairs of 8 rows x 4 lanes hit 32 banks), then
  // to ys in 16-byte chunks, 16 threads a row: chunk q is columns n = n0 +
  // 8q .. +8 of one gate (bs a multiple of 8), ys[g][m, j*bs + n - g*bs].
  __syncthreads();               // every warpgroup is done with the ring
#pragma unroll
  for (int c = 0; c < mma::TILE / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(
          ring + mma::frag_row(tid, h) * FM_OUT_LD +
          mma::frag_col(tid, c) * 2) =
          __floats2bfloat162_rn(acc[c * 4 + 2 * h], acc[c * 4 + 2 * h + 1]);
  __syncthreads();
  constexpr int OUT_CHUNKS = mma::TILE / 8;              // 16 B chunks a row
#pragma unroll
  for (int u = 0; u < mma::TILE * OUT_CHUNKS / mma::THREADS; ++u) {
    const int c = tid + u * mma::THREADS;
    const int r = c / OUT_CHUNKS, q = c % OUT_CHUNKS;
    const int m = m0 + r, n = n0 + q * 8;
    if (m >= M || n >= GB) continue;
    const int gate = n / bs;
    *reinterpret_cast<float4*>(ys + ((size_t)gate * M + m) * N +
                               (size_t)j * bs + (n - gate * bs)) =
        *reinterpret_cast<const float4*>(ring + r * FM_OUT_LD + q * 16);
  }
}

// v3_fwd_gemm over the transposed weight wt (VEC where vec says)
cudaError_t run_fwd_gemm(const float* x, const float* wt, const int* col_idx,
                         float* ys, int M, int K, int N, int Nb, int R,
                         int bs, int G, int vec, cudaStream_t stream) {
  const int GB = G * bs;
  const int smem = FWD_SMEM + R * 4;
  cudaError_t err = vec ? g::allow_smem(v3_fwd_gemm<true>, smem)
                        : g::allow_smem(v3_fwd_gemm<false>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((GB + g::TILE - 1) / g::TILE, (M + g::TILE - 1) / g::TILE,
                  Nb);
  if (vec)
    v3_fwd_gemm<true><<<grid, g::THREADS, smem, stream>>>(x, wt, col_idx, ys,
                                                          M, K, N, R, bs, G);
  else
    v3_fwd_gemm<false><<<grid, g::THREADS, smem, stream>>>(x, wt, col_idx, ys,
                                                           M, K, N, R, bs, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Two launches on `stream`: v3_weight_t writes w_eff transposed into the
// scratch wt (Nb*R*bs*G*bs floats), then v3_fwd_gemm writes ys (G, M, N)
// from x (M, K) and wt; col_idx: (Nb*R,) int32 on the device; sub3: like
// w3, or null; qscale: 2^(bits-1) of the weight quantizer, 0 for none;
// vec: 16-byte loads (bs a multiple of 4, x 16-byte aligned). Returns the
// first cudaError_t, 0 on success.
int block_sparse_v3_fwd(const float* x, const float* w3, const int* col_idx,
                        float* wt, const float* sub3, float* ys, int M, int K,
                        int N, int Nb, int R, int bs, int G, int vec,
                        float qscale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int GB = G * bs, RB = R * bs;
  v3_weight_t<<<dim3((RB + 31) / 32, (GB + 31) / 32, Nb), 256, 0, stream>>>(
      w3, sub3, wt, GB, RB, qscale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_fwd_gemm(x, wt, col_idx, ys, M, K, N, Nb, R, bs, G, vec,
                      stream);
}

// On `stream`: the legacy forward ys (G, M, N), in x's type, from x (M,
// K) and the packed w (nnz, G*bs, bs), nnz = Nb*R; col_idx: (Nb*R,) int32
// on the device; tx / tw: the dtype codes of x and w (0 float32, 1 bf16).
// x float32 (w either): packed_weight_t writes wt (Nb*R*bs*G*bs floats of
// scratch), then v3_fwd_gemm (vec as above). x and w bf16 (bs a multiple
// of 8, both 16-byte aligned): one fwd_mma launch, wt unused. Returns the
// first cudaError_t, 0 on success.
int block_sparse_v3_fwd_packed(const void* x, const void* w,
                               const int* col_idx, float* wt, void* ys,
                               int tx, int tw, int M, int K, int N, int Nb,
                               int R, int bs, int G, int vec,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int GB = G * bs, RB = R * bs;
  if (tx == 0 && (tw == 0 || tw == 1)) {
    const dim3 tgrid((RB + 31) / 32, (GB + 31) / 32, Nb);
    if (tw == 0)
      packed_weight_t<float><<<tgrid, 256, 0, stream>>>(
          static_cast<const float*>(w), wt, GB, RB, R, bs);
    else
      packed_weight_t<__nv_bfloat16><<<tgrid, 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(w), wt, GB, RB, R, bs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return run_fwd_gemm(static_cast<const float*>(x), wt, col_idx,
                        static_cast<float*>(ys), M, K, N, Nb, R, bs, G, vec,
                        stream);
  }
  if (tx == 1 && tw == 1 && bs % 8 == 0) {
    const int smem = FM_SMEM + R * 4;
    static int allowed[g::DEVICES];
    const cudaError_t err = g::allow_smem_once(fwd_mma, smem, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((GB + mma::TILE - 1) / mma::TILE,
                    (M + mma::TILE - 1) / mma::TILE, Nb);
    fwd_mma<<<grid, mma::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), col_idx,
        static_cast<__nv_bfloat16*>(ys), M, K, N, R, bs, G);
    return cudaGetLastError();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
