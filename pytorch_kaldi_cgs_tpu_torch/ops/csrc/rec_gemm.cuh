// The dense recurrences' rebuild GEMM on bs_gemm.cuh's tile, shared by
// the torch-semantics GRU's BPTT (fused_gru_torch.cu, TPU row 23) and the
// liGRU's recompute BPTT (fused_ligru.cu, TPU row 18): both rebuild every
// step's recurrent pre-activations before their reverse chains, because
// those do not depend on dh. Kept apart from bs_gemm.cuh so that the
// block-sparse sources, which include the tile, do not compile it. Its
// names have internal linkage: each library is loaded into one process
// beside the others, and a launcher with external linkage would share its
// record of the attribute it set (and its kernel) across them.

#pragma once

#include "bs_gemm.cuh"

namespace bs_gemm {
namespace {

// The dense recurrences' rebuild product over all M = T*B rows at once:
// u = x @ wt (+ bias) (+ add), (M, K) x (K, N), where x holds each step's
// (quantized) carry h_{t-1} and wt the recurrent matrix transposed, so u
// is every step's recurrent pre-activation; bias (N,) and add (M, N) are
// optional (the torch-semantics GRU adds b_hh, the liGRU the gates, which
// makes u the pre-activation g + q(h_{t-1}) @ U^T itself). A block forms
// 128 x 128 outputs, x's rows staged along the contraction and wt's rows
// k-major, both by cp.async: 16-byte copies where VEC (K and N multiples
// of 4, x and wt 16-byte aligned), 4-byte ones else.
constexpr int U_SLAB_A = TILE * ALD;      // floats
constexpr int U_SLAB_B = BK * TILE;
constexpr int U_SMEM = STAGES * (U_SLAB_A + U_SLAB_B) * 4;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
rec_u_gemm(const float* __restrict__ x,     // (M, K)
           const float* __restrict__ wt,    // (K, N)
           const float* __restrict__ bias,  // (N,) or null
           const float* __restrict__ add,   // (M, N) or null
           float* __restrict__ u,           // (M, N)
           int M, int K, int N) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][TILE][ALD]
  float* Bs = As + STAGES * U_SLAB_A;           // [STAGES][BK][TILE]
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  auto load = [&](int stage, int slab) {
    const int k0 = slab * BK;
    float* as = As + stage * U_SLAB_A;
    float* bs_ = Bs + stage * U_SLAB_B;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < TILE * BK / 4 / THREADS; ++q) {
        const int c = tid + q * THREADS;
        const int r = c / (BK / 4), e = (c % (BK / 4)) * 4;
        const int m = m0 + r, kk = k0 + e;
        const bool ok = m < M && kk < K;
        cp_async16(as + r * ALD + e, ok ? x + (size_t)m * K + kk : x, ok);
      }
#pragma unroll
      for (int q = 0; q < BK * TILE / 4 / THREADS; ++q) {
        const int c = tid + q * THREADS;
        const int r = c / (TILE / 4), e = (c % (TILE / 4)) * 4;
        const int kk = k0 + r, n = n0 + e;
        const bool ok = kk < K && n < N;
        cp_async16(bs_ + r * TILE + e, ok ? wt + (size_t)kk * N + n : wt, ok);
      }
    } else {
#pragma unroll
      for (int q = 0; q < TILE * BK / THREADS; ++q) {
        const int c = tid + q * THREADS;
        const int r = c / BK, e = c % BK;
        const int m = m0 + r, kk = k0 + e;
        const bool ok = m < M && kk < K;
        cp_async4(as + r * ALD + e, ok ? x + (size_t)m * K + kk : x, ok);
      }
#pragma unroll
      for (int q = 0; q < BK * TILE / THREADS; ++q) {
        const int c = tid + q * THREADS;
        const int r = c / TILE, e = c % TILE;
        const int kk = k0 + r, n = n0 + e;
        const bool ok = kk < K && n < N;
        cp_async4(bs_ + c, ok ? wt + (size_t)kk * N + n : wt, ok);
      }
    }
  };

  float acc[8][8] = {};
  const int slabs = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < slabs) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < slabs; ++it) {
    cp_async_wait_slab();
    __syncthreads();          // slab `it` landed; slab it-1 is computed
    const int nxt = it + STAGES - 1;
    if (nxt < slabs) load(nxt % STAGES, nxt);
    cp_async_commit();
    const int st = it % STAGES;
    slab_fma_mk(As + st * U_SLAB_A, Bs + st * U_SLAB_B, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile_at(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < N) {
          const size_t at = (size_t)m * N + n + q;
          float v = acc[i][h * 4 + q];
          if (bias) v += bias[n + q];
          if (add) v = add[at] + v;
          u[at] = v;
        }
    }
  }
}

// Launch rec_u_gemm on `stream` (the 16-byte copies where the shapes and
// pointers allow them); returns the launch's cudaError_t.
cudaError_t rec_u_gemm_launch(const float* x, const float* wt,
                                     const float* bias, const float* add,
                                     float* u, int M, int K, int N,
                                     cudaStream_t stream) {
  static int allowed[2][DEVICES] = {};
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0 &&
                   reinterpret_cast<size_t>(wt) % 16 == 0;
  cudaError_t err =
      vec ? allow_smem_once(rec_u_gemm<true>, U_SMEM, allowed[1])
          : allow_smem_once(rec_u_gemm<false>, U_SMEM, allowed[0]);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  if (vec)
    rec_u_gemm<true><<<grid, THREADS, U_SMEM, stream>>>(x, wt, bias, add, u,
                                                        M, K, N);
  else
    rec_u_gemm<false><<<grid, THREADS, U_SMEM, stream>>>(x, wt, bias, add, u,
                                                         M, K, N);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bs_gemm
