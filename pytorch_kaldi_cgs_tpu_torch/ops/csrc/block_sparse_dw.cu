// Block-sparse weight gradient for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pytorch_kaldi_cgs_tpu/ops/block_sparse.py:
// _make_dw_v3, with its fuse_sub epilogue. For each out-block j of an
// HCGS layout with R kept column blocks per block row:
//
//   dw3g[j] = dg[:, j*G*bs : (j+1)*G*bs]^T @ [x[:, col_idx[j*R+k]*bs : +bs]]_k
//   (times sub3[j] elementwise when sub3 is given)
//
// dg: (M, Nb*G*bs), x: (M, K), dw3g: (Nb, G*bs, R*bs), all float32. It is
// the dU of the sparse fused recurrence (M = T*B) and the dw of the v3
// projections.
//
// What bounds it on this card: at the CGS-16x training shape (M = 4800,
// Nb = 8, G*bs = 512, R*bs = 256) it does 10.07 GFLOP of float32 FMAs
// (0.150 ms at 67 TFLOP/s without tensor cores; TF32 would break the
// 1e-5 parity with the JAX package) and moves ~103 MB (0.031 ms), so
// operations bound it. The TPU kernel walked (j, m) in order with the
// accumulator in VMEM and the R gathered x blocks DMA'd per m tile.
//
// Design: the register-blocked tile of bs_gemm.cuh. A block owns one
// 128 x 128 tile of one dw3g[j] (G*bs rows, R*bs columns) and walks its
// share of M in slabs of 16 rows, three in flight with cp.async. Both
// operands are row-major along the output dimensions, so a slab is a
// plain 2-D copy into k-major shared tiles: dg's rows straight from
// memory, x's rows gathered through col_idx (the block's R indices in
// shared memory, read once; a kept block is bs contiguous floats, so
// each 16-byte chunk lies inside one block). The output is small and M
// is long: at the LibriSpeech GRU's dU (G = 1, R = 2) there are only 16
// tiles for 132 SMs, and the libri v3 dw's 96 fill 73% of one round of
// the 264 resident slots, so the wrapper splits M into S parts chosen
// from the shape and the card (block_sparse.dw_plan over the tile this
// library reports and the SM count: the fewest rounds of slots times the
// rows a block walks; 16, 8 there on the H100); each part writes a float32
// partial and dw_reduce sums the S partials in a fixed order and applies
// sub3, so two calls give the same bits. With S = 1 the tile's epilogue
// applies sub3 and the second pass is skipped.
// Where bs is not a multiple of 4 or a pointer is not 16-byte aligned
// the wrapper takes the scalar-load instantiation (4-byte cp.async).

#include <cuda_runtime.h>

#include "bs_gemm.cuh"

namespace {

using namespace bs_gemm;

constexpr int SLAB = BK * TILE;                            // floats
constexpr int SMEM = 2 * STAGES * SLAB * 4 + TILE * 4;     // + x columns

// One tile of dw3g[j] over rows [s*rows, (s+1)*rows) of M; part null: the
// whole M, written to out (times sub3); else the float32 partial of split
// s, written to part[s].
template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dw_gemm(const float* __restrict__ dg, const float* __restrict__ x,
        const int* __restrict__ col_idx, const float* __restrict__ sub3,
        float* __restrict__ out, float* __restrict__ part, int M, int K,
        int Nb, int R, int bs, int G, int rows) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);       // [STAGES][BK][TILE]
  float* Bs = As + STAGES * SLAB;                    // [STAGES][BK][TILE]
  int* xcol = reinterpret_cast<int*>(Bs + STAGES * SLAB);  // [TILE]
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z % Nb, s = blockIdx.z / Nb;
  const int n0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m_lo = s * rows, m_hi = min(M, m_lo + rows);
  const size_t ld = (size_t)Nb * GB;
  const float* dgj = dg + (size_t)j * GB;

  // x column of each tile column: kept block k, column c inside it
  for (int e = tid; e < TILE; e += THREADS) {
    const int kk = k0 + e;
    xcol[e] = kk < RB ? col_idx[j * R + kk / bs] * bs + kk % bs : -1;
  }
  __syncthreads();

  auto load = [&](int stage, int slab) {
    const int m0 = m_lo + slab * BK;
    float* as = As + stage * SLAB;
    float* bs_ = Bs + stage * SLAB;
    if (VEC) {
#pragma unroll
      for (int u = 0; u < SLAB / 4 / THREADS; ++u) {
        const int c = tid + u * THREADS;
        const int r = c / (TILE / 4), e = (c % (TILE / 4)) * 4;
        const int m = m0 + r, n = n0 + e, xc = xcol[e];
        const bool in_m = m < m_hi;
        cp_async16(as + r * TILE + e, in_m && n < GB ? dgj + (size_t)m * ld + n
                                                     : dg,
                   in_m && n < GB);
        cp_async16(bs_ + r * TILE + e, in_m && xc >= 0 ? x + (size_t)m * K + xc
                                                       : x,
                   in_m && xc >= 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < SLAB / THREADS; ++u) {
        const int c = tid + u * THREADS;
        const int r = c / TILE, e = c % TILE;
        const int m = m0 + r, n = n0 + e, xc = xcol[e];
        const bool in_m = m < m_hi;
        cp_async4(as + c, in_m && n < GB ? dgj + (size_t)m * ld + n : dg,
                  in_m && n < GB);
        cp_async4(bs_ + c, in_m && xc >= 0 ? x + (size_t)m * K + xc : x,
                  in_m && xc >= 0);
      }
    }
  };

  float acc[8][8] = {};
  const int slabs = m_hi > m_lo ? (m_hi - m_lo + BK - 1) / BK : 0;
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
    slab_fma_kk(As + st * SLAB, Bs + st * SLAB, ty, tx, acc);
  }

  const size_t plane = (size_t)GB * RB;
  float* o = part ? part + ((size_t)s * Nb + j) * plane : out + j * plane;
  const float* sb = part || !sub3 ? nullptr : sub3 + j * plane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + tile_at(ty, i);
    if (n >= GB) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k0 + h * 64 + tx * 4;
      const size_t idx = (size_t)n * RB + kk;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[i][h * 4 + q];
      if (VEC) {
        if (kk >= RB) continue;
        if (sb) {
          const float4 m4 = *reinterpret_cast<const float4*>(sb + idx);
          v[0] *= m4.x; v[1] *= m4.y; v[2] *= m4.z; v[3] *= m4.w;
        }
        *reinterpret_cast<float4*>(o + idx) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (kk + q < RB) o[idx + q] = sb ? v[q] * sb[idx + q] : v[q];
      }
    }
  }
}

// out[i] = (part[0][i] + ... + part[S-1][i]) * sub3[i], in that order
__global__ void dw_reduce(const float* __restrict__ part,
                          const float* __restrict__ sub3,
                          float* __restrict__ out, size_t n, int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[s * n + i];
    out[i] = sub3 ? v * sub3[i] : v;
  }
}

template <bool VEC>
cudaError_t launch_gemm(const float* dg, const float* x, const int* col_idx,
                        const float* sub3, float* out, float* part, int M,
                        int K, int Nb, int R, int bs, int G, int splits,
                        int rows, cudaStream_t stream) {
  const cudaError_t err = allow_smem(dw_gemm<VEC>, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((R * bs + TILE - 1) / TILE, (G * bs + TILE - 1) / TILE,
                  Nb * splits);
  dw_gemm<VEC><<<grid, THREADS, SMEM, stream>>>(
      dg, x, col_idx, sub3, out, part, M, K, Nb, R, bs, G, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bs_gemm.cuh's TILE, BK and MIN_BLOCKS into out[0..2]: the wrapper plans
// the split of M (block_sparse.dw_plan) from these and the card's SMs.
void bs_gemm_config(int* out) {
  out[0] = TILE;
  out[1] = BK;
  out[2] = MIN_BLOCKS;
}

// On `stream`: dw3g (Nb, G*bs, R*bs) from dg (M, Nb*G*bs) and x (M, K);
// col_idx: (Nb*R,) int32 on the device; sub3: (Nb, G*bs, R*bs) or null.
// M is split into `splits` parts of `rows` rows (a multiple of 16); with
// splits > 1, `part` holds splits * Nb*G*bs*R*bs floats of scratch and a
// second launch sums them. vec: 16-byte loads (bs a multiple of 4, dg, x
// and sub3 16-byte aligned). Returns the first cudaError_t, 0 on success.
int block_sparse_dw(const float* dg, const float* x, const int* col_idx,
                    const float* sub3, float* out, float* part, int M, int K,
                    int Nb, int R, int bs, int G, int splits, int rows,
                    int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* p = splits > 1 ? part : nullptr;
  cudaError_t err =
      vec ? launch_gemm<true>(dg, x, col_idx, sub3, out, p, M, K, Nb, R, bs,
                              G, splits, rows, stream)
          : launch_gemm<false>(dg, x, col_idx, sub3, out, p, M, K, Nb, R, bs,
                               G, splits, rows, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)Nb * G * bs * R * bs;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  dw_reduce<<<blocks, 256, 0, stream>>>(part, sub3, out, n, splits);
  return cudaGetLastError();
}

}  // extern "C"
