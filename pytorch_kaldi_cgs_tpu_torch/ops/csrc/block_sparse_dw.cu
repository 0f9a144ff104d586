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
// the dU of the sparse fused recurrences (M = T*B) and the dw of the v3
// projections.
//
// It also replaces _make_dw and _make_dw_multi (block_sparse.py:294,
// :487), the legacy v1/v2 dw, where both operands have one type: the
// same product written in the packed (nnz, G*bs, bs) layout, column kk of
// dw3g[j] going to packed block j*R + kk/bs, column kk % bs (pack_layout
// packs block p = j*R + k). Float32 operands take dw_gemm with that
// epilogue (block_sparse_dw_packed, dtype 0); bf16 operands take dw_mma,
// the tensor-core tile of bs_mma.cuh (dtype 1), where bs is a multiple of
// 8 and both operands are 16-byte aligned; the wrapper sends every other
// case (mixed operand types, bf16 at other bs or alignment) to
// block_sparse_legacy.cu's bsl_dw_tile.
//
// What bounds it on this card: at the CGS-16x training shape (M = 4800,
// Nb = 8, G*bs = 512, R*bs = 256) it does 10.07 GFLOP of float32 FMAs
// (0.150 ms at 67 TFLOP/s without tensor cores; TF32 would break the
// 1e-5 parity with the JAX package) and moves ~103 MB (0.031 ms), so
// operations bound it. In bf16 the same work takes 0.010 ms at the
// tensor cores' 989 TFLOP/s and its bytes (~52 MB) 0.015 ms: the bytes
// bound it. The TPU kernel walked (j, m) in order with the accumulator in
// VMEM and the R gathered x blocks DMA'd per m tile.
//
// Design: the register-blocked tile of bs_gemm.cuh (float32) or the
// wgmma tile of bs_mma.cuh (bf16). A block owns one 128 x 128 tile of one
// dw3g[j] (G*bs rows, R*bs columns) and walks its share of M in slabs (16
// rows, three in flight; bf16 32 rows, six resident) with cp.async.
// Both operands are row-major along the output dimensions, so a slab is a
// plain 2-D copy into k-major shared tiles: dg's rows straight from
// memory, x's rows gathered through col_idx (the block's indices in
// shared memory, read once; a kept block is bs contiguous values, so each
// 16-byte chunk lies inside one block). The output is small and M is
// long: at the LibriSpeech GRU's dU (G = 1, R = 2) there are only 16
// tiles for 132 SMs, and the libri v3 dw's 96 fill 73% of one round of
// the 264 resident slots, so the wrapper splits M into S parts chosen
// from the shape and the card (block_sparse.dw_plan over the tile this
// library reports and the SM count: the busiest SM's rounds of resident
// blocks, a round of one block an SM at about half a full one, times the
// rows a block walks; 16, 4 there on the H100); each part writes a float32
// partial and dw_reduce sums the S partials in a fixed order, applies
// sub3 and rounds once to the output type, so two calls give the same
// bits. With S = 1 the tile's epilogue applies sub3 (or rounds) and the
// second pass is skipped.
// Where bs is not a multiple of 4 or a pointer is not 16-byte aligned
// the wrapper takes dw_gemm's scalar-load instantiation (4-byte cp.async).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bs_gemm.cuh"
#include "bs_mma.cuh"

namespace {

using namespace bs_gemm;

constexpr int SLAB = BK * TILE;                            // floats
constexpr int SMEM = 2 * STAGES * SLAB * 4 + TILE * 4;     // + x columns

// Where row n, column kk of dw3g[j] lies in j's part of the output:
// row-major (G*bs, R*bs), or (PACKED) column kk % bs of row n of packed
// block j*R + kk / bs, the legacy layout. Either way j's part starts at
// j*G*bs*R*bs.
template <bool PACKED>
__device__ __forceinline__ size_t out_at(int n, int kk, int GB, int RB,
                                         int bs) {
  return PACKED ? ((size_t)(kk / bs) * GB + n) * bs + kk % bs
                : (size_t)n * RB + kk;
}

// One tile of dw3g[j] over rows [s*rows, (s+1)*rows) of M; part null: the
// whole M, written to out (times sub3); else the float32 partial of split
// s, written to part[s]; in the layout out_at<PACKED> says.
template <bool VEC, bool PACKED>
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
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[i][h * 4 + q];
      if (VEC) {
        if (kk >= RB) continue;
        // bs is a multiple of 4: kk .. kk+3 lie in one packed block
        const size_t idx = out_at<PACKED>(n, kk, GB, RB, bs);
        if (sb) {
          const float4 m4 = *reinterpret_cast<const float4*>(sb + idx);
          v[0] *= m4.x; v[1] *= m4.y; v[2] *= m4.z; v[3] *= m4.w;
        }
        *reinterpret_cast<float4*>(o + idx) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (kk + q >= RB) continue;
          const size_t idx = out_at<PACKED>(n, kk + q, GB, RB, bs);
          o[idx] = sb ? v[q] * sb[idx] : v[q];
        }
      }
    }
  }
}

// One 128 x 128 tile of dw3g[j] from bf16 dg and x on the tensor cores
// (bs_mma.cuh: two warpgroups, wgmma from swizzled shared memory), over
// rows [s*rows, (s+1)*rows) of M, in the packed legacy layout: part null,
// the whole M rounded once to bf16 into out; else the float32 partial of
// split s into part[s]. bs is a multiple of 8 and dg, x are 16-byte
// aligned (the wrapper's route), so a 16-byte chunk of 8 columns lies
// inside one kept block and one out-block.
__global__ void __launch_bounds__(bs_mma::THREADS, bs_mma::MIN_BLOCKS)
dw_mma(const __nv_bfloat16* __restrict__ dg,
       const __nv_bfloat16* __restrict__ x, const int* __restrict__ col_idx,
       __nv_bfloat16* __restrict__ out, float* __restrict__ part, int M,
       int K, int Nb, int R, int bs, int G, int rows) {
  namespace mma = bs_mma;
  extern __shared__ float4 smem4[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const unsigned pad = (1024u - (raw & 1023u)) & 1023u;   // 1 KB atoms
  char* ring = reinterpret_cast<char*>(smem4) + pad;      // A, then B
  const unsigned sring = raw + pad;
  int* xcol = reinterpret_cast<int*>(ring + mma::RING_BYTES);
  constexpr int CHUNKS = mma::TILE / 8;               // 16-byte chunks a line
  constexpr int AHEAD = mma::STAGES - 1 - mma::INFLIGHT;  // slabs loaded ahead
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z % Nb, s = blockIdx.z / Nb;
  const int n0 = blockIdx.y * mma::TILE, k0 = blockIdx.x * mma::TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m_lo = s * rows, m_hi = min(M, m_lo + rows);
  const size_t ld = (size_t)Nb * GB;
  const __nv_bfloat16* dgj = dg + (size_t)j * GB;

  // x column of each chunk of tile columns: kept block k, column c in it
  for (int e = tid; e < CHUNKS; e += mma::THREADS) {
    const int kk = k0 + e * 8;
    xcol[e] = kk < RB ? col_idx[j * R + kk / bs] * bs + kk % bs : -1;
  }
  __syncthreads();

  auto load = [&](int stage, int slab) {
    const int m0 = m_lo + slab * mma::BK;
    char* as = ring + stage * mma::SW_SLAB;
    char* bs_ = ring + (mma::STAGES + stage) * mma::SW_SLAB;
#pragma unroll
    for (int u = 0; u < mma::BK * CHUNKS / mma::THREADS; ++u) {
      const int c = tid + u * mma::THREADS;
      const int r = c / CHUNKS, e = c % CHUNKS;
      const int m = m0 + r, n = n0 + e * 8, xc = xcol[e];
      const bool in_m = m < m_hi;
      const int off = mma::sw_offset(r, e);
      cp_async16(as + off, in_m && n < GB ? dgj + (size_t)m * ld + n : dg,
                 in_m && n < GB);
      cp_async16(bs_ + off, in_m && xc >= 0 ? x + (size_t)m * K + xc : x,
                 in_m && xc >= 0);
    }
  };

  float acc[64] = {};
  const int slabs = m_hi > m_lo ? (m_hi - m_lo + mma::BK - 1) / mma::BK : 0;
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    if (st < slabs) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < slabs; ++it) {
    mma::cp_async_wait_slab();
    mma::fence_async_shared();
    // slab `it` is visible to wgmma; every warpgroup is done with the
    // stage the next load overwrites (read INFLIGHT + 1 slabs ago)
    __syncthreads();
    const int nxt = it + AHEAD;
    if (nxt < slabs) load(nxt % mma::STAGES, nxt);
    cp_async_commit();
    const int st = it % mma::STAGES;
    mma::slab_mma(sring + st * mma::SW_SLAB,
                  sring + (mma::STAGES + st) * mma::SW_SLAB, wg, acc);
  }
  mma::wgmma_wait<0>();
  mma::fence_operand(acc);

  // two neighbouring columns (kk even, bs a multiple of 8) share a block
  const size_t base = (size_t)j * GB * RB;
  float* pp = part ? part + (size_t)s * Nb * GB * RB + base : nullptr;
#pragma unroll
  for (int c = 0; c < mma::TILE / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + mma::frag_row(tid, h);
      const int kk = k0 + mma::frag_col(tid, c);
      if (n >= GB || kk >= RB) continue;
      const size_t idx = out_at<true>(n, kk, GB, RB, bs);
      const float v0 = acc[c * 4 + 2 * h], v1 = acc[c * 4 + 2 * h + 1];
      if (pp)
        *reinterpret_cast<float2*>(pp + idx) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + base + idx) =
            __floats2bfloat162_rn(v0, v1);
    }
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// out[i] = (part[0][i] + ... + part[S-1][i]) * sub3[i], in that order,
// rounded once to TO
template <typename TO>
__global__ void dw_reduce(const float* __restrict__ part,
                          const float* __restrict__ sub3,
                          TO* __restrict__ out, size_t n, int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[s * n + i];
    store(out + i, sub3 ? v * sub3[i] : v);
  }
}

__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o);
  o2[0] = __floats2bfloat162_rn(v.x, v.y);
  o2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The same four elements a thread (n a multiple of 4, sub3 null or 16-byte
// aligned): the same sums in the same order, the S partials' float4s
// independent loads in flight
template <typename TO>
__global__ void dw_reduce(const float4* __restrict__ part,
                           const float4* __restrict__ sub3,
                           TO* __restrict__ out, size_t n4, int S) {
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += (size_t)gridDim.x * blockDim.x) {
    float4 v = part[q];
#pragma unroll 4
    for (int s = 1; s < S; ++s) {
      const float4 p = part[s * n4 + q];
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    if (sub3) {
      const float4 m = sub3[q];
      v.x *= m.x; v.y *= m.y; v.z *= m.z; v.w *= m.w;
    }
    store4(out + 4 * q, v);
  }
}

template <typename TO>
cudaError_t launch_reduce(const float* part, const float* sub3, TO* out,
                          size_t n, int splits, cudaStream_t stream) {
  if (n % 4 == 0 && reinterpret_cast<size_t>(sub3) % 16 == 0) {
    const size_t n4 = n / 4;
    const int blocks = (int)((n4 + 255) / 256 < 2048 ? (n4 + 255) / 256
                                                     : 2048);
    dw_reduce<TO><<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(part),
        reinterpret_cast<const float4*>(sub3), out, n4, splits);
    return cudaGetLastError();
  }
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  dw_reduce<TO><<<blocks, 256, 0, stream>>>(part, sub3, out, n, splits);
  return cudaGetLastError();
}

template <bool VEC, bool PACKED>
cudaError_t launch_gemm(const float* dg, const float* x, const int* col_idx,
                        const float* sub3, float* out, float* part, int M,
                        int K, int Nb, int R, int bs, int G, int splits,
                        int rows, cudaStream_t stream) {
  const cudaError_t err = allow_smem(dw_gemm<VEC, PACKED>, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((R * bs + TILE - 1) / TILE, (G * bs + TILE - 1) / TILE,
                  Nb * splits);
  dw_gemm<VEC, PACKED><<<grid, THREADS, SMEM, stream>>>(
      dg, x, col_idx, sub3, out, part, M, K, Nb, R, bs, G, rows);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t run_gemm(const float* dg, const float* x, const int* col_idx,
                     const float* sub3, float* out, float* part, int M, int K,
                     int Nb, int R, int bs, int G, int splits, int rows,
                     int vec, cudaStream_t stream) {
  float* p = splits > 1 ? part : nullptr;
  cudaError_t err =
      vec ? launch_gemm<true, PACKED>(dg, x, col_idx, sub3, out, p, M, K, Nb,
                                      R, bs, G, splits, rows, stream)
          : launch_gemm<false, PACKED>(dg, x, col_idx, sub3, out, p, M, K,
                                       Nb, R, bs, G, splits, rows, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce(part, sub3, out, (size_t)Nb * G * bs * R * bs, splits,
                       stream);
}

cudaError_t run_mma(const __nv_bfloat16* dg, const __nv_bfloat16* x,
                    const int* col_idx, __nv_bfloat16* out, float* part,
                    int M, int K, int Nb, int R, int bs, int G, int splits,
                    int rows, cudaStream_t stream) {
  constexpr int smem =
      bs_mma::RING_BYTES + bs_mma::ALIGN_SLACK + bs_mma::TILE / 8 * 4;
  cudaError_t err = allow_smem(dw_mma, smem);
  if (err != cudaSuccess) return err;
  const int T = bs_mma::TILE;
  const dim3 grid((R * bs + T - 1) / T, (G * bs + T - 1) / T, Nb * splits);
  dw_mma<<<grid, bs_mma::THREADS, smem, stream>>>(
      dg, x, col_idx, out, splits > 1 ? part : nullptr, M, K, Nb, R, bs, G,
      rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce(part, static_cast<const float*>(nullptr), out,
                       (size_t)Nb * G * bs * R * bs, splits, stream);
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

// The same of bs_mma.cuh's tensor-core tile (dw_mma).
void bs_mma_config(int* out) {
  out[0] = bs_mma::TILE;
  out[1] = bs_mma::BK;
  out[2] = bs_mma::MIN_BLOCKS;
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
  return run_gemm<false>(dg, x, col_idx, sub3, out, part, M, K, Nb, R, bs, G,
                         splits, rows, vec,
                         static_cast<cudaStream_t>(stream_ptr));
}

// On `stream`: the legacy dw (nnz, G*bs, bs), nnz = Nb*R, in the
// operands' type, from gy (M, Nb*G*bs) and x (M, K), both float32 (dtype
// 0: dw_gemm, vec as above) or both bf16 (dtype 1: dw_mma; bs a multiple
// of 8, gy and x 16-byte aligned); col_idx, splits, rows (a multiple of
// the tile's BK) and part as above. Returns the first cudaError_t.
int block_sparse_dw_packed(const void* gy, const void* x, const int* col_idx,
                           void* out, float* part, int dtype, int M, int K,
                           int Nb, int R, int bs, int G, int splits, int rows,
                           int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return run_gemm<true>(static_cast<const float*>(gy),
                          static_cast<const float*>(x), col_idx, nullptr,
                          static_cast<float*>(out), part, M, K, Nb, R, bs, G,
                          splits, rows, vec, stream);
  if (dtype == 1 && bs % 8 == 0)
    return run_mma(static_cast<const __nv_bfloat16*>(gy),
                   static_cast<const __nv_bfloat16*>(x), col_idx,
                   static_cast<__nv_bfloat16*>(out), part, M, K, Nb, R, bs, G,
                   splits, rows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
