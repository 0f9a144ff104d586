// The register-blocked float32 GEMM tile shared by the block-sparse dw
// kernel (block_sparse_dw.cu), the v3 forward (block_sparse_v3.cu), the
// legacy and v3 dx (block_sparse_dx.cu), and the dense recurrences'
// rebuild product (rec_gemm.cuh).
//
// A block of 256 threads owns a 128 x 128 output tile; each thread keeps
// an 8 x 8 register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
// columns tx*4 + {0..3} and 64 + tx*4 + {0..3} (tx = tid % 16, ty = tid /
// 16), so it reads both operands as float4 (LDS.128), 4 loads for every
// 64 FMAs. The contraction is staged in slabs of BK rows, STAGES slabs in
// flight with cp.async (16 bytes a thread where the shape allows it, 4
// otherwise; a copy past the edge of an operand fills zeros): the next
// slabs arrive while the current one computes, one __syncthreads a slab.
// Float32 FMAs with float32 sums: TF32 would break the 1e-5 parity with
// the JAX package. block_sparse_dw.cu exports TILE, BK and MIN_BLOCKS
// (bs_gemm_config), from which ops/block_sparse.py plans the dw's grid.

#pragma once

#include <cuda_runtime.h>

namespace bs_gemm {

constexpr int TILE = 128;     // output rows and columns of a block
constexpr int BK = 16;        // contraction rows per slab
constexpr int STAGES = 3;     // slabs in flight
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int MIN_BLOCKS = 2; // resident blocks per SM (128 registers)

// The v3 projection's effective weight at flat index i of one out-block's
// (G*bs, R*bs) slice of w3: ceil_quant(w) (clip to [-1, 1], ceil of |w| *
// qscale, sign restored; qscale = 0 skips it) times the submask (or
// none). The weight passes of the v3 forward (block_sparse_v3.cu) and dx
// (block_sparse_dx.cu) apply it once a call.
__device__ __forceinline__ float w_eff(const float* __restrict__ w,
                                       const float* __restrict__ sub, size_t i,
                                       float qscale) {
  float v = w[i];
  if (qscale > 0.f) {
    v = fminf(fmaxf(v, -1.f), 1.f);
    const float s = v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
    v = s * (ceilf(fabsf(v) * qscale) / qscale);
  }
  return sub ? v * sub[i] : v;
}

// the row (or column) of a thread's i-th register row (column), i < 8
__device__ __forceinline__ int tile_at(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

// cp.async of 16 (or 4) bytes; src_ok false fills zeros (src-size 0) and
// reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool src_ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool src_ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups are in flight: the oldest slab
// has landed (this thread's copies; a __syncthreads makes all visible)
__device__ __forceinline__ void cp_async_wait_slab() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// b[0..7] <- row p of a k-major slab [BK][TILE] at this thread's columns
__device__ __forceinline__ void load8(const float* slab, int p, int t,
                                      float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(slab + p * TILE + t * 4);
  const float4 hi =
      *reinterpret_cast<const float4*>(slab + p * TILE + 64 + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc += A^T B over one slab, both k-major: as [BK][TILE] (rows of the
// output along TILE), bs [BK][TILE] (columns)
__device__ __forceinline__ void slab_fma_kk(const float* as, const float* bs,
                                            int ty, int tx,
                                            float (*acc)[8]) {
#pragma unroll
  for (int p = 0; p < BK; ++p) {
    float a[8], b[8];
    load8(as, p, ty, a);
    load8(bs, p, tx, b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
  }
}

// acc += A B over one slab, A row-major along the contraction: as
// [TILE][BK + APAD] (one output row per line), bs [BK][TILE] k-major.
// Each float4 of A carries 4 contraction steps of one row.
constexpr int APAD = 4;       // keeps rows 4 apart on other banks
constexpr int ALD = BK + APAD;

__device__ __forceinline__ void slab_fma_mk(const float* as, const float* bs,
                                            int ty, int tx,
                                            float (*acc)[8]) {
#pragma unroll
  for (int p0 = 0; p0 < BK; p0 += 4) {
    float4 a4[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a4[i] = *reinterpret_cast<const float4*>(as + tile_at(ty, i) * ALD + p0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[8];
      load8(bs, p0 + q, tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = comp(a4[i], q);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
      }
    }
  }
}

// the dynamic shared memory of a kernel above 48 KB
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the same, raised on each device to the largest size asked for once, not
// on every call: `allowed` is the kernel's own record, DEVICES entries (a
// second thread setting the attribute again is harmless)
constexpr int DEVICES = 64;
template <typename K>
inline cudaError_t allow_smem_once(K kernel, int bytes, int* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < DEVICES && allowed[dev] >= bytes) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace bs_gemm
