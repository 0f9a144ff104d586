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
// accumulator in VMEM and the R gathered x blocks DMA'd per m tile. Here
// each block owns one 64 x 64 tile of one dw3g[j] and loops over M in
// slabs of 16 rows: it stages the slab's 64 dg columns and 64 gathered x
// columns (col_idx read from device memory) in shared memory, and each
// thread accumulates a 4 x 4 register tile in float32. No tensor cores,
// no pipelining: simple and right first.

#include <cuda_runtime.h>

namespace {

constexpr int TN = 64;       // tile rows (G*bs side)
constexpr int TK = 64;       // tile columns (R*bs side)
constexpr int BM = 16;       // rows of M per slab
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
dw3_tile(const float* __restrict__ dg, const float* __restrict__ x,
         const int* __restrict__ col_idx, const float* __restrict__ sub3,
         float* __restrict__ out, int M, int K, int Nb, int R, int bs,
         int G) {
  __shared__ float as[BM][TN];
  __shared__ float bs_[BM][TK];
  __shared__ int xcol[TK];
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z;
  const int n0 = blockIdx.y * TN, k0 = blockIdx.x * TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // x column of each tile column: kept block k, column c inside it
  for (int e = threadIdx.x; e < TK; e += THREADS) {
    const int kk = k0 + e;
    xcol[e] = kk < RB ? col_idx[j * R + kk / bs] * bs + kk % bs : -1;
  }
  __syncthreads();

  float acc[4][4] = {};
  const size_t ld = (size_t)Nb * GB;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int e = threadIdx.x; e < BM * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      const int m = m0 + r, n = n0 + c;
      as[r][c] = (m < M && n < GB) ? dg[(size_t)m * ld + (size_t)j * GB + n]
                                   : 0.f;
      const int xc = xcol[c];
      bs_[r][c] = (m < M && xc >= 0) ? x[(size_t)m * K + xc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < BM; ++p) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[p][ty * 4 + i];
        b[i] = bs_[p][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)j * GB * RB;
  const float* s = sub3 ? sub3 + (size_t)j * GB * RB : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= GB) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + tx * 4 + q;
      if (kk >= RB) continue;
      const size_t idx = (size_t)n * RB + kk;
      o[idx] = s ? acc[i][q] * s[idx] : acc[i][q];
    }
  }
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch on `stream`: dw3g (Nb, G*bs, R*bs) from dg (M, Nb*G*bs) and
// x (M, K); col_idx: (Nb*R,) int32 on the device; sub3: (Nb, G*bs, R*bs)
// or null. Returns the cudaError_t of the launch, 0 on success.
int block_sparse_dw(const float* dg, const float* x, const int* col_idx,
                    const float* sub3, float* out, int M, int K, int Nb,
                    int R, int bs, int G, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((R * bs + TK - 1) / TK, (G * bs + TN - 1) / TN, Nb);
  dw3_tile<<<grid, THREADS, 0, stream>>>(dg, x, col_idx, sub3, out, M, K,
                                         Nb, R, bs, G);
  return cudaGetLastError();
}

}  // extern "C"
