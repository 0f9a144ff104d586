// The v3 block-sparse projection for Hopper (sm_90a), forward and input
// gradient, plain C interface.
//
// Replaces two TPU kernels of pytorch_kaldi_cgs_tpu/ops/block_sparse.py:
//   _make_fwd_v3 (block_sparse_v3_fwd): for each out-block j of an HCGS
//     layout with R kept column blocks per block row,
//       ys[g][m, j*bs + r] = sum_{k<R, c<bs} x[m, col_idx[j*R+k]*bs + c]
//                                           * w_eff[j, g*bs + r, k*bs + c]
//   _make_dx_v3 (block_sparse_v3_dx): the input gradient against the same
//     effective weight,
//       dx[m, col*bs + c] = sum over the kept blocks (j, k) of column block
//                           col of sum_n gy[m, j*G*bs + n] * w_eff[j, n, k*bs + c]
// with w_eff = ceil_quant(w3) * sub3: the 8-bit weight quantizer (clip to
// [-1, 1], ceil of |w| * 2^(bits-1), sign restored; qscale = 0 skips it)
// and the level-2 submask (sub3, or none), applied to each weight as a
// block stages it, as the TPU kernels apply them to each streamed block.
// x: (M, K), w3 and sub3: (Nb, G*bs, R*bs), ys: (G, M, N), gy: (M,
// Nb*G*bs) (out-block j's G gate slices side by side), dx: (M, K); all
// float32. The weight gradient is block_sparse_dw.cu's.
//
// What bounds it on this card: at the LibriSpeech GRU's training shape
// (M = T*B = 6400, K = 2048, N = 1024, G = 3, Kb = 16, R = 4, bs = 128)
// each kernel does 2*M*nnz*bs^2*G = 20.1 GFLOP of float32 FMAs (0.300 ms
// at 67 TFLOP/s without tensor cores; TF32 would break the 1e-5 parity
// with the JAX package) and moves ~137 MB (0.041 ms), so operations bound
// both. Per out-block the work is a dense (M x R*bs) @ (R*bs x G*bs)
// product over the gathered columns, so each is a tiled SGEMM: a block
// owns one 64 x 64 output tile, walks the contraction in slabs of 16,
// stages the slab's gathered x (or gy) columns and its effective-weight
// rows in shared memory, and each of 256 threads keeps a 4 x 4 register
// tile. The forward gathers x through col_idx (the TPU kernel DMA'd the R
// kept blocks); dx is column-oriented: a block owns a tile of one column
// block and sums over that column's kept blocks (the layout's transposed
// lists t_row_idx / t_perm), so no float atomics are needed and a column
// block no row keeps is written as zeros (the TPU kernel accumulated a
// whole (TILE, K) row block in VMEM instead). No tensor cores, no
// pipelining: simple and right first.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // tile rows (M side)
constexpr int TN = 64;        // tile columns
constexpr int BK = 16;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// w_eff at flat index i of one out-block's (G*bs, R*bs) slice
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

// acc += as^T-slab x bs-slab for this thread's 4 x 4 tile
__device__ __forceinline__ void slab_fma(float (*as)[TM + 1],
                                         float (*bs_)[TN + 1], int ty, int tx,
                                         float (*acc)[4]) {
#pragma unroll
  for (int p = 0; p < BK; ++p) {
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
}

__global__ void __launch_bounds__(THREADS)
v3_fwd_tile(const float* __restrict__ x, const float* __restrict__ w3,
            const int* __restrict__ col_idx, const float* __restrict__ sub3,
            float* __restrict__ ys, int M, int K, int N, int R, int bs, int G,
            float qscale) {
  __shared__ float as[BK][TM + 1];   // gathered x, [kk][m]
  __shared__ float ws[BK][TN + 1];   // w_eff^T, [kk][n]
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* wj = w3 + (size_t)j * GB * RB;
  const float* sj = sub3 ? sub3 + (size_t)j * GB * RB : nullptr;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < RB; k0 += BK) {
    // consecutive threads read consecutive columns of one row
    for (int e = threadIdx.x; e < TM * BK; e += THREADS) {
      const int r = e / BK, p = e % BK;
      const int m = m0 + r, kk = k0 + p;
      float v = 0.f;
      if (m < M && kk < RB)
        v = x[(size_t)m * K + col_idx[j * R + kk / bs] * bs + kk % bs];
      as[p][r] = v;
    }
    for (int e = threadIdx.x; e < TN * BK; e += THREADS) {
      const int c = e / BK, p = e % BK;
      const int n = n0 + c, kk = k0 + p;
      ws[p][c] = (n < GB && kk < RB)
                     ? w_eff(wj, sj, (size_t)n * RB + kk, qscale)
                     : 0.f;
    }
    __syncthreads();
    slab_fma(as, ws, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n >= GB) continue;
      const int g = n / bs;
      ys[((size_t)g * M + m) * N + (size_t)j * bs + (n - g * bs)] = acc[i][q];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
v3_dx_tile(const float* __restrict__ gy, const float* __restrict__ w3,
           const int* __restrict__ t_row_idx, const int* __restrict__ t_perm,
           const float* __restrict__ sub3, float* __restrict__ dx, int M,
           int K, int Nb, int R, int bs, int G, int C, int nnz,
           float qscale) {
  __shared__ float as[BK][TM + 1];   // gy slab, [n][m]
  __shared__ float ws[BK][TN + 1];   // w_eff slab, [n][c]
  const int GB = G * bs, RB = R * bs;
  const int col = blockIdx.z;              // column block of dx
  const int m0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ld = (size_t)Nb * GB;

  float acc[4][4] = {};
  for (int e = 0; e < C; ++e) {            // the valid entries come first
    const int p = t_perm[col * C + e];
    if (p == nnz) break;
    const int j = t_row_idx[col * C + e], k = p - j * R;
    const float* wj = w3 + (size_t)j * GB * RB;
    const float* sj = sub3 ? sub3 + (size_t)j * GB * RB : nullptr;
    for (int n0 = 0; n0 < GB; n0 += BK) {
      for (int i = threadIdx.x; i < TM * BK; i += THREADS) {
        const int r = i / BK, q = i % BK;
        const int m = m0 + r, n = n0 + q;
        as[q][r] = (m < M && n < GB) ? gy[(size_t)m * ld + (size_t)j * GB + n]
                                     : 0.f;
      }
      for (int i = threadIdx.x; i < BK * TN; i += THREADS) {
        const int q = i / TN, c = i % TN;
        const int n = n0 + q, cc = c0 + c;
        ws[q][c] = (n < GB && cc < bs)
                       ? w_eff(wj, sj, (size_t)n * RB + k * bs + cc, qscale)
                       : 0.f;
      }
      __syncthreads();
      slab_fma(as, ws, ty, tx, acc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c0 + tx * 4 + q;
      if (cc < bs) dx[(size_t)m * K + (size_t)col * bs + cc] = acc[i][q];
    }
  }
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch on `stream`: ys (G, M, N) from x (M, K) and w3 (Nb, G*bs,
// R*bs); col_idx: (Nb*R,) int32 on the device; sub3: like w3, or null;
// qscale: 2^(bits-1) of the weight quantizer, 0 for none. Returns the
// cudaError_t of the launch, 0 on success.
int block_sparse_v3_fwd(const float* x, const float* w3, const int* col_idx,
                        const float* sub3, float* ys, int M, int K, int N,
                        int Nb, int R, int bs, int G, float qscale,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((M + TM - 1) / TM, (G * bs + TN - 1) / TN, Nb);
  v3_fwd_tile<<<grid, THREADS, 0, stream>>>(x, w3, col_idx, sub3, ys, M, K,
                                            N, R, bs, G, qscale);
  return cudaGetLastError();
}

// One launch on `stream`: dx (M, K) from gy (M, Nb*G*bs) and w3; the
// layout's transposed lists t_row_idx / t_perm ((K/bs)*C int32 each on the
// device, t_perm == nnz marks a pad entry); sub3 and qscale as above.
// Every column block of dx is written.
int block_sparse_v3_dx(const float* gy, const float* w3, const int* t_row_idx,
                       const int* t_perm, const float* sub3, float* dx, int M,
                       int K, int Nb, int R, int bs, int G, int C, int nnz,
                       float qscale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((M + TM - 1) / TM, (bs + TN - 1) / TN, K / bs);
  v3_dx_tile<<<grid, THREADS, 0, stream>>>(gy, w3, t_row_idx, t_perm, sub3,
                                           dx, M, K, Nb, R, bs, G, C, nnz,
                                           qscale);
  return cudaGetLastError();
}

}  // extern "C"
