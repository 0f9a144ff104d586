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
// and the level-2 submask (sub3, or none).
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
// gate's plane of ys. The dx kernel is the earlier design: a block owns
// a 64 x 64 tile of one column block of dx and sums over that column's
// kept blocks (the layout's transposed lists t_row_idx / t_perm), so no
// float atomics are needed and a column block no row keeps is written as
// zeros; it stages w_eff through the same helper as it reads it, and
// each of 256 threads keeps a 4 x 4 register tile.

#include <cuda_runtime.h>

#include "bs_gemm.cuh"

namespace {

constexpr int TM = 64;        // tile rows (M side)
constexpr int TN = 64;        // tile columns
constexpr int BK = 16;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each (dx)

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
      t[r][tx] = w_eff(wj, sj, (size_t)n * RB + kk, qscale);
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = FWD_SMEM + R * 4;
  err = vec ? g::allow_smem(v3_fwd_gemm<true>, smem)
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
