// The legacy (v1/v2) block-sparse matmul for Hopper (sm_90a), forward,
// input gradient and weight gradient, plain C interface.
//
// Replaces six TPU kernels of pytorch_kaldi_cgs_tpu/ops/block_sparse.py,
// three computations each taken at G = 1 (v1) and at G > 1 (v2: G weight
// matrices stacked on one HCGS layout). With R kept blocks per block row,
// packed block p = j*R + k of out-block row j holding w_p (G*bs, bs):
//   bsl_fwd (_make_fwd, _make_fwd_multi):
//     ys[g][m, j*bs + r] = sum_{k<R, c<bs} x[m, col_idx[j*R+k]*bs + c]
//                                         * w[j*R+k, g*bs + r, c]
//   bsl_dx (_make_dx, _make_dx_multi):
//     dx[m, col*bs + c] = sum over the kept blocks p of column block col
//                         (t_perm, row t_row_idx) of
//                         sum_n gy[m, row_p*G*bs + n] * w[p, n, c]
//   bsl_dw (_make_dw, _make_dw_multi):
//     dw[p, n, c] = sum_m gy[m, row_p*G*bs + n] * x[m, col_p*bs + c]
// x: (M, K), w and dw: (nnz, G*bs, bs), ys: (G, M, N), gy: (M, Nb*G*bs)
// (out-block j's G gate slices side by side; at G = 1 it is (M, N)),
// dx: (M, K). Each operand is float32 or bfloat16 (a template over the
// two operand types); the products and the whole reduction (all R blocks,
// all of a column's entries, all of M) run in float32 FMAs and the result
// is rounded once to the output type: x's for the forward, gy's for dx and
// dw, as the TPU kernels round their float32 accumulator once.
//
// What bounds it on this card: at the LibriSpeech GRU's x-projection
// layout (bs = 128, Kb = 16, R = 4, N = 1024) and M = T*B = 6400, each
// kernel does 2*M*nnz*bs^2*G FMAs: 6.71 GFLOP at G = 1 (0.100 ms at 67
// TFLOP/s without tensor cores; TF32 would break the 1e-5 parity with the
// JAX package) against ~81 MB moved in float32 (0.024 ms), so operations
// bound all three. Each is a tiled SGEMM over gathered operands, the same
// tiling as block_sparse_v3.cu: a block owns one 64 x 64 output tile,
// walks its contraction in slabs of 16, stages the slab's two operands in
// shared memory as float32, and each of 256 threads keeps a 4 x 4 register
// tile. The TPU kernels carried a float32 accumulator in VMEM from one
// grid step to the next (grid (M/T, Nb, R) and the like); here the
// reduction is a loop inside the block, since blocks run in no order:
//   - fwd: a block owns a tile of out-block j's G*bs-wide slab and loops
//     over j's R kept blocks, x columns gathered through col_idx; it writes
//     the (G, M, N) planes directly, so no regroup follows;
//   - dx: a block owns an (M, bs) tile of one column block and loops over
//     that column's C entries, skipping the t_perm == nnz pads, so no zero
//     pad block is concatenated and no float atomics are needed; a column
//     block no row keeps is written as zeros;
//   - dw: a block owns a tile of one packed block and loops over M in
//     slabs.
// No tensor cores, no pipelining: simple and right first.
//
// None of the three is a main route any more: rows 7 and 10 (the
// forward), 8 and 11 (the dx) and 9 and 12 (the dw) run other files'
// tiles for their float32 and bf16 pairs; ops/block_sparse.py picks each
// call's kernel before the launch:
//   - the forward (legacy_fwd_route): float32 x (w float32 or bf16) runs
//     block_sparse_v3.cu's packed_weight_t + v3_fwd_gemm (row 13's
//     register-blocked tile of bs_gemm.cuh over the packed weight
//     transposed once into float32 scratch); x and w bf16, at bs a
//     multiple of 8 with both 16-byte aligned, run its fwd_mma (the K-major
//     tensor-core tile of bs_mma.cuh). bsl_fwd_tile keeps bf16 x with
//     float32 w (the JAX kernel computes that product in float32 and
//     rounds it to bf16; rounding w to bf16 would not be exact) and the
//     bf16 pairs at other bs or alignment;
//   - the dx (legacy_dx_route): both-float32 operands run
//     block_sparse_dx.cu's dx_gemm (the bs_gemm.cuh tile), both-bf16 ones,
//     at bs a multiple of 8 with gy and w 16-byte aligned, its dx_mma (gy
//     K-major, w MN-major on bs_mma.cuh's tensor cores), each over the work
//     items of block_sparse.dx_plan, which balances the uneven columns.
//     bsl_dx_tile keeps the mixed pairs (reachable only by calling bsl_dx
//     / bsl_dx_multi directly) and the bf16 pairs at other bs or
//     alignment;
//   - the dw (legacy_dw_route): both-float32 operands run
//     block_sparse_dw.cu's dw_gemm (the bs_gemm.cuh tile with a
//     packed-layout epilogue, M split as dw_plan says), both-bf16 ones, at
//     bs a multiple of 8 with gy and x 16-byte aligned, its dw_mma (the
//     MN-major tensor-core tile of bs_mma.cuh). bsl_dw_tile keeps the mixed
//     pairs (float32 gy with bf16 x, or the reverse: reachable only by
//     calling bsl_dw / bsl_dw_multi directly, since the autograd path gives
//     gy in x's type) and the bf16 pairs at other bs or alignment: float32
//     sums over all of M, rounded once to gy's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // tile rows
constexpr int TN = 64;        // tile columns
constexpr int BK = 16;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// acc += a-slab^T x b-slab for this thread's 4 x 4 tile
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

// grid (M/TM, G*bs/TN, Nb): tile [m0, m0+TM) x [n0, n0+TN) of out-block
// j's slab, n = g*bs + r
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
bsl_fwd_tile(const TX* __restrict__ x, const TW* __restrict__ w,
             const int* __restrict__ col_idx, TX* __restrict__ ys, int M,
             int K, int N, int R, int bs, int G) {
  __shared__ float as[BK][TM + 1];   // gathered x, [kk][m]
  __shared__ float ws[BK][TN + 1];   // w^T, [kk][n]
  const int GB = G * bs, RB = R * bs;
  const int j = blockIdx.z;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < RB; k0 += BK) {
    // consecutive threads read consecutive columns of one row
    for (int e = threadIdx.x; e < TM * BK; e += THREADS) {
      const int r = e / BK, q = e % BK;
      const int m = m0 + r, kk = k0 + q;
      float v = 0.f;
      if (m < M && kk < RB)
        v = to_f(x[(size_t)m * K + col_idx[j * R + kk / bs] * bs + kk % bs]);
      as[q][r] = v;
    }
    for (int e = threadIdx.x; e < TN * BK; e += THREADS) {
      const int c = e / BK, q = e % BK;
      const int n = n0 + c, kk = k0 + q;
      float v = 0.f;
      if (n < GB && kk < RB)   // block j*R + kk/bs, row n, column kk%bs
        v = to_f(w[((size_t)(j * R + kk / bs) * GB + n) * bs + kk % bs]);
      ws[q][c] = v;
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
      ys[((size_t)g * M + m) * N + (size_t)j * bs + (n - g * bs)] =
          from_f<TX>(acc[i][q]);
    }
  }
}

// grid (M/TM, bs/TN, Kb): tile [m0, m0+TM) x [c0, c0+TN) of column block col
template <typename TG, typename TW>
__global__ void __launch_bounds__(THREADS)
bsl_dx_tile(const TG* __restrict__ gy, const TW* __restrict__ w,
            const int* __restrict__ t_row_idx, const int* __restrict__ t_perm,
            TG* __restrict__ dx, int M, int K, int Nb, int bs, int G, int C,
            int nnz) {
  __shared__ float as[BK][TM + 1];   // gy slab, [n][m]
  __shared__ float ws[BK][TN + 1];   // w slab, [n][c]
  const int GB = G * bs;
  const int col = blockIdx.z;
  const int m0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ld = (size_t)Nb * GB;

  float acc[4][4] = {};
  for (int e = 0; e < C; ++e) {
    const int p = t_perm[col * C + e];
    if (p == nnz) continue;                // a pad entry: no block
    const int j = t_row_idx[col * C + e];
    const TW* wp = w + (size_t)p * GB * bs;
    for (int n0 = 0; n0 < GB; n0 += BK) {
      for (int i = threadIdx.x; i < TM * BK; i += THREADS) {
        const int r = i / BK, q = i % BK;
        const int m = m0 + r, n = n0 + q;
        as[q][r] = (m < M && n < GB)
                       ? to_f(gy[(size_t)m * ld + (size_t)j * GB + n])
                       : 0.f;
      }
      for (int i = threadIdx.x; i < BK * TN; i += THREADS) {
        const int q = i / TN, c = i % TN;
        const int n = n0 + q, cc = c0 + c;
        ws[q][c] = (n < GB && cc < bs) ? to_f(wp[(size_t)n * bs + cc]) : 0.f;
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
      if (cc < bs)
        dx[(size_t)m * K + (size_t)col * bs + cc] = from_f<TG>(acc[i][q]);
    }
  }
}

// grid (bs/TN, G*bs/TM, nnz): tile [n0, n0+TM) x [c0, c0+TN) of block p
template <typename TG, typename TX>
__global__ void __launch_bounds__(THREADS)
bsl_dw_tile(const TG* __restrict__ gy, const TX* __restrict__ x,
            const int* __restrict__ rows, const int* __restrict__ cols,
            TG* __restrict__ dw, int M, int K, int Nb, int bs, int G) {
  __shared__ float as[BK][TM + 1];   // gy slab, [m][n]
  __shared__ float xs[BK][TN + 1];   // x slab, [m][c]
  const int GB = G * bs;
  const int p = blockIdx.z;
  const int n0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t ld = (size_t)Nb * GB;
  const size_t gcol = (size_t)rows[p] * GB, xcol = (size_t)cols[p] * bs;

  float acc[4][4] = {};
  for (int m0 = 0; m0 < M; m0 += BK) {
    for (int e = threadIdx.x; e < BK * TM; e += THREADS) {
      const int r = e / TM, c = e % TM;
      const int m = m0 + r, n = n0 + c;
      as[r][c] = (m < M && n < GB) ? to_f(gy[(size_t)m * ld + gcol + n])
                                   : 0.f;
    }
    for (int e = threadIdx.x; e < BK * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      const int m = m0 + r, cc = c0 + c;
      xs[r][c] = (m < M && cc < bs) ? to_f(x[(size_t)m * K + xcol + cc])
                                    : 0.f;
    }
    __syncthreads();
    slab_fma(as, xs, ty, tx, acc);
    __syncthreads();
  }

  TG* o = dw + (size_t)p * GB * bs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= GB) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = c0 + tx * 4 + q;
      if (cc < bs) o[(size_t)n * bs + cc] = from_f<TG>(acc[i][q]);
    }
  }
}

// dtype codes of the C interface: 0 float32, 1 bfloat16
template <template <typename, typename> class Launch, typename... Args>
int dispatch(int ta, int tb, Args... args) {
  if (ta == 0 && tb == 0) return Launch<float, float>::run(args...);
  if (ta == 0 && tb == 1) return Launch<float, __nv_bfloat16>::run(args...);
  if (ta == 1 && tb == 0) return Launch<__nv_bfloat16, float>::run(args...);
  if (ta == 1 && tb == 1)
    return Launch<__nv_bfloat16, __nv_bfloat16>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX, typename TW>
struct FwdLaunch {
  static int run(const void* x, const void* w, const int* col_idx, void* ys,
                 int M, int K, int N, int Nb, int R, int bs, int G,
                 cudaStream_t stream) {
    const dim3 grid((M + TM - 1) / TM, (G * bs + TN - 1) / TN, Nb);
    bsl_fwd_tile<TX, TW><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), col_idx,
        static_cast<TX*>(ys), M, K, N, R, bs, G);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TG, typename TW>
struct DxLaunch {
  static int run(const void* gy, const void* w, const int* t_row_idx,
                 const int* t_perm, void* dx, int M, int K, int Nb, int bs,
                 int G, int C, int nnz, cudaStream_t stream) {
    const dim3 grid((M + TM - 1) / TM, (bs + TN - 1) / TN, K / bs);
    bsl_dx_tile<TG, TW><<<grid, THREADS, 0, stream>>>(
        static_cast<const TG*>(gy), static_cast<const TW*>(w), t_row_idx,
        t_perm, static_cast<TG*>(dx), M, K, Nb, bs, G, C, nnz);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TG, typename TX>
struct DwLaunch {
  static int run(const void* gy, const void* x, const int* rows,
                 const int* cols, void* dw, int M, int K, int Nb, int nnz,
                 int bs, int G, cudaStream_t stream) {
    const dim3 grid((bs + TN - 1) / TN, (G * bs + TM - 1) / TM, nnz);
    bsl_dw_tile<TG, TX><<<grid, THREADS, 0, stream>>>(
        static_cast<const TG*>(gy), static_cast<const TX*>(x), rows, cols,
        static_cast<TG*>(dw), M, K, Nb, bs, G);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One launch on `stream`: ys (G, M, N), in x's type, from x (M, K) and w
// (nnz, G*bs, bs); col_idx: (Nb*R,) int32 on the device; tx / tw: the
// dtype codes of x and w. Returns the cudaError_t of the launch, 0 on
// success.
int bsl_fwd(const void* x, const void* w, const int* col_idx, void* ys,
            int tx, int tw, int M, int K, int N, int Nb, int R, int bs, int G,
            void* stream_ptr) {
  return dispatch<FwdLaunch>(tx, tw, x, w, col_idx, ys, M, K, N, Nb, R, bs,
                             G, static_cast<cudaStream_t>(stream_ptr));
}

// One launch on `stream`: dx (M, K), in gy's type, from gy (M, Nb*G*bs)
// and w; the layout's transposed lists t_row_idx / t_perm ((K/bs)*C int32
// each on the device, t_perm == nnz marks a pad entry). Every column block
// of dx is written.
int bsl_dx(const void* gy, const void* w, const int* t_row_idx,
           const int* t_perm, void* dx, int tg, int tw, int M, int K, int Nb,
           int bs, int G, int C, int nnz, void* stream_ptr) {
  return dispatch<DxLaunch>(tg, tw, gy, w, t_row_idx, t_perm, dx, M, K, Nb,
                            bs, G, C, nnz,
                            static_cast<cudaStream_t>(stream_ptr));
}

// One launch on `stream`: dw (nnz, G*bs, bs), in gy's type, from gy (M,
// Nb*G*bs) and x (M, K); rows / cols: (nnz,) int32 on the device, each
// packed block's out-block row and in-block column.
int bsl_dw(const void* gy, const void* x, const int* rows, const int* cols,
           void* dw, int tg, int tx, int M, int K, int Nb, int nnz, int bs,
           int G, void* stream_ptr) {
  return dispatch<DwLaunch>(tg, tx, gy, x, rows, cols, dw, M, K, Nb, nnz, bs,
                            G, static_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
