// Device helpers shared by the block-sparse recurrences whose G gates all
// multiply one packed w3g (Nb, G*bs, R*bs) (fused_gru_sparse.cu, G=3;
// fused_ligru_sparse.cu, G=2): the forward's staging of q(v) at an
// out-block's kept columns and its per-row dots, and the backward's
// column lists, cotangent staging and per-column transposed dots.
//
// A block owns BT batch rows; the forward's rows of w3g and the
// backward's units are split over its WARPS warps, each dot reduced over
// the warp's lanes with shuffles. Out-block j holds gate g's rows at
// g*bs.. in w3g; w3t is w3g transposed per block, (Nb, R*bs, G*bs), so
// the backward's lanes read consecutive addresses. A transposed product
// gathers per block column from the layout's column lists (t_row_idx,
// t_perm; a pad entry has t_perm == nnz): no float atomics, and a
// deterministic sum.

#pragma once

#include "lstm_common.cuh"

namespace {

constexpr int BT = 8;               // batch rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BWD_UNITS = 8;        // units per backward block
constexpr int MAX_C = 64;           // entries per column list

// Stage q(v) at the R*bs gathered columns of out-block j for nb batch
// rows from b0: sm[b][k*bs + c] = q(v[b0+b, col_idx[j*R+k]*bs + c]);
// v == nullptr stages zeros; no quantizer when scale is null.
template <bool BF16>
__device__ __forceinline__ void stage_cols(const float* __restrict__ v,
                                           const int* __restrict__ col_idx,
                                           int j, int b0, int nb, int H, int R,
                                           int bs, const unsigned* scale,
                                           float qscale, float* sm) {
  const int K3 = R * bs;
  const float var = scale ? __uint_as_float(*scale) : 0.f;
  for (int e = threadIdx.x; e < nb * K3; e += THREADS) {
    const int b = e / K3, kk = e - b * K3, k = kk / bs;
    const int col = col_idx[j * R + k] * bs + (kk - k * bs);
    float x = v ? v[(size_t)(b0 + b) * H + col] : 0.f;
    if (scale) x = quant(x, var, qscale);
    sm[e] = BF16 ? round_bf16(x) : x;
  }
}

// usm[b][r] = dot(w3g row, sm[b]) for the NR rows of a block: row r is
// gate (gate0 + r / UNITS) of unit u0 + r % UNITS. One warp per row, lanes
// over the R*bs kept columns, then a shuffle reduction.
template <bool BF16, int G, int UNITS, int NR>
__device__ __forceinline__ void row_dots(const void* __restrict__ w3g,
                                         const float* sm, int j, int u0,
                                         int gate0, int nb, int H, int K3,
                                         int bs, float (*usm)[NR]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < NR; r += WARPS) {
    const int g = gate0 + r / UNITS, unit = u0 + r % UNITS;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (unit < H) {
      const size_t row = ((size_t)j * G * bs + g * bs + (unit - j * bs)) * K3;
      for (int kk = lane; kk < K3; kk += 32) {
        const float w = load_w<BF16>(w3g, row + kk);
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) acc[b] = fmaf(sm[b * K3 + kk], w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) usm[b][r] = v;
    }
  }
}

// Fold this thread's max bits into *slot (one atomic per warp).
__device__ __forceinline__ void slot_max(unsigned m, unsigned* slot) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(slot, m);
}

// List the kept blocks (j, k) of block column blk into ent_j / ent_k (the
// valid entries come first); returns their count.
__device__ __forceinline__ int column_entries(const int* __restrict__ t_row_idx,
                                              const int* __restrict__ t_perm,
                                              int blk, int C, int R, int nnz,
                                              int* ent_j, int* ent_k) {
  int nv = 0;
  for (int e = 0; e < C; ++e) {
    const int p = t_perm[blk * C + e];
    if (p == nnz) break;
    if (threadIdx.x == 0) {
      ent_j[e] = t_row_idx[blk * C + e];
      ent_k[e] = p - t_row_idx[blk * C + e] * R;
    }
    ++nv;
  }
  return nv;
}

// Stage the cotangents of gates gate0.. gate0+NG-1 (of dg's G) at the kept
// out-blocks of this block column: dgsm[b][kk*NG*bs + g*bs + r] =
// dg[b0+b, (gate0+g)*H + ent_j[kk]*bs + r] (bf16-rounded under BF16; rows
// C*NG*bs apart).
template <bool BF16, int G, int NG>
__device__ __forceinline__ void stage_dg(const float* __restrict__ dg,
                                         const int* ent_j, int nv, int C,
                                         int gate0, int b0, int nb, int H,
                                         int bs, float* dgsm) {
  const int GB = NG * bs, W = C * GB;
  for (int e = threadIdx.x; e < nb * nv * GB; e += THREADS) {
    const int b = e / (nv * GB), rr = e - b * nv * GB;
    const int kk = rr / GB, q = rr - kk * GB, g = q / bs;
    const float v = dg[(size_t)(b0 + b) * G * H + (gate0 + g) * H +
                       ent_j[kk] * bs + (q - g * bs)];
    dgsm[b * W + kk * GB + q] = BF16 ? round_bf16(v) : v;
  }
}

// dsm[b][jj] = the transposed product for unit u0 + jj of block column
// blk: sum over the kept blocks kk and the NG*bs staged cotangent columns q
// of dgsm[b][kk*NG*bs + q] * w3t[ent_j, ent_k*bs + cc, gate0*bs + q].
template <bool BF16, int G, int NG>
__device__ __forceinline__ void col_dots(const void* __restrict__ w3t,
                                         const float* dgsm, const int* ent_j,
                                         const int* ent_k, int nv, int C,
                                         int blk, int u0, int gate0, int nb,
                                         int H, int K3, int bs,
                                         float (*dsm)[BWD_UNITS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int GB = NG * bs, W = C * GB;
  for (int jj = warp; jj < BWD_UNITS; jj += WARPS) {
    const int cc = u0 + jj - blk * bs;
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;
    if (u0 + jj < H) {
      for (int kk = 0; kk < nv; ++kk) {
        const size_t row =
            ((size_t)ent_j[kk] * K3 + ent_k[kk] * bs + cc) * G * bs +
            gate0 * bs;
        for (int q = lane; q < GB; q += 32) {
          const float w = load_w<BF16>(w3t, row + q);
#pragma unroll
          for (int b = 0; b < BT; ++b)
            if (b < nb) acc[b] = fmaf(dgsm[b * W + kk * GB + q], w, acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) dsm[b][jj] = v;
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
