// The legacy and v3 block-sparse input gradients for Hopper (sm_90a),
// plain C interface.
//
// Replaces _make_dx and _make_dx_multi of
// pytorch_kaldi_cgs_tpu/ops/block_sparse.py (:248, :439), the legacy v1/v2
// dx over packed blocks w (nnz, G*bs, bs):
//   dx[m, col*bs + c] = sum over the kept blocks p of column block col
//                       (the layout's lists t_perm / t_row_idx, row j) of
//                       sum_{n < G*bs} gy[m, j*G*bs + n] * w[p, n, c]
// gy: (M, Nb*G*bs) (out-block j's G gate slices side by side), dx: (M, K).
// The sums are float32 and round once to gy's type; a column block no row
// keeps is written as zeros. The wrapper (block_sparse.legacy_dx_route)
// picks the kernel before the launch:
//   - gy and w float32: dx_gemm, the register-blocked tile of bs_gemm.cuh
//     (its 16-byte loads where bs is a multiple of 4 and both operands are
//     16-byte aligned, block_sparse.gemm_vec; else 4-byte ones);
//   - gy and w bf16, bs a multiple of 8, both 16-byte aligned: dx_mma, two
//     warpgroups of wgmma m64n128k16 (bf16 operands, float32 sums) on
//     bs_mma.cuh's mixed tile (slab_mma_km);
//   - anything else (the mixed pairs, bf16 at another bs or alignment):
//     block_sparse_legacy.cu's bsl_dx_tile.
//
// The operands. A block owns a 128 x 128 tile of one column block col of
// dx (rows m0.., columns c0.. of the block's bs) and contracts over
// k = e*G*bs + n for the real entries e of its share of col's list only (no
// pad block). A is gy: row m, k along a line (K-major, row 13's row-major
// A staging in float32, the forward's K-major half in bf16). B is w[p_e]
// read as (G*bs, bs): k-line n, the output columns c contiguous (MN-major:
// a k-major [BK][TILE] slab copied straight from w's rows in float32, the
// dw's MN-major half in bf16, at the forward's slab depth of 64 k values).
// With bs a multiple of 4 (float32) or 8 (bf16) a 16-byte chunk never
// straddles two entries, so each chunk finds its source from its entry
// e = k / (G*bs): the float32 tile divides once a chunk and slab; dx_mma
// keeps each of a thread's chunks' entry and offset and moves them 64 k
// on a slab, with no division in the loop (on the H100 a division a chunk
// and slab, with its 64-bit address arithmetic, made the bf16 kernel
// 1.26-1.50x slower: PERF.md). The block's entries (gy column j*G*bs and
// packed block p) sit in shared memory.
//
// The plan. The columns are uneven (at the LibriSpeech GRU's x-projection
// layout 0 to 4 kept blocks a column, at the CGS-16x LSTM's 1 to 4), so a
// block on a heavy column does up to 4x the work of one on a light column.
// The wrapper's plan (block_sparse.dx_plan, made on the host and cached)
// lists work items, heaviest first: an item is a column's entries [e0, e1)
// and a slot. The grid is (M tiles, bs tiles, items), so the blocks of the
// heaviest items are dispatched first and the light ones fill in behind
// them. Where the plan splits a heavy column's list, each part writes a
// float32 partial plane (M, bs) at its slot and dx_reduce sums a column's
// partials in part order and rounds once; unsplit columns (slot -1) write
// dx directly. No float atomics: two calls give the same bits.
//
// It also replaces _make_dx_v3 (block_sparse.py:744), the v3 dx against
// the forward's effective weight w_eff = ceil_quant(w3) * sub3 (w3 and
// sub3 (Nb, G*bs, R*bs); block_sparse_v3.cu's header): that is the legacy
// dx over the packed blocks w[j*R + k][n][c] = w_eff[j][n][k*bs + c].
// block_sparse_v3_dx runs it as two launches (three where the plan
// splits): v3_weight_packed applies the quantizer and the submask once a
// call and writes that packed w_eff into float32 scratch (6.3 MB read and
// 6.3 MB written at the libri layout, about 0.004 ms at 3.35 TB/s, and it
// stays in the 50 MB L2), then the unchanged dx_gemm over the plan's
// items (and dx_reduce). The earlier v3 tile applied the epilogue inside
// its loop, once per M tile that read a block, on a 64 x 64 tile: 1.64-1.71
// ms at the libri shape where dx_gemm ran the legacy dx in 0.61 (PERF.md).
//
// What bounds it on this card: at the LibriSpeech GRU's x-projection
// (M = 6400, K = 2048, Nb = 8, Kb = 16, R = 4, bs = 128) the dx does
// 2*M*nnz*bs^2*G FMAs, 6.7 GFLOP at G = 1 and 20.1 at G = 3: 0.100 and
// 0.300 ms of float32 FMAs at 67 TFLOP/s (TF32 would break the 1e-5 parity
// with the JAX package), so operations bound the float32 kernel; in bf16
// at 989 TFLOP/s 7-20 us against 40-68 MB moved (12-21 us at 3.35 TB/s):
// the bytes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bs_gemm.cuh"
#include "bs_mma.cuh"

namespace {

namespace g = bs_gemm;
namespace mma = bs_mma;

// dx_mma's tile: output rows and columns of a block, k values of a slab
// (one 128-byte swizzled line of A; 64 k-lines of B), slabs resident and
// resident blocks an SM (exported by dx_mma_config for the plan)
namespace dxm {
constexpr int TILE = 128;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int MIN_BLOCKS = 2;
}  // namespace dxm
static_assert(dxm::TILE == mma::TILE && dxm::BK == mma::KM_BK,
              "dx_mma's slab is a line of bs_mma.cuh's K-major half");

constexpr int DM_AHEAD = dxm::STAGES - 1;              // slabs loaded ahead
constexpr int DM_SLAB = dxm::TILE * dxm::BK * 2;       // bytes: 16 KB
constexpr int DM_RING = 2 * dxm::STAGES * DM_SLAB;
constexpr int DM_SMEM = DM_RING + mma::ALIGN_SLACK;    // + the entries
constexpr int DM_OUT_LD = dxm::TILE * 2 + 16;  // bytes of a staged output row
static_assert(dxm::TILE * DM_OUT_LD <= DM_RING,
              "the output tile is staged in the ring");

constexpr int DG_SLAB_A = g::TILE * g::ALD;            // floats
constexpr int DG_SLAB_B = g::BK * g::TILE;
constexpr int DG_SMEM = g::STAGES * (DG_SLAB_A + DG_SLAB_B) * 4;

// the block's work item and its entries into shared memory: eg[e] the gy
// column of entry e's out-block row (row * G*bs), ep[e] its packed block;
// -> (col, entries, slot)
__device__ __forceinline__ int3 load_item(const int4* __restrict__ items,
                                          const int* __restrict__ t_row_idx,
                                          const int* __restrict__ t_perm,
                                          int C, int GB, int* eg, int* ep) {
  const int4 it = items[blockIdx.z];
  for (int e = threadIdx.x; e < it.z - it.y; e += blockDim.x) {
    eg[e] = t_row_idx[it.x * C + it.y + e] * GB;
    ep[e] = t_perm[it.x * C + it.y + e];
  }
  __syncthreads();
  return make_int3(it.x, it.z - it.y, it.w);
}

// The float32 tile (bs_gemm.cuh): rows [m0, m0+128) x columns [c0, c0+128)
// of column block col, the contraction over the item's entries in slabs
// of 16 k, A = gy row-major [TILE][ALD], B = w k-major [BK][TILE]. slot < 0:
// dx, else the float32 partial plane `slot` of part (M, bs).
template <bool VEC>
__global__ void __launch_bounds__(g::THREADS, g::MIN_BLOCKS)
dx_gemm(const float* __restrict__ gy, const float* __restrict__ w,
        const int* __restrict__ t_row_idx, const int* __restrict__ t_perm,
        const int4* __restrict__ items, float* __restrict__ dx,
        float* __restrict__ part, int M, int K, int Nb, int bs, int G,
        int C) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][TILE][ALD]
  float* Bs = As + g::STAGES * DG_SLAB_A;       // [STAGES][BK][TILE]
  int* eg = reinterpret_cast<int*>(Bs + g::STAGES * DG_SLAB_B);  // [C]
  int* ep = eg + C;                                              // [C]
  const int GB = G * bs;
  const int3 it = load_item(items, t_row_idx, t_perm, C, GB, eg, ep);
  const int KT = it.y * GB;
  const int m0 = blockIdx.x * g::TILE, c0 = blockIdx.y * g::TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t ld = (size_t)Nb * GB;

  auto load = [&](int stage, int slab) {
    const int k0 = slab * g::BK;
    float* as = As + stage * DG_SLAB_A;
    float* bs_ = Bs + stage * DG_SLAB_B;
    constexpr int W = VEC ? 4 : 1;             // floats a copy
#pragma unroll
    for (int u = 0; u < g::TILE * g::BK / W / g::THREADS; ++u) {
      const int c = tid + u * g::THREADS;
      const int r = c / (g::BK / W), e = (c % (g::BK / W)) * W;
      const int m = m0 + r, kk = k0 + e;
      const bool ok = m < M && kk < KT;
      const int ei = ok ? kk / GB : 0;
      const float* src = ok ? gy + (size_t)m * ld + eg[ei] + (kk - ei * GB)
                            : gy;
      if (VEC) g::cp_async16(as + r * g::ALD + e, src, ok);
      else g::cp_async4(as + r * g::ALD + e, src, ok);
    }
#pragma unroll
    for (int u = 0; u < g::BK * g::TILE / W / g::THREADS; ++u) {
      const int c = tid + u * g::THREADS;
      const int r = c / (g::TILE / W), e = (c % (g::TILE / W)) * W;
      const int kk = k0 + r, cc = c0 + e;
      const bool ok = kk < KT && cc < bs;
      const int ei = ok ? kk / GB : 0;
      const float* src =
          ok ? w + ((size_t)ep[ei] * GB + (kk - ei * GB)) * bs + cc : w;
      if (VEC) g::cp_async16(bs_ + r * g::TILE + e, src, ok);
      else g::cp_async4(bs_ + r * g::TILE + e, src, ok);
    }
  };

  float acc[8][8] = {};
  const int slabs = (KT + g::BK - 1) / g::BK;
#pragma unroll
  for (int st = 0; st < g::STAGES - 1; ++st) {
    if (st < slabs) load(st, st);
    g::cp_async_commit();
  }
  for (int i = 0; i < slabs; ++i) {
    g::cp_async_wait_slab();
    __syncthreads();          // slab i landed; slab i-1 is computed
    const int nxt = i + g::STAGES - 1;
    if (nxt < slabs) load(nxt % g::STAGES, nxt);
    g::cp_async_commit();
    const int st = i % g::STAGES;
    g::slab_fma_mk(As + st * DG_SLAB_A, Bs + st * DG_SLAB_B, ty, tx, acc);
  }

  // a float4 of columns lies inside the block where bs is a multiple of 4
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + g::tile_at(ty, i);
    if (m >= M) continue;
    float* row = it.z < 0 ? dx + (size_t)m * K + (size_t)it.x * bs
                          : part + ((size_t)it.z * M + m) * bs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c0 + h * 64 + tx * 4;
      if (VEC) {
        if (cc < bs)
          *reinterpret_cast<float4*>(row + cc) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                          acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (cc + q < bs) row[cc + q] = acc[i][h * 4 + q];
      }
    }
  }
}

// The bf16 tile (bs_mma.cuh's slab_mma_km): two warpgroups own rows [m0,
// m0+128) x columns [c0, c0+128) of column block col and contract over
// the item's entries in slabs of 64 k. A's line m (K-major): gy[m, eg[e]
// + n]; B's k-line k = e*G*bs + n (MN-major): w[ep[e]][n][c0 ..]; 16-byte
// cp.async copies into the swizzled layouts, zeros past M, bs and the
// item's k. Three slabs resident, two loaded ahead, every slab's wgmma
// waited before the barrier that frees its stage (fwd_mma's pipeline).
// slot < 0: the tile rounded once to bf16, staged in the idle ring and
// written to dx in 16-byte chunks; else float32 pairs into partial plane
// `slot` (M, bs).
__global__ void __launch_bounds__(mma::THREADS, dxm::MIN_BLOCKS)
dx_mma(const __nv_bfloat16* __restrict__ gy,
       const __nv_bfloat16* __restrict__ w, const int* __restrict__ t_row_idx,
       const int* __restrict__ t_perm, const int4* __restrict__ items,
       __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int M, int K,
       int Nb, int bs, int G, int C) {
  extern __shared__ float4 smem4[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem4));
  const unsigned pad = (1024u - (raw & 1023u)) & 1023u;   // 1 KB atoms
  char* ring = reinterpret_cast<char*>(smem4) + pad;      // A, then B
  const unsigned sring = raw + pad;
  int* eg = reinterpret_cast<int*>(ring + DM_RING);       // [C]
  int* ep = eg + C;                                       // [C]
  const int GB = G * bs;
  const int3 it = load_item(items, t_row_idx, t_perm, C, GB, eg, ep);
  const int ne = it.y, KT = ne * GB;
  const int m0 = blockIdx.x * dxm::TILE, c0 = blockIdx.y * dxm::TILE;
  const int tid = threadIdx.x, wg = tid >> 7;
  const size_t ld = (size_t)Nb * GB;

  // A: 8 neighbouring threads copy one line's 128 bytes, chunk ea of lines
  // ra + 32u (fwd_mma's assignment: row pointers, row masks and swizzled
  // offset set once). B: 16 neighbouring threads copy one k-line's 256
  // bytes, chunk eb of k-lines rb + 16u. Each of a thread's chunks keeps
  // its entry and its offset n in it, and a slab moves them 64 k on
  // (n wraps past G*bs to the next entry): no division in the loop.
  constexpr int A_STEP = mma::THREADS / (dxm::BK / 8);   // 32 lines
  constexpr int B_STEP = mma::THREADS / (dxm::TILE / 8); // 16 k-lines
  constexpr int LINES = dxm::TILE / A_STEP;              // 4 a thread
  static_assert(dxm::BK / B_STEP == LINES, "four chunks of each operand");
  const int ea = tid % (dxm::BK / 8), ra = tid / (dxm::BK / 8);
  const int eb = tid % (dxm::TILE / 8), rb = tid / (dxm::TILE / 8);
  const __nv_bfloat16* ga = gy + (size_t)(m0 + ra) * ld;
  const __nv_bfloat16* wc = w + c0 + eb * 8;
  const size_t astep = (size_t)A_STEP * ld;
  const int a_off = mma::km_offset(ra, ea);     // + u * A_STEP / 8 atoms
  const bool b_col = c0 + eb * 8 < bs;
  unsigned a_rows = 0;                          // bit u: line u in range
#pragma unroll
  for (int u = 0; u < LINES; ++u)
    a_rows |= (m0 + ra + A_STEP * u < M ? 1u : 0u) << u;
  int a_e = ea * 8 / GB, a_n = ea * 8 - a_e * GB;
  int b_e[LINES], b_n[LINES];
#pragma unroll
  for (int u = 0; u < LINES; ++u) {
    b_e[u] = (rb + B_STEP * u) / GB;
    b_n[u] = rb + B_STEP * u - b_e[u] * GB;
  }
  auto advance = [&](int& e, int& n) {
    for (n += dxm::BK; n >= GB; n -= GB) ++e;
  };

  auto load = [&](int stage) {                  // the next slab, in order
    char* as = ring + stage * DM_SLAB + a_off;
    char* bs_ = ring + (dxm::STAGES + stage) * DM_SLAB;
    const bool in_k = a_e < ne;
    const __nv_bfloat16* xs = ga + (in_k ? eg[a_e] + a_n : 0);
#pragma unroll
    for (int u = 0; u < LINES; ++u) {
      const bool a_ok = in_k && (a_rows >> u & 1u);
      bs_gemm::cp_async16(as + u * (A_STEP / 8) * mma::SW_GROUP,
                          a_ok ? xs + u * astep : gy, a_ok);
      const bool b_ok = b_col && b_e[u] < ne;
      bs_gemm::cp_async16(
          bs_ + mma::mn_offset<dxm::BK>(rb + B_STEP * u, eb),
          b_ok ? wc + ((size_t)ep[b_e[u]] * GB + b_n[u]) * bs : w, b_ok);
      advance(b_e[u], b_n[u]);
    }
    advance(a_e, a_n);
  };

  const int slabs = (KT + dxm::BK - 1) / dxm::BK;
#pragma unroll
  for (int st = 0; st < DM_AHEAD; ++st) {
    if (st < slabs) load(st);
    bs_gemm::cp_async_commit();
  }
  float acc[64] = {};
  for (int i = 0; i < slabs; ++i) {
    mma::cp_async_wait<DM_AHEAD - 1>();
    mma::fence_async_shared();
    // slab i is visible to wgmma; every warpgroup is done with the stage
    // the next load overwrites (read one slab ago)
    __syncthreads();
    const int nxt = i + DM_AHEAD;
    if (nxt < slabs) load(nxt % dxm::STAGES);
    bs_gemm::cp_async_commit();
    const int st = i % dxm::STAGES;
    mma::slab_mma_km<0>(sring + st * DM_SLAB,
                        sring + (dxm::STAGES + st) * DM_SLAB, wg, acc);
  }
  mma::wgmma_wait<0>();
  mma::fence_operand(acc);

  if (it.z >= 0) {
    // a split part: float32 pairs (c even, bs a multiple of 8) into its
    // partial plane
    float* pp = part + (size_t)it.z * M * bs;
#pragma unroll
    for (int c = 0; c < dxm::TILE / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mma::frag_row(tid, h);
        const int cc = c0 + mma::frag_col(tid, c);
        if (m < M && cc < bs)
          *reinterpret_cast<float2*>(pp + (size_t)m * bs + cc) =
              make_float2(acc[c * 4 + 2 * h], acc[c * 4 + 2 * h + 1]);
      }
    return;
  }
  // The tile, rounded once to bf16, through the idle ring (rows DM_OUT_LD
  // bytes apart), then to dx in 16-byte chunks, 16 threads a row: chunk q
  // is columns c0 + 8q .. +8 of column block col (bs a multiple of 8).
  __syncthreads();               // every warpgroup is done with the ring
#pragma unroll
  for (int c = 0; c < dxm::TILE / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(
          ring + mma::frag_row(tid, h) * DM_OUT_LD +
          mma::frag_col(tid, c) * 2) =
          __floats2bfloat162_rn(acc[c * 4 + 2 * h], acc[c * 4 + 2 * h + 1]);
  __syncthreads();
  constexpr int OUT_CHUNKS = dxm::TILE / 8;              // 16 B chunks a row
#pragma unroll
  for (int u = 0; u < dxm::TILE * OUT_CHUNKS / mma::THREADS; ++u) {
    const int c = tid + u * mma::THREADS;
    const int r = c / OUT_CHUNKS, q = c % OUT_CHUNKS;
    const int m = m0 + r, cc = c0 + q * 8;
    if (m >= M || cc >= bs) continue;
    *reinterpret_cast<float4*>(dx + (size_t)m * K + (size_t)it.x * bs + cc) =
        *reinterpret_cast<const float4*>(ring + r * DM_OUT_LD + q * 16);
  }
}

// The v3 dx's weight pass: the effective weight of w3 (bs_gemm::w_eff)
// in the legacy packed layout dx_gemm reads, wp[j*R + k][n][c] =
// w_eff[j][n][k*bs + c], (nnz, G*bs, bs); the inverse of the forward's
// packed_weight_t mapping with v3_weight_t's epilogue. Each index of w3 in
// order, so that both reads and writes run along c.
__global__ void __launch_bounds__(256)
v3_weight_packed(const float* __restrict__ w3, const float* __restrict__ sub3,
                 float* __restrict__ wp, int GB, int R, int bs, size_t n,
                 float qscale) {
  const size_t RB = (size_t)R * bs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / RB, kk = i - row * RB;     // row = j*GB + n
    const size_t j = row / GB, nn = row - j * GB;
    const size_t k = kk / bs, c = kk - k * bs;
    wp[((j * R + k) * GB + nn) * bs + c] = g::w_eff(w3, sub3, i, qscale);
  }
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// Split columns: red[3*y .. +3] = (col, first slot, parts) of column y of
// the plan's reduce list; dx[m, col*bs + c] = the sum of its parts'
// partial planes at (m, c), in part order, rounded once to TO.
template <typename TO>
__global__ void dx_reduce(const float* __restrict__ part,
                          const int* __restrict__ red, TO* __restrict__ dx,
                          int M, int K, int bs) {
  const int col = red[3 * blockIdx.y], s0 = red[3 * blockIdx.y + 1];
  const int parts = red[3 * blockIdx.y + 2];
  const size_t n = (size_t)M * bs;
  const float* p0 = part + (size_t)s0 * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = p0[i];
    for (int s = 1; s < parts; ++s) v += p0[s * n + i];
    const size_t m = i / bs;
    store(dx + m * K + (size_t)col * bs + (i - m * bs), v);
  }
}

template <typename T>
cudaError_t run_reduce(const float* part, const int* red, T* dx, int M,
                       int K, int bs, int n_red, cudaStream_t stream) {
  const size_t n = (size_t)M * bs;
  const int blocks = (int)((n + 255) / 256 < 512 ? (n + 255) / 256 : 512);
  dx_reduce<T><<<dim3(blocks, n_red), 256, 0, stream>>>(part, red, dx, M, K,
                                                        bs);
  return cudaGetLastError();
}

// The float32 route: dx_gemm over the plan's items (vec: its 16-byte
// loads), then dx_reduce where the plan splits a column.
cudaError_t run_gemm(const float* gy, const float* w, const int* t_row_idx,
                     const int* t_perm, const int4* items, const int* red,
                     float* dx, float* part, int M, int K, int Nb, int bs,
                     int G, int C, int n_items, int n_red, int vec,
                     cudaStream_t stream) {
  static int allowed_vec[g::DEVICES], allowed_scalar[g::DEVICES];
  const int smem = DG_SMEM + 2 * C * 4;             // + the entries
  cudaError_t err =
      vec ? g::allow_smem_once(dx_gemm<true>, smem, allowed_vec)
          : g::allow_smem_once(dx_gemm<false>, smem, allowed_scalar);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + g::TILE - 1) / g::TILE, (bs + g::TILE - 1) / g::TILE,
                  n_items);
  if (vec)
    dx_gemm<true><<<grid, g::THREADS, smem, stream>>>(
        gy, w, t_row_idx, t_perm, items, dx, part, M, K, Nb, bs, G, C);
  else
    dx_gemm<false><<<grid, g::THREADS, smem, stream>>>(
        gy, w, t_row_idx, t_perm, items, dx, part, M, K, Nb, bs, G, C);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_red == 0) return err;
  return run_reduce(part, red, dx, M, K, bs, n_red, stream);
}

}  // namespace

extern "C" {

const char* pk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dx_mma's TILE, BK and MIN_BLOCKS into out[0..2]: the wrapper plans the
// bf16 route's work items (block_sparse.dx_plan) from these and the
// card's SMs.
void dx_mma_config(int* out) {
  out[0] = dxm::TILE;
  out[1] = dxm::BK;
  out[2] = dxm::MIN_BLOCKS;
}

// On `stream`: the legacy dx (M, K), in the operands' type, from gy (M,
// Nb*G*bs) and w (nnz, G*bs, bs), both float32 (dtype 0: dx_gemm; vec: its
// 16-byte loads, bs a multiple of 4, gy and w 16-byte aligned) or both
// bf16 (dtype 1: dx_mma; bs a multiple of 8, gy and w 16-byte aligned);
// t_row_idx / t_perm: the layout's (K/bs)*C lists on the device. The plan
// on the device: items (n_items x 4 int32: column, first and past-last
// entry of its list, slot or -1), heaviest first; red (n_red x 3: column,
// first slot, parts) of the split columns, whose parts write float32
// planes (M, bs) into part, summed by a second launch (dx_reduce). Every
// column block must have an item. Returns the first cudaError_t, 0 on
// success.
int block_sparse_dx_packed(const void* gy, const void* w,
                           const int* t_row_idx, const int* t_perm,
                           const int* items, const int* red, void* dx,
                           float* part, int dtype, int M, int K, int Nb,
                           int bs, int G, int C, int n_items, int n_red,
                           int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_items < 1 || n_items > 65535 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int4* it = reinterpret_cast<const int4*>(items);
  const int entries = 2 * C * 4;          // eg and ep, bytes
  cudaError_t err;
  if (dtype == 0)
    return run_gemm(static_cast<const float*>(gy),
                    static_cast<const float*>(w), t_row_idx, t_perm, it, red,
                    static_cast<float*>(dx), part, M, K, Nb, bs, G, C,
                    n_items, n_red, vec, stream);
  if (dtype == 1 && bs % 8 == 0) {
    static int allowed[g::DEVICES];
    const int smem = DM_SMEM + entries;
    err = g::allow_smem_once(dx_mma, smem, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + dxm::TILE - 1) / dxm::TILE,
                    (bs + dxm::TILE - 1) / dxm::TILE, n_items);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dx);
    dx_mma<<<grid, mma::THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(gy),
        static_cast<const __nv_bfloat16*>(w), t_row_idx, t_perm, it, o, part,
        M, K, Nb, bs, G, C);
    err = cudaGetLastError();
    if (err != cudaSuccess || n_red == 0) return err;
    return run_reduce(part, red, o, M, K, bs, n_red, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// On `stream`: the v3 dx (M, K), float32, from gy (M, Nb*G*bs) and w3
// (Nb, G*bs, R*bs), against w_eff = ceil_quant(w3) * sub3 (sub3 like w3,
// or null; qscale: 2^(bits-1) of the weight quantizer, 0 for none).
// v3_weight_packed writes w_eff packed into wp ((Nb*R, G*bs, bs) floats of
// scratch), then the float32 route of block_sparse_dx_packed over it with
// the same t_row_idx, t_perm, items, red, part and vec (gy and wp 16-byte
// aligned, bs a multiple of 4). Every column block of dx is written.
// Returns the first cudaError_t, 0 on success.
int block_sparse_v3_dx(const float* gy, const float* w3, const float* sub3,
                       float* wp, const int* t_row_idx, const int* t_perm,
                       const int* items, const int* red, float* dx,
                       float* part, int M, int K, int Nb, int R, int bs, int G,
                       int C, int n_items, int n_red, int vec, float qscale,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_items < 1 || n_items > 65535 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)Nb * G * bs * R * bs;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  v3_weight_packed<<<blocks, 256, 0, stream>>>(w3, sub3, wp, G * bs, R, bs, n,
                                               qscale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_gemm(gy, wp, t_row_idx, t_perm,
                  reinterpret_cast<const int4*>(items), red, dx, part, M, K,
                  Nb, bs, G, C, n_items, n_red, vec, stream);
}

}  // extern "C"
