// The bf16 tensor-core GEMM tiles of the port's block-sparse kernels: the
// legacy dw (block_sparse_dw.cu, dw_mma) takes the MN-major half for bf16
// operands, the legacy forward (block_sparse_v3.cu, fwd_mma) the K-major
// half, and the legacy dx (block_sparse_dx.cu, dx_mma) one operand from
// each (slab_mma_km: A K-major, B MN-major, both KM_BK = 64 k deep).
//
// A block of 256 threads, two warpgroups, owns a 128 x 128 output tile;
// warpgroup wg owns its rows wg*64 .. +64 and issues one
// wgmma.mma_async m64n128k16 (bf16 operands, float32 accumulators, 64
// floats a thread) per k16 step. That is what the TPU kernels compute
// with dot_general(bf16, bf16, preferred_element_type=float32): a bf16
// product is exact in float32 and the sums are float32, so the tensor
// cores keep the parity of a float32 FMA loop (TF32 on float32 operands
// would not, and is not used).
//
// Both operands arrive MN-major: the contraction runs along their rows
// (over M in the dw), the output rows or columns along a row. wgmma reads
// such operands straight from shared memory (imm-trans 1) when they lie
// in the canonical MN-major 128-byte-swizzled layout, so no fragment
// passes through ldmatrix and registers. Per operand and slab of BK
// k-lines: two atoms of 64 columns (SW_ATOM bytes apart), each BK/8
// groups of 8 k-lines (1 KB apart, 1 KB aligned), a k-line's eight
// 16-byte chunks stored at chunk index (chunk ^ line % 8). The kernel
// fills that layout with 16-byte cp.async copies (bs_gemm::cp_async16),
// STAGES slabs in flight, and makes each slab visible to the tensor
// cores' async proxy (fence.proxy.async) before a __syncthreads; INFLIGHT
// wgmma groups stay in flight past it, so the next slab's loads go to the
// stage read INFLIGHT + 1 slabs ago.
//
// The kernel exports TILE, BK and MIN_BLOCKS (bs_mma_config), from which
// ops/block_sparse.py plans the split of the contraction (dw_plan).
//
// The K-major half (km_offset, km_desc, slab_mma_k) is for operands whose
// contraction runs along a line: an output row of A, an output column of
// B, each contiguous in memory along k. It is wgmma's native layout
// (imm-trans 0), the canonical K-major 128-byte-swizzled one: a line holds
// KM_BK = 64 bf16 of k (128 bytes), 8 lines make a 1 KB atom, the 16-byte
// chunk e of line r stored at chunk index (e ^ r % 8), and the atoms of
// consecutive 8-line groups lie 1 KB apart (the descriptor's SBO; a
// swizzled K-major operand has no LBO). A k16 step is 32 bytes along a
// line, so the descriptor of step ks starts 32 * ks bytes into the atom
// and the hardware applies the swizzle from the address bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bs_gemm.cuh"

namespace bs_mma {

constexpr int TILE = 128;     // output rows and columns of a block
constexpr int BK = 32;        // contraction rows per slab (two k16 steps)
constexpr int STAGES = 6;     // slabs resident in shared memory
constexpr int INFLIGHT = 1;   // wgmma groups left running past a slab
constexpr int THREADS = 256;  // two warpgroups, 64 output rows each
constexpr int MIN_BLOCKS = 2; // resident blocks per SM (128 registers)
constexpr int SW_GROUP = 1024;                 // bytes of 8 k-lines
constexpr int SW_ATOM = BK / 8 * SW_GROUP;     // bytes of one 64-col atom
constexpr int SW_SLAB = 2 * SW_ATOM;           // bytes of an operand slab
// dynamic shared memory of the two operands' rings, in bytes, and the
// slack that aligns them to 1 KB
constexpr int RING_BYTES = 2 * STAGES * SW_SLAB;
constexpr int ALIGN_SLACK = 1024;

// wait until the slab `it` has landed: at most STAGES - 2 - INFLIGHT
// younger groups of this thread's copies in flight (a __syncthreads makes
// all threads' copies visible)
__device__ __forceinline__ void cp_async_wait_slab() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2 - INFLIGHT));
}

// make this thread's completed shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset in an MN-major slab of DEPTH k-lines (64-column atoms
// DEPTH / 8 KB apart) of k-line k, 16-byte chunk e (8 columns) of 16
template <int DEPTH>
__device__ __forceinline__ int mn_offset(int k, int e) {
  return (e >> 3) * (DEPTH / 8 * SW_GROUP) + (k >> 3) * SW_GROUP +
         (k & 7) * 128 + (((e & 7) ^ (k & 7)) << 4);
}
__device__ __forceinline__ int sw_offset(int k, int e) {
  return mn_offset<BK>(k, e);
}

// the matrix descriptor of an MN-major, 128-byte-swizzled operand of a
// DEPTH-line slab at shared address `addr` (1 KB aligned): LBO the stride
// of the 64-column atoms, SBO that of the 8-line k groups, both in 16-byte
// units
template <int DEPTH>
__device__ __forceinline__ unsigned long long mn_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(DEPTH / 8 * SW_GROUP >> 4) << 16) |
         ((unsigned long long)(SW_GROUP >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ unsigned long long sw_desc(unsigned addr) {
  return mn_desc<BK>(addr);
}

// d += A B for a 64 x 16 A and a 16 x 128 B, each MN-major (imm-trans 1)
// or K-major (imm-trans 0): TA for A, TB for B
template <int TA = 1, int TB = TA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 unsigned long long a,
                                                 unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// wait until at most N wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin the accumulators at this point of the program: the tensor cores
// write them asynchronously between a wgmma and its wait, so no read,
// copy or spill of them may move across a fence or a wait
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc += A^T B over one slab at shared addresses as_, bs_ (the layout
// above), warpgroup wg owning output rows wg*64 .. +64; returns with at
// most INFLIGHT of its groups in flight
__device__ __forceinline__ void slab_mma(unsigned as_, unsigned bs_, int wg,
                                         float (&acc)[64]) {
  fence_operand(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    wgmma_m64n128k16(acc, sw_desc(as_ + wg * SW_ATOM + 2 * ks * SW_GROUP),
                     sw_desc(bs_ + 2 * ks * SW_GROUP));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_wait<INFLIGHT>();
  fence_operand(acc);
}

// ---- the K-major half ----

constexpr int KM_BK = 64;     // k values of one swizzled line (128 bytes)

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset in a K-major slab of line r (an output row or column),
// 16-byte chunk e (8 k values) of KM_BK / 8
__device__ __forceinline__ int km_offset(int r, int e) {
  return (r >> 3) * SW_GROUP + (r & 7) * 128 + ((e ^ (r & 7)) << 4);
}

// the matrix descriptor of a K-major, 128-byte-swizzled operand at shared
// address `addr` (inside a 1 KB aligned atom): SBO the stride of the
// 8-line groups in 16-byte units; LBO unused (1)
__device__ __forceinline__ unsigned long long km_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((unsigned long long)(SW_GROUP >> 4) << 32) | (1ull << 62);
}

// acc += A B^T over one K-major slab of KM_BK k values at shared
// addresses as_ (A: the tile's output rows as lines) and bs_ (B: its
// output columns as lines), warpgroup wg owning output rows wg*64 .. +64
// (8 atoms in); returns with at most INFL of its groups in flight
template <int INFL>
__device__ __forceinline__ void slab_mma_k(unsigned as_, unsigned bs_,
                                           int wg, float (&acc)[64]) {
  fence_operand(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KM_BK / 16; ++ks)
    wgmma_m64n128k16<0>(acc, km_desc(as_ + wg * 8 * SW_GROUP + 32 * ks),
                        km_desc(bs_ + 32 * ks));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_wait<INFL>();
  fence_operand(acc);
}

// ---- one operand of each half ----

// acc += A B over one slab of KM_BK k values: A K-major at shared address
// as_ (the tile's output rows as lines, km_offset), B MN-major at bs_ (its
// KM_BK k-lines of 128 output columns, mn_offset<KM_BK>: atoms 8 KB
// apart), warpgroup wg owning output rows wg*64 .. +64; returns with at
// most INFL of its groups in flight. A k16 step is 32 bytes along A's
// lines and two 8-line k groups (2 KB) of B.
template <int INFL>
__device__ __forceinline__ void slab_mma_km(unsigned as_, unsigned bs_,
                                            int wg, float (&acc)[64]) {
  fence_operand(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KM_BK / 16; ++ks)
    wgmma_m64n128k16<0, 1>(acc, km_desc(as_ + wg * 8 * SW_GROUP + 32 * ks),
                           mn_desc<KM_BK>(bs_ + 2 * ks * SW_GROUP));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_wait<INFL>();
  fence_operand(acc);
}

// The tile row and column of acc[c*4 + 2*h] (acc[c*4 + 2*h + 1] is the
// next column) of thread tid: warp w of warpgroup wg holds rows wg*64 +
// w*16 .. +16, a lane rows lane/4 and lane/4 + 8, columns c*8 +
// (lane%4)*2 of every 8-column block c.
__device__ __forceinline__ int frag_row(int tid, int h) {
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + h * 8 + ((tid & 31) >> 2);
}
__device__ __forceinline__ int frag_col(int tid, int c) {
  return c * 8 + (tid & 3) * 2;
}

}  // namespace bs_mma
