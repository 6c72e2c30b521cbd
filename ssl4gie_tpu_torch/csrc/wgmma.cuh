// Hopper warpgroup-MMA (wgmma) primitives shared by the attention core
// (attention_core.cuh, attention_resident.cuh) and the GEMM core
// (gemm_core.cuh): the swizzled shared-memory tile layout wgmma reads and
// its descriptor, the fence / commit / wait of the asynchronous products,
// ldmatrix, and bf16 packing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Tiles of D-wide bf16 rows (2 D bytes) in the swizzled layout wgmma reads:
// the 16-byte chunk c of row r sits at chunk c ^ ((r / R) % (D / 8)), R = 1
// at D = 64 (the 128-byte swizzle) and 2 at D = 32 (the 64-byte swizzle);
// an atom is 8 rows (1 KiB or 512 B) and every tile starts 1 KiB-aligned.
// D = 80 is the specialisation below.
template <int D>
struct Swz {
  static constexpr int kRowBytes = 2 * D, kAtom = 8 * kRowBytes;
  static constexpr int kChunks = D / 8;
  static constexpr unsigned long long kMode = D == 64 ? 1ull : 2ull;
  __device__ __forceinline__ static int offset(int r, int c) {   // bytes
    const int phase = (r >> (D == 64 ? 0 : 1)) & (kChunks - 1);
    return r * kRowBytes + ((c ^ phase) << 4);
  }
  // Descriptor of the tile at `p`: address / 16, the stride between 8-row
  // groups (one atom) in both offset fields (the leading one is not read:
  // an operand never spans two atoms across), the swizzle mode. Adding
  // b / 16 to it moves the start b bytes on: a k-step of 16 columns is +2,
  // 16 rows of an MN-major operand are + 2 atoms / 16.
  __device__ __forceinline__ static unsigned long long desc(const void* p) {
    const unsigned long long a = (smem_u32(p) & 0x3FFFF) >> 4;
    const unsigned long long atom = kAtom >> 4;
    return a | (atom << 16) | (atom << 32) | (kMode << 62);
  }
};

// Tiles of 80-wide bf16 rows (160 bytes, 10 chunks: the MAE ViT-H's heads),
// which fit neither swizzle. Every such tile has 64 rows (the packed
// kernels' G = 1 tiles) and is split by columns: its columns 0-63 are a
// 64-row tile of Swz<64> (the 128-byte swizzle, 8 KiB), followed by its
// columns 64-79 as 64 rows of 32 bytes in the 32-byte swizzle (chunk c of
// row r at c ^ ((r / 4) % 2); an atom is 8 rows, 256 B). Each k-step of 16
// columns and each MN-major read of 16 rows then lies inside one part: the
// first four k-steps and columns 0-63 of a product read part A through
// `desc`, the fifth k-step and columns 64-79 part B through `desc_b`. No
// column is padded, so the products do no extra work.
template <>
struct Swz<80> {
  static constexpr int kRows = 64, kRowBytes = 160, kChunks = 10;
  static constexpr int kAtom = Swz<64>::kAtom;     // part A's atom
  static constexpr int kSplit = kRows * 128;       // part B, bytes on
  static constexpr int kAtomB = 8 * 32;            // part B's atom
  __device__ __forceinline__ static int offset(int r, int c) {   // bytes
    return c < 8 ? Swz<64>::offset(r, c)
                 : kSplit + r * 32 + (((c - 8) ^ ((r >> 2) & 1)) << 4);
  }
  __device__ __forceinline__ static unsigned long long desc(const void* p) {
    return Swz<64>::desc(p);
  }
  // part B of the tile at `p`: the 32-byte swizzle (mode 3), the stride
  // between 8-row groups one atom
  __device__ __forceinline__ static unsigned long long desc_b(const void* p) {
    const unsigned long long a =
        ((smem_u32(p) + kSplit) & 0x3FFFF) >> 4;
    const unsigned long long atom = kAtomB >> 4;
    return a | (atom << 16) | (atom << 32) | (3ull << 62);
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {   // all but the last group
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Four 8 x 8 b16 matrices from shared memory, lane l addressing row l % 8
// of matrix l / 8: thread t gets row t / 4, columns 2 (t % 4) and + 1 of
// each (the m16n8k16 A layout when lanes 0-15 address rows 0-15 at k 0-7
// and lanes 16-31 the same rows at k 8-15); `_trans` gives column t / 4,
// rows 2 (t % 4) and + 1, so the transpose of a tile stored row-major
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// keep the compiler from touching an accumulator across an async wgmma
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

}  // namespace
