// Shared core of the attention kernels (dense_attention.cu,
// window_attention.cu, flash_attention.cu; attention_resident.cuh builds
// on its helpers) on Hopper's tensor cores
// (sm_90a): one online-softmax forward and one backward (a dq kernel and a
// dk/dv kernel) for every layout.
//
// The head width Dh is a template parameter `D` of every helper and kernel
// (a multiple of 16). The packed-QKV kernels are instantiated for D = 64
// (ViT-S/B/L), D = 32 (the MAE decoder, 512 wide with 16 heads) and D = 80
// (the MAE ViT-H, 1280 wide with 16 heads; one warpgroup a block only, its
// tiles split into a 64-column and a 16-column part, `Swz<80>`); the flash
// kernels use the default, kDh = 64.
//
// Where the rows of a sequence live is a functor `Rows`: rows(seq, r) is the
// token index (row of the flattened (tokens, width) tensor) of row r of
// sequence seq. `DenseRows` is a (B, N, width) tensor, one sequence per
// image, and also the flash layout (BH, N, 64); `WindowRows` is one ws x ws
// window cut straight from a (B, GH, GW, width) grid, so the windowed kernels
// read and write the grid layout with no window transposes. The packed
// layouts: qkv is (tokens, 3C) with columns [q_0..q_H-1 | k.. | v..], each
// head D wide; the output is (tokens, C) with head h in columns
// [h*D, (h+1)*D); the backward writes a packed dqkv (tokens, 3C).
//
// The forward, `attn_fwd`, serves all three layouts. It does 4 N^2 D FLOPs
// per (sequence, head) against about 8 N D bytes, so from N = 197 up the
// tensor cores bound it on this card, and what holds it back from them is
// the work around the products: shared-memory traffic of the operands, the
// softmax's issue slots, and warps that wait on copies. The design:
// - a block is G warpgroups (G = 2 for the flash layout, 1 for the packed
//   ones), each on 64 query rows of one (sequence, head), so that both
//   products are Hopper's warpgroup MMA (wgmma, m64nNk16, bf16 in, f32
//   accumulate) and each warp holds 16 rows of the result;
// - K and V stream in tiles of kKeys = 64 keys through a ring of kStages = 3
//   stages in shared memory, filled by cp.async (16 B a thread, through no
//   registers) in the swizzled layout wgmma reads (`Swz`), so the copies of
//   the next tiles are in flight while one tile is multiplied, and shared
//   memory per block no longer grows with N; the G warpgroups share a tile;
// - S = Q.K^T once per key tile, Q and K read by wgmma from shared memory
//   (both K-major) into registers; the row max and sum across a fragment's
//   quad by two shuffles; exp2 of one FMA with scale * log2(e) folded in;
//   the output accumulators rescaled once per tile;
// - the unnormalised probabilities rounded to bf16 pairs in registers: the
//   accumulator layout of S is the register A layout of P.V, and wgmma
//   reads V (MN-major) transposed from shared memory. No score or
//   probability reaches shared memory;
// - the output is divided by the row sum at the end, as the TPU kernels do,
//   staged through the warp's own Q rows and stored 16 B a lane; each row's
//   log-sum-exp is written in natural log, as the backward reads it;
// - keys at or beyond n_valid are -inf before the max and the loop stops at
//   the last tile that holds a valid key, so every tile it visits has a
//   valid key in each row and no row max is -inf; query rows at or beyond N
//   read zeros and are never stored;
// - no atomics: a forward is bitwise repeatable.
// The same loop on mma.sync m16n8k16 (Q in registers, K and V by ldmatrix,
// 32 rows a warp) took 1.35-1.41x as long at the flash shape and was no
// faster at the window and dense shapes (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md, section 6).
//
// The backward does 10 N^2 D FLOPs (five products) per (sequence, head), so
// the tensor cores bound it too. It is the same machinery twice, with every
// product a wgmma and no score, probability, dP or dS in shared memory:
// - `attn_bwd_dq` walks query rows, 64 G a block: Q and dO of its rows sit
//   in shared memory, K and V stream through the forward's 3-stage ring.
//   Per key tile S = Q.K^T and dP = dO.V^T (both operands from shared
//   memory); P = exp2(fma(S, scale log2 e, -lse log2 e)) from the forward's
//   saved log-sum-exp; dS = P (dP - delta) rounded to bf16 pairs as the
//   register A operand of dQ += dS.K (K read MN-major, as the forward reads
//   V). delta = rowsum(dO * O) is computed in its prologue with 16-byte
//   loads and written for the second kernel.
// - `attn_bwd_dkv` walks key rows, 64 G a block: K and V of its rows sit in
//   shared memory, Q and dO stream through the ring with each tile's lse and
//   delta beside them. Per query tile S^T = K.Q^T and dP^T = V.dO^T; P^T
//   from each column's lse; dV += bf16(P^T).dO and dK += bf16(dS^T).Q with
//   the A operands in registers (the accumulator layout of S^T is the A
//   layout, as in the forward).
// - keys at or beyond n_valid get p = 0 before the exponent (with k zero,
//   exp(-lse) overflows for a row whose lse < -87, and inf * 0 is NaN), so
//   their dk and dv are zero; the dq loop stops at the last tile that holds
//   a valid key; query rows at or beyond N read zeros and get p = 0 (lse =
//   +inf in the dq kernel, by index in the dk/dv kernel).
// - the scale is applied to dQ and dK at the end; P and dS are rounded to
//   bf16 as the A operands, as the TPU kernels round them.
// Two kernels rather than one with atomics on dQ keep the gradients bitwise
// repeatable, at the price of seven products where five would do: S and dP
// are computed in both kernels, and so is the exponent. G is the forward's:
// 1 for the packed layouts (2 took 5-14% longer at Dh = 64 and the same at
// 32), 2 for the flash layout (1 within the spread of the calls; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md, section 6).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kDh = 64;               // default head width (flash kernels)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// One sequence per image of a (B, N, width) tensor. Every Rows functor
// gives rows(seq, r) as base(seq), taken once per block, plus offset(r).
struct DenseRows {
  int N;
  __device__ __forceinline__ size_t base(int seq) const {
    return (size_t)seq * N;
  }
  __device__ __forceinline__ int offset(int r) const { return r; }
};

// Window seq = (b * nh + wy) * nw + wx of a (B, GH, GW, width) grid; row r
// of a window sits at grid cell (wy * ws + r / ws, wx * ws + r % ws).
// r / ws is (r * ws_inv) >> 16 with ws_inv = ceil(2^16 / ws), exact while
// r * ws < 2^16, which r < ws * ws <= 512 gives.
struct WindowRows {
  int ws, nh, nw, GW;
  unsigned ws_inv;
  __device__ __forceinline__ size_t base(int seq) const {
    const int wx = seq % nw, t = seq / nw;
    const int wy = t % nh, b = t / nh;
    return ((size_t)b * nh * ws + wy * ws) * GW + wx * ws;
  }
  __device__ __forceinline__ int offset(int r) const {
    const int ry = (int)(((unsigned)r * ws_inv) >> 16);
    return ry * GW + r - ry * ws;
  }
};

// The windows of ws x ws tokens of a (B, GH, GW, width) grid
inline WindowRows window_rows(int GH, int GW, int ws) {
  return WindowRows{ws, GH / ws, GW / ws, GW,
                    (65536u + (unsigned)ws - 1) / (unsigned)ws};
}

// ---------------------------------------------------------------- forward
constexpr int kKeys = 64;         // keys per streamed K/V tile
constexpr int kStages = 3;        // K/V tiles in flight (the cp.async ring)

__device__ __forceinline__ float exp2_approx(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of a warpgroup's 64 x n product: warp w holds rows
// 16 w.., and d[j] of a lane the mma.sync m16n8 layout of columns 8 j..:
// (g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1), g = lane / 4,
// c = 2 (lane % 4). A operand in registers: per warp the m16n8k16 A layout,
// (g, c), (g + 8, c), (g, c + 8), (g + 8, c + 8) as bf16 pairs along k.
//
// S (64 x 64) = (acc ? S : 0) + A . B^T, A (64 x 16) and B (64 x 16) in
// shared memory, both K-major (rows along k contiguous).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             unsigned long long a,
                                             unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(acc));
}

// O (64 x n, n = 64 or 32) += P (64 x 16, registers) . V (16 x n in shared
// memory, MN-major: V's rows are the 16 keys, transposed by the hardware).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                             const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4],
                                             const unsigned (&a)[4],
                                             unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, "
      "{%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <int NO>
__device__ __forceinline__ void wgmma_pv(float (&d)[NO][4],
                                         const unsigned (&a)[4],
                                         unsigned long long b) {
  if constexpr (NO == 8) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n32(d, a, b);
}
// The D = 80 form, for rows [16 kk, 16 kk + 16) of the 64-row Swz<80> tile
// at `tile` read MN-major: columns 0-63 (part A) by one n64 product into
// d[0..7], columns 64-79 (part B) by one n16 product into d[8..9].
__device__ __forceinline__ void wgmma_pv80(float (&d)[10][4],
                                           const unsigned (&a)[4],
                                           const void* tile, int kk) {
  using S = Swz<80>;
  wgmma_rs_n64(reinterpret_cast<float(&)[8][4]>(d[0]), a,
               S::desc(tile) + kk * (2 * S::kAtom >> 4));
  wgmma_rs_n16(reinterpret_cast<float(&)[2][4]>(d[8]), a,
               S::desc_b(tile) + kk * (2 * S::kAtomB >> 4));
}
// S (64 x 64) += the fifth k-step (columns 64-79) of two Swz<80> tiles
__device__ __forceinline__ void wgmma_ss80_tail(float (&d)[8][4],
                                                const void* a,
                                                const void* b) {
  wgmma_ss_n64(d, Swz<80>::desc_b(a), Swz<80>::desc_b(b), 1);
}
// Products over the head's columns: the 16-column k-steps that lie in the
// 128- or 64-byte swizzle (all of them, or the first four at D = 80)
template <int D>
constexpr int kSteps = D == 80 ? 4 : D / 16;

// cp.async rows [first, first + R) of a sequence's D-wide column slice at
// src (row stride ld) into the swizzled tile at dst, by the T threads
// numbered tid = 0..T-1 (threadIdx.x without tid); rows >= limit become
// zeros (a row that meets p = 0 must not hold a NaN).
template <int D, int R, int T, class Rows>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src,
                                          int ld, Rows rows, int first,
                                          int limit, int tid) {
  constexpr int kChunks = Swz<D>::kChunks;
  static_assert(R * kChunks % T == 0, "whole copies per thread");
  static_assert(D != 80 || R == Swz<80>::kRows, "Swz<80> tiles are 64 rows");
#pragma unroll
  for (int i = 0; i < R * kChunks / T; ++i) {
    const int idx = tid + i * T;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = first + r < limit;
    cp_async16(dst + Swz<D>::offset(r, c),
               src + (size_t)(ok ? rows.offset(first + r) : 0) * ld + c * 8,
               ok);
  }
}

template <int D, int R, int T, class Rows>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src,
                                          int ld, Rows rows, int first,
                                          int limit) {
  load_rows<D, R, T>(dst, src, ld, rows, first, limit, (int)threadIdx.x);
}

// An accumulator of NJ 8-column groups as bf16 A fragments, 16 columns a
// step: the accumulator layout of S is the register A layout of the next
// product
template <int NJ>
__device__ __forceinline__ void pack_a(const float (&x)[NJ][4],
                                       unsigned (&a)[NJ / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// The warp's 16 x D accumulator rows times `mul`, as bf16, into rows
// [row0, row0 + 16) (those < limit) of the D-wide slice at dst (row stride
// ld): staged in the warp's 16 swizzled rows at `stage`, which no wgmma
// reads any more, then stored 16 B a lane.
template <int D, class Rows>
__device__ __forceinline__ void store_rows(unsigned char* stage,
                                           const float (&acc)[D / 8][4],
                                           float mul, bf16* dst, int ld,
                                           Rows rows, int row0, int limit) {
  using S = Swz<D>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(stage + S::offset(g + 8 * hf, n) +
                                         c2 * 2) =
          __floats2bfloat162_rn(acc[n][2 * hf] * mul,
                                acc[n][2 * hf + 1] * mul);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * S::kChunks; i += 32) {
    const int r = i / S::kChunks, c = i % S::kChunks;
    if (row0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)rows.offset(row0 + r) * ld +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + S::offset(r, c));
  }
}

// store_rows for D = 80: the warp's rows [trow, trow + 16) of the 64-row
// Swz<80> tile at `tile` as the stage
template <class Rows>
__device__ __forceinline__ void store_rows80(unsigned char* tile, int trow,
                                             const float (&acc)[10][4],
                                             float mul, bf16* dst, int ld,
                                             Rows rows, int row0, int limit) {
  using S = Swz<80>;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 10; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          tile + S::offset(trow + g + 8 * hf, n) + c2 * 2) =
          __floats2bfloat162_rn(acc[n][2 * hf] * mul,
                                acc[n][2 * hf + 1] * mul);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * S::kChunks; i += 32) {
    const int r = i / S::kChunks, c = i % S::kChunks;
    if (row0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)rows.offset(row0 + r) * ld +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + S::offset(trow + r, c));
  }
}

// Shared memory of a forward block of G warpgroups: Q (64 G rows), then
// kStages stages of a K and a V tile (kKeys rows each), in the swizzled
// layout, plus 1 KiB for the alignment of the first tile. At D = 64: 57 KiB
// (G = 1) and 65 KiB (G = 2); at D = 32: 29 KiB (G = 1). Whatever N.
template <int D, int G>
constexpr size_t fwd_smem() {
  return (size_t)(64 * G + kStages * 2 * kKeys) * 2 * D + 1024;
}

// grid (ceil(N / (64 G)), H, sequences), 128 G threads: warpgroup wg owns
// query rows [64 wg, 64 wg + 64) of the block, warp w of it rows 16 w.. of
// those. q, k, v point at head 0's columns of their row slices (row stride
// ld_in, head h at + h * D); o at head 0's output columns (row stride
// ld_out). Keys >= n_valid are masked; query rows >= N are not stored. lse
// is (sequences, H, N).
template <int D, int G, class Rows>
__global__ void __launch_bounds__(G * 128)
attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, int ld_in, bf16* __restrict__ o,
         int ld_out, float* __restrict__ lse, Rows rows, int N, int n_valid,
         float scale) {
  using S = Swz<D>;
  constexpr int NS = kKeys / 8, NO = D / 8, KS = kSteps<D>;
  constexpr int kRowsF = 64 * G, kThreadsF = 128 * G;
  constexpr int kTileBytes = kKeys * S::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Qs = smem;                               // kRowsF rows
  unsigned char* ring = Qs + kRowsF * S::kRowBytes;     // K, V per stage
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int q0 = blockIdx.x * kRowsF;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16;   // warpgroup, row in it
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  o += base * ld_out + h * D;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;

  // K and V rows of key tile t into stage t % kStages; keys >= n_valid are
  // zeros
  auto load_tile = [&](int t) {
    unsigned char* Kd = ring + (t % kStages) * 2 * kTileBytes;
    load_rows<D, kKeys, kThreadsF>(Kd, k, ld_in, rows, t * kKeys, n_valid);
    load_rows<D, kKeys, kThreadsF>(Kd + kTileBytes, v, ld_in, rows,
                                   t * kKeys, n_valid);
  };
  load_rows<D, kRowsF, kThreadsF>(Qs, q, ld_in, rows, q0, N);
  load_tile(0);                  // with Q: commit group 0
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // per thread: rows g and g + 8 of its warp's 16. m: raw score max; l: this
  // thread's part of the row sum (the quad's parts are added at the end)
  const unsigned char* Qg = Qs + wg * 64 * S::kRowBytes;   // this group's Q
  float acc[NO][4], sc[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;    // scale * log2(e)
  const unsigned long long dq = S::desc(Qg);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t (and Q) have landed
    // order the cp.async writes (generic proxy) before wgmma's reads (async
    // proxy), for every thread; tile t - 1 is no longer read
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* Ks = ring + (t % kStages) * 2 * kTileBytes;
    const unsigned long long dk = S::desc(Ks), dv = S::desc(Ks + kTileBytes);

    // S (64 x kKeys) = Q . K^T, 16 columns of the head (32 B) per step
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, dq + 2 * kk, dk + 2 * kk, kk);
    if constexpr (D == 80) wgmma_ss80_tail(sc, Qg, Ks);
    wg_commit();
    wg_wait0();
    wg_hold(sc);

    if ((t + 1) * kKeys > n_valid) {       // the tile that holds the last key
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * kKeys + j * 8 + c2 + e >= n_valid)
            sc[j][e] = sc[j][e + 2] = -CUDART_INF_F;
    }
    // online softmax, rows g (half 0: sc[j][0..1]) and g + 8 (half 1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float alpha = exp2_approx((m[hf] - mx) * sl2);  // 0 at t = 0
      m[hf] = mx;
      const float ms = mx * sl2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          sc[j][e] = exp2_approx(fmaf(sc[j][e], sl2, -ms));
          sum += sc[j][e];
        }
      l[hf] = l[hf] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }
    // bf16(P) as A fragments: 16 keys per step, the S layout unchanged
    unsigned pa[NS / 2][4];
    pack_a(sc, pa);
    // acc += bf16(P) . V, 16 keys (two 8-row atoms of V) per step
    wg_hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      if constexpr (D == 80) wgmma_pv80(acc, pa[kk], Ks + kTileBytes, kk);
      else wgmma_pv(acc, pa[kk], dv + kk * (2 * S::kAtom >> 4));
    wg_commit();
    wg_wait0();
    wg_hold(acc);
  }
  cp_async_wait<0>();      // only empty groups can be left
  __syncthreads();         // every wgmma read of Q is done

  // o = acc / l, staged as bf16 in the warp's own 16 Q rows, then 16 B a
  // lane; each row's log-sum-exp in natural log
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv = 1.f / sum;
    const int qrow = q0 + wg * 64 + wr + g + 8 * hf;
    if (c2 == 0 && qrow < N)
      lse[((size_t)seq * H + h) * N + qrow] = m[hf] * scale + logf(sum);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * hf] *= inv;
      acc[n][2 * hf + 1] *= inv;
    }
  }
  if constexpr (D == 80)
    store_rows80(Qs, wr, acc, 1.f, o, ld_out, rows, q0 + wr, N);
  else
    store_rows<D>(Qs + (wg * 64 + wr) * S::kRowBytes, acc, 1.f, o, ld_out,
                  rows, q0 + wg * 64 + wr, N);
}

// ---------------------------------------------------------------- backward
// s + the f32 sum of the products of 8 bf16 pairs
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float s) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// Shared memory of a backward block of G warpgroups: its own 64 G rows of
// two operands (Q and dO, or K and V), kStages stages of two streamed
// 64-row tiles (K and V, or Q and dO) in the swizzled layout, for the dk/dv
// kernel (`stats`) each stage's 64 lse and 64 delta values, and 1 KiB for
// the alignment of the first tile. Whatever N: at D = 64, dq 65 KiB and
// dk/dv 66.5 KiB (G = 1), 81 and 82.5 KiB (G = 2); at D = 32, 33 and 34.5
// KiB (G = 1).
template <int D, int G>
constexpr size_t bwd_smem(bool stats) {
  return (size_t)(2 * 64 * G + kStages * 2 * kKeys) * 2 * D +
         (stats ? kStages * 2 * kKeys * 4 : 0) + 1024;
}

// ---------------------------------------------------------------- dq
// grid (ceil(N / (64 G)), H, sequences), 128 G threads: warpgroup wg owns
// query rows [64 wg, 64 wg + 64) of the block, warp w of it rows 16 w.. of
// those. q, k, v as in attn_fwd (row stride ld_in); o (the forward's
// output) and dout at head 0's columns (row stride ld_out); dq (row stride
// ld_dq). lse and delta are (sequences, H, N); delta is written here.
template <int D, int G, class Rows>
__global__ void __launch_bounds__(G * 128)
attn_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, int ld_in, const bf16* __restrict__ o,
            const bf16* __restrict__ dout, int ld_out,
            const float* __restrict__ lse, float* __restrict__ delta,
            bf16* __restrict__ dq, int ld_dq, Rows rows, int N, int n_valid,
            float scale) {
  using S = Swz<D>;
  constexpr int NS = kKeys / 8, NO = D / 8, KS = kSteps<D>;
  constexpr int kRowsB = 64 * G, kT = 128 * G;
  constexpr int kTileBytes = kKeys * S::kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Qs = smem;                               // kRowsB rows
  unsigned char* Gs = Qs + kRowsB * S::kRowBytes;         // dO, kRowsB rows
  unsigned char* ring = Gs + kRowsB * S::kRowBytes;       // K, V per stage
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int q0 = blockIdx.x * kRowsB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16;   // warpgroup, row in it
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  o += base * ld_out + h * D;
  dout += base * ld_out + h * D;
  dq += base * ld_dq + h * D;
  const size_t stat = ((size_t)seq * H + h) * N;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;

  // K and V rows of key tile t into stage t % kStages; keys >= n_valid are
  // zeros
  auto load_tile = [&](int t) {
    unsigned char* Kd = ring + (t % kStages) * 2 * kTileBytes;
    load_rows<D, kKeys, kT>(Kd, k, ld_in, rows, t * kKeys, n_valid);
    load_rows<D, kKeys, kT>(Kd + kTileBytes, v, ld_in, rows, t * kKeys,
                            n_valid);
  };
  load_rows<D, kRowsB, kT>(Qs, q, ld_in, rows, q0, N);
  load_rows<D, kRowsB, kT>(Gs, dout, ld_out, rows, q0, N);
  load_tile(0);                  // with Q and dO: commit group 0
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // while the copies fly, for rows g and g + 8 of the warp: delta =
  // rowsum(dO * O), the quad's four lanes on a row's 16-byte chunks, and
  // -lse * log2(e); rows >= N get p = 0 (lse = +inf)
  float dl[2], nl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + wg * 64 + wr + g + 8 * hf;
    float sum = 0.f;
    if (row < N) {
      const size_t off = (size_t)rows.offset(row) * ld_out;
      for (int c = lane & 3; c < S::kChunks; c += 4)
        sum = dot8(*reinterpret_cast<const uint4*>(o + off + c * 8),
                   *reinterpret_cast<const uint4*>(dout + off + c * 8), sum);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    dl[hf] = sum;
    nl[hf] = row < N ? -lse[stat + row] * kLog2e : -CUDART_INF_F;
    if (c2 == 0 && row < N) delta[stat + row] = sum;
  }

  const float sl2 = scale * kLog2e;
  const unsigned long long dqd = S::desc(Qs + wg * 64 * S::kRowBytes);
  const unsigned long long dgd = S::desc(Gs + wg * 64 * S::kRowBytes);
  float acc[NO][4], sc[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t (and Q, dO) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // tile t - 1 is no longer read
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* Ks = ring + (t % kStages) * 2 * kTileBytes;
    const unsigned long long dk = S::desc(Ks), dv = S::desc(Ks + kTileBytes);

    // S = Q.K^T, then dP = dO.V^T as a second group, so that the exponent
    // runs while dP is multiplied
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, dqd + 2 * kk, dk + 2 * kk, kk);
    if constexpr (D == 80) wgmma_ss80_tail(sc, Qs, Ks);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, dgd + 2 * kk, dv + 2 * kk, kk);
    if constexpr (D == 80) wgmma_ss80_tail(dp, Gs, Ks + kTileBytes);
    wg_commit();
    wg_wait1();
    wg_hold(sc);
    if ((t + 1) * kKeys > n_valid) {       // the tile that holds the last key
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * kKeys + j * 8 + c2 + e >= n_valid)
            sc[j][e] = sc[j][e + 2] = -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = exp2_approx(fmaf(sc[j][e], sl2, nl[e >> 1]));
    wg_wait0();
    wg_hold(dp);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = sc[j][e] * (dp[j][e] - dl[e >> 1]);      // dS
    unsigned da[NS / 2][4];
    pack_a(dp, da);
    // dQ += bf16(dS).K, K read MN-major, 16 keys (two 8-row atoms) a step
    wg_hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      if constexpr (D == 80) wgmma_pv80(acc, da[kk], Ks, kk);
      else wgmma_pv(acc, da[kk], dk + kk * (2 * S::kAtom >> 4));
    wg_commit();
    wg_wait0();
    wg_hold(acc);
  }
  cp_async_wait<0>();      // only empty groups can be left
  __syncthreads();         // every wgmma read of Q is done
  if constexpr (D == 80)
    store_rows80(Qs, wr, acc, scale, dq, ld_dq, rows, q0 + wr, N);
  else
    store_rows<D>(Qs + (wg * 64 + wr) * S::kRowBytes, acc, scale, dq, ld_dq,
                  rows, q0 + wg * 64 + wr, N);
}

// ---------------------------------------------------------------- dk, dv
// grid (ceil(N / (64 G)), H, sequences) over KEY rows, 128 G threads:
// warpgroup wg owns key rows [64 wg, 64 wg + 64) of the block. q, k, v,
// dout as in attn_bwd_dq; dk and dv (row stride ld_dkv); lse and delta
// (sequences, H, N), delta from attn_bwd_dq.
template <int D, int G, class Rows>
__global__ void __launch_bounds__(G * 128)
attn_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, int ld_in,
             const bf16* __restrict__ dout, int ld_out,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int ld_dkv,
             Rows rows, int N, int n_valid, float scale) {
  using S = Swz<D>;
  constexpr int NS = kKeys / 8, NO = D / 8, KS = kSteps<D>;
  constexpr int kRowsB = 64 * G, kT = 128 * G;
  constexpr int kTileBytes = kKeys * S::kRowBytes;
  static_assert(kT >= 2 * kKeys, "a thread per lse and delta value");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Ks = smem;                               // kRowsB rows
  unsigned char* Vs = Ks + kRowsB * S::kRowBytes;         // kRowsB rows
  unsigned char* ring = Vs + kRowsB * S::kRowBytes;       // Q, dO per stage
  // per stage the tile's lse, then its delta
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kTileBytes);
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int k0 = blockIdx.x * kRowsB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  dout += base * ld_out + h * D;
  dk += base * ld_dkv + h * D;
  dv += base * ld_dkv + h * D;
  const size_t stat = ((size_t)seq * H + h) * N;
  lse += stat;
  delta += stat;
  // a block whose keys are all masked has zero gradients and streams nothing
  const int n_tiles = k0 < n_valid ? (N + kKeys - 1) / kKeys : 0;

  // Q and dO rows of query tile t, its lse and delta, into stage
  // t % kStages; queries >= N are zeros
  auto load_tile = [&](int t) {
    unsigned char* Qd = ring + (t % kStages) * 2 * kTileBytes;
    load_rows<D, kKeys, kT>(Qd, q, ld_in, rows, t * kKeys, N);
    load_rows<D, kKeys, kT>(Qd + kTileBytes, dout, ld_out, rows, t * kKeys,
                            N);
    if (tid < 2 * kKeys) {
      const int i = t * kKeys + tid % kKeys;
      cp_async4(stats + (t % kStages) * 2 * kKeys + tid,
                (tid < kKeys ? lse : delta) + (i < N ? i : 0), i < N);
    }
  };
  load_rows<D, kRowsB, kT>(Ks, k, ld_in, rows, k0, n_valid);
  load_rows<D, kRowsB, kT>(Vs, v, ld_in, rows, k0, n_valid);
  if (n_tiles > 0) load_tile(0);  // with K and V: commit group 0
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  const float sl2 = scale * kLog2e;
  const int key = k0 + wg * 64 + wr + g;            // rows key and key + 8
  const unsigned long long dkd = S::desc(Ks + wg * 64 * S::kRowBytes);
  const unsigned long long dvd = S::desc(Vs + wg * 64 * S::kRowBytes);
  float dka[NO][4], dva[NO][4], st[NS][4], dpt[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t (and K, V) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                // tile t - 1 is no longer read
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* Qt = ring + (t % kStages) * 2 * kTileBytes;
    const unsigned long long dqt = S::desc(Qt), dgt = S::desc(Qt + kTileBytes);
    const float* ls = stats + (t % kStages) * 2 * kKeys;   // lse, delta

    // S^T = K.Q^T, then dP^T = V.dO^T as a second group
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(st, dkd + 2 * kk, dqt + 2 * kk, kk);
    if constexpr (D == 80) wgmma_ss80_tail(st, Ks, Qt);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dpt, dvd + 2 * kk, dgt + 2 * kk, kk);
    if constexpr (D == 80) wgmma_ss80_tail(dpt, Vs, Qt + kTileBytes);
    wg_commit();
    wg_wait1();
    wg_hold(st);
    if (k0 + kRowsB > n_valid) {           // keys >= n_valid: p = 0
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (key + 8 * hf >= n_valid)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            st[j][2 * hf] = st[j][2 * hf + 1] = -CUDART_INF_F;
    }
    if ((t + 1) * kKeys > N) {             // queries >= N: p = 0
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * kKeys + j * 8 + c2 + e >= N)
            st[j][e] = st[j][e + 2] = -CUDART_INF_F;
    }
    // P^T from each query column's lse: columns 8 j + c2 and + 1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + j * 8 + c2);
      const float n0 = -l.x * kLog2e, n1 = -l.y * kLog2e;
      st[j][0] = exp2_approx(fmaf(st[j][0], sl2, n0));
      st[j][1] = exp2_approx(fmaf(st[j][1], sl2, n1));
      st[j][2] = exp2_approx(fmaf(st[j][2], sl2, n0));
      st[j][3] = exp2_approx(fmaf(st[j][3], sl2, n1));
    }
    unsigned pa[NS / 2][4];
    pack_a(st, pa);                                   // bf16(P^T)
    wg_wait0();
    wg_hold(dpt);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(ls + kKeys + j * 8 +
                                                        c2);
      dpt[j][0] = st[j][0] * (dpt[j][0] - d.x);
      dpt[j][1] = st[j][1] * (dpt[j][1] - d.y);
      dpt[j][2] = st[j][2] * (dpt[j][2] - d.x);
      dpt[j][3] = st[j][3] * (dpt[j][3] - d.y);
    }
    unsigned da[NS / 2][4];
    pack_a(dpt, da);                                  // bf16(dS^T)
    // dV += bf16(P^T).dO and dK += bf16(dS^T).Q, dO and Q read MN-major
    wg_hold(dva);
    wg_hold(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      if constexpr (D == 80) wgmma_pv80(dva, pa[kk], Qt + kTileBytes, kk);
      else wgmma_pv(dva, pa[kk], dgt + kk * (2 * S::kAtom >> 4));
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      if constexpr (D == 80) wgmma_pv80(dka, da[kk], Qt, kk);
      else wgmma_pv(dka, da[kk], dqt + kk * (2 * S::kAtom >> 4));
    wg_commit();
    wg_wait0();
    wg_hold(dva);
    wg_hold(dka);
  }
  cp_async_wait<0>();      // only empty groups can be left
  __syncthreads();         // every wgmma read of K and V is done
  // keys in [n_valid, N) store their zero gradients
  const int row0 = k0 + wg * 64 + wr;
  if constexpr (D == 80) {
    store_rows80(Ks, wr, dka, scale, dk, ld_dkv, rows, row0, N);
    store_rows80(Vs, wr, dva, 1.f, dv, ld_dkv, rows, row0, N);
  } else {
    store_rows<D>(Ks + (wg * 64 + wr) * S::kRowBytes, dka, scale, dk, ld_dkv,
                  rows, row0, N);
    store_rows<D>(Vs + (wg * 64 + wr) * S::kRowBytes, dva, 1.f, dv, ld_dkv,
                  rows, row0, N);
  }
}

// Set the dynamic shared-memory cap a kernel needs (above the 48 KB default).
template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The forward over `seqs` sequences of N rows placed by `rows`, H heads D
// wide, by blocks of G warpgroups (see attn_fwd for the pointers and
// strides).
template <int D, int G, class Rows>
cudaError_t launch_attn_fwd(const void* q, const void* k, const void* v,
                            int ld_in, void* o, int ld_out, void* lse,
                            Rows rows, int seqs, int H, int N, int n_valid,
                            float scale, void* stream) {
  static_assert(D != 80 || G == 1, "Swz<80> tiles are 64 rows");
  constexpr size_t smem = fwd_smem<D, G>();
  cudaError_t err = allow_smem(attn_fwd<D, G, Rows>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 64 * G - 1) / (64 * G), H, seqs);
  attn_fwd<D, G, Rows><<<grid, 128 * G, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld_in, (bf16*)o, ld_out,
      (float*)lse, rows, N, n_valid, scale);
  return cudaGetLastError();
}

// The packed-QKV forward: qkv (tokens, 3C) -> out (tokens, C), no key
// mask, one warpgroup per block (N <= 512 gives few key tiles per block, and
// more, smaller blocks keep the SMs busier).
template <int D = kDh, class Rows>
cudaError_t launch_packed_fwd(const void* qkv, void* out, void* lse,
                              Rows rows, int seqs, int N, int H, float scale,
                              void* stream) {
  const int C = H * D;
  const bf16* x = (const bf16*)qkv;
  return launch_attn_fwd<D, 1>(x, x + C, x + 2 * C, 3 * C, out, C, lse,
                               rows, seqs, H, N, N, scale, stream);
}

// The backward over `seqs` sequences of N rows placed by `rows`, H heads D
// wide: dq (and delta), then dk and dv, each by blocks of G warpgroups (see
// the kernels for the pointers and strides; dq, dk and dv share ld_grad).
template <int D, int G, class Rows>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            int ld_in, const void* o, const void* dout,
                            int ld_out, const void* lse, void* delta, void* dq,
                            void* dk, void* dv, int ld_grad, Rows rows,
                            int seqs, int H, int N, int n_valid, float scale,
                            void* stream) {
  static_assert(D != 80 || G == 1, "Swz<80> tiles are 64 rows");
  constexpr size_t dq_smem = bwd_smem<D, G>(false);
  constexpr size_t dkv_smem = bwd_smem<D, G>(true);
  cudaError_t err = allow_smem(attn_bwd_dq<D, G, Rows>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv<D, G, Rows>, dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 64 * G - 1) / (64 * G), H, seqs);
  cudaStream_t s = (cudaStream_t)stream;
  attn_bwd_dq<D, G, Rows><<<grid, 128 * G, dq_smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld_in, (const bf16*)o,
      (const bf16*)dout, ld_out, (const float*)lse, (float*)delta, (bf16*)dq,
      ld_grad, rows, N, n_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv<D, G, Rows><<<grid, 128 * G, dkv_smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, ld_in, (const bf16*)dout,
      ld_out, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      ld_grad, rows, N, n_valid, scale);
  return cudaGetLastError();
}

// The packed-QKV backward: qkv (tokens, 3C), out and dout (tokens, C) ->
// dqkv (tokens, 3C), no key mask, one warpgroup per block, as the forward.
template <int D = kDh, class Rows>
cudaError_t launch_packed_bwd(const void* qkv, const void* out,
                              const void* lse, const void* dout, void* delta,
                              void* dqkv, Rows rows, int seqs, int N, int H,
                              float scale, void* stream) {
  const int C = H * D;
  const bf16* x = (const bf16*)qkv;
  bf16* dx = (bf16*)dqkv;
  return launch_attn_bwd<D, 1>(x, x + C, x + 2 * C, 3 * C, out, dout, C, lse,
                               delta, dx, dx + C, dx + 2 * C, 3 * C, rows,
                               seqs, H, N, N, scale, stream);
}

}  // namespace
