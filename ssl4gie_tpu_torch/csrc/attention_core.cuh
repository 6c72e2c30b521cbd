// Shared core of the attention kernels (dense_attention.cu,
// window_attention.cu, flash_attention.cu) on Hopper's tensor cores
// (sm_90a): one online-softmax forward for every layout, and the packed-QKV
// dq / dk-dv backward kernels for sequences of at most 512 rows.
//
// The head width Dh is a template parameter `D` of every helper and kernel
// (a multiple of 16). The packed-QKV kernels are instantiated for D = 64
// (ViT-S/B/L) and D = 32 (the MAE decoder, 512 wide with 16 heads); the
// flash kernels use the default, kDh = 64.
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
// The backward: WMMA 16x16x16 products (bf16 in, f32 accumulate) between a
// warp's 16 rows and staged D-wide row slices, the softmax elementwise in
// f32 through a per-warp tile in shared memory. One block of 4 warps per
// (64-row tile, head, sequence); the head's whole K and V (or Q and dO for
// the dK/dV kernel) are staged once into shared memory, rows zero-padded to
// whole 32-row chunks and padded to D + 8 values; each warp owns 16 rows and
// walks the other sequence in chunks of 32. Keys >= N are masked by index.
// It is two kernels instead of atomics (run-to-run nondeterministic):
// `attn_bwd_dq` walks query rows, computes delta = rowsum(dO * O) and dq;
// `attn_bwd_dkv` walks key rows and recomputes P from the saved log-sum-exp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "async_copy.cuh"

namespace {

using namespace nvcuda;

constexpr int kDh = 64;               // default head width (flash kernels)
// bf16 row of a staged D-wide slice (72 at D = 64, 40 at D = 32)
template <int D> constexpr int kLdRow = D + 8;
// f32 output staging row (68 at D = 64, 36 at D = 32)
template <int D> constexpr int kLdOut = D + 4;
constexpr int kLd = kLdRow<kDh>;
constexpr int kChunk = 32;            // keys (or queries) per inner step
constexpr int kLdS = kChunk + 4;      // f32 score tile row (16 x 36)
constexpr int kLdP = kChunk + 8;      // bf16 probability tile row (16 x 40)
// per-warp f32 area: two score tiles, also the output staging area
constexpr int kTileF = 2 * 16 * kLdS;
static_assert(kTileF >= 16 * kLdOut<kDh>,
              "output staging must fit two score tiles");
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;    // rows a block owns
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
// B = X^T for X stored row-major [n][k] (scores against staged rows)
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
// B = X for X stored row-major [k][n]
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

inline int pad_rows(int n) { return (n + kChunk - 1) / kChunk * kChunk; }

// One sequence per image of a (B, N, width) tensor. Every Rows functor
// splits rows(seq, r) into base(seq), once per block, and offset(r).
struct DenseRows {
  int N;
  __device__ __forceinline__ size_t base(int seq) const {
    return (size_t)seq * N;
  }
  __device__ __forceinline__ int offset(int r) const { return r; }
  __device__ __forceinline__ size_t operator()(int seq, int r) const {
    return base(seq) + offset(r);
  }
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
  __device__ __forceinline__ size_t operator()(int seq, int r) const {
    return base(seq) + offset(r);
  }
};

// Rows [first, first + count) of sequence `seq` of a D-wide column slice
// starting at `src` (row stride `stride` elements) into shared memory with
// row length kLdRow<D>; rows >= n_valid become zeros. 16-byte pieces, D / 8
// per row.
template <int D = kDh, class Rows>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, Rows rows,
                                      int seq, int first, int count,
                                      int n_valid, int stride) {
  constexpr int kPieces = D / 8;
  for (int idx = threadIdx.x; idx < count * kPieces; idx += blockDim.x) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const int g = first + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < n_valid)
      v = *reinterpret_cast<const uint4*>(src + rows(seq, g) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLdRow<D> + c) = v;
  }
}

template <int D = kDh>
__device__ __forceinline__ void load_rows(FragA (&a)[D / 16], const bf16* rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(a[kk], rows + kk * 16, kLdRow<D>);
}

// S (16 x kChunk f32, row length kLdS) = A (16 x D) . X^T for the kChunk
// staged rows X starting at `x`.
template <int D = kDh>
__device__ __forceinline__ void scores(float* S, const FragA (&a)[D / 16],
                                       const bf16* x) {
#pragma unroll
  for (int n = 0; n < kChunk / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt b;
      wmma::load_matrix_sync(b, x + n * 16 * kLdRow<D> + kk * 16, kLdRow<D>);
      wmma::mma_sync(c, a[kk], b, c);
    }
    wmma::store_matrix_sync(S + n * 16, c, kLdS, wmma::mem_row_major);
  }
}

// acc[n] += P (16 x kChunk bf16, row length kLdP) . X (kChunk staged rows x D)
template <int D = kDh>
__device__ __forceinline__ void accumulate(FragC (&acc)[D / 16], const bf16* P,
                                           const bf16* x) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    FragA pa;
    wmma::load_matrix_sync(pa, P + kk * 16, kLdP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, x + kk * 16 * kLdRow<D> + n * 16, kLdRow<D>);
      wmma::mma_sync(acc[n], pa, b, acc[n]);
    }
  }
}

// Write the warp's 16 x D accumulators times `mul` as bf16 into rows
// [row0, row0 + 16) (those < n_valid) of sequence `seq` of `dst` (row stride
// `stride`), via the warp's kTileF f32 area T. Lane: row lane & 15, columns
// (lane >> 4) * D / 2 + [0, D / 2).
template <int D = kDh, class Rows>
__device__ __forceinline__ void write_rows(FragC (&acc)[D / 16], float* T,
                                           float mul, bf16* dst, Rows rows,
                                           int seq, int row0, int n_valid,
                                           int stride) {
  static_assert(kTileF >= 16 * kLdOut<D>,
                "output staging must fit two score tiles");
  constexpr int kLdO = kLdOut<D>, kHalf = D / 2;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(T + n * 16, acc[n], kLdO, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31, r = lane & 15, c0 = (lane >> 4) * kHalf;
  if (row0 + r < n_valid) {
    bf16* d = dst + rows(seq, row0 + r) * stride + c0;
    const float* t = T + r * kLdO + c0;
#pragma unroll
    for (int c = 0; c < kHalf; c += 8) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(t[c + e] * mul);
      *reinterpret_cast<uint4*>(d + c) = *reinterpret_cast<const uint4*>(v);
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------- forward
constexpr int kKeys = 64;         // keys per streamed K/V tile
constexpr int kStages = 3;        // K/V tiles in flight (the cp.async ring)

__device__ __forceinline__ float exp2_approx(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Tiles of D-wide bf16 rows (2 D bytes) in the swizzled layout wgmma reads:
// the 16-byte chunk c of row r sits at chunk c ^ ((r / R) % (D / 8)), R = 1
// at D = 64 (the 128-byte swizzle) and 2 at D = 32 (the 64-byte swizzle);
// an atom is 8 rows (1 KiB or 512 B) and every tile starts 1 KiB-aligned.
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

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from touching an accumulator across an async wgmma
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
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
template <int NO>
__device__ __forceinline__ void wgmma_pv(float (&d)[NO][4],
                                         const unsigned (&a)[4],
                                         unsigned long long b) {
  if constexpr (NO == 8) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n32(d, a, b);
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
  constexpr int NS = kKeys / 8, NO = D / 8, KS = D / 16;
  constexpr int kRowsF = 64 * G, kThreadsF = 128 * G, kChunks = S::kChunks;
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
  // zeros (their V rows meet p = 0, which must not meet a NaN)
  auto load_tile = [&](int t) {
    unsigned char* Kd = ring + (t % kStages) * 2 * kTileBytes;
    unsigned char* Vd = Kd + kTileBytes;
#pragma unroll
    for (int i = 0; i < kKeys * kChunks / kThreadsF; ++i) {
      const int idx = tid + i * kThreadsF;
      const int r = idx / kChunks, c = idx % kChunks;
      const int key = t * kKeys + r;
      const bool ok = key < n_valid;
      const size_t off = (size_t)(ok ? rows.offset(key) : 0) * ld_in + c * 8;
      cp_async16(Kd + S::offset(r, c), k + off, ok);
      cp_async16(Vd + S::offset(r, c), v + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kRowsF * kChunks / kThreadsF; ++i) {
    const int idx = tid + i * kThreadsF;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = q0 + r < N;
    cp_async16(Qs + S::offset(r, c),
               q + (size_t)(ok ? rows.offset(q0 + r) : 0) * ld_in + c * 8, ok);
  }
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
  const float sl2 = scale * 1.4426950408889634f;    // scale * log2(e)
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
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      pa[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    // acc += bf16(P) . V, 16 keys (two 8-row atoms of V) per step
    wg_hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      wgmma_pv(acc, pa[kk], dv + kk * (2 * S::kAtom >> 4));
    wg_commit();
    wg_wait0();
    wg_hold(acc);
  }
  cp_async_wait<0>();      // only empty groups can be left
  __syncthreads();         // every wgmma read of Q is done

  // o = acc / l, staged as bf16 in the warp's own 16 Q rows, then 16 B a lane
  unsigned char* Qw = Qs + (wg * 64 + wr) * S::kRowBytes;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    const float inv = 1.f / sum;
    const int r = g + 8 * hf;
    const int qrow = q0 + wg * 64 + wr + r;
    if (c2 == 0 && qrow < N)
      lse[((size_t)seq * H + h) * N + qrow] = m[hf] * scale + logf(sum);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(Qw + S::offset(r, n) + c2 * 2) =
          __floats2bfloat162_rn(acc[n][2 * hf] * inv, acc[n][2 * hf + 1] * inv);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int qrow = q0 + wg * 64 + wr + r;
    if (qrow < N)
      *reinterpret_cast<uint4*>(o + (size_t)rows.offset(qrow) * ld_out +
                                c * 8) =
          *reinterpret_cast<const uint4*>(Qw + S::offset(r, c));
  }
}

// ---------------------------------------------------------------- dq
// grid (ceil(N / kRows), H, sequences). smem: K, V (NP rows), Q, dO (kRows
// rows), per warp a kTileF f32 area (two score tiles) and one bf16 tile.
// Also writes delta per row.
template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
            const float* __restrict__ lse, const bf16* __restrict__ dout,
            float* __restrict__ delta, bf16* __restrict__ dqkv, Rows rows,
            int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int L = kLdRow<D>, K = D / 16;
  const int NP = (N + kChunk - 1) / kChunk * kChunk;
  const int h = blockIdx.y, seq = blockIdx.z, q0 = blockIdx.x * kRows;
  const int C = H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * L;
  bf16* Qs = Vs + NP * L;
  bf16* Gs = Qs + kRows * L;
  float* S = reinterpret_cast<float*>(Gs + kRows * L) + warp * kTileF;
  float* dP = S + 16 * kLdS;
  bf16* P = reinterpret_cast<bf16*>(reinterpret_cast<float*>(Gs + kRows * L) +
                                    kWarps * kTileF) + warp * 16 * kLdP;

  stage<D>(Ks, qkv + C + h * D, rows, seq, 0, NP, N, C3);
  stage<D>(Vs, qkv + 2 * C + h * D, rows, seq, 0, NP, N, C3);
  stage<D>(Qs, qkv + h * D, rows, seq, q0, kRows, N, C3);
  stage<D>(Gs, dout + h * D, rows, seq, q0, kRows, N, C);
  __syncthreads();

  const int r = lane & 15, half = lane >> 4;
  const int qrow = q0 + warp * 16 + r;
  const size_t stat = ((size_t)seq * H + h) * N + qrow;
  // delta = rowsum(dO * O) over the row's D columns, split between halves
  float dl = 0.f, row_lse = CUDART_INF_F;      // rows >= N get p = 0
  if (qrow < N) {
    const bf16* orow = o + rows(seq, qrow) * C + h * D + half * (D / 2);
    const bf16* grow = Gs + (warp * 16 + r) * L + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      dl += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
    row_lse = lse[stat];
  }
  dl += __shfl_xor_sync(kFull, dl, 16);
  if (half == 0 && qrow < N) delta[stat] = dl;

  FragA qa[K], ga[K];
  load_rows<D>(qa, Qs + warp * 16 * L);
  load_rows<D>(ga, Gs + warp * 16 * L);
  FragC acc[K];
#pragma unroll
  for (int n = 0; n < K; ++n) wmma::fill_fragment(acc[n], 0.f);
  const float* Srow = S + r * kLdS + half * 16;
  const float* Drow = dP + r * kLdS + half * 16;
  bf16* Prow = P + r * kLdP + half * 16;
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    scores<D>(S, qa, Ks + c0 * L);         // q . k
    scores<D>(dP, ga, Vs + c0 * L);        // dP = dO . v
    __syncwarp();
    const int key0 = c0 + half * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = key0 + j < N ? expf(Srow[j] * scale - row_lse) : 0.f;
      Prow[j] = __float2bfloat16(p * (Drow[j] - dl));   // dS
    }
    __syncwarp();
    accumulate<D>(acc, P, Ks + c0 * L);    // dq += dS . K
    __syncwarp();
  }
  write_rows<D>(acc, S, scale, dqkv + h * D, rows, seq, q0 + warp * 16, N, C3);
}

// ---------------------------------------------------------------- dk, dv
// grid (ceil(N / kRows), H, sequences) over KEY rows. smem: Q, dO (NP rows),
// the block's K and V rows, lse and delta (NP floats), per warp a kTileF f32
// area (two score tiles) and two bf16 tiles.
template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv(const bf16* __restrict__ qkv, const float* __restrict__ lse,
             const bf16* __restrict__ dout, const float* __restrict__ delta,
             bf16* __restrict__ dqkv, Rows rows, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int L = kLdRow<D>, K = D / 16;
  const int NP = (N + kChunk - 1) / kChunk * kChunk;
  const int h = blockIdx.y, seq = blockIdx.z, k0 = blockIdx.x * kRows;
  const int C = H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + NP * L;
  bf16* Ks = Gs + NP * L;
  bf16* Vs = Ks + kRows * L;
  float* lse_s = reinterpret_cast<float*>(Vs + kRows * L);
  float* delta_s = lse_s + NP;
  float* S = delta_s + NP + warp * kTileF;
  float* dP = S + 16 * kLdS;
  bf16* P = reinterpret_cast<bf16*>(delta_s + NP + kWarps * kTileF) +
            warp * 2 * 16 * kLdP;
  bf16* DS = P + 16 * kLdP;

  stage<D>(Qs, qkv + h * D, rows, seq, 0, NP, N, C3);
  stage<D>(Gs, dout + h * D, rows, seq, 0, NP, N, C);
  stage<D>(Ks, qkv + C + h * D, rows, seq, k0, kRows, N, C3);
  stage<D>(Vs, qkv + 2 * C + h * D, rows, seq, k0, kRows, N, C3);
  const size_t r0 = ((size_t)seq * H + h) * N;
  for (int i = threadIdx.x; i < NP; i += blockDim.x) {
    lse_s[i] = i < N ? lse[r0 + i] : CUDART_INF_F;    // queries >= N: p = 0
    delta_s[i] = i < N ? delta[r0 + i] : 0.f;
  }
  __syncthreads();

  FragA ka[K], va[K];
  load_rows<D>(ka, Ks + warp * 16 * L);
  load_rows<D>(va, Vs + warp * 16 * L);
  FragC dk[K], dv[K];
#pragma unroll
  for (int n = 0; n < K; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }
  const int r = lane & 15, half = lane >> 4;
  const float* Srow = S + r * kLdS + half * 16;
  const float* Drow = dP + r * kLdS + half * 16;
  bf16* Prow = P + r * kLdP + half * 16;
  bf16* DSrow = DS + r * kLdP + half * 16;
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    scores<D>(S, ka, Qs + c0 * L);         // (k . q)^T
    scores<D>(dP, va, Gs + c0 * L);        // dP^T = v . dO
    __syncwarp();
    const int qi = c0 + half * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(Srow[j] * scale - lse_s[qi + j]);
      Prow[j] = __float2bfloat16(p);
      DSrow[j] = __float2bfloat16(p * (Drow[j] - delta_s[qi + j]));
    }
    __syncwarp();
    accumulate<D>(dv, P, Gs + c0 * L);     // dv += P^T . dO
    accumulate<D>(dk, DS, Qs + c0 * L);    // dk += dS^T . Q
    __syncwarp();
  }
  write_rows<D>(dk, S, scale, dqkv + C + h * D, rows, seq, k0 + warp * 16, N,
                C3);
  write_rows<D>(dv, S, 1.f, dqkv + 2 * C + h * D, rows, seq, k0 + warp * 16,
                N, C3);
}

// Shared memory per backward block. At D = 64 and N = 197: 104 and 111
// KiB, so two blocks fit on one SM (228 KiB); at N = 256: 113 and 120 KiB;
// at N = 512: 185 and 194 KiB. At D = 32 and N = 197: 68 and 75 KiB, so
// three blocks fit.
template <int D>
size_t dq_smem(int N) {
  return (2 * (size_t)pad_rows(N) + 2 * kRows) * kLdRow<D> * 2 +
         kWarps * ((size_t)kTileF * 4 + 16 * kLdP * 2);
}
template <int D>
size_t dkv_smem(int N) {
  return (2 * (size_t)pad_rows(N) + 2 * kRows) * kLdRow<D> * 2 +
         2 * (size_t)pad_rows(N) * 4 +
         kWarps * ((size_t)kTileF * 4 + 2 * 16 * kLdP * 2);
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

// The packed-QKV backward: dq (and delta), then dk and dv.
template <int D = kDh, class Rows>
cudaError_t launch_attn_bwd(const void* qkv, const void* out, const void* lse,
                            const void* dout, void* delta, void* dqkv,
                            Rows rows, int seqs, int N, int H, float scale,
                            void* stream) {
  cudaError_t err = allow_smem(attn_bwd_dq<D, Rows>, dq_smem<D>(N));
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv<D, Rows>, dkv_smem<D>(N));
  if (err != cudaSuccess) return err;
  dim3 grid((N + kRows - 1) / kRows, H, seqs);
  cudaStream_t s = (cudaStream_t)stream;
  attn_bwd_dq<D, Rows><<<grid, kThreads, dq_smem<D>(N), s>>>(
      (const bf16*)qkv, (const bf16*)out, (const float*)lse,
      (const bf16*)dout, (float*)delta, (bf16*)dqkv, rows, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv<D, Rows><<<grid, kThreads, dkv_smem<D>(N), s>>>(
      (const bf16*)qkv, (const float*)lse, (const bf16*)dout,
      (const float*)delta, (bf16*)dqkv, rows, N, H, scale);
  return cudaGetLastError();
}

}  // namespace
