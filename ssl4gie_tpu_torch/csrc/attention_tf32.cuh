// The float32 attention kernels (dense_attention.cu, window_attention.cu,
// flash_attention.cu) on Hopper's tensor cores in 3xTF32: one
// online-softmax forward, and a backward of a dq kernel then a dk/dv
// kernel, for every layout, with the Rows functors of attention_core.cuh
// (`DenseRows`, `WindowRows`).
//
// Replaces the same Pallas TPU kernels as the bf16 kernels, run at dt =
// f32: ssl4gie_tpu/kernels/dense_attention.py (`_fwd_kernel`,
// `_bwd_kernel`), window_attention.py (`_fwd_kernel`, `_bwd_kernel`) and
// flash_attention.py (`_fwd_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`),
// which accumulate in f32 and, under `--compute-dtype float32`, keep P and
// dS in float32.
//
// What bounds them on the card: 4 N^2 D FLOPs (forward) and 10 N^2 D
// (backward) per (sequence, head), and float32's precision. One TF32
// product (a 10-bit mantissa) errs near 1e-3.
// Split every f32 operand x into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// and x = hi + lo holds about 22 bits; a.b = lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b (small terms first) drops only lo_a.lo_b, near 2^-22 of the
// product. Three TF32 wgmmas per product, accumulated in f32: float32's
// precision at 495 / 3 = 165 TFLOP/s (H100 SXM), against 67 on the FFMA
// pipes. The design is the bf16 core's (attention_core.cuh): every product
// a wgmma (m64nNk8.f32.tf32.tf32) on 64 rows a warpgroup, the scores, P
// and dS in registers, no atomics. What TF32 changes:
// - wgmma reads TF32 operands from shared memory K-major only (no
//   transpose bits, as CUTLASS's SM90 TF32 atoms are all _TN), so the
//   products that the bf16 core reads transposed, O += P.V in the forward,
//   dQ += dS.K, dV += P^T.dO and dK += dS^T.Q in the backward, read a
//   transposed copy (V^T, K^T, dO^T, Q^T) that the split pass writes while
//   it splits the streamed tile anyway.
// - the f32 accumulator's layout is not the TF32 register A layout: a
//   thread's A elements in a k-step of 8 are columns t and t + 4 (t = lane
//   % 4), its accumulator elements columns 2t and 2t + 1. So P, dS, P^T and
//   dS^T go into A unchanged, and the transposed copies permute each 8
//   rows the same way: k position p holds row 2p (p < 4) or 2(p - 4) + 1.
// - every tile is `F32Pan`: panels of 8 f32 columns (32 bytes, one k-step),
//   each in the 32-byte swizzle, so Dh 32, 64 and 80 and the transposed
//   tiles (Dh rows, the 32-byte swizzle's 8-row groups) are one layout.
// - the split: cp.async lands the raw f32 rows of a streamed tile in the
//   layout wgmma reads; once landed, the block splits it in place (hi over
//   the raw value) and writes lo and the transposed hi and lo beside it,
//   each warp's scalar stores of the transpose rotated onto 32 banks.
//   The resident tile (Q; Q and dO; K and V) is split once.
// - the forward's block is G warpgroups (G = 2 but at Dh 80, `kFwdGroups`),
//   each on its own 64 query rows against the shared streamed tile, all of
//   them loading, splitting and multiplying: two halve the split per
//   product, and the second issues its S = Q.K^T after the first, so that
//   one's softmax runs beside the other's products. Each tile's P.V goes
//   into a fresh partial that a rounded FMA adds to the output (see
//   attn_fwd_tf32). ptxas serializes every wgmma of a kernel in which a
//   product sits under a thread-dependent branch, or in which another
//   instruction touches a wgmma's accumulator while a product is in flight
//   (ptxas notes C7514, C7515, C7518), so the forward has neither (PERF.md,
//   section 6; benchmarks/ablate_f32_forward.py).
// - the backward's block is two warpgroups that both load and split, and
//   warpgroup 0 alone multiplies: with one warpgroup the split took about
//   a third of the #7 backward, and two warpgroups that each took half of
//   the products were slower (PERF.md, section 6,
//   benchmarks/ablate_f32_backward.py).
// - the backward's products wait on each other less: dQ += dS.K goes in
//   two groups, the second half's fragments split while the first is
//   multiplied, and in the dk/dv kernel dV += P^T.dO runs while dS^T is
//   formed.
// Shared memory a block (X = a 64-row f32 tile, 64 D 4 bytes; XT = one of
// the streamed tile's kTf32Rows<D> rows: 64, or 32 at Dh 80):
// - forward: Q hi and lo of each warpgroup (2 G X); K lo, V^T hi and lo
//   (3 XT); two stages of K (landing as hi) and V (4 XT): Dh 32 89 KiB, 64
//   177 KiB, 80 111 KiB (G = 2, 2, 1).
// - dq: Q hi, lo, dO hi, lo (4 X); K lo, V lo, K^T hi, lo (4 XT); two
//   stages of K and V landing as hi (4 XT): Dh 32 97 KiB, 64 193 KiB, 80
//   161 KiB.
// - dk/dv: K, V hi and lo (4 X); Q lo, dO lo, Q^T, dO^T hi and lo (6 XT);
//   two stages of Q and dO (4 XT) with their lse and delta: Dh 32 114 KiB,
//   64 226 KiB, 80 181.5 KiB.
// Dh 80 streams 32-row tiles, since 64 would need 221 KiB (forward, G = 2),
// 241 KiB (dq) and 282 KiB (dk/dv). The masks: in the forward keys at or
// beyond n_valid are -inf before the max and the key loop stops at the
// last tile that holds a valid key; in the backward they get p = 0 (their
// dk and dv are zero; a dk/dv block whose keys are all masked streams
// nothing); query rows at or beyond N read zeros (the backward gives them
// p = 0) and are never stored.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "attention_core.cuh"
#include "wgmma.cuh"

namespace {

// rows of the tiles the backward streams (K, V in the dq kernel; Q, dO in
// the dk/dv kernel)
template <int D>
constexpr int kTf32Rows = D == 80 ? 32 : 64;
// threads a backward block: warpgroup 0 multiplies; both load and split
// the tiles
constexpr int kTf32Threads = 256;

// A tile of R rows of f32 columns as panels of 8 columns (32 bytes): panel
// p at p R 32 bytes, row r of it at r 32, its two 16-byte halves swapped in
// rows with (r / 4) odd (the 32-byte swizzle; 8-row atoms of 256 bytes).
// Every tile starts 1 KiB-aligned.
template <int R>
struct F32Pan {
  static constexpr int kPanel = R * 32;
  __device__ __forceinline__ static int offset(int r, int c) {   // bytes
    return (c >> 3) * kPanel + r * 32 +
           ((((c >> 2) ^ (r >> 2)) & 1) << 4) + (c & 3) * 4;
  }
  // Descriptor of panel p of the tile at `tile`: 8-row groups one atom apart
  // (the leading offset is not read: a k-step is one panel row), the
  // 32-byte swizzle (mode 3)
  __device__ __forceinline__ static unsigned long long desc(const void* tile,
                                                            int p) {
    const unsigned long long a =
        ((smem_u32(tile) + p * kPanel) & 0x3FFFF) >> 4;
    return a | (16ull << 16) | (16ull << 32) | (3ull << 62);
  }
};

// the k position, in a transposed tile's panel, of row i (0-7) of the
// source's 8: row 2p sits at p, row 2p + 1 at p + 4
__device__ __forceinline__ int tf32_pos(int i) {
  return (i >> 1) + ((i & 1) << 2);
}

// x rounded to TF32 (to nearest, ties away from zero), the function of
// cvt.rna.tf32.f32: half a TF32 ulp added to the magnitude's bits, the 13
// low bits cleared. Two integer operations, which issue faster than the
// conversion (PERF.md, PR 18).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void tf32_split(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// cp.async rows [first, first + R) of a sequence's C-wide f32 column slice
// at src (row stride ld) into the F32Pan<R> tile at dst, by the block's kT
// threads; rows >= limit become zeros.
template <int R, int C, int kT = kTf32Threads, class Rows>
__device__ __forceinline__ void load_pan(unsigned char* dst, const float* src,
                                         int ld, Rows rows, int first,
                                         int limit) {
  constexpr int kChunks = C / 4;
#pragma unroll
  for (int i = 0; i < (R * kChunks + kT - 1) / kT; ++i) {
    const int idx = threadIdx.x + i * kT;
    if (R * kChunks % kT != 0 && idx >= R * kChunks) break;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = first + r < limit;
    cp_async16(dst + F32Pan<R>::offset(r, 4 * c),
               src + (size_t)(ok ? rows.offset(first + r) : 0) * ld + 4 * c,
               ok);
  }
}

// The raw R x C tile at `hi` (F32Pan<R>, as load_pan left it) split by the
// block's kT threads: in place into its TF32 high parts, its low parts into `lo`
// (the same layout), and with kTrans both transposed into `thi` and `tlo`
// (F32Pan<C>: C rows whose columns are the R source rows, each 8 in
// tf32_pos order); without kPlain only the transposed parts are written
// (the raw tile stays). A warp takes 8 rows x 4 chunks of 4 columns; its
// lane with chunk cq stores column (e + cq) % 4 of its chunk in transposed
// store e, so each store's 32 lanes meet 32 banks.
template <int R, int C, bool kTrans, bool kPlain = true,
          int kT = kTf32Threads>
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo,
                                           unsigned char* thi,
                                           unsigned char* tlo) {
  constexpr int kUnits = R * C / 128, kWarps = kT / 32;
  static_assert(R % 8 == 0 && C % 16 == 0, "units of 8 rows x 16 columns");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane >> 3;
#pragma unroll
  for (int i = 0; i < (kUnits + kWarps - 1) / kWarps; ++i) {
    const int u = warp + kWarps * i;
    if (kUnits % kWarps != 0 && u >= kUnits) break;
    const int r = (u % (R / 8)) * 8 + (lane & 7);
    const int c = (u / (R / 8)) * 16 + 4 * cq;
    const int off = F32Pan<R>::offset(r, c);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    unsigned h[4], l[4];
    tf32_split(x.x, h[0], l[0]);
    tf32_split(x.y, h[1], l[1]);
    tf32_split(x.z, h[2], l[2]);
    tf32_split(x.w, h[3], l[3]);
    if constexpr (kPlain) {
      *reinterpret_cast<uint4*>(hi + off) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    if constexpr (kTrans) {
      // rotate by cq: element e of the rotated pair is column (e + cq) % 4
      const bool s1 = cq & 1, s2 = cq & 2;
      unsigned a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = s1 ? h[(e + 1) & 3] : h[e];
        b[e] = s1 ? l[(e + 1) & 3] : l[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = s2 ? a[(e + 2) & 3] : a[e];
        l[e] = s2 ? b[(e + 2) & 3] : b[e];
      }
      const int col = (r & ~7) + tf32_pos(r & 7);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t_off = F32Pan<C>::offset(c + ((e + cq) & 3), col);
        *reinterpret_cast<unsigned*>(thi + t_off) = h[e];
        *reinterpret_cast<unsigned*>(tlo + t_off) = l[e];
      }
    }
  }
}

// ------------------------------------------------------- TF32 products
// The accumulator of a warpgroup's 64 x n product is the bf16 core's (warp
// w rows 16 w.., d[j] of a lane: (g, 8 j + 2t), (g, + 1), (g + 8, 8 j +
// 2t), (g + 8, + 1), g = lane / 4, t = lane % 4). A register A operand of
// a k-step of 8: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
//
// d (64 x n, n = 64 or 32) = (acc ? d : 0) + A . B^T, A (64 x 8) and B (n x
// 8) TF32 panels in shared memory, both K-major.
__device__ __forceinline__ void tf32_ss(float (&d)[8][4], unsigned long long a,
                                        unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1;\n}\n"
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
__device__ __forceinline__ void tf32_ss(float (&d)[4][4], unsigned long long a,
                                        unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x n, n = 32, 64 or 80) = (acc ? d : 0) + A (64 x 8, registers) .
// B^T, B (n x 8) a TF32 panel in shared memory, K-major
__device__ __forceinline__ void tf32_rs(float (&d)[4][4],
                                        const unsigned (&a)[4],
                                        unsigned long long b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void tf32_rs(float (&d)[8][4],
                                        const unsigned (&a)[4],
                                        unsigned long long b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void tf32_rs(float (&d)[10][4],
                                        const unsigned (&a)[4],
                                        unsigned long long b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39}, "
      "{%40,%41,%42,%43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d = (first k-step ? 0 : d) + A . B^T over K columns: each k-step (panel)
// as lo.hi, hi.lo, hi.hi. A: 64-row panels `ah`/`al`, B: R-row panels
// `bh`/`bl`.
template <int K, int R, int NJ>
__device__ __forceinline__ void tf32x3_ss(float (&d)[NJ][4],
                                          const unsigned char* ah,
                                          const unsigned char* al,
                                          const unsigned char* bh,
                                          const unsigned char* bl) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    tf32_ss(d, F32Pan<64>::desc(al, kk), F32Pan<R>::desc(bh, kk), kk);
    tf32_ss(d, F32Pan<64>::desc(ah, kk), F32Pan<R>::desc(bl, kk), 1);
    tf32_ss(d, F32Pan<64>::desc(ah, kk), F32Pan<R>::desc(bh, kk), 1);
  }
}

// d += X . B over columns [8 J0, 8 J1) of the accumulator-laid x (P, dS,
// or their transposes), split into A fragments, against the transposed
// F32Pan<D> tile `bh`/`bl` (D rows, x's columns in tf32_pos order); with
// kFresh, d = X . B (the first product does not read d, so no other
// instruction need zero it)
template <int D, int J0, int J1, int NS, bool kFresh = false>
__device__ __forceinline__ void tf32x3_rs(float (&d)[D / 8][4],
                                          const unsigned (&xh)[NS][4],
                                          const unsigned (&xl)[NS][4],
                                          const unsigned char* bh,
                                          const unsigned char* bl) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    tf32_rs(d, xl[j], F32Pan<D>::desc(bh, j), !kFresh || j > J0);
    tf32_rs(d, xh[j], F32Pan<D>::desc(bl, j));
    tf32_rs(d, xh[j], F32Pan<D>::desc(bh, j));
  }
}

// Columns [8 J0, 8 J1) of the accumulator x as A fragments, hi and lo:
// k-step j's (g, t) is x's (g, 8 j + 2t), (g, t + 4) its (g, 8 j + 2t + 1)
template <int J0, int J1, int NS>
__device__ __forceinline__ void tf32_frags(const float (&x)[NS][4],
                                           unsigned (&h)[NS][4],
                                           unsigned (&l)[NS][4]) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    tf32_split(x[j][0], h[j][0], l[j][0]);
    tf32_split(x[j][2], h[j][1], l[j][1]);
    tf32_split(x[j][1], h[j][2], l[j][2]);
    tf32_split(x[j][3], h[j][3], l[j][3]);
  }
}

// keep the compiler from reusing the registers of an A operand until the
// wgmma that reads them is waited for
template <int NS>
__device__ __forceinline__ void wg_hold_a(const unsigned (&x)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(x[j][e]) : "memory");
}

// The warp's rows g and g + 8 of a 64 x D accumulator times `mul` into rows
// row0 and row0 + 8 (those < limit) of the D-wide f32 slice at dst (row
// stride ld), two floats a store
template <int D, class Rows>
__device__ __forceinline__ void store_acc_f32(const float (&acc)[D / 8][4],
                                              float mul, float* dst, int ld,
                                              Rows rows, int row0,
                                              int limit) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    if (row < limit) {
      float* p = dst + (size_t)rows.offset(row) * ld + c2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(p + 8 * n) =
            make_float2(acc[n][2 * hf] * mul, acc[n][2 * hf + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward
// warpgroups a forward block, each on 64 query rows
template <int D>
constexpr int kFwdGroups = D == 80 ? 1 : 2;

template <int D, int G>
constexpr size_t fwd_smem_tf32() {
  return (size_t)(2 * 64 * G + 7 * kTf32Rows<D>) * D * 4 + 1024;
}

// grid (ceil(N / (64 G)), H, sequences), 128 G threads: warpgroup wg owns
// query rows [64 wg, 64 wg + 64) of the block (warp w of it rows 16 w..);
// every thread loads, splits and multiplies (a product under a
// thread-dependent branch would make ptxas serialize every wgmma). q, k, v
// point at head 0's columns of their row slices (row stride ld_in, head h
// at + h * D); o at head 0's output columns (row stride ld_out). Keys >=
// n_valid are masked; query rows >= N are not stored. lse is (sequences,
// H, N).
//
// Per key tile t: split K(t) in place and V(t) into V^T; S = Q.K^T (the
// two warpgroups staggered); the online softmax; P.V into a partial that starts at zero (the first
// product does not read it) and is added to the output accumulator by a
// rounded FMA, o = o * alpha + part. The tensor cores' accumulation does
// not round to nearest: over the 1536 accumulations of a 4096-key row in
// one accumulator its error grew with N to 5e-5 of the largest output,
// against 4e-6 by tiles (PERF.md, section 6).
template <int D, int G, class Rows>
__global__ void __launch_bounds__(G * 128)
attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, int ld_in, float* __restrict__ o,
              int ld_out, float* __restrict__ lse, Rows rows, int N,
              int n_valid, float scale) {
  constexpr int T = kTf32Rows<D>, NS = T / 8, NO = D / 8, kT = G * 128;
  constexpr int X = 64 * D * 4, XT = T * D * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Qh = smem;                    // G tiles of 64 rows
  unsigned char* Ql = Qh + G * X;
  unsigned char* Kl = Ql + G * X;
  unsigned char* VTh = Kl + XT;                // V^T, keys in tf32_pos order
  unsigned char* VTl = VTh + XT;
  unsigned char* ring = VTl + XT;              // per stage K (hi), V raw
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int q0 = blockIdx.x * 64 * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  o += base * ld_out + h * D;
  const int n_tiles = (n_valid + T - 1) / T;

  // K and V rows of key tile t into stage t % 2; keys >= n_valid are zeros
  auto load_tile = [&](int t) {
    unsigned char* Kd = ring + (t & 1) * 2 * XT;
    load_pan<T, D, kT>(Kd, k, ld_in, rows, t * T, n_valid);
    load_pan<T, D, kT>(Kd + XT, v, ld_in, rows, t * T, n_valid);
  };
#pragma unroll
  for (int i = 0; i < G; ++i)
    load_pan<64, D, kT>(Qh + i * X, q, ld_in, rows, q0 + 64 * i, N);
  load_tile(0);                  // with Q: one group
  cp_async_commit();

  // per thread: rows g and g + 8 of its warp's 16. m: raw score max; l: this
  // thread's part of the row sum (the quad's parts are added at the end)
  const unsigned char* Qgh = Qh + wg * X;      // this warpgroup's Q
  const unsigned char* Qgl = Ql + wg * X;
  const float sl2 = scale * kLog2e;    // scale * log2(e)
  float acc[NO][4], part[NO][4], sc[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = part[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();              // tile t (and Q) have landed
    __syncthreads();                 // for every thread; tile t - 1 is done
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    unsigned char* Kh = ring + (t & 1) * 2 * XT;
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        split_tile<64, D, false, true, kT>(Qh + i * X, Ql + i * X, nullptr,
                                          nullptr);
    }
    split_tile<T, D, false, true, kT>(Kh, Kl, nullptr, nullptr);
    split_tile<T, D, true, false, kT>(Kh + XT, nullptr, VTh, VTl);
    // order the split's stores (generic proxy) before wgmma's reads (async
    // proxy), for every thread
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S (64 x T) = Q.K^T. With two warpgroups the second issues its S once
    // the first has issued its own, so that the tensor cores run one's S
    // (then P.V) while the other computes its softmax
    if (G == 2 && wg == 1) named_sync(1, 256);
    wg_fence();
    tf32x3_ss<D, T>(sc, Qgh, Qgl, Kh, Kl);
    wg_commit();
    if (G == 2 && wg == 0) named_arrive(1, 256);
    wg_wait0();
    wg_hold(sc);
    if ((t + 1) * T > n_valid) {     // the tile that holds the last key
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * T + j * 8 + c2 + e >= n_valid)
            sc[j][e] = sc[j][e + 2] = -CUDART_INF_F;
    }
    // online softmax, rows g (half 0: sc[j][0..1]) and g + 8 (half 1)
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m[hf];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      alpha[hf] = exp2_approx((m[hf] - mx) * sl2);     // 0 at t = 0
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
      l[hf] = l[hf] * alpha[hf] + sum;
    }
    // part = P.V against V^T, P split into A fragments; o = o * alpha + part
    unsigned ph[NS][4], pl[NS][4];
    tf32_frags<0, NS>(sc, ph, pl);
    wg_fence();
    tf32x3_rs<D, 0, NS, NS, true>(part, ph, pl, VTh, VTl);
    wg_commit();
    wg_wait0();
    wg_hold(part);
    wg_hold_a(ph);
    wg_hold_a(pl);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], part[n][e]);
  }
  cp_async_wait<0>();              // only empty groups can be left

  // o = acc / l; each row's log-sum-exp in natural log
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float sum = l[hf];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    inv[hf] = 1.f / sum;
    const int row = row0 + 8 * hf;
    if (c2 == 0 && row < N)
      lse[((size_t)seq * H + h) * N + row] = m[hf] * scale + logf(sum);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_acc_f32<D>(acc, 1.f, o, ld_out, rows, row0, N);
}

// The float32 forward over `seqs` sequences of N rows placed by `rows`, H
// heads D wide (see attn_fwd_tf32 for the pointers and strides).
template <int D, class Rows>
cudaError_t launch_attn_fwd_f32(const void* q, const void* k, const void* v,
                                int ld_in, void* o, int ld_out, void* lse,
                                Rows rows, int seqs, int H, int N,
                                int n_valid, float scale, void* stream) {
  constexpr int G = kFwdGroups<D>;
  constexpr size_t smem = fwd_smem_tf32<D, G>();
  cudaError_t err = allow_smem(attn_fwd_tf32<D, G, Rows>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 64 * G - 1) / (64 * G), H, seqs);
  attn_fwd_tf32<D, G, Rows><<<grid, G * 128, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, ld_in, (float*)o,
      ld_out, (float*)lse, rows, N, n_valid, scale);
  return cudaGetLastError();
}

// The float32 packed-QKV forward: qkv (tokens, 3C) -> out (tokens, C), no
// key mask.
template <int D, class Rows>
cudaError_t launch_packed_fwd_f32(const void* qkv, void* out, void* lse,
                                  Rows rows, int seqs, int N, int H,
                                  float scale, void* stream) {
  const int C = H * D;
  const float* x = (const float*)qkv;
  return launch_attn_fwd_f32<D>(x, x + C, x + 2 * C, 3 * C, out, C, lse,
                                rows, seqs, H, N, N, scale, stream);
}

template <int D>
constexpr size_t dq_smem_tf32() {
  return (size_t)(4 * 64 + 8 * kTf32Rows<D>) * D * 4 + 1024;
}
template <int D>
constexpr size_t dkv_smem_tf32() {
  return (size_t)(4 * 64 + 10 * kTf32Rows<D>) * D * 4 +
         2 * 2 * kTf32Rows<D> * 4 + 1024;
}

// ---------------------------------------------------------------- dq
// grid (ceil(N / 64), H, sequences), kTf32Threads threads: warpgroup 0
// multiplies on 64 query rows (warp w rows 16 w..). q, k, v point at head
// 0's columns of their row slices (row stride ld_in, head h at + h * D); o
// (the forward's output) and dout at head 0's columns (row stride ld_out);
// dq (row stride ld_dq). lse and delta are (sequences, H, N); delta is
// written here.
template <int D, class Rows>
__global__ void __launch_bounds__(kTf32Threads)
attn_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int ld_in,
                 const float* __restrict__ o, const float* __restrict__ dout,
                 int ld_out, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int ld_dq,
                 Rows rows, int N, int n_valid, float scale) {
  constexpr int T = kTf32Rows<D>, NS = T / 8, NO = D / 8;
  constexpr int X = 64 * D * 4, XT = T * D * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Qh = smem;
  unsigned char* Ql = Qh + X;
  unsigned char* Gh = Ql + X;                  // dO
  unsigned char* Gl = Gh + X;
  unsigned char* Kl = Gl + X;
  unsigned char* Vl = Kl + XT;
  unsigned char* KTh = Vl + XT;                // K^T, keys in tf32_pos order
  unsigned char* KTl = KTh + XT;
  unsigned char* ring = KTl + XT;              // per stage K hi, V hi
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int q0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool mma = warp < 4;                   // warpgroup 0 multiplies
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  o += base * ld_out + h * D;
  dout += base * ld_out + h * D;
  dq += base * ld_dq + h * D;
  const size_t stat = ((size_t)seq * H + h) * N;
  const int n_tiles = (n_valid + T - 1) / T;

  // K and V rows of key tile t into stage t % 2; keys >= n_valid are zeros
  auto load_tile = [&](int t) {
    unsigned char* Kd = ring + (t & 1) * 2 * XT;
    load_pan<T, D>(Kd, k, ld_in, rows, t * T, n_valid);
    load_pan<T, D>(Kd + XT, v, ld_in, rows, t * T, n_valid);
  };
  load_pan<64, D>(Qh, q, ld_in, rows, q0, N);
  load_pan<64, D>(Gh, dout, ld_out, rows, q0, N);
  load_tile(0);                  // with Q and dO: one group
  cp_async_commit();

  // while the copies fly, for rows g and g + 8 of the warp: delta =
  // rowsum(dO * O), the quad's lanes on alternate 16-byte chunks, and
  // -lse * log2(e); rows >= N get p = 0
  float dl[2], nl[2];
#pragma unroll
  for (int hf = 0; hf < 2 && mma; ++hf) {
    const int row = q0 + warp * 16 + g + 8 * hf;
    float sum = 0.f;
    if (row < N) {
      const size_t off = (size_t)rows.offset(row) * ld_out;
      for (int c = lane & 3; c < D / 4; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(o + off + 4 * c);
        const float4 b = *reinterpret_cast<const float4*>(dout + off + 4 * c);
        sum = fmaf(a.x, b.x, sum);
        sum = fmaf(a.y, b.y, sum);
        sum = fmaf(a.z, b.z, sum);
        sum = fmaf(a.w, b.w, sum);
      }
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    dl[hf] = sum;
    nl[hf] = row < N ? -lse[stat + row] * kLog2e : -CUDART_INF_F;
    if (c2 == 0 && row < N) delta[stat + row] = sum;
  }

  const float sl2 = scale * kLog2e;
  float acc[NO][4], sc[NS][4], dp[NS][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();              // tile t (and Q, dO) have landed
    __syncthreads();                 // for every thread; tile t - 1 is done
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    unsigned char* Kh = ring + (t & 1) * 2 * XT;
    unsigned char* Vh = Kh + XT;
    if (t == 0) {
      split_tile<64, D, false>(Qh, Ql, nullptr, nullptr);
      split_tile<64, D, false>(Gh, Gl, nullptr, nullptr);
    }
    split_tile<T, D, true>(Kh, Kl, KTh, KTl);
    split_tile<T, D, false>(Vh, Vl, nullptr, nullptr);
    // order the split's stores (generic proxy) before wgmma's reads (async
    // proxy), for every thread
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!mma) continue;

    // S = Q.K^T, then dP = dO.V^T as a second group
    wg_fence();
    tf32x3_ss<D, T>(sc, Qh, Ql, Kh, Kl);
    wg_commit();
    tf32x3_ss<D, T>(dp, Gh, Gl, Vh, Vl);
    wg_commit();
    wg_wait1();
    wg_hold(sc);
    if ((t + 1) * T > n_valid) {     // the tile that holds the last key
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * T + j * 8 + c2 + e >= n_valid)
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
    // dQ += dS.K against K^T, in two groups of keys: the second half's
    // fragments are split while the first half is multiplied
    unsigned dh[NS][4], dl_[NS][4];
    wg_hold(acc);
    tf32_frags<0, NS / 2>(dp, dh, dl_);
    wg_fence();
    tf32x3_rs<D, 0, NS / 2>(acc, dh, dl_, KTh, KTl);
    wg_commit();
    tf32_frags<NS / 2, NS>(dp, dh, dl_);
    wg_fence();
    tf32x3_rs<D, NS / 2, NS>(acc, dh, dl_, KTh, KTl);
    wg_commit();
    wg_wait0();
    wg_hold(acc);
    wg_hold_a(dh);
    wg_hold_a(dl_);
  }
  cp_async_wait<0>();              // only empty groups can be left
  if (mma)
    store_acc_f32<D>(acc, scale, dq, ld_dq, rows, q0 + warp * 16 + g, N);
}

// ---------------------------------------------------------------- dk, dv
// grid (ceil(N / 64), H, sequences) over KEY rows, kTf32Threads threads
// (warpgroup 0 multiplies on the 64 keys). q, k, v, dout as in
// attn_bwd_dq_tf32; dk and dv (row stride ld_dkv); lse and delta
// (sequences, H, N), delta from attn_bwd_dq_tf32.
template <int D, class Rows>
__global__ void __launch_bounds__(kTf32Threads)
attn_bwd_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, int ld_in,
                  const float* __restrict__ dout, int ld_out,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int ld_dkv, Rows rows, int N,
                  int n_valid, float scale) {
  constexpr int T = kTf32Rows<D>, NS = T / 8, NO = D / 8;
  constexpr int X = 64 * D * 4, XT = T * D * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* Kh = smem;
  unsigned char* Kl = Kh + X;
  unsigned char* Vh = Kl + X;
  unsigned char* Vl = Vh + X;
  unsigned char* Ql = Vl + X;
  unsigned char* Gl = Ql + XT;                 // dO
  unsigned char* QTh = Gl + XT;                // Q^T (tf32_pos order)
  unsigned char* QTl = QTh + XT;
  unsigned char* GTh = QTl + XT;               // dO^T
  unsigned char* GTl = GTh + XT;
  unsigned char* ring = GTl + XT;              // per stage Q hi, dO hi
  // per stage the tile's lse, then its delta
  float* stats = reinterpret_cast<float*>(ring + 4 * XT);
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int k0 = blockIdx.x * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool mma = warp < 4;                   // warpgroup 0 multiplies
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
  const int n_tiles = k0 < n_valid ? (N + T - 1) / T : 0;

  // Q and dO rows of query tile t, its lse and delta, into stage t % 2;
  // queries >= N are zeros
  auto load_tile = [&](int t) {
    unsigned char* Qd = ring + (t & 1) * 2 * XT;
    load_pan<T, D>(Qd, q, ld_in, rows, t * T, N);
    load_pan<T, D>(Qd + XT, dout, ld_out, rows, t * T, N);
    if (tid < 2 * T) {
      const int i = t * T + tid % T;
      cp_async4(stats + (t & 1) * 2 * T + tid,
                (tid < T ? lse : delta) + (i < N ? i : 0), i < N);
    }
  };
  load_pan<64, D>(Kh, k, ld_in, rows, k0, n_valid);
  load_pan<64, D>(Vh, v, ld_in, rows, k0, n_valid);
  if (n_tiles > 0) load_tile(0);   // with K and V: one group
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  const int key = k0 + warp * 16 + g;          // rows key and key + 8
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
    cp_async_wait<0>();              // tile t (and K, V) have landed
    __syncthreads();                 // for every thread; tile t - 1 is done
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    unsigned char* Qh = ring + (t & 1) * 2 * XT;
    unsigned char* Gh = Qh + XT;
    const float* ls = stats + (t & 1) * 2 * T;   // lse, delta
    if (t == 0) {
      split_tile<64, D, false>(Kh, Kl, nullptr, nullptr);
      split_tile<64, D, false>(Vh, Vl, nullptr, nullptr);
    }
    split_tile<T, D, true>(Qh, Ql, QTh, QTl);
    split_tile<T, D, true>(Gh, Gl, GTh, GTl);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (!mma) continue;

    // S^T = K.Q^T, then dP^T = V.dO^T as a second group
    wg_fence();
    tf32x3_ss<D, T>(st, Kh, Kl, Qh, Ql);
    wg_commit();
    tf32x3_ss<D, T>(dpt, Vh, Vl, Gh, Gl);
    wg_commit();
    wg_wait1();
    wg_hold(st);
    if (k0 + 64 > n_valid) {         // keys >= n_valid: p = 0
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (key + 8 * hf >= n_valid)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            st[j][2 * hf] = st[j][2 * hf + 1] = -CUDART_INF_F;
    }
    if ((t + 1) * T > N) {           // queries >= N: p = 0
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * T + j * 8 + c2 + e >= N)
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
    // dV += P^T.dO against dO^T while dS^T is formed, then dK += dS^T.Q
    // against Q^T
    unsigned ph[NS][4], pl[NS][4], dh[NS][4], dl[NS][4];
    tf32_frags<0, NS>(st, ph, pl);
    wg_hold(dva);
    wg_fence();
    tf32x3_rs<D, 0, NS>(dva, ph, pl, GTh, GTl);
    wg_commit();
    wg_wait1();                      // dP^T is done; dV may run on
    wg_hold(dpt);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(ls + T + j * 8 + c2);
      dpt[j][0] = st[j][0] * (dpt[j][0] - d.x);
      dpt[j][1] = st[j][1] * (dpt[j][1] - d.y);
      dpt[j][2] = st[j][2] * (dpt[j][2] - d.x);
      dpt[j][3] = st[j][3] * (dpt[j][3] - d.y);
    }
    tf32_frags<0, NS>(dpt, dh, dl);
    wg_hold(dka);
    wg_fence();
    tf32x3_rs<D, 0, NS>(dka, dh, dl, QTh, QTl);
    wg_commit();
    wg_wait0();
    wg_hold(dva);
    wg_hold(dka);
    wg_hold_a(ph);
    wg_hold_a(pl);
    wg_hold_a(dh);
    wg_hold_a(dl);
  }
  cp_async_wait<0>();              // only empty groups can be left
  // keys in [n_valid, N) store their zero gradients
  if (mma) {
    store_acc_f32<D>(dka, scale, dk, ld_dkv, rows, key, N);
    store_acc_f32<D>(dva, 1.f, dv, ld_dkv, rows, key, N);
  }
}

// The float32 backward: dq (and delta), then dk and dv (see the kernels for
// the pointers and strides; dq, dk and dv share ld_grad).
template <int D, class Rows>
cudaError_t launch_attn_bwd_f32(const void* q, const void* k, const void* v,
                                int ld_in, const void* o, const void* dout,
                                int ld_out, const void* lse, void* delta,
                                void* dq, void* dk, void* dv, int ld_grad,
                                Rows rows, int seqs, int H, int N,
                                int n_valid, float scale, void* stream) {
  constexpr size_t dq_smem = dq_smem_tf32<D>(), dkv_smem = dkv_smem_tf32<D>();
  cudaError_t err = allow_smem(attn_bwd_dq_tf32<D, Rows>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv_tf32<D, Rows>, dkv_smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 63) / 64, H, seqs);
  cudaStream_t s = (cudaStream_t)stream;
  attn_bwd_dq_tf32<D, Rows><<<grid, kTf32Threads, dq_smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, ld_in,
      (const float*)o, (const float*)dout, ld_out, (const float*)lse,
      (float*)delta, (float*)dq, ld_grad, rows, N, n_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_tf32<D, Rows><<<grid, kTf32Threads, dkv_smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, ld_in,
      (const float*)dout, ld_out, (const float*)lse, (const float*)delta,
      (float*)dk, (float*)dv, ld_grad, rows, N, n_valid, scale);
  return cudaGetLastError();
}

// The float32 packed-QKV backward: qkv (tokens, 3C), out and dout (tokens,
// C) -> dqkv (tokens, 3C), no key mask.
template <int D, class Rows>
cudaError_t launch_packed_bwd_f32(const void* qkv, const void* out,
                                  const void* lse, const void* dout,
                                  void* delta, void* dqkv, Rows rows,
                                  int seqs, int N, int H, float scale,
                                  void* stream) {
  const int C = H * D;
  const float* x = (const float*)qkv;
  float* dx = (float*)dqkv;
  return launch_attn_bwd_f32<D>(x, x + C, x + 2 * C, 3 * C, out, dout, C,
                                lse, delta, dx, dx + C, dx + 2 * C, 3 * C,
                                rows, seqs, H, N, N, scale, stream);
}

}  // namespace
