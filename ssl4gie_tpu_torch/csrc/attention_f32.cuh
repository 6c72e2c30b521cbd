// The float32 forward of the attention kernels (dense_attention.cu,
// window_attention.cu, flash_attention.cu): one online-softmax forward for
// every layout, with the Rows functors of attention_core.cuh (`DenseRows`,
// `WindowRows`). The float32 backward is attention_tf32.cuh's (3xTF32
// wgmma).
//
// Replaces the same Pallas TPU kernels as the bf16 forward, run at dt =
// f32: ssl4gie_tpu/kernels/dense_attention.py (`_fwd_kernel`),
// window_attention.py (`_fwd_kernel`) and flash_attention.py
// (`_fwd_kernel`), which take the compute dtype from their inputs and
// accumulate in f32. Under `--compute-dtype float32` every model of the JAX
// package runs them so.
//
// What bounds it on the card: the same 4 N^2 D FLOPs as the bf16 forward.
// One TF32 pass (10-bit mantissa) errs near 1e-3 relative, far outside the
// float32 parity the port is held to; this forward does every product as
// an FFMA on the SMs' float32 pipes (67 TFLOP/s on an H100 SXM), where the
// 3xTF32 split of attention_tf32.cuh would reach 495 / 3 = 165. The design
// keeps the FFMA pipes fed:
// - a block is 128 threads on 64 query rows of one (sequence, head); K and V
//   come in tiles of 64 rows through a 2-stage cp.async ring (16 B a
//   thread, no registers), f32 rows padded to D + 4 floats so that 8
//   consecutive rows fall on distinct banks;
// - thread (rg, cg) = (tid / 16, tid % 16) computes an 8 x 4 register tile
//   of the 64 x 64 scores: its rows r0 + 2 i (r0 = 16 (rg / 2) + rg % 2, so
//   that the two half-warps read neighbouring rows, which lie on other
//   banks) against the tile's rows cg + 16 j, by float4 reads of both
//   operands along D: 128 FFMAs per 12 shared-memory loads;
// - the online softmax in f32: the row max and sum across the 16 lanes of a
//   half-warp by four shuffles, exp2 of one FMA with scale * log2(e) folded
//   in, the output rescaled once per tile, each row's log-sum-exp written in
//   natural log as the backward reads it;
// - P goes to shared memory transposed, into slots that only the half-warp
//   that owns the rows reads (so a __syncwarp orders them), and P.V reads
//   it back as two float4 broadcasts a key, against the tile's columns cg +
//   16 n: an 8 x D/16 tile of the output a thread;
// - keys at or beyond n_valid are -inf before the max and the key loop
//   stops at the last tile that holds a valid key; rows at or beyond N read
//   zeros and are never stored; no atomics, so the forward is bitwise
//   repeatable.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_copy.cuh"
#include "attention_core.cuh"

namespace {

constexpr int kF32Rows = 64;      // rows a block owns, and rows a tile
constexpr int kF32Threads = 128;
constexpr int kF32Stages = 2;     // streamed tiles in flight
constexpr int kSlotLd = 64 + 4;   // a P slot row: 64 rows, padded

// A tile of 64 f32 rows D wide, each padded to D + 4 floats
template <int D>
struct F32Tile {
  static constexpr int kLd = D + 4, kFloats = kF32Rows * kLd;
};

// cp.async rows [first, first + 64) of a sequence's D-wide f32 column slice
// at src (row stride ld) into the padded tile at dst; rows >= limit become
// zeros.
template <int D, class Rows>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int ld, Rows rows, int first,
                                              int limit) {
  constexpr int kChunks = D / 4, kLd = F32Tile<D>::kLd;
  static_assert(kF32Rows * kChunks % kF32Threads == 0, "whole copies");
#pragma unroll
  for (int i = 0; i < kF32Rows * kChunks / kF32Threads; ++i) {
    const int idx = threadIdx.x + i * kF32Threads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = first + r < limit;
    cp_async16(dst + r * kLd + c * 4,
               src + (size_t)(ok ? rows.offset(first + r) : 0) * ld + c * 4,
               ok);
  }
}

// s[i][j] = A[r0 + 2 i] . B[cg + 16 j] over the D columns of two padded
// tiles
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[8][4], const float* A,
                                         int r0, const float* B, int cg) {
  constexpr int kLd = F32Tile<D>::kLd;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (r0 + 2 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
      }
    }
  }
}

// The thread's 8 x 4 register tile into its half-warp's slots: slot row
// (column of the tile) cg + 16 j, slots 8 rg .. 8 rg + 7 for its rows
__device__ __forceinline__ void put_slots(float* slots, const float (&x)[8][4],
                                          int rg, int cg) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* p = slots + (cg + 16 * j) * kSlotLd + 8 * rg;
    *reinterpret_cast<float4*>(p) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    *reinterpret_cast<float4*>(p + 4) =
        make_float4(x[4][j], x[5][j], x[6][j], x[7][j]);
  }
}

// acc[i][n] += sum over the 64 slot rows t of slots[t][8 rg + i] *
// B[t][cg + 16 n], B a padded tile
template <int D>
__device__ __forceinline__ void slot_product(float (&acc)[8][D / 16],
                                             const float* slots, int rg,
                                             const float* B, int cg) {
  constexpr int kLd = F32Tile<D>::kLd, NJ = D / 16;
#pragma unroll 4
  for (int t = 0; t < kF32Rows; ++t) {
    const float4 p0 = *reinterpret_cast<const float4*>(slots + t * kSlotLd +
                                                       8 * rg);
    const float4 p1 = *reinterpret_cast<const float4*>(slots + t * kSlotLd +
                                                       8 * rg + 4);
    const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    float b[NJ];
#pragma unroll
    for (int n = 0; n < NJ; ++n) b[n] = B[t * kLd + cg + 16 * n];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NJ; ++n) acc[i][n] = fmaf(p[i], b[n], acc[i][n]);
  }
}

// sum of v over the 16 lanes of a half-warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the rows thread rg owns: r0 + 2 i, i < 8
__device__ __forceinline__ int f32_row0(int rg) {
  return (rg >> 1) * 16 + (rg & 1);
}

// thread's 8 x D/16 tile times `mul` into rows [row0 + r0 + 2 i] (those <
// limit) of the D-wide slice at dst (row stride ld), columns cg + 16 n
template <int D, class Rows>
__device__ __forceinline__ void store_tile_f32(const float (&acc)[8][D / 16],
                                               const float (&mul)[8],
                                               float* dst, int ld, Rows rows,
                                               int row0, int limit, int cg) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 2 * i;
    if (row < limit) {
      float* p = dst + (size_t)rows.offset(row) * ld + cg;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) p[16 * n] = acc[i][n] * mul[i];
    }
  }
}

// Shared memory of a forward block: Q, kF32Stages stages of a K and a V
// tile, the P slots. D = 32: 62 KiB, 64: 102 KiB, 80: 122 KiB.
template <int D>
constexpr size_t fwd_smem_f32() {
  return (size_t)((1 + 2 * kF32Stages) * F32Tile<D>::kFloats +
                  kF32Rows * kSlotLd) * 4;
}

// ---------------------------------------------------------------- forward
// grid (ceil(N / 64), H, sequences), 128 threads. q, k, v point at head 0's
// columns of their row slices (row stride ld_in, head h at + h * D); o at
// head 0's output columns (row stride ld_out). Keys >= n_valid are masked;
// query rows >= N are not stored. lse is (sequences, H, N).
template <int D, class Rows>
__global__ void __launch_bounds__(kF32Threads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, int ld_in, float* __restrict__ o,
             int ld_out, float* __restrict__ lse, Rows rows, int N,
             int n_valid, float scale) {
  constexpr int NJ = D / 16, kTile = F32Tile<D>::kFloats;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* ring = Qs + kTile;                              // K, V per stage
  float* slots = ring + kF32Stages * 2 * kTile;          // P
  const int h = blockIdx.y, H = gridDim.y, seq = blockIdx.z;
  const int q0 = blockIdx.x * kF32Rows;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15, r0 = f32_row0(rg);
  const size_t base = rows.base(seq);
  q += base * ld_in + h * D;
  k += base * ld_in + h * D;
  v += base * ld_in + h * D;
  o += base * ld_out + h * D;
  const int n_tiles = (n_valid + kF32Rows - 1) / kF32Rows;

  auto load_tile = [&](int t) {
    float* Kd = ring + (t % kF32Stages) * 2 * kTile;
    load_rows_f32<D>(Kd, k, ld_in, rows, t * kF32Rows, n_valid);
    load_rows_f32<D>(Kd + kTile, v, ld_in, rows, t * kF32Rows, n_valid);
  };
  load_rows_f32<D>(Qs, q, ld_in, rows, q0, N);
  load_tile(0);                        // with Q: commit group 0
  cp_async_commit();

  float acc[8][NJ], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                   // tile t - 1's stage is free
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q) have landed
    __syncthreads();
    const float* Ks = ring + (t % kF32Stages) * 2 * kTile;
    float s[8][4];
    dot_tile<D>(s, Qs, r0, Ks, cg);
    if ((t + 1) * kF32Rows > n_valid) {  // the tile that holds the last key
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t * kF32Rows + cg + 16 * j >= n_valid)
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = -CUDART_INF_F;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      mx = fmaxf(mx, m[i]);
      const float alpha = exp2_approx((m[i] - mx) * sl2);   // 0 at t = 0
      m[i] = mx;
      const float ms = mx * sl2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2_approx(fmaf(s[i][j], sl2, -ms));
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NJ; ++n) acc[i][n] *= alpha;
    }
    put_slots(slots, s, rg, cg);       // the previous tile's reads are done
    __syncwarp();
    slot_product<D>(acc, slots, rg, Ks + kTile, cg);
  }
  cp_async_wait<0>();                  // only empty groups can be left

  float inv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float sum = half_warp_sum(l[i]);
    inv[i] = 1.f / sum;
    const int row = q0 + r0 + 2 * i;
    if (cg == 0 && row < N)
      lse[((size_t)seq * H + h) * N + row] = m[i] * scale + logf(sum);
  }
  store_tile_f32<D>(acc, inv, o, ld_out, rows, q0 + r0, N, cg);
}

// The f32 forward over `seqs` sequences of N rows placed by `rows`, H heads
// D wide (see attn_fwd_f32 for the pointers and strides).
template <int D, class Rows>
cudaError_t launch_attn_fwd_f32(const void* q, const void* k, const void* v,
                                int ld_in, void* o, int ld_out, void* lse,
                                Rows rows, int seqs, int H, int N,
                                int n_valid, float scale, void* stream) {
  constexpr size_t smem = fwd_smem_f32<D>();
  cudaError_t err = allow_smem(attn_fwd_f32<D, Rows>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kF32Rows - 1) / kF32Rows, H, seqs);
  attn_fwd_f32<D, Rows><<<grid, kF32Threads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, ld_in, (float*)o,
      ld_out, (float*)lse, rows, N, n_valid, scale);
  return cudaGetLastError();
}

// The f32 packed-QKV forward: qkv (tokens, 3C) -> out (tokens, C), no key
// mask.
template <int D, class Rows>
cudaError_t launch_packed_fwd_f32(const void* qkv, void* out, void* lse,
                                  Rows rows, int seqs, int N, int H,
                                  float scale, void* stream) {
  const int C = H * D;
  const float* x = (const float*)qkv;
  return launch_attn_fwd_f32<D>(x, x + C, x + 2 * C, 3 * C, out, C, lse,
                                rows, seqs, H, N, N, scale, stream);
}

}  // namespace
