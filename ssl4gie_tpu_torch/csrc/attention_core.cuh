// Shared core of the attention kernels (dense_attention.cu,
// window_attention.cu, flash_attention.cu) on Hopper's tensor cores
// (sm_90a): WMMA 16x16x16 products (bf16 in, f32 accumulate) between a
// warp's 16 rows and staged Dh-wide row slices, the softmax elementwise in
// f32 through a per-warp tile in shared memory, and the packed-QKV
// forward / dq / dk-dv kernels for sequences of at most 512 rows.
//
// The head width Dh is a template parameter `D` of every helper and kernel
// (a multiple of 16: D / 16 k-steps over the head in the score products and
// D / 16 output column tiles in the accumulations). The packed-QKV kernels
// are instantiated for D = 64 (ViT-S/B/L) and D = 32 (the MAE decoder, 512
// wide with 16 heads); the flash kernels use the default, kDh = 64.
//
// Where the rows of a sequence live is a functor `Rows`: rows(seq, r) is the
// token index (row of the flattened (tokens, width) tensor) of row r of
// sequence seq. `DenseRows` is a (B, N, width) tensor, one sequence per
// image; `WindowRows` is one ws x ws window cut straight from a
// (B, GH, GW, width) grid, so the windowed kernels read and write the grid
// layout with no window transposes.
//
// The packed-QKV kernels: qkv is (tokens, 3C) with columns
// [q_0..q_H-1 | k.. | v..], each head D wide; the output is (tokens, C)
// with head h in columns [h*D, (h+1)*D); the backward writes a packed dqkv
// (tokens, 3C). One block of 4 warps per (64-row tile, head, sequence); the
// head's whole K and V (or Q and dO for the dK/dV kernel) are staged once into
// shared memory, rows zero-padded to whole 32-row chunks and padded to D + 8
// values so that matrix loads of neighbouring rows start in different banks;
// each warp owns 16 rows and walks the other sequence in chunks of 32. Keys
// >= N are masked by index. The forward takes two passes over the keys, row
// max and sum first, then normalized probabilities (bf16) times V, so no
// running rescale of the output is needed; it saves each row's log-sum-exp.
// The backward is two kernels instead of atomics (run-to-run
// nondeterministic): `attn_bwd_dq` walks query rows, computes delta =
// rowsum(dO * O) and dq; `attn_bwd_dkv` walks key rows and recomputes P from
// the saved log-sum-exp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

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

// One sequence per image of a (B, N, width) tensor.
struct DenseRows {
  int N;
  __device__ __forceinline__ size_t operator()(int seq, int r) const {
    return (size_t)seq * N + r;
  }
};

// Window seq = (b * nh + wy) * nw + wx of a (B, GH, GW, width) grid; row r
// of a window sits at grid cell (wy * ws + r / ws, wx * ws + r % ws).
struct WindowRows {
  int ws, nh, nw, GW;
  __device__ __forceinline__ size_t operator()(int seq, int r) const {
    const int wx = seq % nw, t = seq / nw;
    const int wy = t % nh, b = t / nh;
    const int ry = r / ws, rx = r - ry * ws;
    return ((size_t)b * nh * ws + wy * ws + ry) * GW + wx * ws + rx;
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
// grid (ceil(N / kRows), H, sequences). smem: K, V (NP rows), Q (kRows
// rows), per warp a kTileF f32 area and a 16 x kLdP bf16 tile. lse is
// (sequences, H, N).
template <int D, class Rows>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out,
         float* __restrict__ lse, Rows rows, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int L = kLdRow<D>, K = D / 16;
  const int NP = (N + kChunk - 1) / kChunk * kChunk;
  const int h = blockIdx.y, seq = blockIdx.z, q0 = blockIdx.x * kRows;
  const int C = H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * L;
  bf16* Qs = Vs + NP * L;
  float* S = reinterpret_cast<float*>(Qs + kRows * L) + warp * kTileF;
  bf16* P = reinterpret_cast<bf16*>(reinterpret_cast<float*>(Qs + kRows * L) +
                                    kWarps * kTileF) + warp * 16 * kLdP;

  stage<D>(Ks, qkv + C + h * D, rows, seq, 0, NP, N, C3);
  stage<D>(Vs, qkv + 2 * C + h * D, rows, seq, 0, NP, N, C3);
  stage<D>(Qs, qkv + h * D, rows, seq, q0, kRows, N, C3);
  __syncthreads();

  FragA qa[K];
  load_rows<D>(qa, Qs + warp * 16 * L);
  // elementwise: row r of the warp's 16, columns half * 16 + [0, 16)
  const int r = lane & 15, half = lane >> 4;
  const float* Srow = S + r * kLdS + half * 16;

  float m = -1e30f, l = 0.f;
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    scores<D>(S, qa, Ks + c0 * L);
    __syncwarp();
    const int key0 = c0 + half * 16;
    float cm = -1e30f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (key0 + j < N) cm = fmaxf(cm, Srow[j] * scale);
    const float mn = fmaxf(m, cm);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (key0 + j < N) sum += expf(Srow[j] * scale - mn);
    l = l * expf(m - mn) + sum;
    m = mn;
    __syncwarp();
  }
  {
    const float mo = __shfl_xor_sync(kFull, m, 16);
    const float lo = __shfl_xor_sync(kFull, l, 16);
    const float mt = fmaxf(m, mo);
    l = l * expf(m - mt) + lo * expf(mo - mt);
    m = mt;
  }
  const float row_lse = m + logf(l);
  const int qrow = q0 + warp * 16 + r;
  if (half == 0 && qrow < N) lse[((size_t)seq * H + h) * N + qrow] = row_lse;

  FragC acc[K];
#pragma unroll
  for (int n = 0; n < K; ++n) wmma::fill_fragment(acc[n], 0.f);
  bf16* Prow = P + r * kLdP + half * 16;
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    scores<D>(S, qa, Ks + c0 * L);
    __syncwarp();
    const int key0 = c0 + half * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      Prow[j] = __float2bfloat16(key0 + j < N ? expf(Srow[j] * scale - row_lse)
                                              : 0.f);
    __syncwarp();
    accumulate<D>(acc, P, Vs + c0 * L);
    __syncwarp();
  }
  write_rows<D>(acc, S, 1.f, out + h * D, rows, seq, q0 + warp * 16, N, C);
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

// Shared memory per block. At D = 64 and N = 197: 95, 104 and 111 KiB, so
// two blocks fit on one SM (228 KiB); at N = 256: 104, 113 and 120 KiB; at
// N = 512: 176, 185 and 194 KiB. At D = 32 and N = 197: 63, 68 and 75 KiB,
// so three blocks fit.
template <int D>
size_t fwd_smem(int N) {
  return (2 * (size_t)pad_rows(N) + kRows) * kLdRow<D> * 2 +
         kWarps * ((size_t)kTileF * 4 + 16 * kLdP * 2);
}
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

// The packed-QKV forward over `seqs` sequences of N rows placed by `rows`,
// heads D wide.
template <int D = kDh, class Rows>
cudaError_t launch_attn_fwd(const void* qkv, void* out, void* lse, Rows rows,
                            int seqs, int N, int H, float scale, void* stream) {
  cudaError_t err = allow_smem(attn_fwd<D, Rows>, fwd_smem<D>(N));
  if (err != cudaSuccess) return err;
  dim3 grid((N + kRows - 1) / kRows, H, seqs);
  attn_fwd<D, Rows><<<grid, kThreads, fwd_smem<D>(N), (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, (float*)lse, rows, N, H, scale);
  return cudaGetLastError();
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
