// Blockwise (flash-style) softmax attention over long sequences, forward and
// backward, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernels in ssl4gie_tpu/kernels/flash_attention.py:
// `_fwd_kernel` (pallas_call in `_flash_fwd`), `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (pallas_calls in `_flash_bwd_vjp`). Same function: q, k,
// v are (BH, N, 64) bf16, keys >= n_valid are masked; the forward returns
// o (BH, N, 64) and each row's log-sum-exp as (BH, N) float32 (the TPU's
// 8-sublane broadcast of it is tiling, not semantics); the backward takes
// o, the log-sum-exp and dO and returns dq, dk, dv.
//
// What bounds it on the card: at ViT-Det's global blocks (N = 4096, 12
// heads of 64, B images) the scores of one head are 64 MB in float32, so
// they must never reach device memory, and one head's K and V (512 KB each
// in bf16) do not fit in shared memory. The work is 4096 x 4096 x 64
// products per head, two in the forward and seven in the backward (five, and
// the scores and dP recomputed by its second kernel), so the tensor cores
// bound it; what keeps a kernel from them is the work around the products
// (shared-memory traffic, the softmax's issue slots, waiting on copies).
// - The forward is the shared online-softmax core, `attn_fwd` of
//   attention_core.cuh, on DenseRows with q, k, v apart (row stride 64), in
//   blocks of two warpgroups (128 query rows) that share each K/V tile:
//   keys stream through a 3-stage cp.async ring in tiles of 64, Q.K^T is
//   computed once per tile by wgmma into registers, the probabilities stay
//   in registers as the A operand of P.V, and the loop stops at the last
//   tile that holds a key < n_valid. Two warpgroups halve the K/V traffic
//   per product against one, which is what the long key loop pays for.
// - The backward is two kernels and no atomics: `flash_bwd_dq` over query
//   tiles (it also writes delta = rowsum(dO * O)), then `flash_bwd_dkv` over
//   key tiles with the queries streaming, both on the WMMA helpers of
//   attention_core.cuh with keys in 128-row tiles; in both, key columns >=
//   n_valid get p = 0 before the exponent could overflow (a row with lse <
//   -87 would otherwise give exp(-lse) = inf and inf * 0 = NaN, ADVICE r2),
//   so padded keys also get zero dk and dv.

#include "attention_core.cuh"

namespace {

constexpr int kKT = 128;   // key (or query) rows per streamed backward tile

// ---------------------------------------------------------------- dq
// grid (N / kRows, BH). smem: K, V tiles (kKT rows), Q, dO (kRows rows), per
// warp a kTileF f32 area (two score tiles) and one bf16 tile. Also writes
// delta per row.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const float* __restrict__ lse, const bf16* __restrict__ dout,
             float* __restrict__ delta, bf16* __restrict__ dq, int N,
             int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kKT * kLd;
  bf16* Qs = Vs + kKT * kLd;
  bf16* Gs = Qs + kRows * kLd;
  float* S = reinterpret_cast<float*>(Gs + kRows * kLd) + warp * kTileF;
  float* D = S + 16 * kLdS;
  bf16* P = reinterpret_cast<bf16*>(reinterpret_cast<float*>(Gs + kRows * kLd) +
                                    kWarps * kTileF) + warp * 16 * kLdP;
  const DenseRows rows{N};

  stage(Qs, q, rows, bh, q0, kRows, N, kDh);
  stage(Gs, dout, rows, bh, q0, kRows, N, kDh);
  __syncthreads();

  const int r = lane & 15, half = lane >> 4;
  const int qrow = q0 + warp * 16 + r;
  const size_t stat = (size_t)bh * N + qrow;
  float dl = 0.f, row_lse = CUDART_INF_F;      // rows >= N get p = 0
  if (qrow < N) {
    const bf16* orow = o + stat * kDh + half * 32;
    const bf16* grow = Gs + (warp * 16 + r) * kLd + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      dl += __bfloat162float(orow[c]) * __bfloat162float(grow[c]);
    row_lse = lse[stat];
  }
  dl += __shfl_xor_sync(kFull, dl, 16);
  if (half == 0 && qrow < N) delta[stat] = dl;

  FragA qa[4], ga[4];
  load_rows(qa, Qs + warp * 16 * kLd);
  load_rows(ga, Gs + warp * 16 * kLd);
  FragC acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
  const float* Srow = S + r * kLdS + half * 16;
  const float* Drow = D + r * kLdS + half * 16;
  bf16* Prow = P + r * kLdP + half * 16;
  for (int t0 = 0; t0 < n_valid; t0 += kKT) {
    __syncthreads();
    stage(Ks, k, rows, bh, t0, kKT, n_valid, kDh);
    stage(Vs, v, rows, bh, t0, kKT, n_valid, kDh);
    __syncthreads();
    const int tn = min(kKT, n_valid - t0);
    for (int c0 = 0; c0 < tn; c0 += kChunk) {
      scores(S, qa, Ks + c0 * kLd);        // q . k
      scores(D, ga, Vs + c0 * kLd);        // dP = dO . v
      __syncwarp();
      const int key0 = t0 + c0 + half * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p =
            key0 + j < n_valid ? expf(Srow[j] * scale - row_lse) : 0.f;
        Prow[j] = __float2bfloat16(p * (Drow[j] - dl));   // dS
      }
      __syncwarp();
      accumulate(acc, P, Ks + c0 * kLd);   // dq += dS . K
      __syncwarp();
    }
  }
  write_rows(acc, S, scale, dq, rows, bh, q0 + warp * 16, N, kDh);
}

// ---------------------------------------------------------------- dk, dv
// grid (N / kRows, BH) over KEY rows. smem: the block's K and V rows, Q and
// dO tiles (kKT rows), lse and delta of the tile, per warp a kTileF f32 area
// (two score tiles) and two bf16 tiles.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ lse,
              const bf16* __restrict__ dout, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
              int n_valid, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * kLd;
  bf16* Qs = Vs + kRows * kLd;
  bf16* Gs = Qs + kKT * kLd;
  float* lse_s = reinterpret_cast<float*>(Gs + kKT * kLd);
  float* delta_s = lse_s + kKT;
  float* S = delta_s + kKT + warp * kTileF;
  float* D = S + 16 * kLdS;
  bf16* P = reinterpret_cast<bf16*>(delta_s + kKT + kWarps * kTileF) +
            warp * 2 * 16 * kLdP;
  bf16* DS = P + 16 * kLdP;
  const DenseRows rows{N};

  stage(Ks, k, rows, bh, k0, kRows, n_valid, kDh);
  stage(Vs, v, rows, bh, k0, kRows, n_valid, kDh);
  __syncthreads();
  FragA ka[4], va[4];
  load_rows(ka, Ks + warp * 16 * kLd);
  load_rows(va, Vs + warp * 16 * kLd);
  FragC dkf[4], dvf[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(dkf[n], 0.f);
    wmma::fill_fragment(dvf[n], 0.f);
  }
  const int r = lane & 15, half = lane >> 4;
  // this lane's key row; a padded key gets p = 0 (masked before the exponent)
  const bool key_ok = k0 + warp * 16 + r < n_valid;
  const float* Srow = S + r * kLdS + half * 16;
  const float* Drow = D + r * kLdS + half * 16;
  bf16* Prow = P + r * kLdP + half * 16;
  bf16* DSrow = DS + r * kLdP + half * 16;
  const size_t r0 = (size_t)bh * N;
  for (int t0 = 0; t0 < N; t0 += kKT) {
    __syncthreads();
    stage(Qs, q, rows, bh, t0, kKT, N, kDh);
    stage(Gs, dout, rows, bh, t0, kKT, N, kDh);
    for (int i = threadIdx.x; i < kKT; i += blockDim.x) {
      const int g = t0 + i;
      lse_s[i] = g < N ? lse[r0 + g] : CUDART_INF_F;   // queries >= N: p = 0
      delta_s[i] = g < N ? delta[r0 + g] : 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < kKT; c0 += kChunk) {
      scores(S, ka, Qs + c0 * kLd);        // (k . q)^T
      scores(D, va, Gs + c0 * kLd);        // dP^T = v . dO
      __syncwarp();
      const int qi = c0 + half * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = key_ok ? expf(Srow[j] * scale - lse_s[qi + j]) : 0.f;
        Prow[j] = __float2bfloat16(p);
        DSrow[j] = __float2bfloat16(p * (Drow[j] - delta_s[qi + j]));
      }
      __syncwarp();
      accumulate(dvf, P, Gs + c0 * kLd);   // dv += P^T . dO
      accumulate(dkf, DS, Qs + c0 * kLd);  // dk += dS^T . Q
      __syncwarp();
    }
  }
  write_rows(dkf, S, scale, dk, rows, bh, k0 + warp * 16, N, kDh);
  write_rows(dvf, S, 1.f, dv, rows, bh, k0 + warp * 16, N, kDh);
}

// Shared memory per backward block: 77 and 83 KiB, whatever N.
constexpr size_t kDqSmem =
    (2 * kKT + 2 * kRows) * kLd * 2 + kWarps * (kTileF * 4 + 16 * kLdP * 2);
constexpr size_t kDkvSmem = (2 * kRows + 2 * kKT) * kLd * 2 + 2 * kKT * 4 +
                            kWarps * (kTileF * 4 + 2 * 16 * kLdP * 2);

}  // namespace

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError(). The Python wrapper checks the shapes, the dtype
// (bf16), D == 64, N a multiple of 64 and 1 <= n_valid <= N before calling.
extern "C" int ssl4gie_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int N,
                                 int n_valid, float scale, void* stream) {
  return (int)launch_attn_fwd<kDh, 2>(q, k, v, kDh, o, kDh, lse, DenseRows{N},
                                      BH, 1, N, n_valid, scale, stream);
}

extern "C" int ssl4gie_flash_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, void* delta, void* dq,
                                 void* dk, void* dv, int BH, int N,
                                 int n_valid, float scale, void* stream) {
  cudaError_t err = allow_smem(flash_bwd_dq, kDqSmem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(flash_bwd_dkv, kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kRows, BH);
  cudaStream_t s = (cudaStream_t)stream;
  flash_bwd_dq<<<grid, kThreads, kDqSmem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const float*)lse, (const bf16*)dout, (float*)delta, (bf16*)dq, N,
      n_valid, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv<<<grid, kThreads, kDkvSmem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lse,
      (const bf16*)dout, (const float*)delta, (bf16*)dk, (bf16*)dv, N,
      n_valid, scale);
  return (int)cudaGetLastError();
}
