// The transformer MLP, y = gelu(x.W1 + b1).W2 + b2, forward and the fused
// part of its backward, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernels in ssl4gie_tpu/kernels/fused_mlp.py:
// `_fwd_kernel` (pallas_call in `_mlp_fwd`) and `_bwd_kernel` (pallas_call in
// `_mlp_bwd_fused`). Same function: x is (M, C) bf16, the forward writes y
// (M, C) and the pre-GELU hidden h (M, H), which is the backward's residual;
// the backward reads h once and writes dh = gelu'(h) * (dy . W2^T) and
// g = gelu(h) (M, H), from which the caller's plain GEMMs make dx, dW1, dW2.
// Both weights are read in nn.Linear layout, W1 as fc1.weight (H, C) and W2
// as fc2.weight (C, H), so no transpose is ever copied: x.W1 and g.W2 are
// products whose two operands are both contiguous along the summed axis,
// and dy.W2^T reads fc2.weight row-major along its output axis.
//
// What bounds it on the card: at the MAE ViT-B shapes (M = 12,800 tokens at
// C = 768, H = 3072; M = 50,432 at C = 512, H = 2048) the forward is 121 and
// 212 GFLOP against 127 and 314 MB of device traffic, so it is bound by the
// matrix units (0.12 and 0.21 ms at 989 TFLOP/s), and the backward kernel,
// 60 and 106 GFLOP against 260 and 674 MB, by device memory (0.08 and
// 0.20 ms at 3.35 TB/s). The TPU kernel keeps both weights resident in
// VMEM (9 MB for ViT-B); a Hopper block has 227 KB of shared memory, so
// that does not carry over. What the TPU kernel keeps out of device memory
// is kept out here too: g = gelu(h) never reaches device memory in the
// forward (the GELU is applied in f32 to each h tile as it is staged into
// shared memory for the second product), and the backward reads h once, in
// the epilogue of dy.W2^T, and writes dh and g there.
//
// The design: one tiled WMMA GEMM (16x16x16 bf16 products, f32 accumulate)
// with a mode for the prologue and epilogue. A block of 8 warps owns a
// 128 x 128 output tile; each warp a 64 x 32 piece (4 x 2 accumulator
// fragments). The summed axis is walked in 64-wide steps through a ring of
// kStages shared-memory stages filled by cp.async, kStages - 1 steps ahead
// of the products (one barrier per step); in the forward's second product
// each thread applies the GELU in place to the pieces of h it copied, once
// they have landed. Rows >= M are zero-filled on load and not stored, so
// the token count needs no tile multiple; the widths must be multiples of
// 128.
// The forward is two launches, (a) h = x.W1^T + b1 stored bf16 and (b)
// y = gelu(h).W2^T + b2. A fully fused tile (hidden axis streamed, y
// accumulated on chip), wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "async_copy.cuh"

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int kBM = 128, kBN = 128, kBK = 64;   // block tile, summed step
constexpr int kThreads = 256;                   // 8 warps: 2 rows x 4 columns
constexpr int kWM = 64, kWN = 32;               // warp tile
constexpr int kFM = kWM / 16, kFN = kWN / 16;   // 4 x 2 accumulator fragments
constexpr int kLdK = kBK + 8;       // bf16 row of an [rows][kBK] tile (72)
constexpr int kLdN = kBN + 8;       // bf16 row of a [kBK][kBN] tile (136)
constexpr int kTileA = kBM * kLdK;  // elements per A buffer
constexpr int kTileB = kBN * kLdK;  // elements per B buffer (either layout)
static_assert(kTileB >= kBK * kLdN, "a [kBK][kBN] tile must fit a B buffer");
constexpr int kStages = 3;          // cp.async ring depth
constexpr int kLdE = 20;            // f32 row of a warp's 16 x 16 epilogue tile
constexpr int kSmem = kStages * (kTileA + kTileB) * 2;   // 108 KB, dynamic
// 16-byte pieces each thread copies per step, of A and of B
constexpr int kPieces = kBM * kBK / 8 / kThreads;
constexpr int kRowPieces = kBK / 8;         // per row of A or an (N, K) B
constexpr int kColPieces = kBN / 8;         // per row of a (K, N) B
static_assert(kBN * kBK / 8 / kThreads == kPieces, "even B copies");
static_assert(kThreads / 32 * 16 * kLdE * 4 <= kSmem, "epilogue tiles fit");

// prologue / epilogue of the GEMM
enum Mode {
  kBias = 0,      // out = A.B^T + bias                       (forward (a))
  kGeluBias = 1,  // out = gelu(A).B^T + bias                 (forward (b))
  kDgelu = 2,     // acc = A.B; out = acc * gelu'(h), out2 = gelu(h)  (backward)
};

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kRsqrt2 = 0.7071067811865476f;
constexpr float kRsqrt2Pi = 0.3989422804014327f;

// as `_gelu_f32` / `_dgelu_f32` of the JAX kernel: tanh form when `approx`,
// else the exact erf form
__device__ __forceinline__ float gelu(float h, int approx) {
  if (approx)
    return 0.5f * h * (1.f + tanhf(kSqrt2OverPi * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * kRsqrt2));
}

// gelu(h) and gelu'(h) from one tanh (or erf)
__device__ __forceinline__ void gelu_and_grad(float h, int approx, float& g,
                                              float& dg) {
  if (approx) {
    const float t = tanhf(kSqrt2OverPi * (h + 0.044715f * h * h * h));
    const float dt = (1.f - t * t) * kSqrt2OverPi * (1.f + 3.f * 0.044715f * h * h);
    g = 0.5f * h * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * h * dt;
  } else {
    const float e = erff(h * kRsqrt2);
    g = 0.5f * h * (1.f + e);
    dg = 0.5f * (1.f + e) + h * expf(-0.5f * h * h) * kRsqrt2Pi;
  }
}

// One 128 x 128 tile of the (M, N) output. A is (M, K) row-major; B is
// (N, K) row-major (nn.Linear weight, modes kBias and kGeluBias) or (K, N)
// row-major (mode kDgelu). K is a multiple of kBK, N of kBN.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
mlp_gemm(const bf16* __restrict__ A, const bf16* __restrict__ B,
         const bf16* __restrict__ bias, const bf16* __restrict__ hin,
         bf16* __restrict__ out, bf16* __restrict__ out2, int M, int N, int K,
         int approx) {
  constexpr bool kNK = kMode != kDgelu;     // B in nn.Linear layout (N, K)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);   // kStages [kBM][kLdK] buffers
  bf16* Bs = As + kStages * kTileA;           // kStages B buffers
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * kWM, wn = (warp & 3) * kWN;

  // Each thread copies kPieces 16-byte pieces of A and of B per step: A
  // (and an (N, K) B) as 128 rows x kRowPieces, a (K, N) B as kBK rows x
  // kColPieces.
  auto fetch = [&](int t) {
    const int k0 = t * kBK;
    bf16* as = As + (t % kStages) * kTileA;
    bf16* bs = Bs + (t % kStages) * kTileB;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kRowPieces, c = (idx % kRowPieces) * 8;
      const int row = m0 + r;
      cp_async16(as + r * kLdK + c,
                 A + (size_t)(row < M ? row : M - 1) * K + k0 + c, row < M);
      if (kNK) {
        cp_async16(bs + r * kLdK + c, B + (size_t)(n0 + r) * K + k0 + c, true);
      } else {
        const int rk = idx / kColPieces, cn = (idx % kColPieces) * 8;
        cp_async16(bs + rk * kLdN + cn, B + (size_t)(k0 + rk) * N + n0 + cn,
                   true);
      }
    }
  };
  // g = gelu(h) in f32, rounded once, over this thread's own pieces of A
  auto gelu_tile = [&](int t) {
    bf16* as = As + (t % kStages) * kTileA;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int idx = tid + i * kThreads;
      uint4* p = reinterpret_cast<uint4*>(as + (idx / kRowPieces) * kLdK +
                                          (idx % kRowPieces) * 8);
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(gelu(__bfloat162float(e[j]), approx));
      *p = v;
    }
  };

  FragC acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int steps = K / kBK;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) fetch(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();            // this thread's step t landed
    if (kMode == kGeluBias) gelu_tile(t);
    __syncthreads();   // step t visible to all; step t - 1's stage is free
    if (t + kStages - 1 < steps) fetch(t + kStages - 1);
    cp_async_commit();
    const bf16* as = As + (t % kStages) * kTileA;
    const bf16* bs = Bs + (t % kStages) * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[kFM];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + i * 16) * kLdK + kk, kLdK);
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        if (kNK) {
          FragBt b;
          wmma::load_matrix_sync(b, bs + (wn + j * 16) * kLdK + kk, kLdK);
#pragma unroll
          for (int i = 0; i < kFM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        } else {
          FragB b;
          wmma::load_matrix_sync(b, bs + kk * kLdN + wn + j * 16, kLdN);
#pragma unroll
          for (int i = 0; i < kFM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free for the epilogue tiles

  // Epilogue, one 16 x 16 fragment at a time through the warp's f32 tile in
  // the (now free) shared memory: lane -> row lane / 2, 8 columns.
  float* E = reinterpret_cast<float*>(smem) + warp * 16 * kLdE;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(E, acc[i][j], kLdE, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm + i * 16 + er, col = n0 + wn + j * 16 + ec;
      if (row < M) {
        const float* e = E + er * kLdE + ec;
        const size_t o = (size_t)row * N + col;
        __align__(16) bf16 r1[8];
        if (kMode != kDgelu) {
          const uint4 bv = *reinterpret_cast<const uint4*>(bias + col);
          const bf16* b = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            r1[c] = __float2bfloat16(e[c] + __bfloat162float(b[c]));
        } else {
          const uint4 hv = *reinterpret_cast<const uint4*>(hin + o);
          const bf16* hh = reinterpret_cast<const bf16*>(&hv);
          __align__(16) bf16 r2[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float g, dg;
            gelu_and_grad(__bfloat162float(hh[c]), approx, g, dg);
            r1[c] = __float2bfloat16(e[c] * dg);
            r2[c] = __float2bfloat16(g);
          }
          *reinterpret_cast<uint4*>(out2 + o) = *reinterpret_cast<const uint4*>(r2);
        }
        *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(r1);
      }
      __syncwarp();
    }
  }
}

template <int kMode>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias,
                        const void* hin, void* out, void* out2, int M, int N,
                        int K, int approx, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_gemm<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  mlp_gemm<kMode><<<grid, kThreads, kSmem, stream>>>(
      (const bf16*)A, (const bf16*)B, (const bf16*)bias, (const bf16*)hin,
      (bf16*)out, (bf16*)out2, M, N, K, approx);
  return cudaGetLastError();
}

}  // namespace

// Every entry point returns a cudaError_t value: what the launches left in
// cudaGetLastError(). The Python wrapper checks the shapes, the dtype
// (bf16), contiguity, 16-byte alignment, C % 128 == 0 and H % 128 == 0
// before calling.

// Forward: x (M, C), w1 = fc1.weight (H, C), b1 (H), w2 = fc2.weight (C, H),
// b2 (C) -> h (M, H), y (M, C).
extern "C" int ssl4gie_mlp_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h, void* y,
                               int M, int C, int H, int approx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_gemm<kBias>(x, w1, b1, nullptr, h, nullptr, M, H, C,
                                       approx, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm<kGeluBias>(h, w2, b2, nullptr, y, nullptr, M, C, H,
                                     approx, s);
}

// Backward: h (M, H), dy (M, C), w2 = fc2.weight (C, H) -> dh, g (M, H).
extern "C" int ssl4gie_mlp_bwd(const void* h, const void* dy, const void* w2,
                               void* dh, void* g, int M, int C, int H,
                               int approx, void* stream) {
  return (int)launch_gemm<kDgelu>(dy, w2, nullptr, h, dh, g, M, H, C, approx,
                                  (cudaStream_t)stream);
}
