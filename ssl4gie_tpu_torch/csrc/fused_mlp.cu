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
// products whose two operands are both contiguous along the summed axis
// (K-major), and dy.W2^T reads fc2.weight along its output axis (an
// MN-major B, which wgmma reads transposed).
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
// forward (the GELU is applied in registers to the A operand of the second
// product), and the backward reads h once, in the epilogue of dy.W2^T, and
// writes dh and g there.
//
// The design is the warp-specialised persistent GEMM of gemm_core.cuh (TMA
// producer, two wgmma consumer warpgroups, TMA stores): the forward is two
// launches, (a) h = x.W1^T + b1 stored bf16 and (b) y = gelu(h).W2^T + b2,
// and the backward one. The N tile of each product is the widest of 256,
// 192 and 128 that divides its N (the output width: H for (a), C for (b)),
// and 128 in the backward, whose two consumers take alternate tiles, each
// with its own h tile and staging. A fully fused tile (hidden axis streamed, y accumulated on
// chip) does not fit a block's registers at C = 768 without a cluster.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_core.cuh"

namespace {

// A row-major (rows, cols) bf16 matrix as 64-column (128-byte) boxes of
// box_rows rows in the 128-byte swizzle; rows past the end read as zeros
// and are not written.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_map(map, p, 2, dims, strides, box);
}

// One product on the GEMM core: out (M, N) from A (M, K) and B ((N, K), or
// (K, N) in kDgelu); the kDgelu epilogue also reads h and writes out2
// (both (M, N)).
template <int kMode, int BN>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias,
                        const void* hin, void* out, void* out2, int M, int N,
                        int K, int approx, cudaStream_t stream) {
  using G = GemmShape<kMode, BN>;
  CUtensorMap mA, mB, mOut, mOut2, mH;
  const bool ok =
      tensor_map(&mA, A, M, K, kBM) &&
      (kMode == kDgelu ? tensor_map(&mB, B, K, N, 64)
                       : tensor_map(&mB, B, N, K, BN)) &&
      tensor_map(&mOut, out, M, N, G::kPing ? kBM : 64) &&
      (kMode == kDgelu ? tensor_map(&mOut2, out2, M, N, kBM) &&
                             tensor_map(&mH, hin, M, N, kBM)
                       : true);
  if (!ok) return cudaErrorInvalidValue;
  if (kMode != kDgelu) mOut2 = mH = mOut;       // not read
  const int sms = sm_count();
  if (!sms) return cudaErrorNoDevice;
  // the shared-memory limit, once per instantiation and device
  static bool attributed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !attributed[dev]) {
    err = cudaFuncSetAttribute(mlp_gemm<kMode, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attributed[dev] = true;
  }
  GemmArgs args;
  args.bias = static_cast<const bf16*>(bias);
  args.K = K;
  args.tiles_n = N / BN;
  args.tiles = (M + kBM - 1) / kBM * args.tiles_n;
  args.approx = approx;
  const int grid = args.tiles < sms ? args.tiles : sms;
  mlp_gemm<kMode, BN><<<grid, kGemmThreads, G::kSmem, stream>>>(
      mA, mB, mOut, mOut2, mH, args);
  return cudaGetLastError();
}

// the forward's products, with the widest N tile that divides N
template <int kMode>
cudaError_t launch_fwd(const void* A, const void* B, const void* bias,
                       void* out, int M, int N, int K, int approx,
                       cudaStream_t s) {
  if (N % 256 == 0)
    return launch_gemm<kMode, 256>(A, B, bias, nullptr, out, nullptr, M, N, K,
                                   approx, s);
  if (N % 192 == 0)
    return launch_gemm<kMode, 192>(A, B, bias, nullptr, out, nullptr, M, N, K,
                                   approx, s);
  return launch_gemm<kMode, 128>(A, B, bias, nullptr, out, nullptr, M, N, K,
                                 approx, s);
}

}  // namespace

// Every entry point returns a cudaError_t value: what the launches left in
// cudaGetLastError(), or cudaErrorInvalidValue if a tensor map could not be
// made. The Python wrapper checks the shapes, the dtype (bf16), contiguity,
// 16-byte alignment, C % 128 == 0 and H % 128 == 0 before calling.

// Forward: x (M, C), w1 = fc1.weight (H, C), b1 (H), w2 = fc2.weight (C, H),
// b2 (C) -> h (M, H), y (M, C).
extern "C" int ssl4gie_mlp_fwd(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h, void* y,
                               int M, int C, int H, int approx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_fwd<kBias>(x, w1, b1, h, M, H, C, approx, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd<kGeluBias>(h, w2, b2, y, M, C, H, approx, s);
}

// Backward: h (M, H), dy (M, C), w2 = fc2.weight (C, H) -> dh, g (M, H).
extern "C" int ssl4gie_mlp_bwd(const void* h, const void* dy, const void* w2,
                               void* dh, void* g, int M, int C, int H,
                               int approx, void* stream) {
  return (int)launch_gemm<kDgelu, 128>(dy, w2, nullptr, h, dh, g, M, H, C,
                                       approx, (cudaStream_t)stream);
}

// One forward product alone, with its N tile named (for measuring tile
// choices; ssl4gie_mlp_fwd picks its own): mode 0 = (a) out = A.B^T + bias,
// 1 = (b) out = gelu(A).B^T + bias; A (M, K), B (N, K), bias (N), out
// (M, N); bn 256, 192 or 128. cudaErrorInvalidValue for any other mode or
// tile, or an N that the tile does not divide.
extern "C" int ssl4gie_mlp_gemm(int mode, int bn, const void* A,
                                const void* B, const void* bias, void* out,
                                int M, int N, int K, int approx,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bn <= 0 || N % bn) return (int)cudaErrorInvalidValue;
#define MLP_GEMM(MODE, BN)                                                  \
  if (mode == MODE && bn == BN)                                             \
    return (int)launch_gemm<MODE, BN>(A, B, bias, nullptr, out, nullptr, M, \
                                      N, K, approx, s);
  MLP_GEMM(kBias, 256) MLP_GEMM(kBias, 192) MLP_GEMM(kBias, 128)
  MLP_GEMM(kGeluBias, 256) MLP_GEMM(kGeluBias, 192) MLP_GEMM(kGeluBias, 128)
#undef MLP_GEMM
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a block of the GEMM core in mode (0, 1: as
// ssl4gie_mlp_gemm; 2: the backward) at N tile bn, in bytes; 0 for a pair
// that is not built.
extern "C" int ssl4gie_mlp_smem(int mode, int bn) {
#define MLP_SMEM(MODE, BN) \
  if (mode == MODE && bn == BN) return GemmShape<MODE, BN>::kSmem;
  MLP_SMEM(kBias, 256) MLP_SMEM(kBias, 192) MLP_SMEM(kBias, 128)
  MLP_SMEM(kGeluBias, 256) MLP_SMEM(kGeluBias, 192) MLP_SMEM(kGeluBias, 128)
  MLP_SMEM(kDgelu, 128)
#undef MLP_SMEM
  return 0;
}
