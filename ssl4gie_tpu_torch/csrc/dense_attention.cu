// Packed-QKV multi-head softmax attention for short sequences, forward and
// backward, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernels in ssl4gie_tpu/kernels/dense_attention.py:
// `_fwd_kernel` (forward, pallas_call in `_fused_fwd`) and `_bwd_kernel`
// (backward, pallas_call in `_fused_bwd_vjp`). Same function: qkv is the
// (B, N, 3C) output of the qkv Linear with columns [q_0..q_H-1 | k.. | v..],
// each head Dh wide; the output is (B, N, C) with head h in columns
// [h*Dh, (h+1)*Dh); the backward writes a packed dqkv (B, N, 3C). No head
// split or merge copies on either side. The kernels themselves are the
// shared ones of attention_core.cuh, with one sequence per image
// (`DenseRows`), instantiated for Dh = 64 (ViT-S/B/L) and Dh = 32 (the MAE
// decoder: 512 wide, 16 heads).
//
// What bounds it on the card: at ViT-B 224 (N=197, Dh=64) one (image, head)
// reads 75 KB of q, k, v and does 197x197x64 products: three in the forward
// (the scores twice, for the row statistics and then the probabilities, and
// P.V) and seven in the backward (scores and dP recomputed by both
// kernels). So it is bound by matrix-unit issue, shared-memory traffic and
// occupancy, not by device memory. At Dh = 32 the products halve but the
// softmax work per score does not, so the elementwise passes over the
// 16 x 32 score tiles weigh more. The TPU's 16-row padding and its
// analytic softmax-denominator fix are not needed (keys >= N are masked by
// index); the scale multiplies the f32 scores (the TPU scales q in bf16
// first: one rounding fewer). wgmma, TMA and pipelining are later work.

#include "attention_core.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError() (cudaErrorInvalidValue for a head width the kernels are
// not built for). The Python wrapper checks the shapes, the dtype (bf16),
// Dh in {32, 64} and N <= 512 (at most 194 KiB of shared memory) before
// calling.
extern "C" int ssl4gie_attn_fwd(const void* qkv, void* out, void* lse, int B,
                                int N, int H, int Dh, float scale,
                                void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_attn_fwd<64>(qkv, out, lse, rows, B, N, H, scale,
                                    stream);
  if (Dh == 32)
    return (int)launch_attn_fwd<32>(qkv, out, lse, rows, B, N, H, scale,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_bwd(const void* qkv, const void* out,
                                const void* lse, const void* dout, void* delta,
                                void* dqkv, int B, int N, int H, int Dh,
                                float scale, void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_attn_bwd<64>(qkv, out, lse, dout, delta, dqkv, rows, B,
                                    N, H, scale, stream);
  if (Dh == 32)
    return (int)launch_attn_bwd<32>(qkv, out, lse, dout, delta, dqkv, rows, B,
                                    N, H, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssl4gie_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
