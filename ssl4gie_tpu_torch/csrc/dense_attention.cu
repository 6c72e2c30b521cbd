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
// (`DenseRows`), instantiated for Dh = 64 (ViT-S/B/L), Dh = 32 (the MAE
// decoder: 512 wide, 16 heads) and Dh = 80 (the MAE ViT-H: 1280 wide, 16
// heads; its tiles are split into a 64-column and a 16-column part, see
// `Swz<80>`). The float32 entries run the FFMA kernels of attention_f32.cuh
// on the same layout at the same three head widths.
//
// What bounds it on the card: at ViT-B 224 (N=197, Dh=64) one (image, head)
// reads 75 KB of q, k, v and does 197x197x64 products: two in the forward
// (Q.K^T and P.V, once each, in the online-softmax core `attn_fwd`) and
// seven in the backward (S and dP computed by both of its kernels,
// `attn_bwd_dq` and `attn_bwd_dkv`). So it is bound by the tensor cores and
// the work around them (shared-memory traffic, the softmax, occupancy), not
// by device memory. At Dh = 32 the products halve but the softmax work per
// score does not, so the softmax weighs more. N = 197 ends in a partial
// 64-row tile, whose rows >= N are zero-filled and masked by index. The
// TPU's 16-row padding and its analytic softmax-denominator fix are not
// needed; the scale multiplies the f32 scores (the TPU scales q in bf16
// first: one rounding fewer). Every product of both directions is wgmma on
// one warpgroup per 64 rows, with K/V (or Q/dO) streamed through a cp.async
// ring, so shared memory per block does not grow with N.

#include "attention_core.cuh"
#include "attention_f32.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError() (cudaErrorInvalidValue for a head width the kernels are
// not built for). The Python wrapper checks the shapes, the dtype (bf16 for
// the first two entries, float32 for the `_f32` ones), Dh in {32, 64, 80}
// and N <= 512 (the range the model routes here, as the JAX kernel's) before
// calling.
extern "C" int ssl4gie_attn_fwd(const void* qkv, void* out, void* lse, int B,
                                int N, int H, int Dh, float scale,
                                void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_packed_fwd<64>(qkv, out, lse, rows, B, N, H, scale,
                                      stream);
  if (Dh == 32)
    return (int)launch_packed_fwd<32>(qkv, out, lse, rows, B, N, H, scale,
                                      stream);
  if (Dh == 80)
    return (int)launch_packed_fwd<80>(qkv, out, lse, rows, B, N, H, scale,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_bwd(const void* qkv, const void* out,
                                const void* lse, const void* dout, void* delta,
                                void* dqkv, int B, int N, int H, int Dh,
                                float scale, void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_packed_bwd<64>(qkv, out, lse, dout, delta, dqkv, rows,
                                      B, N, H, scale, stream);
  if (Dh == 32)
    return (int)launch_packed_bwd<32>(qkv, out, lse, dout, delta, dqkv, rows,
                                      B, N, H, scale, stream);
  if (Dh == 80)
    return (int)launch_packed_bwd<80>(qkv, out, lse, dout, delta, dqkv, rows,
                                      B, N, H, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_fwd_f32(const void* qkv, void* out, void* lse,
                                    int B, int N, int H, int Dh, float scale,
                                    void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_packed_fwd_f32<64>(qkv, out, lse, rows, B, N, H, scale,
                                          stream);
  if (Dh == 32)
    return (int)launch_packed_fwd_f32<32>(qkv, out, lse, rows, B, N, H, scale,
                                          stream);
  if (Dh == 80)
    return (int)launch_packed_fwd_f32<80>(qkv, out, lse, rows, B, N, H, scale,
                                          stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_bwd_f32(const void* qkv, const void* out,
                                    const void* lse, const void* dout,
                                    void* delta, void* dqkv, int B, int N,
                                    int H, int Dh, float scale, void* stream) {
  const DenseRows rows{N};
  if (Dh == 64)
    return (int)launch_packed_bwd_f32<64>(qkv, out, lse, dout, delta, dqkv,
                                          rows, B, N, H, scale, stream);
  if (Dh == 32)
    return (int)launch_packed_bwd_f32<32>(qkv, out, lse, dout, delta, dqkv,
                                          rows, B, N, H, scale, stream);
  if (Dh == 80)
    return (int)launch_packed_bwd_f32<80>(qkv, out, lse, dout, delta, dqkv,
                                          rows, B, N, H, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssl4gie_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
