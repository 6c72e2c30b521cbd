// Windowed multi-head attention read straight from the (B, GH, GW, 3C)
// packed-qkv grid, forward and backward, on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernels in ssl4gie_tpu/kernels/window_attention.py:
// `_fwd_kernel` (pallas_call in `_call_fwd`) and `_bwd_kernel` (pallas_call
// in `_wfa_bwd`). Same function: each ws x ws window of the grid is one
// attention sequence of ws*ws tokens (256 for ViTDet's 16 x 16 windows);
// the output (B, GH, GW, C) and the backward's dqkv (B, GH, GW, 3C) are
// written in grid layout. The TPU kernel exists to avoid the two window
// transposes per block of the reshape formulation; here the row functor
// `WindowRows` of attention_core.cuh computes each window row's grid address
// (b, wy*ws + r/ws, wx*ws + r%ws), so the dense kernels' staging loads and
// output stores read and write the grid in place and no transpose touches
// device memory.
//
// What bounds it on the card: at ViT-Det 1024 px (64 x 64 grid, 16 windows
// per image, 12 heads of 64) one (window, head) reads 96 KB of q, k, v and
// does 256x256x64 products, two in the forward and seven in the backward:
// the tensor cores and the work around them (shared-memory traffic, the
// softmax, waiting on copies), not device memory. Both directions are the
// shared core of attention_core.cuh on one warpgroup per 64 rows, with
// wgmma for every product: a window's 64-row tile is four grid rows of 16
// tokens, each (16 x 64) piece of a head contiguous in the grid, and
// cp.async brings it 16 B a thread into a 3-stage ring, so shared memory
// per block does not depend on the window size (the forward 57 KiB, the
// backward's two kernels 65 and 66.5 KiB). `WindowRows` finds a window's
// grid origin once per block and each row's offset from it by a multiply
// and a shift. 256 tokens need no key masking. The forward saves each row's
// log-sum-exp (the TPU kernel recomputes it in the backward; either is
// right), and the backward is the dq kernel then the dk/dv kernel, so no
// atomics and gradients that match from run to run. The float32 entries run
// the 3xTF32 wgmma forward and backward of attention_tf32.cuh over the
// same `WindowRows`.

#include "attention_core.cuh"
#include "attention_tf32.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError(). The Python wrapper checks the shapes, the dtype (bf16;
// float32 for the `_f32` entries), Dh == 64, GH and GW multiples of ws,
// and ws * ws <= 512 before calling.
// lse and delta are (B * (GH/ws) * (GW/ws), H, ws*ws) float32.
extern "C" int ssl4gie_window_attn_fwd(const void* qkv, void* out, void* lse,
                                       int B, int GH, int GW, int ws, int H,
                                       float scale, void* stream) {
  const int seqs = B * (GH / ws) * (GW / ws);
  return (int)launch_packed_fwd(qkv, out, lse, window_rows(GH, GW, ws), seqs,
                                ws * ws, H, scale, stream);
}

extern "C" int ssl4gie_window_attn_bwd(const void* qkv, const void* out,
                                       const void* lse, const void* dout,
                                       void* delta, void* dqkv, int B, int GH,
                                       int GW, int ws, int H, float scale,
                                       void* stream) {
  const int seqs = B * (GH / ws) * (GW / ws);
  return (int)launch_packed_bwd(qkv, out, lse, dout, delta, dqkv,
                                window_rows(GH, GW, ws), seqs, ws * ws, H,
                                scale, stream);
}

extern "C" int ssl4gie_window_attn_fwd_f32(const void* qkv, void* out,
                                           void* lse, int B, int GH, int GW,
                                           int ws, int H, float scale,
                                           void* stream) {
  const int seqs = B * (GH / ws) * (GW / ws);
  return (int)launch_packed_fwd_f32<kDh>(qkv, out, lse,
                                         window_rows(GH, GW, ws), seqs,
                                         ws * ws, H, scale, stream);
}

extern "C" int ssl4gie_window_attn_bwd_f32(const void* qkv, const void* out,
                                           const void* lse, const void* dout,
                                           void* delta, void* dqkv, int B,
                                           int GH, int GW, int ws, int H,
                                           float scale, void* stream) {
  const int seqs = B * (GH / ws) * (GW / ws);
  return (int)launch_packed_bwd_f32<kDh>(qkv, out, lse, dout, delta, dqkv,
                                         window_rows(GH, GW, ws), seqs,
                                         ws * ws, H, scale, stream);
}
