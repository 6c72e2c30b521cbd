// The window-attention A/B variant of the JAX package's kernel harness on
// the resident-sequence core of attention_resident.cuh (sm_90a): windowed
// attention read straight from the (B, GH, GW, 3C) packed-qkv grid (Dh =
// 64, ws * ws <= 256 tokens a window), with G horizontally adjacent windows
// a block.
//
// Replaces the Pallas TPU kernels of benchmarks/bench_window_kernel.py #12
// `_mk_v2` (`_fwd_kernel_v2`, `_bwd_kernel_v2`): the scale folded into q in
// bf16, the unnormalised exponent rounded to bf16 for P.V and the division
// applied to the (N, Dh) output, G windows a program. Both kernels are the
// persistent TMA kernels of #10 on 256-key tiles (16 x 16 windows need no
// key mask): `res_fwd_tma` and `res_bwd_tma` (dQ, dK and dV of a window in
// one pass, as `_bwd_kernel_v2` in one program). Each moves a window's
// rows as one TMA box of a 4-D map over the grid, (1, ws, ws, 64), which
// lands them in window order, so no window transpose touches device
// memory.
//
// What bounds it on the card: at ViT-Det 1024 px (4 images, 64 x 64 grid,
// 16 windows an image, 12 heads) device memory, by a factor of two to three
// over the products. Each window's operands are read once per head, where
// the streaming core of #4 / #5 re-reads K and V (or Q and dO) once per
// 64-row tile (four times a window).

#include "attention_resident.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError() (cudaErrorInvalidValue for a tensor map that could
// not be made). The Python wrapper checks the shapes, the dtype
// (bf16), Dh == 64, GH and GW multiples of ws, ws * ws <= 256 and that G
// divides GW / ws before calling. lse is (B * (GH/ws) * (GW/ws), H, ws*ws)
// float32.
extern "C" int ssl4gie_window_attn_v2_fwd(const void* qkv, void* out,
                                          void* lse, int B, int GH, int GW,
                                          int ws, int H, int G, float scale,
                                          void* stream) {
  return (int)launch_window_v2_fwd(qkv, out, lse, B, GH, GW, ws, H, G, scale,
                                   stream);
}

extern "C" int ssl4gie_window_attn_v2_bwd(const void* qkv, const void* out,
                                          const void* lse, const void* dout,
                                          void* dqkv, int B, int GH, int GW,
                                          int ws, int H, int G, float scale,
                                          void* stream) {
  return (int)launch_window_v2_bwd(qkv, out, lse, dout, dqkv, B, GH, GW, ws,
                                   H, G, scale, stream);
}
