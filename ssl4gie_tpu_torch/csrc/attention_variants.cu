// The dense-attention A/B variants of the JAX package's kernel harness, on
// the resident-sequence core of attention_resident.cuh (sm_90a). Same
// function as dense_attention.cu (packed qkv (B, N, 3C) -> out (B, N, C),
// the backward a packed dqkv), for N <= Nb <= 256 and Dh = 64.
//
// Replaces the Pallas TPU kernels of benchmarks/bench_attention_kernel.py:
// - #10 `_mk_v2` (`_fwd_kernel_v2`, `_bwd_kernel_v2`): Nb-row blocks (256,
//   or 208 for its "v3" leg) and G images a program; q scaled in bf16 before
//   Q.K^T, the unnormalised exponent rounded to bf16 for P.V and the
//   division applied to the (N, Dh) output; the backward recomputes the
//   softmax. Here: `res_fwd_tma` (the persistent TMA forward, saving each
//   row's log-sum-exp) and `res_bwd_tma` (the persistent TMA backward: dQ,
//   dK and dV of a sequence in one pass, five products, as `_bwd_kernel_v2`
//   does in one program).
// - #11 `_mk_v4` (`_fwd_kernel_v4`, `_bwd_kernel_v4`): "save-P", the forward
//   also writes the normalised softmax P as bf16, (B, H, N, Nb) here, and
//   the backward reads it instead of recomputing S and the exponent: delta
//   = rowsum(P * dP) from the bf16 P, dS = P (dP - delta), dQ, dK, dV. Here:
//   the same two persistent kernels as #10 in their kSaveP instance, P
//   stored and read by TMA in 64 x 64 boxes; the backward one kernel, four
//   products a key tile and query chunk and one more a query tile for
//   delta.
// The TPU's pad handling (zeroed k / v rows and the analytic l - pad
// exp(-m)) is not carried over: keys >= N are masked by index. P's rows >= N
// are never written (the TPU kernel fills them from out-of-bounds q), and
// the backward ignores its columns >= N.
//
// What bounds them on the card: at ViT-B 224 (B = 64, N = 197, 12 heads of
// 64) device memory (#11's P, 63 MB at Nb = 208, is written by the forward
// and read by the backward: about 44% and 31% of their bytes); the
// resident design reads each K and V (or Q and dO) once per (sequence,
// head) from device memory, where the streaming core re-reads them once per
// 64-row tile. chip_smoke.py prints each kernel's time beside its bound.

#include "attention_resident.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError() (cudaErrorInvalidValue for an Nb the kernels are not
// built for: 208 or 256 for #10, 208 for #11, the harness's; or a tensor
// map that could not be made). The Python
// wrapper checks the shapes, the dtype (bf16), Dh == 64, Nb, 1 <= N <= Nb
// and G >= 1 before calling. lse is (B, H, N) float32; p is (B, H, N, Nb)
// bf16.
extern "C" int ssl4gie_attn_v2_fwd(const void* qkv, void* out, void* lse,
                                   int B, int N, int H, int Nb, int G,
                                   float scale, void* stream) {
  if (Nb == 256)
    return (int)launch_dense_fwd<256, false>(qkv, out, lse, B, N, H, G, scale,
                                              stream);
  if (Nb == 208)
    return (int)launch_dense_fwd<208, false>(qkv, out, lse, B, N, H, G, scale,
                                              stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_v2_bwd(const void* qkv, const void* out,
                                   const void* lse, const void* dout,
                                   void* dqkv, int B, int N, int H, int Nb,
                                   int G, float scale, void* stream) {
  if (Nb == 256)
    return (int)launch_dense_bwd<256, false>(qkv, out, lse, dout, dqkv, B, N,
                                             H, G, scale, stream);
  if (Nb == 208)
    return (int)launch_dense_bwd<208, false>(qkv, out, lse, dout, dqkv, B, N,
                                             H, G, scale, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ssl4gie_attn_savep_fwd(const void* qkv, void* out, void* p,
                                      int B, int N, int H, int Nb, int G,
                                      float scale, void* stream) {
  if (Nb != 208) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_fwd<208, true>(qkv, out, p, B, N, H, G, scale,
                                          stream);
}

extern "C" int ssl4gie_attn_savep_bwd(const void* qkv, const void* p,
                                      const void* dout, void* dqkv, int B,
                                      int N, int H, int Nb, int G,
                                      float scale, void* stream) {
  if (Nb != 208) return (int)cudaErrorInvalidValue;
  return (int)launch_dense_bwd<208, true>(qkv, p, nullptr, dout, dqkv, B, N,
                                          H, G, scale, stream);
}
