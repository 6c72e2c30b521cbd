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
// Both directions are the shared core of attention_core.cuh on DenseRows
// with q, k, v apart (row stride 64), in blocks of two warpgroups (128 rows)
// that share each streamed tile; two warpgroups halve the tile traffic per
// product against one, which is what the long loops pay for.
// - The forward, `attn_fwd`: keys stream through a 3-stage cp.async ring in
//   tiles of 64, Q.K^T is computed once per tile by wgmma into registers,
//   the probabilities stay in registers as the A operand of P.V, and the
//   loop stops at the last tile that holds a key < n_valid.
// - The backward, `attn_bwd_dq` over query rows (it also writes delta =
//   rowsum(dO * O)) then `attn_bwd_dkv` over key rows, no atomics: every
//   product is wgmma, P and dS stay in registers as A operands, and key
//   columns >= n_valid get p = 0 before the exponent could overflow (a row
//   with lse < -87 would otherwise give exp(-lse) = inf and inf * 0 = NaN),
//   so padded keys also get zero dk and dv; a dk/dv block whose keys are
//   all padded streams nothing.
// The float32 entries run the 3xTF32 wgmma forward and backward of
// attention_tf32.cuh on the same layout (forward blocks of two multiplying
// warpgroups, backward blocks of 64 rows), with the same masking.

#include "attention_core.cuh"
#include "attention_tf32.cuh"

// Every entry point returns a cudaError_t value: what the launch left in
// cudaGetLastError(). The Python wrapper checks the shapes, the dtype
// (bf16; float32 for the `_f32` entries), D == 64, N a multiple of 64 and
// 1 <= n_valid <= N before calling.
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
  return (int)launch_attn_bwd<kDh, 2>(q, k, v, kDh, o, dout, kDh, lse, delta,
                                      dq, dk, dv, kDh, DenseRows{N}, BH, 1, N,
                                      n_valid, scale, stream);
}

extern "C" int ssl4gie_flash_fwd_f32(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int BH, int N, int n_valid, float scale,
                                     void* stream) {
  return (int)launch_attn_fwd_f32<kDh>(q, k, v, kDh, o, kDh, lse,
                                       DenseRows{N}, BH, 1, N, n_valid, scale,
                                       stream);
}

extern "C" int ssl4gie_flash_bwd_f32(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     void* delta, void* dq, void* dk, void* dv,
                                     int BH, int N, int n_valid, float scale,
                                     void* stream) {
  return (int)launch_attn_bwd_f32<kDh>(q, k, v, kDh, o, dout, kDh, lse, delta,
                                       dq, dk, dv, kDh, DenseRows{N}, BH, 1, N,
                                       n_valid, scale, stream);
}
