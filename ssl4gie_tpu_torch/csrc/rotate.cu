// Nearest rotation by Paeth 3-shear, one thread per output element, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssl4gie_tpu/kernels/rotate.py:`_kernel`
// (pallas_call in `shear_rotate_pallas`), which rotates an already
// rot90-folded canvas by three integer-shift passes:
//   pass A (x-shear)  tA[y, j] = g[y, j - P + s1(y)]   fill outside [0, W)
//   pass B (y-shear)  tB[y, j] = tA[y + s2(j), j]      fill outside [0, H)
//   pass C (x-shear)  out[y, x] = tB[y, x + P + s1(y)]
// with s1(y) = round(alpha * (y - c)), s2(j) = round(beta * (j - P - c)),
// c = (H - 1) / 2. The three passes compose into one chain of indices per
// output pixel, so here each thread follows that chain back to the one source
// element it copies: a gather. With u = x + s1(y) the canvas column less P,
//   y2 = y + round(beta * (u - c)),  x2 = u + s1(y2),  out = g[y2, x2]
// (fill where y2 or x2 falls outside the image): the pad P cancels, because
// the TPU's P only keeps its circular rolls from wrapping. The roll/select
// binary decomposition, the 128-lane padding and the channel-group split kept
// the TPU's canvas in VMEM; none of them is needed here.
//
// Rounding must be the reference's: jnp.round rounds half to even, so the
// shifts use rintf (never roundf, which rounds half away from zero), and
// alpha * (row - c) is one f32 multiply (__fmul_rn keeps the compiler from
// contracting it into anything else).
//
// Optionally the rot90 fold of data/augment.py:rotate_nearest_shear (quarter
// turn q per image) is applied in the same index chain, so the unfolded image
// is read directly instead of being permuted by four extra passes.
//
// What bounds it on the card: it moves B*H*W*C elements in and out (2 bytes
// each in bf16) with a few integer operations per element, so it is bound by
// device memory and launch cost; the gathers of one warp read neighbouring
// channels and pixels of one source row except where the shears break a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int shift(float factor, int pos, float c) {
  return (int)rintf(__fmul_rn(factor, __fsub_rn((float)pos, c)));
}

__global__ void shear_rotate(const bf16* __restrict__ g,
                             const float* __restrict__ alpha,
                             const float* __restrict__ beta,
                             const int* __restrict__ quarter,
                             bf16* __restrict__ out, int B, int H, int W, int C,
                             float fill) {
  const long long total = (long long)B * H * W * C;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % C);
  long long rest = idx / C;
  const int x = (int)(rest % W);
  rest /= W;
  const int y = (int)(rest % H);
  const int b = (int)(rest / H);

  const float c = (H - 1) * 0.5f;
  const float a = alpha[b];
  const int u = x + shift(a, y, c);                // pass C source column - P
  const int y2 = y + shift(beta[b], u, c);         // pass B source row
  bf16 v = __float2bfloat16(fill);
  if (y2 >= 0 && y2 < H) {
    const int x2 = u + shift(a, y2, c);            // pass A source column
    if (x2 >= 0 && x2 < W) {
      int sy = y2, sx = x2;                        // (sy, sx) in the canvas
      if (quarter != nullptr) {
        switch (quarter[b] & 3) {                  // canvas -> image (square)
          case 1: sy = W - 1 - x2; sx = y2; break;
          case 2: sy = H - 1 - y2; sx = W - 1 - x2; break;
          case 3: sy = x2; sx = H - 1 - y2; break;
          default: break;
        }
      }
      v = g[(((long long)b * H + sy) * W + sx) * C + ch];
    }
  }
  out[idx] = v;
}

}  // namespace

// Returns what the launch left in cudaGetLastError(). `quarter` may be null
// (g is already folded). The Python wrapper checks shapes and dtypes.
extern "C" int ssl4gie_shear_rotate(const void* g, const void* alpha,
                                    const void* beta, const void* quarter,
                                    void* out, int B, int H, int W, int C,
                                    float fill, void* stream) {
  const long long total = (long long)B * H * W * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  shear_rotate<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)g, (const float*)alpha, (const float*)beta,
      (const int*)quarter, (bf16*)out, B, H, W, C, fill);
  return (int)cudaGetLastError();
}
