// Nearest rotation by Paeth 3-shear as a tiled gather, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssl4gie_tpu/kernels/rotate.py:`_kernel`
// (pallas_call in `shear_rotate_pallas`), which rotates an already
// rot90-folded canvas by three integer-shift passes:
//   pass A (x-shear)  tA[y, j] = g[y, j - P + s1(y)]   fill outside [0, W)
//   pass B (y-shear)  tB[y, j] = tA[y + s2(j), j]      fill outside [0, H)
//   pass C (x-shear)  out[y, x] = tB[y, x + P + s1(y)]
// with s1(y) = round(alpha * (y - c)), s2(j) = round(beta * (j - P - c)),
// c = (H - 1) / 2. The three passes compose into one chain of indices per
// output pixel. With u = x + s1(y) the canvas column less P,
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
// turn q per image) is applied in the same index chain: the chain ends at a
// canvas pixel (y2, x2), and the fold maps it to the pixel (sy, sx) of the
// unfolded image that is read.
//
// The design. One block of 256 threads takes one image's 32 x 32 output tile
// with all C channels:
// 1. Each thread follows the chain of four of the tile's pixels once (not
//    once per channel) and keeps their source pixels in registers; the block
//    reduces the sources' bounding box in the image (warp min/max, then
//    shared-memory atomics).
// 2. The box is staged in shared memory by 16-byte copies along the image's
//    rows (cp.async), whatever the quarter turn: the
//    fold is applied when indexing the staged box, so quarter turns 1 and 3
//    read rows as 0 and 2 do. For |r| <= 45 degrees (what the fold leaves)
//    the box of a 32 x 32 tile is at most 46 x 46 pixels; the launch sizes
//    it for 54. A box that does not fit (shear factors from elsewhere) is
//    read from device memory pixel by pixel instead, in the same kernel.
//    A tile whose pixels all fall outside reads nothing.
// 3. Each thread copies its pixels' C channels (or the fill) from the box
//    into a shared output tile, and the block writes the tile's rows with
//    16-byte stores (a 32-pixel row is 192 B at C = 3, 320 B at C = 5).
// The 16-byte path needs rows of a multiple of 16 bytes (W * C * 2) and
// aligned pointers; otherwise the same kernel reads pixel by pixel and
// stores 2 bytes at a time. It is a gather: no tensor cores, and it is bound
// by the device memory's rate (each input byte read once, each output byte
// written once), plus the index arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 32;          // output tile side, pixels
constexpr int kThreads = 256;
constexpr int kPixPerThread = kTile * kTile / kThreads;
constexpr int kBoxPix = 54;        // staged box side the launch sizes for

__device__ __forceinline__ int shift(float factor, int pos, float c) {
  return (int)rintf(__fmul_rn(factor, __fsub_rn((float)pos, c)));
}

// the packed source pixel (sy << 16 | sx) of output pixel (y, x), or -1
__device__ __forceinline__ int source_of(int y, int x, float a, float be,
                                         int q, int H, int W, float c) {
  const int u = x + shift(a, y, c);                // pass C source column - P
  const int y2 = y + shift(be, u, c);              // pass B source row
  if (y2 < 0 || y2 >= H) return -1;
  const int x2 = u + shift(a, y2, c);              // pass A source column
  if (x2 < 0 || x2 >= W) return -1;
  int sy = y2, sx = x2;                            // canvas -> image (square)
  switch (q) {
    case 1: sy = W - 1 - x2; sx = y2; break;
    case 2: sy = H - 1 - y2; sx = W - 1 - x2; break;
    case 3: sy = x2; sx = H - 1 - y2; break;
    default: break;
  }
  return (sy << 16) | sx;
}

// kC: channels at compile time (0: the runtime `Crt`).
template <int kC>
__global__ void __launch_bounds__(kThreads)
    rotate_tiled(const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const int* __restrict__ quarter,
                 __nv_bfloat16* __restrict__ out, int H, int W, int Crt,
                 float fill, int vec, int box_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int bbox[4];                          // min sy, max sy, min sx, max sx
  const int C = kC > 0 ? kC : Crt;
  const int pix_bytes = C * 2;
  const int tile_pitch = kTile * pix_bytes;        // output tile row, bytes
  unsigned char* box = smem;                       // box_cap bytes
  unsigned char* otile = smem + box_cap;           // kTile * tile_pitch bytes

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float c = (H - 1) * 0.5f;
  const float a = alpha[b], be = beta[b];
  const int q = quarter != nullptr ? (quarter[b] & 3) : 0;
  const size_t row_bytes = (size_t)W * pix_bytes;
  const unsigned char* img =
      reinterpret_cast<const unsigned char*>(g) + (size_t)b * H * row_bytes;

  if (tid == 0) {
    bbox[0] = INT_MAX; bbox[1] = INT_MIN; bbox[2] = INT_MAX; bbox[3] = INT_MIN;
  }
  // 1. the chains, once per pixel
  int src[kPixPerThread];
  int ymin = INT_MAX, ymax = INT_MIN, xmin = INT_MAX, xmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    const int y = y0 + p / kTile, x = x0 + p % kTile;
    src[k] = (y < H && x < W) ? source_of(y, x, a, be, q, H, W, c) : -1;
    if (src[k] >= 0) {
      const int sy = src[k] >> 16, sx = src[k] & 0xffff;
      ymin = min(ymin, sy); ymax = max(ymax, sy);
      xmin = min(xmin, sx); xmax = max(xmax, sx);
    }
  }
  ymin = __reduce_min_sync(0xffffffffu, ymin);
  ymax = __reduce_max_sync(0xffffffffu, ymax);
  xmin = __reduce_min_sync(0xffffffffu, xmin);
  xmax = __reduce_max_sync(0xffffffffu, xmax);
  __syncthreads();                                 // bbox initialised
  if ((tid & 31) == 0 && ymin <= ymax) {
    atomicMin(&bbox[0], ymin); atomicMax(&bbox[1], ymax);
    atomicMin(&bbox[2], xmin); atomicMax(&bbox[3], xmax);
  }
  __syncthreads();

  // 2. stage the box: rows r0..r1 of the image, bytes [lo, lo + pitch)
  const int r0 = bbox[0];
  const int rows = r0 <= bbox[1] ? bbox[1] - r0 + 1 : 0;   // 0: all fill
  int lo = 0, pitch = 0;
  bool staged = false;
  if (rows > 0 && vec) {
    lo = (bbox[2] * pix_bytes) & ~15;
    pitch = (((bbox[3] + 1) * pix_bytes + 15) & ~15) - lo;
    staged = (long long)rows * pitch <= box_cap;
  }
  if (staged) {
    const int chunks = pitch >> 4;
    for (int i = tid; i < rows * chunks; i += kThreads) {
      const int r = i / chunks, j = i - r * chunks;
      const unsigned char* s = img + (size_t)(r0 + r) * row_bytes + lo + j * 16;
      cp_async16(box + r * pitch + j * 16, s, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // 3. each pixel's channels (or the fill) into the output tile
  const __nv_bfloat16 fill_v = __float2bfloat16(fill);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = tid + k * kThreads;
    __nv_bfloat16* d =
        reinterpret_cast<__nv_bfloat16*>(otile + (p / kTile) * tile_pitch) +
        (p % kTile) * C;
    if (src[k] < 0) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) d[ch] = fill_v;
      continue;
    }
    const int sy = src[k] >> 16, sx = src[k] & 0xffff;
    const __nv_bfloat16* s =
        staged ? reinterpret_cast<const __nv_bfloat16*>(
                     box + (sy - r0) * pitch + sx * pix_bytes - lo)
               : reinterpret_cast<const __nv_bfloat16*>(
                     img + (size_t)sy * row_bytes) + (size_t)sx * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) d[ch] = s[ch];
  }
  __syncthreads();

  // 4. the tile's rows to device memory
  const int th = min(kTile, H - y0), tw = min(kTile, W - x0);
  const int nb = tw * pix_bytes;                   // bytes of a tile row
  unsigned char* obase = reinterpret_cast<unsigned char*>(out) +
                         ((size_t)b * H + y0) * row_bytes +
                         (size_t)x0 * pix_bytes;
  const int chunks = vec ? nb >> 4 : 0;
  for (int i = tid; i < th * chunks; i += kThreads) {
    const int r = i / chunks, j = i - r * chunks;
    *reinterpret_cast<uint4*>(obase + r * row_bytes + j * 16) =
        *reinterpret_cast<const uint4*>(otile + r * tile_pitch + j * 16);
  }
  const int tail = (nb - chunks * 16) >> 1;        // 2-byte elements a row
  for (int i = tid; i < th * tail; i += kThreads) {
    const int r = i / tail, e = i - r * tail;
    const int off = chunks * 16 + e * 2;
    *reinterpret_cast<__nv_bfloat16*>(obase + r * row_bytes + off) =
        *reinterpret_cast<const __nv_bfloat16*>(otile + r * tile_pitch + off);
  }
}

template <int kC>
int launch(const void* g, const void* alpha, const void* beta,
           const void* quarter, void* out, int B, int H, int W, int C,
           float fill, int vec, cudaStream_t stream) {
  // the box for |r| <= 45 degrees (rows padded for 16-byte alignment at both
  // ends), unless it would not leave room for the output tile
  int box_cap = kBoxPix * (((kBoxPix * C * 2 + 30) + 15) & ~15);
  const int tile_bytes = kTile * kTile * C * 2;
  if (!vec || box_cap + tile_bytes > 200 * 1024) box_cap = 0;
  const int smem = box_cap + tile_bytes;
  auto kernel = rotate_tiled<kC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)g, (const float*)alpha, (const float*)beta,
      (const int*)quarter, (__nv_bfloat16*)out, H, W, C, fill, vec, box_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns what the launch left in cudaGetLastError(). `quarter` may be null
// (g is already folded). The Python wrapper checks shapes and dtypes.
extern "C" int ssl4gie_shear_rotate(const void* g, const void* alpha,
                                    const void* beta, const void* quarter,
                                    void* out, int B, int H, int W, int C,
                                    float fill, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H >= 32768 || W >= 32768 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = ((size_t)W * C * 2) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    return launch<3>(g, alpha, beta, quarter, out, B, H, W, C, fill, vec, s);
  if (C == 5)
    return launch<5>(g, alpha, beta, quarter, out, B, H, W, C, fill, vec, s);
  return launch<0>(g, alpha, beta, quarter, out, B, H, W, C, fill, vec, s);
}
