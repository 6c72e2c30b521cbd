// LayerNorm over the last dim of bfloat16 rows with float32 statistics,
// scale and bias, in one pass each way, for Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package's bf16 LayerNorm is flax's
// `nn.LayerNorm(dtype=bfloat16)` with float32 scale and bias: XLA fuses the
// convert to float32, the statistics, the normalisation and the affine into
// one pass that reads the bf16 row and writes the bf16 result, and does the
// same with the gradient. Eagerly, the port ran it as three passes (a bf16 ->
// f32 copy, the f32 LayerNorm, an f32 -> bf16 copy) and its backward as four
// (the upcast of dy, the input gradient, the scale and bias gradients, the
// downcast of dx), moving 52 bytes an element where 10 do. No torch operator
// reads bf16 rows with f32 scale and bias in one pass, and casting the scale
// and bias to bf16 would round them and their gradients.
//
// What bounds it: bytes. Per element the forward reads x and writes y (2 + 2
// bytes), the backward reads dy and x and writes dx (2 + 2 + 2); the
// statistics are 8 bytes a row and the scale and bias C floats each. The
// arithmetic is a few operations a byte, far below the card's ridge.
//
// The design moves only those bytes:
// - a row is held in registers by a group of 32 threads (C <= 1024) or 64
//   (C <= 2048), each taking 16-byte chunks of 8 bf16 (chunk j of the row to
//   thread j mod group size), so a row is read once, by coalesced 16-byte
//   loads;
// - the forward's mean and variance come from the registers in float32, the
//   variance in a second pass over the registers (no E[x^2] - E[x]^2), rstd =
//   rsqrt(var + eps); y = (x - mean) * rstd * gamma + beta in float32 with
//   gamma and beta read as float32 (they stay in L1), rounded to bf16 once
//   (round to nearest even, as torch's `.to(bfloat16)`);
// - the backward recomputes xhat from x and the saved mean and rstd, takes
//   g = dy * gamma and the row sums of g and g * xhat, and writes
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), rounded once. In the
//   same pass each thread adds dy * xhat and dy into float32 registers for
//   its columns over the rows its group visits; at the end the block sums its
//   groups in shared memory and writes one float32 partial row of dgamma and
//   one of dbeta to a workspace. A second, small kernel sums the partial rows
//   per column. No atomics: every sum has a fixed order, so two runs are
//   bitwise equal.
// - The backward's grid is a few blocks an SM (the wrapper sizes it), each
//   walking rows with a stride of the grid, so the partials stay a few
//   hundred rows; the forward launches a block for every 8 (or 4) rows.
// Row reductions are warp shuffles; with 64 threads a row the two warps
// exchange their sums through shared memory behind a named barrier of the
// group, and add them in the same order, so both see the same value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;          // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 2048;
constexpr int kReduceRows = 8;         // the partial sum's row slices

// chunk i (8 values) of a bf16 row -> float32
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums over a row's group of WPR warps, the same value on every thread
// of the group. `slot` holds two floats for each warp of the block.
template <int WPR>
__device__ __forceinline__ float2 group_sum(float a, float b, float2* slot,
                                            int warp, int group) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (WPR == 1) {
    return make_float2(a, b);
  } else {
    const int lane = threadIdx.x & 31;
    if (lane == 0) slot[warp] = make_float2(a, b);
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(WPR * 32)
                 : "memory");
    float2 s = slot[group * WPR];
#pragma unroll
    for (int w = 1; w < WPR; ++w) {
      const float2 t = slot[group * WPR + w];
      s.x += t.x;
      s.y += t.y;
    }
    // the slots are written again at the next sum
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(WPR * 32)
                 : "memory");
    return s;
  }
}

// VPT chunks of 8 a thread, WPR warps a row, kWarps / WPR rows a block.
template <int VPT, int WPR>
__global__ void __launch_bounds__(kThreads, 2)
ln_fwd(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
       float* __restrict__ mean_out, float* __restrict__ rstd_out, int M,
       int C, float eps) {
  constexpr int kGroup = 32 * WPR;
  constexpr int kRows = kWarps / WPR;
  __shared__ float2 slot[kWarps];
  const int warp = threadIdx.x >> 5;
  const int group = warp / WPR;
  const int t = threadIdx.x - group * kGroup;     // thread in the row
  const int row = blockIdx.x * kRows + group;
  const int chunks = C >> 3;
  // every thread of a group takes part in its sums, also past the last row
  const bool live = row < M;
  const __nv_bfloat16* xr = x + (size_t)(live ? row : 0) * C;

  float v[VPT][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = t + i * kGroup;
    if (live && j < chunks) {
      unpack(*reinterpret_cast<const uint4*>(xr + j * 8), v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[i][k];
    }
  }
  const float inv_c = 1.f / (float)C;
  const float mean = group_sum<WPR>(sum, 0.f, slot, warp, group).x * inv_c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = t + i * kGroup;
    if (live && j < chunks) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[i][k] - mean;
        sq += d * d;
      }
    }
  }
  const float var = group_sum<WPR>(sq, 0.f, slot, warp, group).x * inv_c;
  const float rstd = rsqrtf(var + eps);
  if (!live) return;
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  __nv_bfloat16* yr = y + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = t + i * kGroup;
    if (j < chunks) {
      float g[8], be[8], o[8];
      load8(w + j * 8, g);
      load8(b + j * 8, be);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[i][k] - mean) * rstd * g[k] + be[k];
      *reinterpret_cast<uint4*>(yr + j * 8) = pack(o);
    }
  }
}

template <int VPT, int WPR>
__global__ void __launch_bounds__(kThreads, 2)
ln_bwd(const __nv_bfloat16* __restrict__ dy,
       const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean_in,
       const float* __restrict__ rstd_in, const float* __restrict__ w,
       __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int M,
       int C) {
  constexpr int kGroup = 32 * WPR;
  constexpr int kRows = kWarps / WPR;
  // the groups' dgamma (then dbeta) columns, summed at the end: kRows
  // groups of at most 1024 * WPR columns (the dispatch's widths), 32 KiB
  __shared__ float red[kRows * 1024 * WPR];
  __shared__ float2 slot[kWarps];
  const int warp = threadIdx.x >> 5;
  const int group = warp / WPR;
  const int t = threadIdx.x - group * kGroup;
  const int chunks = C >> 3;
  const float inv_c = 1.f / (float)C;

  float dg[VPT][8], db[VPT][8];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) dg[i][k] = db[i][k] = 0.f;

  for (int row = blockIdx.x * kRows + group; row < M;
       row += gridDim.x * kRows) {
    const float mean = __ldg(mean_in + row), rstd = __ldg(rstd_in + row);
    const __nv_bfloat16* xr = x + (size_t)row * C;
    const __nv_bfloat16* dyr = dy + (size_t)row * C;
    uint4 xs[VPT], ds[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroup;
      if (j < chunks) {
        xs[i] = *reinterpret_cast<const uint4*>(xr + j * 8);
        ds[i] = *reinterpret_cast<const uint4*>(dyr + j * 8);
      }
    }
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroup;
      if (j < chunks) {
        float xv[8], dv[8], gm[8];
        unpack(xs[i], xv);
        unpack(ds[i], dv);
        load8(w + j * 8, gm);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xv[k] - mean) * rstd;
          const float g = dv[k] * gm[k];
          sg += g;
          sgx += g * xh;
          dg[i][k] += dv[k] * xh;
          db[i][k] += dv[k];
        }
      }
    }
    const float2 s = group_sum<WPR>(sg, sgx, slot, warp, group);
    const float a = s.x * inv_c, c = s.y * inv_c;
    __nv_bfloat16* dxr = dx + (size_t)row * C;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroup;
      if (j < chunks) {
        float xv[8], dv[8], gm[8], o[8];
        unpack(xs[i], xv);
        unpack(ds[i], dv);
        load8(w + j * 8, gm);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xv[k] - mean) * rstd;
          o[k] = rstd * (dv[k] * gm[k] - a - xh * c);
        }
        *reinterpret_cast<uint4*>(dxr + j * 8) = pack(o);
      }
    }
  }

  // the block's partial rows: dgamma, then dbeta, each the sum of its groups
  // in group order
  float* out[2] = {part + (size_t)blockIdx.x * C,
                   part + ((size_t)gridDim.x + blockIdx.x) * C};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroup;
      if (j < chunks) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          red[group * C + j * 8 + k] = which == 0 ? dg[i][k] : db[i][k];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < C; col += kThreads) {
      float s = red[col];
      for (int r = 1; r < kRows; ++r) s += red[r * C + col];
      out[which][col] = s;
    }
  }
}

// dgamma (blockIdx.y 0) and dbeta (1): the sum of `parts` partial rows per
// column, in a fixed order (each of kReduceRows slices in row order, then the
// slices in order).
__global__ void __launch_bounds__(32 * kReduceRows)
ln_reduce(const float* __restrict__ part, float* __restrict__ dw,
          float* __restrict__ db, int parts, int C) {
  __shared__ float red[kReduceRows][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + (size_t)blockIdx.y * parts * C;
  float s = 0.f;
  if (col < C)
    for (int r = threadIdx.y; r < parts; r += kReduceRows)
      s += p[(size_t)r * C + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float total = red[0][threadIdx.x];
    for (int r = 1; r < kReduceRows; ++r) total += red[r][threadIdx.x];
    (blockIdx.y == 0 ? dw : db)[col] = total;
  }
}

template <int VPT, int WPR>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int M, int C, float eps,
                       cudaStream_t s) {
  constexpr int kRows = kWarps / WPR;
  const int blocks = (M + kRows - 1) / kRows;
  ln_fwd<VPT, WPR><<<blocks, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), M, C, eps);
  return cudaGetLastError();
}

template <int VPT, int WPR>
cudaError_t launch_bwd(const void* dy, const void* x, const void* mean,
                       const void* rstd, const void* w, void* dx, void* part,
                       int M, int C, int parts, cudaStream_t s) {
  ln_bwd<VPT, WPR><<<parts, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), M, C);
  return cudaGetLastError();
}

// the instance for width C: 32 threads a row up to 1024, 64 up to 2048
#define SSL4GIE_LN_DISPATCH(FN, ...)                                      \
  (C <= 256    ? FN<1, 1>(__VA_ARGS__)                                    \
   : C <= 512  ? FN<2, 1>(__VA_ARGS__)                                    \
   : C <= 768  ? FN<3, 1>(__VA_ARGS__)                                    \
   : C <= 1024 ? FN<4, 1>(__VA_ARGS__)                                    \
   : C <= 1536 ? FN<3, 2>(__VA_ARGS__)                                    \
               : FN<4, 2>(__VA_ARGS__))

bool valid(int M, int C) { return M >= 1 && C >= 8 && C <= kMaxC && C % 8 == 0; }

}  // namespace

// y (M, C) bf16 and `stats` (2, M) f32, the rows' mean then their rstd,
// from x (M, C) bf16 and the f32 scale w and bias b (C,). Every pointer
// 16-byte aligned, rows contiguous.
extern "C" int ssl4gie_layer_norm_fwd(const void* x, const void* w,
                                      const void* b, void* y, void* stats,
                                      int M, int C, float eps, void* stream) {
  if (!valid(M, C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mean = static_cast<float*>(stats);
  return (int)SSL4GIE_LN_DISPATCH(launch_fwd, x, w, b, y, mean, mean + M, M,
                                  C, eps, s);
}

// dx (M, C) bf16 and the f32 gradients dw, db (C,) of the scale and the
// bias from dy, x (M, C) bf16, the forward's `stats` and the scale w. `part`
// is a (2, parts, C) f32 workspace for the partial rows of the `parts`
// blocks that walk the rows.
extern "C" int ssl4gie_layer_norm_bwd(const void* dy, const void* x,
                                      const void* stats, const void* w,
                                      void* dx, void* dw, void* db,
                                      void* part, int M, int C, int parts,
                                      void* stream) {
  if (!valid(M, C) || parts < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mean = static_cast<const float*>(stats);
  const cudaError_t e = SSL4GIE_LN_DISPATCH(launch_bwd, dy, x, mean,
                                            mean + M, w, dx, part, M, C,
                                            parts, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + 31) / 32, 2), block(32, kReduceRows);
  ln_reduce<<<grid, block, 0, s>>>(static_cast<const float*>(part),
                                   static_cast<float*>(dw),
                                   static_cast<float*>(db), parts, C);
  return (int)cudaGetLastError();
}
