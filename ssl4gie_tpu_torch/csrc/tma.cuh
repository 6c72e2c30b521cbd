// Hopper's asynchronous data movement, shared by the TMA kernels (the GEMM
// core of gemm_core.cuh and the resident attention forward and backward of
// attention_resident.cuh): mbarriers, TMA loads, L2 prefetches and stores
// of 2- to 4-D boxes with their bulk groups, setmaxnreg, and on the host
// the tensor maps (cuTensorMapEncodeTiled) and the card's SM count.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

// ------------------------------------------------ mbarrier, TMA, setmaxnreg
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// the box of `map` at (column c0, row c1) into dst; completes on bar
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         unsigned long long* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}
// src into the box of `map` at (column c0, row c1); rows past the end are
// not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// the 3-D box of `map` at coordinates (c0, c1, c2), innermost first, into
// dst; completes on bar. Coordinates past a dimension's end read zeros.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, void* dst,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// the 4-D box of `map` at (c0, c1, c2, c3) into dst; completes on bar
__device__ __forceinline__ void tma_load_4d(const CUtensorMap* map, void* dst,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the 3-D / 4-D box of `map` at (c0, c1, c2[, c3]) into L2 only: a later
// load of it reads L2 instead of device memory
__device__ __forceinline__ void tma_prefetch_3d(const CUtensorMap* map,
                                                int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n"
      ::"l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_4d(const CUtensorMap* map,
                                                int c0, int c1, int c2,
                                                int c3) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.4d.L2.global.tile "
      "[%0, {%1, %2, %3, %4}];\n"
      ::"l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// src into the 3-D box of `map` at (c0, c1, c2); elements past a
// dimension's end are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// src into the 4-D box of `map` at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {   // until they are done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// order this thread's generic-proxy writes to shared memory before the
// async proxy's (TMA's) reads of them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that the library links without -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dimensions (dims innermost first, in elements;
// strides of dimensions 1.. in bytes, multiples of 16) as boxes of `box`
// elements in the 128-byte swizzle that wgmma's descriptors read (box[0]
// is 64: one 128-byte row); elements past a dimension's end read as zeros
// and are not written.
// The encoder fails in a thread with no current context: one that has made
// no runtime call yet, as autograd's worker thread may be when it runs a
// backward first. Binding the device's primary context once a thread
// (cudaSetDevice) gives it one.
bool encode_map(CUtensorMap* map, const void* p, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  static thread_local bool bound = false;
  int dev = 0;
  if (!bound && (cudaGetDevice(&dev) != cudaSuccess ||
                 cudaSetDevice(dev) != cudaSuccess))
    return false;
  bound = true;
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                const_cast<void*>(p), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace
