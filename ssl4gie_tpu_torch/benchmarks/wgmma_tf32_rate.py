"""The rate of TF32 wgmma (m64n64k8) on the card with K-major operands in
the 32-byte swizzle (`csrc/attention_tf32.cuh:F32Pan`, 8 floats a row)
against the 128-byte swizzle (32 floats a row), both operands in shared
memory (SS) or A in registers (RS), with 1, 2 or 4 warpgroups an SM: a
kernel that issues nothing but 3 x 8 such products a group, 2000 groups a
block, on constant data. Prints one line per case with the card's name and
power limit:

    python3 ssl4gie_tpu_torch/benchmarks/wgmma_tf32_rate.py
"""

import ctypes
import subprocess
import tempfile

import torch

from ssl4gie_tpu_torch.kernels import _build
SRC = r'''
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ unsigned long long mk(const void* p, int sbo16, int mode) {
  unsigned long long a = (smem_u32(p) & 0x3FFFF) >> 4;
  return a | ((unsigned long long)sbo16 << 16) | ((unsigned long long)sbo16 << 32) | ((unsigned long long)mode << 62);
}
#define ACC "+f"(d[0][0]),"+f"(d[0][1]),"+f"(d[0][2]),"+f"(d[0][3]),"+f"(d[1][0]),"+f"(d[1][1]),"+f"(d[1][2]),"+f"(d[1][3]),"+f"(d[2][0]),"+f"(d[2][1]),"+f"(d[2][2]),"+f"(d[2][3]),"+f"(d[3][0]),"+f"(d[3][1]),"+f"(d[3][2]),"+f"(d[3][3]),"+f"(d[4][0]),"+f"(d[4][1]),"+f"(d[4][2]),"+f"(d[4][3]),"+f"(d[5][0]),"+f"(d[5][1]),"+f"(d[5][2]),"+f"(d[5][3]),"+f"(d[6][0]),"+f"(d[6][1]),"+f"(d[6][2]),"+f"(d[6][3]),"+f"(d[7][0]),"+f"(d[7][1]),"+f"(d[7][2]),"+f"(d[7][3])
#define REGS "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"
__device__ __forceinline__ void ss(float (&d)[8][4], unsigned long long a, unsigned long long b) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS ", %32, %33, 1, 1, 1;\n" : ACC : "l"(a), "l"(b));
}
__device__ __forceinline__ void rs(float (&d)[8][4], const unsigned (&x)[4], unsigned long long b) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS ", {%32,%33,%34,%35}, %36, 1, 1, 1;\n" : ACC : "r"(x[0]),"r"(x[1]),"r"(x[2]),"r"(x[3]),"l"(b));
}
// mode bit 0: 128-byte swizzle (else 32-byte); bit 1: A in registers
extern "C" __global__ void __launch_bounds__(128) rate(int mode, int iters, float* out) {
  extern __shared__ __align__(1024) unsigned char sm[];
  for (int i = threadIdx.x; i < 8192; i += 128) ((float*)sm)[i] = 1e-3f * (i & 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float d[8][4] = {};
  unsigned x[4] = {0x3a800000u, 0x3a800000u, 0x3a800000u, 0x3a800000u};
  const bool w128 = mode & 1, reg = mode & 2;
  unsigned char* A = sm; unsigned char* B = sm + 16384;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    #pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      unsigned long long da, db;
      if (w128) { da = mk(A + (kk >> 2) * 8192 + (kk & 3) * 32, 64, 1); db = mk(B + (kk >> 2) * 8192 + (kk & 3) * 32, 64, 1); }
      else { da = mk(A + kk * 2048, 16, 3); db = mk(B + kk * 2048, 16, 3); }
      #pragma unroll
      for (int p = 0; p < 3; ++p) { if (reg) rs(d, x, db); else ss(d, da, db); }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  if (threadIdx.x == 0) out[blockIdx.x] = d[0][0] + d[7][3];
}
extern "C" int launch(int mode, int iters, int blocks, int smem, float* out, void* stream) {
  cudaFuncSetAttribute(rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate<<<blocks, 128, smem, (cudaStream_t)stream>>>(mode, iters, out);
  return (int)cudaGetLastError();
}
'''
ITERS, SMS = 2000, 132


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wgmma_tf32_rate: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/rate.cu", "w") as f:
            f.write(SRC)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", f"{tmp}/rate.so",
                        f"{tmp}/rate.cu"], capture_output=True, check=True)
        lib = ctypes.CDLL(f"{tmp}/rate.so")
    lib.launch.argtypes = (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 2
    out = torch.zeros(SMS * 4, device="cuda")
    for per_sm, smem in ((1, 200 * 1024), (2, 100 * 1024), (4, 48 * 1024)):
        for mode, name in ((0, "SS 32B"), (1, "SS 128B"), (2, "RS 32B"),
                           (3, "RS 128B")):
            blocks = SMS * per_sm
            run = lambda: lib.launch(
                mode, ITERS, blocks, smem, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if run() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            rate = blocks * ITERS * 24 * 64 * 64 * 8 * 2 / ms / 1e9
            print(f"{per_sm} warpgroup(s) an SM, {name}: {ms:.3f} ms, "
                  f"{rate:.1f} TFLOP/s TF32  [{card}]", flush=True)


if __name__ == "__main__":
    main()
