// A warp-specialised, persistent GEMM core for Hopper (sm_90a): TMA loads
// into a ring of shared-memory stages, wgmma products, and an epilogue that
// stores through shared memory with TMA. The fused MLP (fused_mlp.cu) runs
// its three products on it, told apart by `kMode`:
//   kBias     out = A.B^T + bias               (forward (a): h = x.W1^T + b1)
//   kGeluBias out = gelu(A).B^T + bias         (forward (b): y = gelu(h).W2^T
//                                               + b2, the GELU applied to the
//                                               A operand in registers)
//   kDgelu    acc = A.B, then out = acc * gelu'(h), out2 = gelu(h)
//                                              (backward: dg = dy.W2, h read
//                                               once, in the epilogue)
// A is (M, K) row-major. B is (N, K) row-major (an nn.Linear weight, K-major)
// in kBias and kGeluBias, and (K, N) row-major (fc2.weight read along its
// input axis, MN-major) in kDgelu.
//
// The block: three warpgroups. Warpgroup 0 is the producer: after giving up
// registers (setmaxnreg 40), one of its threads walks the block's tiles and
// keeps TMA loads of the A tile (128 rows x 64 of K) and the B tile (BN x 64)
// in flight into kStages ring stages, each guarded by a full and an empty
// mbarrier. Warpgroups 1 and 2 are the consumers (setmaxnreg 232). They
// issue wgmma m64nBNk16 (bf16 in, f32 accumulate), four per 64-wide k-step
// and 64 rows, keep one k-step's products in flight while they wait on the
// next stage, and free a stage once the products that read it have
// completed.
// - kBias and kGeluBias (cooperative): both consumers work on every tile,
//   64 rows each. In kGeluBias each loads its 64 x 16 A slices from the
//   TMA-landed h tile with ldmatrix, applies the GELU in f32 (tanh.approx.f32
//   for the tanh form, erff for the exact one), packs them as bf16 A
//   fragments and issues the register-A form of wgmma; two fragment sets
//   alternate between k-steps, so the GELU of one step overlaps the products
//   of the one before. g never reaches device memory. The GELU is computed
//   once per N tile of the output (C / BN times).
// - kDgelu (ping-pong): the consumers take the block's tiles in turn, all
//   128 rows each, so that one's epilogue (dgelu, two outputs) runs while
//   the other multiplies. An order barrier (`turn`) lets a consumer start
//   its products only once the other has issued its own for the tile
//   before; then each full barrier it waits on is at most one phase ahead.
//   After the tile's operands the producer loads the 128 x BN tile of h
//   into that consumer's buffer (hfull / hempty); the epilogue reads each
//   element of h once and writes g over it and dh into a staging tile.
//
// Tiles: every operand tile is made of 64-column (128-byte) chunks in the
// 128-byte swizzle that both TMA (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma's
// descriptors use, so no thread touches an operand on its way in. Rows past
// M are zero-filled by TMA on load and clipped by TMA on store, so M needs no
// tile multiple; N is a multiple of BN (the caller picks BN among 256, 192,
// 128) and K of 128.
//
// Persistent blocks: one block per SM (at most), each walking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... with the N tile fastest, so the
// blocks in flight share A rows and the weights stay in L2. The ring runs
// on across tiles, so the producer loads the next tile's operands while the
// consumers finish the last one's epilogue; the outputs are staged in
// shared memory and one thread of each consumer issues TMA stores, which
// drain while the next tile's products run (the staging is reused only
// after the stores have read it). No atomics and no split-K: every output
// is summed in one fixed order, so two runs give the same bits.
//
// What bounds it: the forward's products are bound by the tensor cores;
// the backward by device memory at its bound, but each of its 128 x 128
// tiles reads its operands from L2 once, which at the MAE encoder's shape
// (dy 24 times, W2 100 times) is 944 MB against 256 MB of device traffic.
// A wider backward tile does not leave the shared memory its epilogue
// needs. Times and rates: PERF.md, section 6.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

enum Mode { kBias = 0, kGeluBias = 1, kDgelu = 2 };

constexpr int kBM = 128, kBK = 64;       // output rows, k-step of a tile
constexpr int kGemmThreads = 384;        // producer + two consumer groups
constexpr int kChunkBytes = 64 * 128;    // 64 rows of a 64-column chunk
constexpr int kMaxSmem = 232448;         // a block's dynamic shared memory

template <int kMode, int BN>
struct GemmShape {
  static_assert(BN % 64 == 0 && BN <= 256, "BN: 128, 192 or 256");
  // kDgelu: the two consumers take alternate tiles (ping-pong), so that
  // one's epilogue runs while the other multiplies; otherwise they share
  // each tile, 64 rows each
  static constexpr bool kPing = kMode == kDgelu;
  static constexpr int kABytes = kBM * kBK * 2;             // 16 KiB
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  static constexpr int kTileBytes = kBM * BN * 2;           // a bf16 tile
  // output staging; kDgelu: per consumer the h tile (g is written over
  // it) and dh's staging
  static constexpr int kEpiBytes = (kPing ? 4 : 1) * kTileBytes;
  static constexpr int kBarBytes = 256;
  static constexpr int kFit =
      (kMaxSmem - 1024 - kBarBytes - kEpiBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs two stages");
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kEpiBytes + kBarBytes;
};

struct GemmArgs {
  const bf16* bias;   // (N,), kBias and kGeluBias
  int K, tiles_n, tiles;
  int approx;         // GELU: tanh form if nonzero, else erf
};

// ------------------------------------------------------------------ GELU
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kRsqrt2 = 0.7071067811865476f;
constexpr float kRsqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The GELU, as `_gelu_f32` / `_dgelu_f32` of the JAX kernel: the tanh form
// (kApprox) with the hardware tanh (tanh.approx.f32, relative error about
// 2^-11, below the bf16 rounding that follows), else the exact erf form.
// The form is a template parameter, so that the loops over a tile carry no
// branch.
template <bool kApprox>
__device__ __forceinline__ float gelu(float h) {
  const float hh = 0.5f * h;
  if (kApprox) {
    const float t =
        tanh_approx(h * fmaf(h * h, kSqrt2OverPi * 0.044715f, kSqrt2OverPi));
    return fmaf(hh, t, hh);
  }
  return fmaf(hh, erff(h * kRsqrt2), hh);
}

// gelu(h) and gelu'(h) from one tanh (or erf)
template <bool kApprox>
__device__ __forceinline__ void gelu_and_grad(float h, float& g, float& dg) {
  if (kApprox) {
    const float t = tanh_approx(kSqrt2OverPi * (h + 0.044715f * h * h * h));
    const float dt =
        (1.f - t * t) * kSqrt2OverPi * (1.f + 3.f * 0.044715f * h * h);
    g = 0.5f * h * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * h * dt;
  } else {
    const float e = erff(h * kRsqrt2);
    g = 0.5f * h * (1.f + e);
    dg = 0.5f * (1.f + e) + h * expf(-0.5f * h * h) * kRsqrt2Pi;
  }
}

// a bf16 pair -> gelu of each, rounded to a bf16 pair
template <bool kApprox>
__device__ __forceinline__ unsigned gelu_pair(unsigned x) {
  return pack_bf16(gelu<kApprox>(__uint_as_float(x << 16)),
                   gelu<kApprox>(__uint_as_float(x & 0xffff0000u)));
}

// f(std::true_type) for the tanh form, f(std::false_type) for erf: one
// uniform branch around a whole loop
template <class F>
__device__ __forceinline__ void with_gelu_form(int approx, F&& f) {
  if (approx)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// ------------------------------------------------------------ wgmma, wide
// The accumulator of a warpgroup's 64 x n product, as in attention_core.cuh:
// warp w holds rows 16 w.., and d[j] of a lane columns 8 j + 2 (lane % 4)
// (+1) of rows lane / 4 (d[j][0..1]) and lane / 4 + 8 (d[j][2..3]).
// wgmma_ss: A and B from shared memory (kTransB = 1: B MN-major);
// wgmma_rs: A from registers (the m16n8k16 A layout per warp), B K-major.
// acc = 0 starts the sum.
#define WG_ACC4(d, i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_ACC32(d, i)                                                   \
  WG_ACC4(d, i), WG_ACC4(d, i + 1), WG_ACC4(d, i + 2), WG_ACC4(d, i + 3), \
      WG_ACC4(d, i + 4), WG_ACC4(d, i + 5), WG_ACC4(d, i + 6),            \
      WG_ACC4(d, i + 7)
#define WG_ACC128(d) WG_ACC32(d, 0), WG_ACC32(d, 8)
#define WG_ACC192(d) WG_ACC128(d), WG_ACC32(d, 16)
#define WG_ACC256(d) WG_ACC192(d), WG_ACC32(d, 24)

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4],
                                         unsigned long long a,
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : WG_ACC128(d)
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const unsigned (&a)[4],
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : WG_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[24][4],
                                         unsigned long long a,
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, "
      "%96, %97, p, 1, 1, 0, %99;\n}\n"
      : WG_ACC192(d)
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[24][4],
                                         const unsigned (&a)[4],
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, "
      "{%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
      : WG_ACC192(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32][4],
                                         unsigned long long a,
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : WG_ACC256(d)
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const unsigned (&a)[4],
                                         unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "{%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : WG_ACC256(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WG_ACC4
#undef WG_ACC32
#undef WG_ACC128
#undef WG_ACC192
#undef WG_ACC256

// descriptor of a (K, N) B tile: BN / 64 chunks of 64 K-rows x 64 N-columns
// (128 B rows, 128-byte swizzle) 8 KiB apart. Leading offset: the next 64
// columns of N (one chunk); stride offset: the next 8 K-rows (1 KiB). A
// k-step of 16 rows is + 2 KiB (+128).
__device__ __forceinline__ unsigned long long mn_desc(const void* p) {
  const unsigned long long a = (smem_u32(p) & 0x3FFFF) >> 4;
  return a | ((unsigned long long)(kChunkBytes >> 4) << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// --------------------------------------------------------------- the GEMM
// mA: A, box 64 x 128. mB: B, box 64 x BN (kDgelu: 64 N-columns x 64
// K-rows). mOut (and in kDgelu mOut2): the outputs, box 64 x 64 (kDgelu:
// 64 x 128). mH (kDgelu): h, box 64 x 128. grid: at most one block per SM;
// 384 threads.
template <int kMode, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
mlp_gemm(const __grid_constant__ CUtensorMap mA,
         const __grid_constant__ CUtensorMap mB,
         const __grid_constant__ CUtensorMap mOut,
         const __grid_constant__ CUtensorMap mOut2,
         const __grid_constant__ CUtensorMap mH, const GemmArgs args) {
  using G = GemmShape<kMode, BN>;
  constexpr bool kPing = G::kPing;
  constexpr int NJ = BN / 8;           // accumulator column groups
  constexpr int kHalves = kPing ? 2 : 1;   // 64-row halves a consumer owns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(smem_raw) + 1023) & ~(size_t)1023);
  unsigned char* epi = ring + G::kStages * G::kStageBytes;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(epi + G::kEpiBytes);
  unsigned long long* empty = full + G::kStages;
  unsigned long long* hfull = empty + G::kStages;   // kDgelu, per consumer
  unsigned long long* hempty = hfull + 2;
  unsigned long long* turn = hempty + 2;            // kDgelu, per consumer
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  const int steps = args.K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kPing ? 128 : 256);   // each reader arrives
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(hfull + c, 1);
      mbar_init(hempty + c, 1);
      mbar_init(turn + c, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (wt == 0) {
      int stage = 0, phase = 0, it = 0;
      for (int tile = blockIdx.x; tile < args.tiles;
           tile += gridDim.x, ++it) {
        const int m0 = tile / args.tiles_n * kBM;
        const int n0 = tile % args.tiles_n * BN;
        for (int ks = 0; ks < steps; ++ks) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_expect_tx(full + stage, G::kStageBytes);
          unsigned char* As = ring + stage * G::kStageBytes;
          unsigned char* Bs = As + G::kABytes;
          tma_load(&mA, As, full + stage, ks * kBK, m0);
          if constexpr (kMode == kDgelu) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load(&mB, Bs + c * kChunkBytes, full + stage, n0 + 64 * c,
                       ks * kBK);
          } else {
            tma_load(&mB, Bs, full + stage, ks * kBK, n0);
          }
          if (++stage == G::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (kMode == kDgelu) {
          // the tile's h into its consumer's buffer, after the tile's
          // operands: the consumer frees the buffer early in this tile's
          // products, once its stores of the tile before have read it
          const int o = it & 1, u = it >> 1;
          mbar_wait(hempty + o, (u & 1) ^ 1);
          mbar_expect_tx(hfull + o, G::kTileBytes);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load(&mH, epi + o * 2 * G::kTileBytes + c * 2 * kChunkBytes,
                     hfull + o, n0 + 64 * c, m0);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int w = wg - 1;
    const int warp = wt >> 5, lane = wt & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const int r0 = warp * 16 + g;        // row (of 64) of d[j][0..1]
    float acc[kHalves][NJ][4];
    unsigned a0[4][4], a1[4][4];         // kGeluBias A fragments
    int stage = 0, phase = 0;
    auto advance = [&] {
      if (++stage == G::kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    // one 64-wide k-step on the stage that holds it: wait for the loads,
    // issue the products, wait for the step before and free its stage
    auto k_step = [&](int ks, unsigned(&a)[4][4]) {
      mbar_wait(full + stage, phase);
      const unsigned char* As =
          ring + stage * G::kStageBytes + (kPing ? 0 : w * kChunkBytes);
      const unsigned char* Bs = ring + stage * G::kStageBytes + G::kABytes;
      if constexpr (kMode == kGeluBias) {
        // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31
        // the same rows at k 8-15; gives the m16n8k16 A layout
        const int r = warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldmatrix_x4(a[kk], As + r * 128 +
                                 (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4));
        }
        with_gelu_form(args.approx, [&](auto form) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[kk][i] = gelu_pair<decltype(form)::value>(a[kk][i]);
        });
      }
      const unsigned long long da = Swz<64>::desc(As);
      const unsigned long long db =
          kMode == kDgelu ? mn_desc(Bs) : Swz<64>::desc(Bs);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kMode == kGeluBias) {
          wgmma_rs(acc[0], a[kk], db + 2 * kk, ks | kk);
        } else {
#pragma unroll
          for (int i = 0; i < kHalves; ++i)
            wgmma_ss<kMode == kDgelu>(
                acc[i], da + i * (kChunkBytes >> 4) + 2 * kk,
                db + (kMode == kDgelu ? 128 : 2) * kk, ks | kk);
        }
      }
      wg_commit();
      wg_wait1();                    // the step before has completed
      if (ks > 0)
        mbar_arrive(empty + (stage == 0 ? G::kStages - 1 : stage - 1));
      advance();
    };

    // kDgelu: the other consumer's first tile is not ours
    if (kPing && w == 1)
      for (int ks = 0; ks < steps; ++ks) advance();
    int u = 0;                           // this consumer's tiles so far
    for (int tile = blockIdx.x + (kPing ? w * gridDim.x : 0);
         tile < args.tiles; tile += (kPing ? 2 : 1) * gridDim.x, ++u) {
      const int m0 = tile / args.tiles_n * kBM;
      const int n0 = tile % args.tiles_n * BN;
      // kDgelu: this consumer's products start once the other's for the
      // tile before are issued: then every full barrier it waits on is at
      // most one phase ahead, so its parity names the right phase
      if (kPing && (w == 1 || u > 0))
        mbar_wait(turn + w, (w == 1 ? u : u - 1) & 1);
      for (int ks = 0; ks < steps; ks += 2) {   // K % 128 == 0
        k_step(ks, a0);
        k_step(ks + 1, a1);
        if (kPing && ks == 0 && u > 0 && wt == 0) {
          // the last tile's stores have read the h tile and the staging:
          // the producer may load this tile's h
          bulk_wait_read();
          mbar_arrive(hempty + w);
        }
      }
      if (kPing) mbar_arrive(turn + (1 - w));
      wg_wait0();
#pragma unroll
      for (int i = 0; i < kHalves; ++i) wg_hold(acc[i]);
      mbar_arrive(empty + (stage == 0 ? G::kStages - 1 : stage - 1));

      if constexpr (kPing) {
        // skip the other consumer's tile, then the epilogue: g over h in
        // the h tile, dh in the staging, both 128 rows x BN
        for (int ks = 0; ks < steps; ++ks) advance();
        unsigned char* hb = epi + w * 2 * G::kTileBytes;
        unsigned char* st = hb + G::kTileBytes;
        mbar_wait(hfull + w, u & 1);
        with_gelu_form(args.approx, [&](auto form) {
#pragma unroll
          for (int i = 0; i < kHalves; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int r = 64 * i + r0 + 8 * hf;
                const int o = (j >> 3) * 2 * kChunkBytes + r * 128 +
                              (((j & 7) ^ (r & 7)) << 4) + c2 * 2;
                const float2 hv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(hb + o));
                float g0, d0, g1, d1;
                gelu_and_grad<decltype(form)::value>(hv.x, g0, d0);
                gelu_and_grad<decltype(form)::value>(hv.y, g1, d1);
                *reinterpret_cast<__nv_bfloat162*>(st + o) =
                    __floats2bfloat162_rn(acc[i][j][2 * hf] * d0,
                                          acc[i][j][2 * hf + 1] * d1);
                *reinterpret_cast<__nv_bfloat162*>(hb + o) =
                    __floats2bfloat162_rn(g0, g1);
              }
        });
        fence_async_shared();
        named_sync(1 + w, 128);
        if (wt == 0) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            tma_store(&mOut, st + c * 2 * kChunkBytes, n0 + 64 * c, m0);
            tma_store(&mOut2, hb + c * 2 * kChunkBytes, n0 + 64 * c, m0);
          }
          bulk_commit();
        }
      } else {
        // the staging is free once the last tile's stores have read it
        if (wt == 0) bulk_wait_read();
        named_sync(1 + w, 128);
        unsigned char* st = epi + w * (64 * BN * 2);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(args.bias + n0 + 8 * j +
                                                        c2));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + 8 * hf;
            *reinterpret_cast<__nv_bfloat162*>(
                st + (j >> 3) * kChunkBytes + r * 128 +
                (((j & 7) ^ (r & 7)) << 4) + c2 * 2) =
                __floats2bfloat162_rn(acc[0][j][2 * hf] + b.x,
                                      acc[0][j][2 * hf + 1] + b.y);
          }
        }
        fence_async_shared();
        named_sync(1 + w, 128);
        if (wt == 0) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_store(&mOut, st + c * kChunkBytes, n0 + 64 * c, m0 + 64 * w);
          bulk_commit();
        }
      }
    }
    if (wt == 0) bulk_wait();
  }
}

}  // namespace
