// Exact greedy NMS keeping the top-k survivors of each image, in one
// launch, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs `ops/nms.py:nms_topk` as
// a slot loop that XLA compiles into one device loop. Run eagerly, the
// port's slot loop is about twenty launches a slot, so at the RPN's k =
// 1,000 the host's launch rate paces the whole detection step. This kernel
// runs the same loop on the card.
//
// The function is the slot loop's, bit for bit (`ops/nms.py:_nms_topk`):
// - slot s takes the live candidate of highest score, the first index among
//   equal scores, as `torch.argmax` does (a NaN score counts above every
//   number, -0 equals +0); its index is the slot's, and the slot is valid
//   where that score is finite;
// - a valid slot suppresses every candidate whose IoU with its box is above
//   the threshold, by the loop's float32 expression in the loop's order
//   (inter = w * h of the clamped overlap, union = (area1 + area2) - inter,
//   iou = inter / max(union, 1e-12) where union > 0, else 0), rounded at
//   each step with the `__f*_rn` intrinsics, which the compiler never
//   contracts into an FMA, and an IEEE divide; the chosen candidate leaves
//   the live set; an invalid slot suppresses nothing;
// - once every live score is -inf each remaining slot is index 0, invalid,
//   as `torch.argmax` over an all -inf row gives.
//
// What bounds it: the slot loop's dependence. Each slot needs the previous
// slot's suppressions, so a slot is an argmax over the image's candidates
// and a pass over them, k in sequence; the work is k x N IoUs an image and
// its bytes are a few per candidate. One block an image leaves most SMs
// idle (16 images, 132 SMs) and gives each thread a dozen candidates a
// slot (3.0 ms a train call, 3 us a slot). Design:
// - a cluster of C blocks an image (C = ceil(N / 1,024), at most 8), each
//   holding a contiguous share of the candidates, one or two a thread:
//   their live scores in registers as 32-bit keys (an order-preserving map
//   of the float32 score), their boxes in the block's shared memory;
// - a slot's argmax: a thread's max over its keys (the lowest index first
//   among equals), per warp one `redux` max of the key and one `redux` min
//   of the index among the lanes that hold it, one barrier, the same over
//   the warps; each block writes its winner (key, index, box) to its shared
//   memory, one cluster barrier, and every warp reads the C winners through
//   distributed shared memory and takes the best the same way, so every
//   thread of the cluster knows the slot's winner and its box;
// - the per-slot buffers alternate between two by slot, so one cluster
//   barrier a slot is enough (a block writes a buffer again only after
//   every block has passed the next barrier, which each reaches after its
//   reads);
// - a dead candidate (suppressed or taken) is skipped, and the divide runs
//   only where the boxes overlap (inter > 0; otherwise the loop's IoU is 0);
// - the loop stops at the first exhausted slot and fills the rest; a last
//   cluster barrier keeps every block's shared memory alive until the
//   others have read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kMaxPer = 2;               // candidates a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNegInfKey = 0x007FFFFFu;   // order_key(-inf)
constexpr uint32_t kPosInfKey = 0xFF800000u;   // order_key(+inf)
constexpr uint32_t kNone = 0xFFFFFFFFu;        // no index

// An order-preserving map of a float32 score to 32 bits: NaN above +inf
// (torch.argmax's order), -0 equal to +0; every score's key is
// kNegInfKey or above, and 0 stands below them all (no candidate).
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return 0xFFFFFFFFu;
  if (s == 0.f) s = 0.f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's highest key and, among the lanes that hold it, the lowest
// index: the same pair in every lane.
__device__ __forceinline__ void warp_best(uint32_t& key, uint32_t& c) {
  const uint32_t top = __reduce_max_sync(kFull, key);
  c = __reduce_min_sync(kFull, key == top ? c : kNone);
  key = top;
}

// (x2 - x1) * (y2 - y1), as the loop's `areas`
__device__ __forceinline__ float area_of(const float4& b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// iou(a, b) > thr by the loop's expression; area_a = area_of(a)
__device__ __forceinline__ bool over(const float4& a, float area_a,
                                     const float4& b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  float iou = 0.f;
  if (inter > 0.f) {
    const float uni = __fsub_rn(__fadd_rn(area_a, area_of(b)), inter);
    if (uni > 0.f) iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
  }
  return iou > thr;
}

struct Winner {           // a block's winner of a slot
  uint32_t key, c;
  float4 box;
};

// grid: B clusters of C blocks along x; block r of an image's cluster
// holds its candidates [r * Nb, min((r + 1) * Nb, N)).
template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
nms_greedy_slots(const float4* __restrict__ boxes,
                 const float* __restrict__ scores,
                 const uint8_t* __restrict__ valid, int64_t* __restrict__ idx,
                 uint8_t* __restrict__ ok, int N, int Nb, int k, float thr) {
  extern __shared__ float4 sbox[];
  __shared__ uint32_t warp_key[2][kMaxThreads / 32];
  __shared__ uint32_t warp_c[2][kMaxThreads / 32];
  __shared__ Winner block_best[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int warps = T >> 5;
  const size_t img = blockIdx.x / C;
  const int base = r * Nb;
  const int nb = min(Nb, N - base);      // this block's candidates
  const float4* gbox = boxes + img * N + base;
  const float* sc = scores + img * N + base;
  const uint8_t* va = valid ? valid + img * N + base : nullptr;
  int64_t* out_idx = idx + img * k;
  uint8_t* out_ok = ok + img * k;

  uint32_t key[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * T + t;
    key[j] = 0;                          // past the share: no candidate
    if (c < nb) {
      key[j] = (va == nullptr || va[c]) ? order_key(sc[c]) : kNegInfKey;
      sbox[c] = gbox[c];
    }
  }
  __syncthreads();

  int slot = 0;
  for (; slot < k; ++slot) {
    const int buf = slot & 1;
    uint32_t top = 0, at = kNone;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (key[j] > top) {
        top = key[j];
        at = base + j * T + t;
      }
    warp_best(top, at);
    if (lane == 0) {
      warp_key[buf][warp] = top;
      warp_c[buf][warp] = at;
    }
    __syncthreads();
    top = lane < warps ? warp_key[buf][lane] : 0u;
    at = lane < warps ? warp_c[buf][lane] : kNone;
    warp_best(top, at);
    if (t == 0) {
      Winner mine;
      mine.key = top;
      mine.c = at;
      mine.box = top > 0u ? sbox[at - base] : make_float4(0.f, 0.f, 0.f, 0.f);
      block_best[buf] = mine;
    }
    cluster.sync();
    // the slot's winner among the C blocks' winners, in every warp
    Winner w;
    w.key = 0u;
    w.c = kNone;
    w.box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < C) w = *cluster.map_shared_rank(&block_best[buf], lane);
    top = w.key;
    at = w.c;
    warp_best(top, at);
    const int from =
        __ffs(__ballot_sync(kFull, w.key == top && w.c == at)) - 1;
    const float4 a = make_float4(__shfl_sync(kFull, w.box.x, from),
                                 __shfl_sync(kFull, w.box.y, from),
                                 __shfl_sync(kFull, w.box.z, from),
                                 __shfl_sync(kFull, w.box.w, from));
    const int i = static_cast<int>(at);
    const bool finite = top > kNegInfKey && top < kPosInfKey;
    if (r == 0 && t == 0) {
      out_idx[slot] = i;
      out_ok[slot] = finite;
    }
    if (top <= kNegInfKey) break;        // exhausted: every live score -inf
    const float area_a = area_of(a);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = j * T + t;
      if (key[j] <= kNegInfKey) continue;
      if (base + c == i || (finite && over(a, area_a, sbox[c], thr)))
        key[j] = kNegInfKey;
    }
  }
  if (r == 0)                            // after exhaustion: index 0, invalid
    for (int s = slot + 1 + t; s < k; s += T) {
      out_idx[s] = 0;
      out_ok[s] = 0;
    }
  cluster.sync();   // no block leaves while another may read its buffers
}

template <int PER>
cudaError_t launch(const float4* boxes, const float* scores,
                   const uint8_t* valid, int64_t* idx, uint8_t* ok, int B,
                   int N, int C, int k, float thr, cudaStream_t stream) {
  const int Nb = (N + C - 1) / C;
  const int T = ((Nb + PER - 1) / PER + 31) / 32 * 32;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * C);
  config.blockDim = dim3(T);
  config.dynamicSmemBytes = static_cast<size_t>(Nb) * sizeof(float4);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, nms_greedy_slots<PER>, boxes, scores,
                            valid, idx, ok, N, Nb, k, thr);
}

}  // namespace

// idx (B, k) int64 and ok (B, k) bool of the greedy NMS of each image's N
// boxes (B, N, 4) float32 xyxy under scores (B, N) float32, with `valid`
// (B, N) bool or null (an invalid candidate's score is -inf); 1 <= N <=
// kMaxCluster * kMaxThreads * kMaxPer.
extern "C" int ssl4gie_nms_topk(const void* boxes, const void* scores,
                                const void* valid, void* idx, void* ok, int B,
                                int N, int k, float thr, void* stream) {
  if (B < 0 || N < 1 || k < 0 || N > kMaxCluster * kMaxThreads * kMaxPer)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || k == 0) return (int)cudaSuccess;
  const auto* bx = static_cast<const float4*>(boxes);
  const auto* sc = static_cast<const float*>(scores);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* ix = static_cast<int64_t*>(idx);
  auto* o = static_cast<uint8_t*>(ok);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // blocks of up to kMaxThreads threads, one candidate a thread where C
  // blocks reach N, two where they do not
  const int C = std::min(kMaxCluster, (N + kMaxThreads - 1) / kMaxThreads);
  const int per = (N + C * kMaxThreads - 1) / (C * kMaxThreads);
  const cudaError_t e =
      per == 1 ? launch<1>(bx, sc, va, ix, o, B, N, C, k, thr, s)
               : launch<2>(bx, sc, va, ix, o, B, N, C, k, thr, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
