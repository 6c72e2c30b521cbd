// Resident-sequence attention core for short sequences (N <= NK <= 256,
// head width 64) on Hopper's tensor cores (sm_90a): the kernels of the A/B
// variants in attention_variants.cu (#10 packed-QKV v2, #11 save-P) and
// window_attention_v2.cu (#12 window v2).
//
// The streaming core of attention_core.cuh walks 64-key tiles through a
// cp.async ring, and each 64-row query block re-reads all of K and V. Here
// one block holds a whole sequence's operands for one head in shared memory
// and serves every 64-row tile of that sequence from them, then the next of
// its G sequences (G adjacent images, or G horizontally adjacent windows):
// the counterpart of the TPU kernels' G sequences a program.
// - #10 and #12 run two persistent, warp-specialised kernels: a producer
//   warpgroup moves every operand in and every output out by TMA
//   (csrc/tma.cuh), two consumer warpgroups multiply (setmaxnreg 240).
//   `res_fwd_tma` (the forward; its comment has the design) and
//   `res_bwd_tma` (dQ, dK and dV in one pass; its comment has the design).
// - #11 (`res_savep_fwd`, `res_savep_dq`, `res_savep_dkv`): a block is two
//   warpgroups (256 threads, __launch_bounds__(256, 1)); its resident
//   operands come by cp.async, kept twice with G > 1 so that the next
//   sequence's copies fly while this one is computed; a warpgroup's own
//   64-row tiles come through registers (copy_rows).
// - NK is the width of the resident score tile, 208 or 256 keys (the TPU
//   kernels' Nb): a 64 x NK product is issued as 64-column wgmma chunks
//   and, at NK = 208, one 16-column chunk (`res_fwd_tma`: one m64nNKk16
//   product a k-step), so columns beyond NK cost nothing.
// - q is scaled, bf16(q * bf16(scale)), the TPU kernels' rounding point
//   (in shared memory; `res_fwd_tma` in registers), so the scores need no
//   scale and dK = dS^T.(scaled q) none either.
// - Forward: per query tile S = Q.K^T over all NK keys at once (NK / 2
//   registers a thread) and a single-pass softmax: no running max, no
//   rescale; keys >= N are -inf.
//   - #10 / #12: the unnormalised exponent is rounded to bf16 for P.V and
//     the output divided by the row sum, as the TPU's v2 kernels do; each
//     row's log-sum-exp is written for the backward.
//   - #11: P = exp / sum, rounded to bf16, is the A operand of P.V and is
//     also written, (seqs, H, N, NK) bf16: N rows, all NK columns (columns
//     >= N are exactly 0). Rows >= N are never written: the TPU kernel
//     fills them from out-of-bounds q and its backward contracts over them
//     (ROADMAP.md, "Known faults in the reference itself").
// - Backward, no atomics, bitwise repeatable:
//   - #10 / #12 (`res_bwd_tma`): per (64-key tile, query chunk) S^T, dP^T
//     and, from the forward's lse, P^T, dS^T, then dV, dK and the chunk's
//     dQ partial: five products and one exponent, as the TPU's v2 kernels
//     compute dq, dk and dv of a sequence in one program. delta =
//     rowsum(dO * O), as the port's #2 (the TPU's v2 takes rowsum(P * dP):
//     equal in exact arithmetic).
//   - #11 reads P in place of S and the exponent, in two kernels:
//     `res_savep_dq` takes a whole 64 x NK dP tile and P's 64 rows (through
//     registers into shared memory, then ldmatrix in the accumulator
//     layout), delta = rowsum(P * dP) from the bf16 P (the TPU's rounding
//     point), dS, dQ (two products); `res_savep_dkv` takes 64 x 64 tiles of
//     P the same way, transposed by ldmatrix .trans into the A layout of
//     dV = P^T.dO, and runs dP^T, dV and dK (three).
//
// Shared memory per block (64-wide bf16 rows of 128 B; NK rows rounded up
// to 224 at 208 in #11's kernels; "x2" with G > 1): `res_fwd_tma` 2 NK +
// 256 rows x2 at every G (168 or 192 KiB); `res_bwd_tma` 4 NK rows, 2 NK
// f32 rows, two 64-row tiles and 8 NK bytes (174 or 211 KiB); the save-P
// forward 2 NK + 256 rows x2; the save-P dq 2 NK rows x2 + 128 + a 64 x NK
// P tile per warpgroup, its dk/dv 2 NK rows x2 + 256 + 8 NK bytes of
// statistics + two 64 x 64 P tiles per warpgroup.

#pragma once

#include <type_traits>

#include "attention_core.cuh"
#include "tma.cuh"

namespace {

// ------------------------------------------------ chunk products
// S (64 x 16) = (acc ? S : 0) + A . B^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[2][4],
                                             unsigned long long a,
                                             unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(acc));
}

template <int NJ>
__device__ __forceinline__ void zero(float (&x)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// A 64 x W score chunk (W = 64 or 16) over a head of D: d = A . B^T, both
// K-major in shared memory, D / 16 k-steps of 32 bytes
template <int D, int W>
__device__ __forceinline__ void mma_scores(float (&d)[W / 8][4],
                                           unsigned long long a,
                                           unsigned long long b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (W == 64) wgmma_ss_n64(d, a + 2 * kk, b + 2 * kk, kk);
    else wgmma_ss_n16(d, a + 2 * kk, b + 2 * kk, kk);
  }
}

// acc (64 x D) += A (64 x 16 KS, bf16 fragments in registers) . B (16 KS
// rows of D in shared memory, MN-major), 16 rows (two atoms) a step
template <int D, int KS>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const unsigned (&a)[KS][4],
                                       unsigned long long b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_pv(acc, a[kk], b + kk * (2 * Swz<D>::kAtom >> 4));
}

// ------------------------------------------- #11's backward steps
// The end of a dk/dv step: with P^T of the warp's keys at W query columns
// (st in f32, pa its bf16 A fragments) and dP^T = V.dO^T the last wgmma
// group in flight, dS^T = P^T (dP^T - delta) (the chunk's delta at dl),
// then dV += bf16(P^T).dO and dK += bf16(dS^T).Q with the chunk's dO and Q
// rows (at dg, dq) read MN-major.
template <int D, int W>
__device__ __forceinline__ void dkv_tail(float (&dka)[D / 8][4],
                                         float (&dva)[D / 8][4],
                                         const float (&st)[W / 8][4],
                                         const unsigned (&pa)[W / 16][4],
                                         float (&dpt)[W / 8][4],
                                         const float* dl,
                                         unsigned long long dq,
                                         unsigned long long dg) {
  const int c2 = (threadIdx.x & 3) * 2;
  wg_wait0();
  wg_hold(dpt);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(dl + j * 8 + c2);
    dpt[j][0] = st[j][0] * (dpt[j][0] - d.x);
    dpt[j][1] = st[j][1] * (dpt[j][1] - d.y);
    dpt[j][2] = st[j][2] * (dpt[j][2] - d.x);
    dpt[j][3] = st[j][3] * (dpt[j][3] - d.y);
  }
  unsigned da[W / 16][4];
  pack_a(dpt, da);                                  // bf16(dS^T)
  wg_hold(dva);
  wg_hold(dka);
  wg_fence();
  mma_pv<D, W / 16>(dva, pa, dg);
  mma_pv<D, W / 16>(dka, da, dq);
  wg_commit();
  wg_wait0();
  wg_hold(dva);
  wg_hold(dka);
}

constexpr int kResThreads = 256;          // two warpgroups a block
constexpr int kRowBytes = 128;            // one 64-wide bf16 row
constexpr unsigned long long kChunkDesc = 64 * kRowBytes >> 4;   // 64 rows

// Rows of a resident buffer of NK rows: whole copies for 256 threads (8
// 16-byte chunks a row), so 224 at NK = 208; the rows >= N are zeros.
template <int NK>
constexpr int kResRows = (NK + 31) / 32 * 32;
// Rows of the forward's resident Q: whole 64-row query tiles (256)
template <int NK>
constexpr int kQRows = (NK + 63) / 64 * 64;

// A 64 x NK product: 64-column chunks, then NK % 64 (16) columns; B's rows
// 64 c.. are chunk c
template <int NK>
__device__ __forceinline__ void mma_wide(float (&d)[NK / 8][4],
                                         unsigned long long a,
                                         unsigned long long b) {
  static_assert(NK % 64 == 0 || NK % 64 == 16, "chunks of 64, then 16");
#pragma unroll
  for (int c = 0; c < NK / 64; ++c)
    mma_scores<64, 64>(*reinterpret_cast<float(*)[8][4]>(&d[8 * c]), a,
                       b + c * kChunkDesc);
  if constexpr (NK % 64 != 0)
    mma_scores<64, 16>(*reinterpret_cast<float(*)[2][4]>(&d[8 * (NK / 64)]),
                       a, b + (NK / 64) * kChunkDesc);
}

// barrier of warpgroup wg's 128 threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// order this thread's shared-memory writes (cp.async or plain) before the
// wgmma reads that follow the next barrier
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The chunks that thread tid (of T) copied into an R-row tile by load_rows,
// times s, rounded to bf16: bf16(q * bf16(scale)), the TPU kernels' q. Call
// after the thread's own cp.async has landed.
template <int R, int T>
__device__ __forceinline__ void scale_rows(unsigned char* tile, int tid,
                                           float s) {
#pragma unroll
  for (int i = 0; i < R * 8 / T; ++i) {
    const int idx = tid + i * T;
    uint4* p = reinterpret_cast<uint4*>(tile +
                                        Swz<64>::offset(idx / 8, idx % 8));
    uint4 u = *p;
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x[e]);
      x[e] = __floats2bfloat162_rn(f.x * s, f.y * s);
    }
    *p = u;
  }
}

// The shared array p from its first 1 KiB boundary on, as an offset of p
// itself: the compiler keeps knowing that the pointers derived from it are
// shared and addresses them in 32 bits (rounding the address as an integer
// makes them generic, 64 bits a pointer, which cost the backward its
// registers: 564 bytes of spills).
__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Rows [first, first + R) of a sequence's 64-wide column slice at src (row
// stride ld) into the swizzled tile at dst, by the T threads tid = 0..T-1,
// through registers: all loads, then all stores. Unlike load_rows it joins
// no cp.async group, so it neither waits for nor is waited for by the
// copies of the next sequence in flight. Rows >= limit become zeros.
template <int R, int T, class Rows>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src,
                                          int ld, Rows rows, int first,
                                          int limit, int tid) {
  constexpr int kN = R * 8 / T;
  static_assert(R * 8 % T == 0, "whole copies per thread");
  uint4 x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = tid + i * T, r = idx / 8;
    x[i] = first + r < limit
               ? *reinterpret_cast<const uint4*>(
                     src + (size_t)rows.offset(first + r) * ld + idx % 8 * 8)
               : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int idx = tid + i * T;
    *reinterpret_cast<uint4*>(dst + Swz<64>::offset(idx / 8, idx % 8)) = x[i];
  }
}

// A tile of P (bf16, row stride NK elements): rows [r0, r0 + R) from column
// col0, CH 16-byte chunks a row, by a warpgroup's 128 threads (wt), through
// registers (`load_p` into x, then `store_p`) into rows of CH * 16 + 16
// bytes (the 16 bytes of padding put the 8 rows an ldmatrix reads on
// distinct banks); rows >= N and columns >= NK are zeros.
template <int R, int CH>
constexpr int kPCopies = (R * CH + 127) / 128;
template <int R, int CH>
__device__ __forceinline__ void load_p(uint4 (&x)[kPCopies<R, CH>],
                                       const bf16* p, int NK, int r0,
                                       int col0, int N, int wt) {
#pragma unroll
  for (int i = 0; i < kPCopies<R, CH>; ++i) {
    const int idx = wt + i * 128, r = idx / CH, c = idx % CH;
    x[i] = idx < R * CH && r0 + r < N && col0 + c * 8 < NK
               ? *reinterpret_cast<const uint4*>(p + (size_t)(r0 + r) * NK +
                                                 col0 + c * 8)
               : make_uint4(0, 0, 0, 0);
  }
}
template <int R, int CH>
__device__ __forceinline__ void store_p(unsigned char* dst,
                                        const uint4 (&x)[kPCopies<R, CH>],
                                        int wt) {
#pragma unroll
  for (int i = 0; i < kPCopies<R, CH>; ++i) {
    const int idx = wt + i * 128;
    if (idx < R * CH)
      *reinterpret_cast<uint4*>(dst + idx / CH * (CH * 16 + 16) +
                                idx % CH * 16) = x[i];
  }
}

// bf16 pair -> two floats
__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Shared memory of the kernels. The resident operands of a sequence (the
// forward's K, V and Q; the dq kernels' K and V; the dk/dv kernel's Q and
// dO) are kept twice when G > 1, so that the next sequence's cp.async
// copies fly while this one is computed; then per warpgroup its 64-row
// tiles, the dk/dv kernel's statistics and the save-P kernels' P tiles (a
// 64 x NK row tile per warpgroup in dq, two 64 x 64 tiles in dk/dv).
template <int NK>
constexpr int kPRowBytes = NK * 2 + 16;
constexpr int kPtBytes = 64 * (64 * 2 + 16);
template <int NK>
__host__ __device__ constexpr size_t resident_bytes(int operands, int G) {
  return (size_t)(G > 1 ? 2 : 1) * operands * kResRows<NK> * kRowBytes;
}
template <int NK>
size_t res_fwd_smem(int G) {
  return (size_t)(G > 1 ? 2 : 1) * (2 * kResRows<NK> + kQRows<NK>) *
             kRowBytes + 1024;
}
template <int NK>
size_t res_dq_smem(int G) {
  return resident_bytes<NK>(2, G) + 2 * 64 * (kRowBytes + kPRowBytes<NK>) +
         1024;
}
template <int NK>
size_t res_dkv_smem(int G) {
  return resident_bytes<NK>(2, G) + 8 * kResRows<NK> + 2 * 128 * kRowBytes +
         2 * 2 * kPtBytes + 1024;
}

// ------------------------------------------------ forward (#10, #12)
// `res_fwd_tma`: persistent and warp-specialised. A work item is G
// sequences of one head: item i is head i % H of sequences (i / H) G ..
// (i / H) G + G - 1 (< seqs), so G changes only the order of the work. A
// block takes every gridDim.x-th sequence in item order (SeqWalk); the
// grid is at most one block an SM (kResPersistent).
// - Warpgroup 0, the producer (setmaxnreg 24): one thread walks the
//   block's sequences and keeps the next one's K, V and Q in flight by TMA
//   (one box each) into a ring of two stages of a whole sequence each,
//   guarded by a full and a done mbarrier. The ring runs on across items,
//   so every copy overlaps the compute of the sequence before, at G = 1
//   too. Dense (#10): 3-D maps over qkv (B, N, 3C), boxes of 64 columns by
//   NK rows (K, V) or 64 ceil(N / 64) rows (Q); TMA zero-fills rows >= N.
//   Windows (#12): 4-D maps over (B, GH, GW, 3C) with (1, ws, ws, 64)
//   boxes, which land a window's rows in order (WindowRows' gather); K and
//   V rows that a box leaves unwritten (ws^2 < NK) are zeroed once. Every
//   box is in the 128-byte swizzle that wgmma's descriptors read, so no
//   thread touches an operand on its way in.
// - Warpgroups 1 and 2, the consumers (setmaxnreg 240), take the
//   sequence's 64-row query tiles w, w + 2, ...: Q by ldmatrix into
//   registers and scaled there, bf16(q bf16(scale)); S = Q.K^T over all NK
//   keys, one register-A wgmma (m64nNKk16) a k-step; the row max over all
//   NK keys; then per 64-key chunk the exponent (columns >= N skip it,
//   warps of only padding rows skip it all), bf16(P) and the chunk's
//   O += P.V (V read MN-major), issued so that it runs under the next
//   chunk's exponent; O / l staged into the tile's own Q rows (read
//   already); each row's lse stored. Consumer 1 issues its first product
//   after consumer 0's, so that the softmax of one runs under the
//   products of the other.
// - Once both consumers are through a sequence (its done barrier), the
//   producer stores its O from the stage by one TMA box (the Q box's shape;
//   rows past N are not written), and refills the stage after the store
//   has read it.
// - Registers: the score tile takes NK / 2 a thread; P a chunk at a time
//   keeps bf16(P) at 16 (a 64-key chunk) instead of NK / 4, and the
//   consumers' 240 hold it. (P packed whole beside the score tile needed
//   about 246 registers at NK = 208 and spilled at 256 even at 255; a
//   block of 288 threads, nine warps, gets 168 registers a thread.)
// - The consumers' compute, not the copies, sets its time (PERF.md,
//   section 6).
// No atomics: every output is computed once, in one order.

constexpr int kTmaStages = 2;             // whole sequences in flight
// The design's two choices, switchable for measuring them
// (benchmarks/ablate_resident_forward.py, ablate_resident_backward.py),
// in the forward and the backward alike: a producer warpgroup loads and
// stores (else thread 0 of consumer 0 does, before each sequence), and the
// grid is persistent (else a block an item).
constexpr bool kResProducer = true;
constexpr bool kResPersistent = true;

template <int NK>
struct ResTma {
  static constexpr int kKV = NK * kRowBytes;        // K or V of a sequence
  static constexpr int kQ = 256 * kRowBytes;        // Q, then O: four tiles
  static constexpr int kStage = 2 * kKV + kQ;       // 1 KiB multiples
  static constexpr int kSmem = 1024 + kTmaStages * kStage + 64;
  static constexpr int kThreads = kResProducer ? 384 : 256;
};

struct ResTmaArgs {
  float* lse;               // (seqs, H, N)
  int seqs, G, H, N;
  int items;                // ceil(seqs / G) H: the grid of a block an item
  int nh, nw, ws;           // windows: per image column and row; width
  int kv_rows;              // rows a K or V box writes
  int tx_bytes;             // bytes a stage receives
  float scale;
};

// The sequences of a block, in order: the f-th of all seqs H sequences
// in item order for f = blockIdx.x, + gridDim.x, ..., so that every block
// takes an equal share (to one sequence) whatever G is, and the blocks at
// work at one time hold neighbouring sequences, all heads of one image
// together. Row r of items holds sequences r G .. r G + G - 1 (< seqs),
// head 0's, then head 1's, ...: G changes only the order of the work.
struct SeqWalk {
  int f, seq, h;
  __device__ __forceinline__ explicit SeqWalk(const ResTmaArgs& a)
      : f(blockIdx.x) {
    locate(a);
  }
  __device__ __forceinline__ void locate(const ResTmaArgs& a) {
    const int r = f / (a.G * a.H), rem = f - r * a.G * a.H;
    const int gr = min(a.G, a.seqs - r * a.G);    // the row's sequences
    h = rem / gr;
    seq = r * a.G + rem - h * gr;
  }
  __device__ __forceinline__ bool more(const ResTmaArgs& a) const {
    return f < a.seqs * a.H;
  }
  __device__ __forceinline__ void next(const ResTmaArgs& a) {
    f += gridDim.x;
    if (more(a)) locate(a);
  }
};

// Sequence seq's box of `map` at column col: (col, 0, seq) of a dense map,
// (col, x0, y0, image) of a window's
template <bool kWindow>
__device__ __forceinline__ void seq_load(const CUtensorMap* map, void* dst,
                                         unsigned long long* bar, int col,
                                         int seq, const ResTmaArgs& a) {
  if constexpr (kWindow) {
    const int t = seq / a.nw;
    tma_load_4d(map, dst, bar, col, seq % a.nw * a.ws, t % a.nh * a.ws,
                t / a.nh);
  } else {
    tma_load_3d(map, dst, bar, col, 0, seq);
  }
}
template <bool kWindow>
__device__ __forceinline__ void seq_store(const CUtensorMap* map,
                                          const void* src, int col, int seq,
                                          const ResTmaArgs& a) {
  if constexpr (kWindow) {
    const int t = seq / a.nw;
    tma_store_4d(map, src, col, seq % a.nw * a.ws, t % a.nh * a.ws,
                 t / a.nh);
  } else {
    tma_store_3d(map, src, col, 0, seq);
  }
}

// Sequence seq's box of `map` at column col into L2 (seq_load's box)
template <bool kWindow>
__device__ __forceinline__ void seq_prefetch(const CUtensorMap* map, int col,
                                             int seq, const ResTmaArgs& a) {
  if constexpr (kWindow) {
    const int t = seq / a.nw;
    tma_prefetch_4d(map, col, seq % a.nw * a.ws, t % a.nh * a.ws, t / a.nh);
  } else {
    tma_prefetch_3d(map, col, 0, seq);
  }
}

// The producer's walk: loads each sequence into stage j % 2 once the
// sequence two before it is through and its O stored and read.
template <int NK, bool kWindow>
struct ResLoader {
  using T = ResTma<NK>;
  unsigned char* smem;
  unsigned long long *full, *done;
  const CUtensorMap *mKV, *mQ, *mO;
  SeqWalk ld, st;            // the next sequence to load; to store
  int j;                     // sequences loaded
  __device__ __forceinline__ ResLoader(unsigned char* smem_,
                                       unsigned long long* full_,
                                       unsigned long long* done_,
                                       const CUtensorMap* kv,
                                       const CUtensorMap* q,
                                       const CUtensorMap* o,
                                       const ResTmaArgs& a)
      : smem(smem_), full(full_), done(done_), mKV(kv), mQ(q), mO(o),
        ld(a), st(a), j(0) {}
  // O of the block's sequence k, once both consumers are through it
  __device__ __forceinline__ void store(int k, const ResTmaArgs& a) {
    const int s = k & 1;
    mbar_wait(done + s, (k >> 1) & 1);
    seq_store<kWindow>(mO, smem + s * T::kStage + 2 * T::kKV, st.h * 64,
                       st.seq, a);
    bulk_commit();
    st.next(a);
  }
  __device__ __forceinline__ void step(const ResTmaArgs& a) {
    const int s = j & 1, C = 64 * a.H;
    unsigned char* buf = smem + s * T::kStage;
    if (j >= 2) {
      store(j - 2, a);
      bulk_wait_read();                // the store has read the stage
    }
    mbar_expect_tx(full + s, a.tx_bytes);
    seq_load<kWindow>(mKV, buf, full + s, C + ld.h * 64, ld.seq, a);
    seq_load<kWindow>(mKV, buf + T::kKV, full + s, 2 * C + ld.h * 64, ld.seq,
                      a);
    seq_load<kWindow>(mQ, buf + 2 * T::kKV, full + s, ld.h * 64, ld.seq, a);
    ld.next(a);
    ++j;
  }
  __device__ __forceinline__ void drain(const ResTmaArgs& a) {
    for (int k = j < 2 ? 0 : j - 2; k < j; ++k) store(k, a);
    bulk_wait();
  }
};

// S (64 x NK) = (acc ? S : 0) + A . B^T, NK = 208 or 256, in one product:
// A (64 x 16) bf16 fragments in registers, B (NK x 16) in shared memory,
// K-major
#define RES_ACC4(d, i) \
  "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[26][4],
                                              const unsigned (&a)[4],
                                              unsigned long long b,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103"
      "}, {%104,%105,%106,%107}, %108, p, 1, 1, 0;\n}\n"
      : RES_ACC4(d, 0), RES_ACC4(d, 1), RES_ACC4(d, 2),
        RES_ACC4(d, 3), RES_ACC4(d, 4), RES_ACC4(d, 5),
        RES_ACC4(d, 6), RES_ACC4(d, 7), RES_ACC4(d, 8),
        RES_ACC4(d, 9), RES_ACC4(d, 10), RES_ACC4(d, 11),
        RES_ACC4(d, 12), RES_ACC4(d, 13), RES_ACC4(d, 14),
        RES_ACC4(d, 15), RES_ACC4(d, 16), RES_ACC4(d, 17),
        RES_ACC4(d, 18), RES_ACC4(d, 19), RES_ACC4(d, 20),
        RES_ACC4(d, 21), RES_ACC4(d, 22), RES_ACC4(d, 23),
        RES_ACC4(d, 24), RES_ACC4(d, 25)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[32][4],
                                              const unsigned (&a)[4],
                                              unsigned long long b,
                                              int acc) {
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
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : RES_ACC4(d, 0), RES_ACC4(d, 1), RES_ACC4(d, 2),
        RES_ACC4(d, 3), RES_ACC4(d, 4), RES_ACC4(d, 5),
        RES_ACC4(d, 6), RES_ACC4(d, 7), RES_ACC4(d, 8),
        RES_ACC4(d, 9), RES_ACC4(d, 10), RES_ACC4(d, 11),
        RES_ACC4(d, 12), RES_ACC4(d, 13), RES_ACC4(d, 14),
        RES_ACC4(d, 15), RES_ACC4(d, 16), RES_ACC4(d, 17),
        RES_ACC4(d, 18), RES_ACC4(d, 19), RES_ACC4(d, 20),
        RES_ACC4(d, 21), RES_ACC4(d, 22), RES_ACC4(d, 23),
        RES_ACC4(d, 24), RES_ACC4(d, 25), RES_ACC4(d, 26),
        RES_ACC4(d, 27), RES_ACC4(d, 28), RES_ACC4(d, 29),
        RES_ACC4(d, 30), RES_ACC4(d, 31)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
#undef RES_ACC4

// bf16 pair x s, rounded to a bf16 pair
__device__ __forceinline__ unsigned scale_pair(unsigned x, float s) {
  const float2 f = unpack_bf16(x);
  return pack_bf16(f.x * s, f.y * s);
}

// One 64-row query tile of a sequence (its Q rows at Qt), by a consumer
// warpgroup: O staged over the tile's Q rows, lse of rows < N stored at
// lse + row. `first`: consumer 0's first tile (it lets consumer 1 start).
template <int NK>
__device__ __forceinline__ void res_tile(unsigned char* Qt,
                                         unsigned long long dk,
                                         unsigned long long dv, int row0,
                                         int N, float qscale, float* lse,
                                         bool first) {
  constexpr int NJ = NK / 8;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5 & 3) * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // Q's A fragments (ldmatrix: lanes 0-15 rows at k 0-7, 16-31 at k 8-15)
  unsigned qa[4][4];
  const int r = wr + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(qa[kk], Qt + Swz<64>::offset(r, 2 * kk + (lane >> 4)));
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], qscale);
  }
  float sc[NJ][4];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide(sc, qa[kk], dk + 2 * kk, kk);
  wg_commit();
  if (first) named_arrive(1, 256);
  wg_wait0();
  wg_hold(sc);
  // single-pass softmax of rows g (half 0) and g + 8 (half 1): the row
  // max over all NK keys (keys >= N are -inf), then per 64-key chunk the
  // exponent (an 8-column group wholly past N skips it), its row sums,
  // bf16(P) and the chunk's P.V, which runs under the next chunk's
  // exponent
  const bool live = row0 + wr < N;      // the warp holds a row < N
  float mx[2] = {0.f, 0.f}, ms[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  if (live) {
    if (N < NK) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 8 + c2 + e >= N) sc[j][e] = sc[j][e + 2] = -CUDART_INF_F;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        m = fmaxf(m, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
      m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
      mx[hf] = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
      ms[hf] = mx[hf] * kLog2e;
    }
  }
  float acc[8][4];
  zero(acc);
  wg_hold(acc);
#pragma unroll
  for (int c = 0; c < (NJ + 7) / 8; ++c) {
    const int j0 = 8 * c, jn = NJ - j0 < 8 ? NJ - j0 : 8;   // NK = 208: 2
#pragma unroll
    for (int j = j0; j < j0 + jn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = live && j * 8 < N
                       ? exp2_approx(fmaf(sc[j][e], kLog2e, -ms[e >> 1]))
                       : 0.f;
        l[e >> 1] += sc[j][e];
      }
    if (c > 0) wg_wait0();              // the last chunk's P.V read its P
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < jn / 2; ++kk) {
      const int j = j0 + 2 * kk;
      pa[kk][0] = pack_bf16(sc[j][0], sc[j][1]);
      pa[kk][1] = pack_bf16(sc[j][2], sc[j][3]);
      pa[kk][2] = pack_bf16(sc[j + 1][0], sc[j + 1][1]);
      pa[kk][3] = pack_bf16(sc[j + 1][2], sc[j + 1][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < jn / 2; ++kk)
      wgmma_rs_n64(acc, pa[kk],
                   dv + (4 * c + kk) * (2 * Swz<64>::kAtom >> 4));
    wg_commit();
  }
  wg_wait0();
  wg_hold(acc);
  float sum[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float s = l[hf] + __shfl_xor_sync(kFull, l[hf], 1);
    sum[hf] = s + __shfl_xor_sync(kFull, s, 2);
  }
  // O / l over the warp's own Q rows; each row's log-sum-exp
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + wr + g + 8 * hf;
    if (c2 == 0 && row < N) lse[row] = mx[hf] + logf(sum[hf]);
    const float inv = live ? 1.f / sum[hf] : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          Qt + Swz<64>::offset(wr + g + 8 * hf, n) + c2 * 2) =
          __floats2bfloat162_rn(acc[n][2 * hf] * inv,
                                acc[n][2 * hf + 1] * inv);
  }
}

// mKV, mQ: qkv's maps (K and V boxes; Q boxes), mO: out's (Q's box shape).
template <int NK, bool kWindow>
__global__ void __launch_bounds__(ResTma<NK>::kThreads, 1)
res_fwd_tma(const __grid_constant__ CUtensorMap mKV,
            const __grid_constant__ CUtensorMap mQ,
            const __grid_constant__ CUtensorMap mO,
            const __grid_constant__ ResTmaArgs a) {
  using T = ResTma<NK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + kTmaStages * T::kStage);
  unsigned long long* done = full + kTmaStages;
  // K and V rows that no box writes (windows of fewer than NK tokens):
  // zeros, so that P = 0 meets no NaN in V
  for (int i = a.kv_rows * 8 + threadIdx.x; i < NK * 8; i += T::kThreads)
#pragma unroll
    for (int s = 0; s < kTmaStages; ++s) {
      unsigned char* b = smem + s * T::kStage + i * 16;
      *reinterpret_cast<uint4*>(b) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(b + T::kKV) = make_uint4(0, 0, 0, 0);
    }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(done + s, 256);       // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async();
  __syncthreads();
  ResLoader<NK, kWindow> loader(smem, full, done, &mKV, &mQ, &mO, a);
  const int wg = threadIdx.x >> 7;
  if constexpr (kResProducer) {
    if (wg == 0) {
      setmaxnreg_dec<24>();
      if (threadIdx.x == 0) {
        while (loader.ld.more(a)) loader.step(a);
        loader.drain(a);
      }
      return;
    }
    setmaxnreg_inc<240>();
  }
  const int w = kResProducer ? wg - 1 : wg;
  const bool loads = !kResProducer && threadIdx.x == 0;
  const int n_qt = (a.N + 63) >> 6;
  const float qscale = __bfloat162float(__float2bfloat16(a.scale));
  if (loads) loader.step(a);            // every block has a sequence
  if (w == 1) named_sync(1, 256);       // behind consumer 0's first S
  int j = 0;
  for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j) {
    if (loads && loader.ld.more(a)) loader.step(a);    // one ahead
    const int s = j & 1;
    unsigned char* buf = smem + s * T::kStage;
    mbar_wait(full + s, (j >> 1) & 1);
    const unsigned long long dk = Swz<64>::desc(buf);
    const unsigned long long dv = Swz<64>::desc(buf + T::kKV);
    float* lse = a.lse + ((size_t)sw.seq * a.H + sw.h) * a.N;
    for (int qt = w; qt < n_qt; qt += 2)
      res_tile<NK>(buf + 2 * T::kKV + qt * 64 * kRowBytes, dk, dv, qt * 64,
                   a.N, qscale, lse, w == 0 && j == 0 && qt == 0);
    fence_async();                      // the O rows, before TMA reads them
    mbar_arrive(done + s);
  }
  if (loads) loader.drain(a);
}

// ------------------------------------------------ backward (#10, #12)
// `res_bwd_tma`: dQ, dK and dV of a sequence in one pass, persistent and
// warp-specialised like res_fwd_tma, on the same walk (SeqWalk), with the
// forward's lse. Per sequence (one whole-sequence stage in shared memory,
// ResBwd):
// - The producer warpgroup (setmaxnreg 24): one thread loads Q, K, V (a
//   map over qkv), dO and O (maps over dout and out) by TMA, one box each,
//   and once both consumers are through the sequence stores dQ, dK and dV
//   by three boxes of one map over dqkv from where Q, K and V were; then
//   it loads the next sequence, which it has already brought into L2
//   (seq_prefetch) while this one was computed. Warp 1 brings -lse
//   log2(e) (load_lse). No multiplying thread touches an operand on its
//   way in or out.
// - The two consumers (setmaxnreg 240) first take, one row a thread,
//   q's scaling in place (bf16(q bf16(scale))) and delta = rowsum(dO * O)
//   (rows >= N: delta 0; their -lse log2(e) is -inf, so P^T = 0 there).
// - Then a key-major loop: consumer w owns the 64-key tiles w, w + 2, ...
//   and holds their dK and dV in registers, 64 f32 a thread. Per query
//   chunk c (64 rows; at NK = 208 the last is 16) it issues S^T = K.Qs^T
//   and dP^T = V.dO^T as two groups; P^T = exp2(S^T log2(e) - lse
//   log2(e)) (keys >= N masked); dS^T = P^T (dP^T - delta); bf16(dS^T) to
//   the consumer's staging tile (stmatrix); then dV += bf16(P^T).dO (P^T
//   in registers), dK += bf16(dS^T).Qs and the partial dQ_c = bf16(dS).K
//   (the staging tile read K-major, then MN-major). Five products a (key
//   tile, chunk) and one exponent, as the TPU kernel. Chunk c + 1's S^T
//   and dP^T are issued before chunk c's dV, dK and dQ, so those run under
//   chunk c + 1's exponent; a step waits for chunk c - 1's products once,
//   where it reuses their P^T registers and the staging tile.
// - dQ without atomics: the partials of chunk c are summed in f32 in
//   shared memory (where O lay: delta is taken first) in key-tile order,
//   ((p0 + p1) + p2) + p3, so every run gives the same bits. The consumer
//   of key tile k takes its turn on chunk c after the one of k - 1 (named
//   barriers, one per chunk and direction); key tile 0 writes the sum,
//   the last adds, scales, rounds to bf16 once and writes dQ over Q's
//   rows of the chunk (every product that reads them is through: the
//   turns order them). The sums keep the accumulator's layout, a float4 a
//   thread and column group, so a warp's accesses are 512 contiguous
//   bytes. With consumer 1 a step behind consumer 0 the turns cost little
//   waiting; their shared-memory traffic is what they cost.
// - Each key tile's dK and dV go, as bf16, over its own K and V rows
//   (only its owner reads them).
// - Buffers: at NK = 256 the stage takes 211 KiB (Q, K, V, dO 4 x 32, the
//   f32 sums 64 with O in them first, two 8 KiB staging tiles, lse and
//   delta), so no second stage fits and a sequence's loads wait for the
//   last one's stores to be read; every SM reloads at about the same time,
//   so the L2 prefetch shortens that wait only a little. NK = 208 (174
//   KiB) has the same design.
// - Rows a box leaves unwritten (windows of fewer than NK tokens) are
//   zeroed once; the outputs written over Q, K and V are zeros there
//   again, so no row meets a NaN. At NK = 208 a 64-key tile's rows past
//   208 lie in the next buffer: finite, masked, never written.

template <int NK>
struct ResBwd {
  static constexpr int kOp = NK * kRowBytes;        // Q, K, V or dO rows
  static constexpr int kQ = 0, kK = kOp, kV = 2 * kOp, kG = 3 * kOp;
  static constexpr int kAcc = 4 * kOp;              // dQ's f32 sums; O first
  static constexpr int kStage = kAcc + NK * 256;    // a dS^T tile a consumer
  static constexpr int kLse = kStage + 2 * 64 * kRowBytes;  // -lse log2(e)
  static constexpr int kDelta = kLse + NK * 4;
  static constexpr int kBar = kDelta + NK * 4;      // full, done
  static constexpr int kSmem = 1024 + kBar + 16;
  static constexpr int kThreads = kResProducer ? 384 : 256;
  static constexpr int kChunks = (NK + 63) / 64;    // query chunks
  // the width of query chunk c: 64, the last 16 at NK = 208
  __host__ __device__ static constexpr int width(int c) {
    return NK - 64 * c < 64 ? NK - 64 * c : 64;
  }
};
static_assert(ResBwd<256>::kSmem <= 232448 && ResBwd<208>::kSmem <= 232448,
              "one stage fits the block's shared memory");

// named barriers: 1 + w a consumer's own, the prologue's, then one per
// query chunk and direction of the dQ turns
constexpr int kBarPro = 3, kBarTurn = 4;

// S (64 x 64) = (acc ? S : 0) + A . B^T from shared memory, A MN-major if
// TA, B MN-major if TB (the 16-row k-step at +2 atoms / 16 then)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64t(float (&d)[8][4],
                                              unsigned long long a,
                                              unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// Four 8 x 8 b16 matrices into shared memory, lane l addressing row l % 8
// of matrix l / 8, thread t giving row t / 4, columns 2 (t % 4) and + 1 of
// each (the accumulator layout of a 16 x 16 block, bf16-packed)
__device__ __forceinline__ void stmatrix_x4(void* p, const unsigned (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// keep the compiler from touching A fragments a wgmma in flight reads
template <int K>
__device__ __forceinline__ void wg_hold_a(unsigned (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the first W / 8 column groups of a 64-column accumulator, and the first
// W / 16 k-steps of its A fragments
template <int W>
using Cols = float[W / 8][4];
template <int W>
using Steps = unsigned[W / 16][4];
template <int W>
__device__ __forceinline__ Cols<W>& cols(float (&x)[8][4]) {
  return *reinterpret_cast<Cols<W>*>(&x[0]);
}
template <int W>
__device__ __forceinline__ Steps<W>& steps(unsigned (&x)[4][4]) {
  return *reinterpret_cast<Steps<W>*>(&x[0]);
}

// -lse log2(e) of sequence j (rows >= N: -inf, so that P^T = 0 there)
// into the stage, by one warp (producer warp 1), once the consumers are
// through sequence j - 1: each lane's rows are read before the wait. Plain
// loads: a sequence's lse starts at any 4 bytes, and one TMA box of a 1-D
// map over lse a sequence stopped the kernel with an illegal instruction
// on the H100.
constexpr int kLseArrivals = 32;
template <int NK>
__device__ __forceinline__ void load_lse(unsigned char* smem,
                                         unsigned long long* full,
                                         unsigned long long* done,
                                         const SeqWalk& sw, int j,
                                         const ResTmaArgs& a) {
  constexpr int kPer = (NK + 31) / 32;
  const int lane = threadIdx.x & 31;
  const float* src = a.lse + ((size_t)sw.seq * a.H + sw.h) * a.N;
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = lane + 32 * i;
    v[i] = r < a.N ? -src[r] * kLog2e : -CUDART_INF_F;
  }
  if (j >= 1) mbar_wait(done, (j - 1) & 1);
  float* nl = reinterpret_cast<float*>(smem + ResBwd<NK>::kLse);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (lane + 32 * i < NK) nl[lane + 32 * i] = v[i];
  mbar_arrive(full);
}

// The producer's walk: loads sequence j once sequence j - 1's outputs are
// stored and read (one stage).
template <int NK, bool kWindow>
struct BwdLoader {
  using T = ResBwd<NK>;
  unsigned char* smem;
  unsigned long long *full, *done;
  const CUtensorMap *mIn, *mO, *mG, *mD;
  SeqWalk ld, st;            // the next sequence to load; to store
  int j;                     // sequences loaded
  __device__ __forceinline__ BwdLoader(unsigned char* smem_,
                                       unsigned long long* full_,
                                       unsigned long long* done_,
                                       const CUtensorMap* in,
                                       const CUtensorMap* o,
                                       const CUtensorMap* g,
                                       const CUtensorMap* d,
                                       const ResTmaArgs& a)
      : smem(smem_), full(full_), done(done_), mIn(in), mO(o), mG(g), mD(d),
        ld(a), st(a), j(0) {}
  // dQ, dK, dV of the block's last sequence, once both consumers are
  // through it
  __device__ __forceinline__ void store(const ResTmaArgs& a) {
    const int C = 64 * a.H;
    mbar_wait(done, (j - 1) & 1);
    seq_store<kWindow>(mD, smem + T::kQ, st.h * 64, st.seq, a);
    seq_store<kWindow>(mD, smem + T::kK, C + st.h * 64, st.seq, a);
    seq_store<kWindow>(mD, smem + T::kV, 2 * C + st.h * 64, st.seq, a);
    bulk_commit();
    st.next(a);
  }
  __device__ __forceinline__ void step(const ResTmaArgs& a) {
    const int C = 64 * a.H, col = ld.h * 64;
    if (j >= 1) {
      store(a);
      bulk_wait_read();                // the stores have read the stage
    }
    mbar_expect_tx(full, a.tx_bytes);
    seq_load<kWindow>(mIn, smem + T::kQ, full, col, ld.seq, a);
    seq_load<kWindow>(mIn, smem + T::kK, full, C + col, ld.seq, a);
    seq_load<kWindow>(mIn, smem + T::kV, full, 2 * C + col, ld.seq, a);
    seq_load<kWindow>(mG, smem + T::kG, full, col, ld.seq, a);
    seq_load<kWindow>(mO, smem + T::kAcc, full, col, ld.seq, a);
    ld.next(a);
    ++j;
    // the next sequence into L2 while this one is computed: its loads
    // wait for this one's stores, but then read L2
    if (ld.more(a)) {
      const int ncol = ld.h * 64;
      seq_prefetch<kWindow>(mIn, ncol, ld.seq, a);
      seq_prefetch<kWindow>(mIn, C + ncol, ld.seq, a);
      seq_prefetch<kWindow>(mIn, 2 * C + ncol, ld.seq, a);
      seq_prefetch<kWindow>(mG, ncol, ld.seq, a);
      seq_prefetch<kWindow>(mO, ncol, ld.seq, a);
    }
  }
  __device__ __forceinline__ void drain(const ResTmaArgs& a) {
    if (j >= 1) store(a);
    bulk_wait();
  }
};

// One key tile kt (keys 64 kt..) of a sequence, by consumer w: every query
// chunk's five products, the chunks' dQ turns, then dK and dV over the
// tile's K and V rows.
template <int NK>
__device__ __forceinline__ void bwd_key_tile(unsigned char* smem, int w,
                                             int kt, int n_kt, int N,
                                             float scale) {
  using T = ResBwd<NK>;
  using S = Swz<64>;
  constexpr unsigned long long kStep = 2 * S::kAtom >> 4;   // 16 rows
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5 & 3) * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  unsigned char* Kt = smem + T::kK + kt * 64 * kRowBytes;
  unsigned char* Vt = smem + T::kV + kt * 64 * kRowBytes;
  unsigned char* Dt = smem + T::kStage + w * 64 * kRowBytes;   // dS^T
  const unsigned long long kd = S::desc(Kt), vd = S::desc(Vt);
  const unsigned long long sd = S::desc(Dt);
  const unsigned long long qd = S::desc(smem + T::kQ);
  const unsigned long long gd = S::desc(smem + T::kG);
  const float* nl = reinterpret_cast<const float*>(smem + T::kLse);
  const float* dl = reinterpret_cast<const float*>(smem + T::kDelta);
  float* acc = reinterpret_cast<float*>(smem + T::kAcc);
  const bool first = kt == 0, last = kt == n_kt - 1;
  const bool edge = kt * 64 + 64 > N;            // the tile holds keys >= N
  float dka[8][4], dva[8][4], st[8][4], dpt[8][4], dqp[8][4];
  unsigned pa[4][4], da[4][4];
  zero(dka);
  zero(dva);

  // S^T and dP^T of chunk c, two groups
  auto issue_s = [&](auto cc) {
    constexpr int c = decltype(cc)::value, W = T::width(c);
    const unsigned long long off = c * 4 * kStep;           // 64 c rows
    wg_fence();
    mma_scores<64, W>(cols<W>(st), kd, qd + off);
    wg_commit();
    mma_scores<64, W>(cols<W>(dpt), vd, gd + off);
    wg_commit();
  };
  // chunk c's dQ partial (in dqp) into the f32 sums in key-tile order; the
  // last key tile writes bf16(sum scale) over Q's rows of the chunk
  auto turn = [&](auto cc) {
    constexpr int c = decltype(cc)::value, W = T::width(c);
    if (!first) named_sync(kBarTurn + 2 * c + ((kt - 1) & 1), 256);
    if (W == 64 || wr == 0) {             // W = 16: warp 0's rows only
      // the sums in the accumulator's own layout: a thread's four values
      // of column group n (rows g and g + 8) as one float4, a warp's 32
      // float4 of one n side by side (conflict-free, 16 bytes a thread)
      float4* r = reinterpret_cast<float4*>(acc) +
                  ((c * 4 + wr / 16) * 8) * 32 + (threadIdx.x & 31);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float4 v = make_float4(dqp[n][0], dqp[n][1], dqp[n][2], dqp[n][3]);
        if (!first) {
          const float4 o = r[n * 32];
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        if (last) {
          *reinterpret_cast<__nv_bfloat162*>(
              smem + T::kQ + S::offset(c * 64 + wr + g, n) + c2 * 2) =
              __floats2bfloat162_rn(v.x * scale, v.y * scale);
          *reinterpret_cast<__nv_bfloat162*>(
              smem + T::kQ + S::offset(c * 64 + wr + g + 8, n) + c2 * 2) =
              __floats2bfloat162_rn(v.z * scale, v.w * scale);
        } else {
          r[n * 32] = v;
        }
      }
    }
    if (!last) {
      __threadfence_block();
      named_arrive(kBarTurn + 2 * c + (kt & 1), 256);
    }
  };
  // one chunk: P^T and dS^T under chunk c - 1's products, then that
  // chunk's dQ turn, the next chunk's S^T and dP^T, and this chunk's dV,
  // dK and dQ products
  auto chunk = [&](auto cc) {
    constexpr int c = decltype(cc)::value, W = T::width(c);
    const unsigned long long off = c * 4 * kStep;
    // pending: S^T(c), dP^T(c), and chunk c - 1's two groups
    if constexpr (c == 0) wg_wait1();
    else wg_wait<3>();
    wg_hold(cols<W>(st));
    if (edge) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (kt * 64 + wr + g + 8 * hf >= N)
#pragma unroll
          for (int j = 0; j < W / 8; ++j)
            st[j][2 * hf] = st[j][2 * hf + 1] = -CUDART_INF_F;
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(nl + c * 64 + j * 8 +
                                                        c2);
      st[j][0] = exp2_approx(fmaf(st[j][0], kLog2e, l.x));
      st[j][1] = exp2_approx(fmaf(st[j][1], kLog2e, l.y));
      st[j][2] = exp2_approx(fmaf(st[j][2], kLog2e, l.x));
      st[j][3] = exp2_approx(fmaf(st[j][3], kLog2e, l.y));
    }
    if constexpr (c == 0) wg_wait0();
    else wg_wait<2>();
    wg_hold(cols<W>(dpt));
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dl + c * 64 + j * 8 +
                                                        c2);
      dpt[j][0] = st[j][0] * (dpt[j][0] - d.x);
      dpt[j][1] = st[j][1] * (dpt[j][1] - d.y);
      dpt[j][2] = st[j][2] * (dpt[j][2] - d.x);
      dpt[j][3] = st[j][3] * (dpt[j][3] - d.y);
    }
    pack_a(cols<W>(dpt), steps<W>(da));                 // bf16(dS^T)
    if constexpr (c > 0) {
      // chunk c - 1's products are through: its dQ turn; the staging tile
      // and the P^T fragments are free
      wg_wait0();
      wg_hold(dqp);
      wg_hold(dka);
      wg_hold(dva);
      wg_hold_a(pa);
      turn(std::integral_constant<int, c - 1>());
    }
    pack_a(cols<W>(st), steps<W>(pa));                  // bf16(P^T)
    if constexpr (c + 1 < T::kChunks)
      issue_s(std::integral_constant<int, c + 1>());
    // bf16(dS^T) by stmatrix: per k-step four 8 x 8 matrices, lane l
    // addressing row l % 8 of matrix l / 8 (rows + 8 for odd matrices,
    // 16-byte chunk + 1 for matrices 2 and 3)
    {
      const int lane = threadIdx.x & 31, m = lane >> 3;
      unsigned char* row = Dt + (wr + (lane & 7) + 8 * (m & 1)) * kRowBytes;
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        stmatrix_x4(row + (((2 * kk + (m >> 1)) ^ (lane & 7)) << 4), da[kk]);
    }
    fence_async();
    named_sync(1 + w, 128);             // the whole dS^T tile is written
    wg_fence();
    mma_pv<64, W / 16>(dva, steps<W>(pa), gd + off);    // dV += P^T.dO
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)                 // dK += dS^T.Qs
      wgmma_ss_n64t<0, 1>(dka, sd + 2 * kk, qd + off + kk * kStep, 1);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)                      // dQ_c = dS.K
      wgmma_ss_n64t<1, 1>(dqp, sd + kk * kStep, kd + kk * kStep, kk);
    wg_commit();
  };

  static_assert(T::kChunks == 4, "four query chunks");
  issue_s(std::integral_constant<int, 0>());
  chunk(std::integral_constant<int, 0>());
  chunk(std::integral_constant<int, 1>());
  chunk(std::integral_constant<int, 2>());
  chunk(std::integral_constant<int, 3>());
  wg_wait0();
  wg_hold(dqp);
  wg_hold(dka);
  wg_hold(dva);
  wg_hold_a(pa);
  turn(std::integral_constant<int, 3>());
  // dK (the scale is in Qs already) and dV over the tile's rows < NK
  if (kt * 64 + wr < NK) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int o = S::offset(wr + g + 8 * hf, n) + c2 * 2;
        *reinterpret_cast<__nv_bfloat162*>(Kt + o) =
            __floats2bfloat162_rn(dka[n][2 * hf], dka[n][2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(Vt + o) =
            __floats2bfloat162_rn(dva[n][2 * hf], dva[n][2 * hf + 1]);
      }
  }
}

// mIn: qkv's map (Q, K, V boxes), mO, mG: out's and dout's, mD: dqkv's
// (the boxes of mIn); a.lse the forward's lse.
template <int NK, bool kWindow>
__global__ void __launch_bounds__(ResBwd<NK>::kThreads, 1)
res_bwd_tma(const __grid_constant__ CUtensorMap mIn,
            const __grid_constant__ CUtensorMap mO,
            const __grid_constant__ CUtensorMap mG,
            const __grid_constant__ CUtensorMap mD,
            const __grid_constant__ ResTmaArgs a) {
  using T = ResBwd<NK>;
  using S = Swz<64>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + T::kBar);
  unsigned long long* done = full + 1;
  // Q, K, V and dO rows that no box writes (windows of fewer than NK
  // tokens): zeros
  for (int i = a.kv_rows * 8 + threadIdx.x; i < NK * 8; i += T::kThreads)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<uint4*>(smem + b * T::kOp + i * 16) =
          make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    mbar_init(full, kLseArrivals + 1);   // + the loads' expect_tx
    mbar_init(done, 256);             // every consumer thread arrives
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async();
  __syncthreads();
  BwdLoader<NK, kWindow> loader(smem, full, done, &mIn, &mO, &mG, &mD, a);
  const int wg = threadIdx.x >> 7;
  if constexpr (kResProducer) {
    if (wg == 0) {
      setmaxnreg_dec<24>();
      if (threadIdx.x == 0) {
        while (loader.ld.more(a)) loader.step(a);
        loader.drain(a);
      } else if (threadIdx.x >> 5 == 1) {
        int j = 0;
        for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j)
          load_lse<NK>(smem, full, done, sw, j, a);
      }
      return;
    }
    setmaxnreg_inc<240>();
  }
  const int w = kResProducer ? wg - 1 : wg;
  const int t = threadIdx.x - (kResProducer ? 128 : 0);   // 0..255
  const bool loads = !kResProducer && threadIdx.x == 0;
  const int n_kt = (a.N + 63) >> 6;
  const float qscale = __bfloat162float(__float2bfloat16(a.scale));
  int j = 0;
  for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j) {
    if (loads) loader.step(a);
    if (!kResProducer && t < 32) load_lse<NK>(smem, full, done, sw, j, a);
    mbar_wait(full, j & 1);
    // row t: q scaled in place, delta = rowsum(dO * O) (O where the sums
    // go; rows >= N: 0)
    if (t < NK) {
      float* dl = reinterpret_cast<float*>(smem + T::kDelta);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int o = S::offset(t, c);
        uint4* q = reinterpret_cast<uint4*>(smem + T::kQ + o);
        uint4 u = *q;
        u.x = scale_pair(u.x, qscale);
        u.y = scale_pair(u.y, qscale);
        u.z = scale_pair(u.z, qscale);
        u.w = scale_pair(u.w, qscale);
        *q = u;
        sum = dot8(*reinterpret_cast<const uint4*>(smem + T::kAcc + o),
                   *reinterpret_cast<const uint4*>(smem + T::kG + o), sum);
      }
      dl[t] = t < a.N ? sum : 0.f;
    }
    fence_async();                      // the scaled Q, before wgmma reads
    named_sync(kBarPro, 256);           // ... and O is read: the sums start
    for (int kt = w; kt < n_kt; kt += 2)
      bwd_key_tile<NK>(smem, w, kt, n_kt, a.N, a.scale);
    fence_async();                      // the outputs, before TMA reads them
    mbar_arrive(done);
  }
  if (loads) loader.drain(a);
}

// ------------------------------------------------------ save-P forward
// #11's forward. grid (ceil(seqs / G), H), 256 threads; block x takes
// sequences x G .. x G + G - 1 (< seqs) of head blockIdx.y. q, k, v point
// at head 0's columns of their row slices (row stride ld_in, head h at
// + 64 h), o at head 0's output columns (row stride ld_out); p (seqs, H, N,
// NK). A sequence's K, V and Q (NK rows each) come by cp.async into one
// buffer; with G > 1 there are two, and the next sequence's copies fly
// while this one is computed.
template <int NK, class Rows>
__global__ void __launch_bounds__(kResThreads, 1)
res_savep_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, int ld_in, bf16* __restrict__ o,
              int ld_out, bf16* __restrict__ p, Rows rows, int seqs, int G,
              int N, float scale) {
  using S = Swz<64>;
  constexpr int NJ = NK / 8, NR = kResRows<NK>, QR = kQRows<NK>;
  constexpr int kTile = NR * kRowBytes;            // K or V of a sequence
  constexpr int kSeq = 2 * kTile + QR * kRowBytes; // K, V and Q
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const int h = blockIdx.y, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int n_qt = (N + 63) / 64;
  const int first = blockIdx.x * G, n_seq = min(G, seqs - first);
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  // K, V, Q of sequence first + i into buffer i % 2 (rows >= N: zeros)
  auto load_seq = [&](int i) {
    unsigned char* b = smem + (i & 1) * kSeq;
    const size_t off = rows.base(first + i) * ld_in + h * 64;
    load_rows<64, NR, kResThreads>(b, k + off, ld_in, rows, 0, N, tid);
    load_rows<64, NR, kResThreads>(b + kTile, v + off, ld_in, rows, 0, N,
                                   tid);
    load_rows<64, QR, kResThreads>(b + 2 * kTile, q + off, ld_in, rows, 0, N,
                                   tid);
    cp_async_commit();
  };
  load_seq(0);

  for (int gi = 0; gi < n_seq; ++gi) {
    const int seq = first + gi;
    bf16* ob = o + rows.base(seq) * ld_out + h * 64;
    const size_t stat = ((size_t)seq * H + h) * N;
    unsigned char* Ks = smem + (gi & 1) * kSeq;
    unsigned char* Qs = Ks + 2 * kTile;
    cp_async_wait<0>();              // this sequence's copies
    scale_rows<QR, kResThreads>(Qs, tid, qscale);
    fence_async();
    __syncthreads();                 // ... everyone's; the last one is read
    if (gi + 1 < n_seq) load_seq(gi + 1);
    const unsigned long long dk = S::desc(Ks), dv = S::desc(Ks + kTile);

    for (int qt = wg; qt < n_qt; qt += 2) {
      unsigned char* Qt = Qs + qt * 64 * kRowBytes;
      // S = Qs.K^T over all NK keys
      float sc[NJ][4];
      zero(sc);
      wg_fence();
      mma_wide<NK>(sc, S::desc(Qt), dk);
      wg_commit();
      wg_wait0();
      wg_hold(sc);
      if (N < NK) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j * 8 + c2 + e >= N) sc[j][e] = sc[j][e + 2] = -CUDART_INF_F;
      }
      // single-pass softmax of rows g (half 0) and g + 8 (half 1)
      float sum[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          m = fmaxf(m, fmaxf(sc[j][2 * hf], sc[j][2 * hf + 1]));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
        const float ms = m * kLog2e;
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            sc[j][e] = exp2_approx(fmaf(sc[j][e], kLog2e, -ms));
            l += sc[j][e];
          }
        l += __shfl_xor_sync(kFull, l, 1);
        l += __shfl_xor_sync(kFull, l, 2);
        sum[hf] = l;
      }
      const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= inv[e >> 1];
      unsigned pa[NJ / 2][4];
      pack_a(sc, pa);
      // P's rows < N, all NK columns
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qt * 64 + wr + g + 8 * hf;
        if (row < N) {
          bf16* pr = p + (stat + row) * NK + c2;
#pragma unroll
          for (int kk = 0; kk < NJ / 2; ++kk) {
            *reinterpret_cast<unsigned*>(pr + 16 * kk) = pa[kk][hf];
            *reinterpret_cast<unsigned*>(pr + 16 * kk + 8) = pa[kk][2 + hf];
          }
        }
      }
      // O = bf16(P).V, all NK keys
      float acc[8][4];
      zero(acc);
      wg_hold(acc);
      wg_fence();
      mma_pv<64, NJ / 2>(acc, pa, dv);
      wg_commit();
      wg_wait0();
      wg_hold(acc);
      wg_sync(wg);                 // every wgmma read of this Q tile is done
      store_rows<64>(Qt + wr * kRowBytes, acc, 1.f, ob, ld_out, rows,
                     qt * 64 + wr, N);
    }
  }
}

// ---------------------------------------------------------------- #11's dq
// grid and sequences as res_savep_fwd. K and V of a sequence resident (in
// one of two buffers when G > 1); a dO tile
// and a P row tile (64 x NK of p (seqs, H, N, NK)) per warpgroup; per query
// tile dP = dO.V^T over all NK keys, P by ldmatrix in the accumulator
// layout, delta = rowsum(P * dP) (written for the dk/dv kernel), dS = P (dP
// - delta), dQ = bf16(dS).K.
template <int NK, class Rows>
__global__ void __launch_bounds__(kResThreads, 1)
res_savep_dq(const bf16* __restrict__ k, const bf16* __restrict__ v,
             int ld_in, const bf16* __restrict__ p,
             const bf16* __restrict__ dout, int ld_out,
             float* __restrict__ delta, bf16* __restrict__ dq, int ld_dq,
             Rows rows, int seqs, int G, int N, float scale) {
  using S = Swz<64>;
  constexpr int NJ = NK / 8, NR = kResRows<NK>, kTile = NR * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const int h = blockIdx.y, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16, wt = tid & 127;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  unsigned char* Gs = smem + resident_bytes<NK>(2, G) +
                      wg * 64 * kRowBytes;                      // dO
  unsigned char* Pt = smem + resident_bytes<NK>(2, G) + 2 * 64 * kRowBytes +
                      wg * 64 * kPRowBytes<NK>;                 // P rows
  const unsigned long long dgd = S::desc(Gs);
  // ldmatrix rows of this lane: lanes 0-15 rows 0-15 of the warp's 16 at
  // keys 0-7 of a 16-key step, lanes 16-31 the same rows at keys 8-15
  const unsigned char* pl = Pt + (wr + (lane & 15)) * kPRowBytes<NK> +
                            (lane >> 4) * 16;
  const int n_qt = (N + 63) / 64;
  const int first = blockIdx.x * G, n_seq = min(G, seqs - first);
  auto load_kv = [&](int i) {        // K, V of sequence first + i
    unsigned char* b = smem + (i & 1) * 2 * kTile;
    const size_t off = rows.base(first + i) * ld_in + h * 64;
    load_rows<64, NR, kResThreads>(b, k + off, ld_in, rows, 0, N, tid);
    load_rows<64, NR, kResThreads>(b + kTile, v + off, ld_in, rows, 0, N,
                                   tid);
    cp_async_commit();
  };
  load_kv(0);

  for (int gi = 0; gi < n_seq; ++gi) {
    const int seq = first + gi;
    const size_t base = rows.base(seq);
    const bf16* gb = dout + base * ld_out + h * 64;
    bf16* dqb = dq + base * ld_dq + h * 64;
    const size_t stat = ((size_t)seq * H + h) * N;
    const unsigned char* Ks = smem + (gi & 1) * 2 * kTile;
    const unsigned long long dkd = S::desc(Ks), dvd = S::desc(Ks + kTile);
    cp_async_wait<0>();              // this sequence's K and V
    fence_async();
    __syncthreads();                 // ... everyone's; the last one is read
    if (gi + 1 < n_seq) load_kv(gi + 1);

    for (int qt = wg; qt < n_qt; qt += 2) {
      wg_sync(wg);                   // the staged rows are read back
      {
        uint4 x[kPCopies<64, NK / 8>];
        load_p<64, NK / 8>(x, p + stat * NK, NK, qt * 64, 0, N, wt);
        copy_rows<64, 128>(Gs, gb, ld_out, rows, qt * 64, N, wt);
        store_p<64, NK / 8>(Pt, x, wt);
      }
      fence_async();
      wg_sync(wg);
      float dp[NJ][4];
      zero(dp);
      wg_fence();
      mma_wide<NK>(dp, dgd, dvd);
      wg_commit();
      wg_wait0();
      wg_hold(dp);
      // P of rows g and g + 8 in the accumulator layout, 16 keys a step
      // (a[0], a[1]: rows g, g + 8 at keys c2..; a[2], a[3] at keys 8 + c2..;
      // rows >= N are zeros): delta = rowsum(P * dP), then dS
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, pl + kk * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 pf = unpack_bf16(a[e]);
          const int j = 2 * kk + (e >> 1), hf = e & 1;
          s[hf] = fmaf(pf.x, dp[j][2 * hf], s[hf]);
          s[hf] = fmaf(pf.y, dp[j][2 * hf + 1], s[hf]);
        }
      }
      float dl[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dl[hf] = s[hf] + __shfl_xor_sync(kFull, s[hf], 1);
        dl[hf] += __shfl_xor_sync(kFull, dl[hf], 2);
        const int row = qt * 64 + wr + g + 8 * hf;
        if (c2 == 0 && row < N) delta[stat + row] = dl[hf];
      }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, pl + kk * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 pf = unpack_bf16(a[e]);
          const int j = 2 * kk + (e >> 1), hf = e & 1;
          dp[j][2 * hf] = pf.x * (dp[j][2 * hf] - dl[hf]);
          dp[j][2 * hf + 1] = pf.y * (dp[j][2 * hf + 1] - dl[hf]);
        }
      }
      unsigned da[NJ / 2][4];
      pack_a(dp, da);
      float acc[8][4];
      zero(acc);
      wg_hold(acc);
      wg_fence();
      mma_pv<64, NJ / 2>(acc, da, dkd);
      wg_commit();
      wg_wait0();
      wg_hold(acc);
      wg_sync(wg);                   // every wgmma read of dO is done
      store_rows<64>(Gs + wr * kRowBytes, acc, scale, dqb, ld_dq, rows,
                     qt * 64 + wr, N);
    }
  }
}

// The save-P dk/dv step (#11): W queries from query c0 at the 64-key tile
// kt, with P's tile (queries c0.., keys 64 kt..; pb: this sequence and
// head's P, row stride NK) in place of S^T and the exponent. dP^T = V.dO^T
// is issued, the P tile goes through registers to pt, P^T comes by
// ldmatrix .trans straight in the A layout (lanes 0-7 / 16-23 address
// queries 0-7 / 8-15 of a 16-query step at the warp's keys 0-7, lanes
// 8-15 / 24-31 the same at keys 8-15), then dkv_tail. P's columns >= N
// are zeros, as the forward writes them.
template <int NK, int W>
__device__ __forceinline__ void savep_dkv_step(
    float (&dka)[8][4], float (&dva)[8][4], unsigned long long dv,
    unsigned long long dq, unsigned long long dg, unsigned char* pt,
    const bf16* pb, int c0, int kt, int N, const float* dl) {
  constexpr int kPt = 64 * 2 + 16;                 // a P tile's row bytes
  const int tid = threadIdx.x, lane = tid & 31, wt = tid & 127;
  const int wr = (tid >> 5 & 3) * 16;
  float st[W / 8][4], dpt[W / 8][4];
  unsigned pa[W / 16][4];
  zero(dpt);
  uint4 px[kPCopies<W, 8>];
  load_p<W, 8>(px, pb, NK, c0, kt * 64, N, wt);
  wg_fence();
  mma_scores<64, W>(dpt, dv, dg);
  wg_commit();
  store_p<W, 8>(pt, px, wt);
  wg_sync(tid >> 7);
  const unsigned char* pl = pt + ((lane & 7) + (lane >> 4) * 8) * kPt +
                            (wr + (lane >> 3 & 1) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    ldmatrix_x4_trans(pa[kk], pl + kk * 16 * kPt);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 pf = unpack_bf16(pa[kk][e]);
      st[2 * kk + (e >> 1)][2 * (e & 1)] = pf.x;
      st[2 * kk + (e >> 1)][2 * (e & 1) + 1] = pf.y;
    }
  }
  dkv_tail<64, W>(dka, dva, st, pa, dpt, dl, dq, dg);
}

// ---------------------------------------------------------- #11's dk, dv
// grid and sequences as res_savep_fwd, over KEY tiles. Scaled Q and dO of the
// sequence resident (in one of two buffers when G > 1) with delta of each
// query; warpgroup wg takes key tiles wg, wg + 2, .. with its own V tile.
// No S, no exponent: per query chunk the 64 x 64 tile of p (seqs, H, N,
// NK) goes to one of two tiles of the warpgroup and P^T comes by ldmatrix
// .trans, straight in the A layout (P's columns >= N are zeros, as the
// forward writes them). dk, dv (row stride ld_dkv); delta from the dq
// kernel.
template <int NK, class Rows>
__global__ void __launch_bounds__(kResThreads, 1)
res_savep_dkv(const bf16* __restrict__ q, const bf16* __restrict__ v,
              int ld_in, const bf16* __restrict__ dout, int ld_out,
              const bf16* __restrict__ p, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int ld_dkv,
              Rows rows, int seqs, int G, int N, float scale) {
  using S = Swz<64>;
  constexpr int NR = kResRows<NK>, kTile = NR * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const int h = blockIdx.y, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wg = warp >> 2, wr = (warp & 3) * 16, wt = tid & 127;
  unsigned char* Kt = smem + resident_bytes<NK>(2, G) + wg * 128 * kRowBytes;
  unsigned char* Vt = Kt + 64 * kRowBytes;
  float* dls = reinterpret_cast<float*>(smem + resident_bytes<NK>(2, G) +
                                        256 * kRowBytes) + NR;
  unsigned char* Pts = reinterpret_cast<unsigned char*>(dls + NR) +
                       wg * 2 * kPtBytes;          // two P tiles
  const unsigned long long dvt = S::desc(Vt);
  const int n_kt = (N + 63) / 64;
  const int first = blockIdx.x * G, n_seq = min(G, seqs - first);
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  auto load_qg = [&](int i) {        // Q, dO of sequence first + i
    unsigned char* b = smem + (i & 1) * 2 * kTile;
    const size_t base = rows.base(first + i);
    load_rows<64, NR, kResThreads>(b, q + base * ld_in + h * 64, ld_in, rows,
                                   0, N, tid);
    load_rows<64, NR, kResThreads>(b + kTile, dout + base * ld_out + h * 64,
                                   ld_out, rows, 0, N, tid);
    cp_async_commit();
  };
  load_qg(0);

  for (int gi = 0; gi < n_seq; ++gi) {
    const int seq = first + gi;
    const size_t base = rows.base(seq);
    const bf16* vb = v + base * ld_in + h * 64;
    bf16* dkb = dk + base * ld_dkv + h * 64;
    bf16* dvb = dv + base * ld_dkv + h * 64;
    const size_t stat = ((size_t)seq * H + h) * N;
    const bf16* pb = p + stat * NK;
    unsigned char* Qs = smem + (gi & 1) * 2 * kTile;
    const unsigned long long dqs = S::desc(Qs), dgs = S::desc(Qs + kTile);
    cp_async_wait<0>();              // this sequence's Q and dO
    __syncthreads();                 // the last sequence's statistics are read
    for (int i = tid; i < NR; i += kResThreads)     // masked: i >= N
      dls[i] = i < N ? delta[stat + i] : 0.f;
    scale_rows<NR, kResThreads>(Qs, tid, qscale);
    fence_async();
    __syncthreads();
    if (gi + 1 < n_seq) load_qg(gi + 1);

    for (int kt = wg; kt < n_kt; kt += 2) {
      wg_sync(wg);                   // the staged rows are read back
      copy_rows<64, 128>(Vt, vb, ld_in, rows, kt * 64, N, wt);
      fence_async();
      wg_sync(wg);
      float dka[8][4], dva[8][4];
      zero(dka);
      zero(dva);
      // chunks of 64 queries, then NK % 64
      auto chunk = [&](auto width, int c0) {
        constexpr int W = decltype(width)::value;
        const unsigned long long qoff = (unsigned long long)c0 * 8;  // rows
        savep_dkv_step<NK, W>(dka, dva, dvt, dqs + qoff, dgs + qoff,
                              Pts + (c0 / 64 & 1) * kPtBytes, pb, c0, kt, N,
                              dls + c0);
      };
#pragma unroll
      for (int c = 0; c < NK / 64; ++c)
        if (c * 64 < N) chunk(std::integral_constant<int, 64>(), c * 64);
      if constexpr (NK % 64 != 0)
        if (NK / 64 * 64 < N)
          chunk(std::integral_constant<int, NK % 64>(), NK / 64 * 64);
      wg_sync(wg);                   // every wgmma read of K and V is done
      // keys < N; the scale is in Qs already
      store_rows<64>(Kt + wr * kRowBytes, dka, 1.f, dkb, ld_dkv, rows,
                     kt * 64 + wr, N);
      store_rows<64>(Vt + wr * kRowBytes, dva, 1.f, dvb, ld_dkv, rows,
                     kt * 64 + wr, N);
    }
  }
}

// ---------------------------------------------------------------- launch
// Packed-QKV layouts: qkv (tokens, 3C) with C = 64 H; out and dout (tokens,
// C); dqkv (tokens, 3C); `seqs` sequences of N <= NK rows placed by `rows`,
// G of them a block.

// A kernel's shared-memory cap, set on the current device once: `done` is
// a static of the calling launcher, one per kernel instantiation. The cap
// is the most any launch of the kernel asks for.
constexpr int kDevices = 64;
template <typename Kern>
cudaError_t allow_smem_once(Kern kernel, size_t bytes,
                            bool (&done)[kDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && done[dev])) return err;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

// #11's forward
template <int NK, class Rows>
cudaError_t launch_savep_fwd(const void* qkv, void* out, void* p, Rows rows,
                             int seqs, int N, int H, int G, float scale,
                             void* stream) {
  const size_t smem = res_fwd_smem<NK>(G);
  static bool attributed[kDevices] = {};
  cudaError_t err = allow_smem_once(res_savep_fwd<NK, Rows>,
                                    res_fwd_smem<NK>(2), attributed);
  if (err != cudaSuccess) return err;
  const int C = 64 * H;
  const bf16* x = (const bf16*)qkv;
  dim3 grid((seqs + G - 1) / G, H);
  res_savep_fwd<NK, Rows><<<grid, kResThreads, smem, (cudaStream_t)stream>>>(
      x, x + C, x + 2 * C, 3 * C, (bf16*)out, C, (bf16*)p, rows, seqs, G, N,
      scale);
  return cudaGetLastError();
}

// #10 / #12's forward on its three tensor maps (a's items set here)
template <int NK, bool kWindow>
cudaError_t run_res_fwd_tma(const CUtensorMap& mKV, const CUtensorMap& mQ,
                            const CUtensorMap& mO, ResTmaArgs a,
                            void* stream) {
  using T = ResTma<NK>;
  a.items = (a.seqs + a.G - 1) / a.G * a.H;
  const int sms = sm_count();
  if (!sms) return cudaErrorNoDevice;
  static bool attributed[kDevices] = {};
  cudaError_t err =
      allow_smem_once(res_fwd_tma<NK, kWindow>, T::kSmem, attributed);
  if (err != cudaSuccess) return err;
  const int grid = kResPersistent ? min(sms, a.seqs * a.H) : a.items;
  res_fwd_tma<NK, kWindow><<<grid, T::kThreads, T::kSmem,
                             (cudaStream_t)stream>>>(mKV, mQ, mO, a);
  return cudaGetLastError();
}

// #10: qkv (B, N, 3C) -> out (B, N, C), lse (B, H, N); N <= NK
template <int NK>
cudaError_t launch_v2_fwd(const void* qkv, void* out, void* lse, int B,
                          int N, int H, int G, float scale, void* stream) {
  const cuuint64_t C = 64 * H, q_rows = (N + 63) / 64 * 64;
  const cuuint64_t din[3] = {3 * C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sin[2] = {3 * C * 2, N * 3 * C * 2};
  const cuuint64_t dout[3] = {C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sout[2] = {C * 2, N * C * 2};
  const cuuint32_t bkv[3] = {64, NK, 1}, bq[3] = {64, (cuuint32_t)q_rows, 1};
  CUtensorMap mKV, mQ, mO;
  if (!encode_map(&mKV, qkv, 3, din, sin, bkv) ||
      !encode_map(&mQ, qkv, 3, din, sin, bq) ||
      !encode_map(&mO, out, 3, dout, sout, bq))
    return cudaErrorInvalidValue;
  ResTmaArgs a{};
  a.lse = (float*)lse;
  a.seqs = B;
  a.G = G;
  a.H = H;
  a.N = N;
  a.kv_rows = NK;
  a.tx_bytes = (int)(2 * NK + q_rows) * kRowBytes;
  a.scale = scale;
  return run_res_fwd_tma<NK, false>(mKV, mQ, mO, a, stream);
}

// #12: qkv (B, GH, GW, 3C) -> out (B, GH, GW, C), lse (windows, H, ws^2),
// ws^2 <= 256
inline cudaError_t launch_window_v2_fwd(const void* qkv, void* out,
                                        void* lse, int B, int GH, int GW,
                                        int ws, int H, int G, float scale,
                                        void* stream) {
  const cuuint64_t C = 64 * H;
  const cuuint64_t din[4] = {3 * C, (cuuint64_t)GW, (cuuint64_t)GH,
                             (cuuint64_t)B};
  const cuuint64_t sin[3] = {3 * C * 2, GW * 3 * C * 2, GH * GW * 3 * C * 2};
  const cuuint64_t dout[4] = {C, (cuuint64_t)GW, (cuuint64_t)GH,
                              (cuuint64_t)B};
  const cuuint64_t sout[3] = {C * 2, GW * C * 2, GH * GW * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)ws, (cuuint32_t)ws, 1};
  CUtensorMap mKV, mO;
  if (!encode_map(&mKV, qkv, 4, din, sin, box) ||
      !encode_map(&mO, out, 4, dout, sout, box))
    return cudaErrorInvalidValue;
  ResTmaArgs a{};
  a.lse = (float*)lse;
  a.nh = GH / ws;
  a.nw = GW / ws;
  a.ws = ws;
  a.seqs = B * a.nh * a.nw;
  a.G = G;
  a.H = H;
  a.N = ws * ws;
  a.kv_rows = ws * ws;
  a.tx_bytes = 3 * ws * ws * kRowBytes;
  a.scale = scale;
  return run_res_fwd_tma<256, true>(mKV, mKV, mO, a, stream);
}

// #10 / #12's backward on its four tensor maps (a's items set here)
template <int NK, bool kWindow>
cudaError_t run_res_bwd_tma(const CUtensorMap (&m)[4], ResTmaArgs a,
                            void* stream) {
  using T = ResBwd<NK>;
  a.items = (a.seqs + a.G - 1) / a.G * a.H;
  const int sms = sm_count();
  if (!sms) return cudaErrorNoDevice;
  static bool attributed[kDevices] = {};
  cudaError_t err =
      allow_smem_once(res_bwd_tma<NK, kWindow>, T::kSmem, attributed);
  if (err != cudaSuccess) return err;
  const int grid = kResPersistent ? min(sms, a.seqs * a.H) : a.items;
  res_bwd_tma<NK, kWindow><<<grid, T::kThreads, T::kSmem,
                             (cudaStream_t)stream>>>(m[0], m[1], m[2], m[3],
                                                     a);
  return cudaGetLastError();
}

// #10: qkv, dqkv (B, N, 3C), out, dout (B, N, C), lse (B, H, N); N <= NK
template <int NK>
cudaError_t launch_v2_bwd(const void* qkv, const void* out, const void* lse,
                          const void* dout, void* dqkv, int B, int N, int H,
                          int G, float scale, void* stream) {
  const cuuint64_t C = 64 * H;
  const cuuint64_t din[3] = {3 * C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sin[2] = {3 * C * 2, N * 3 * C * 2};
  const cuuint64_t dout_[3] = {C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sout[2] = {C * 2, N * C * 2};
  const cuuint32_t box[3] = {64, NK, 1};
  CUtensorMap m[4];
  if (!encode_map(&m[0], qkv, 3, din, sin, box) ||
      !encode_map(&m[1], out, 3, dout_, sout, box) ||
      !encode_map(&m[2], dout, 3, dout_, sout, box) ||
      !encode_map(&m[3], dqkv, 3, din, sin, box))
    return cudaErrorInvalidValue;
  ResTmaArgs a{};
  a.lse = (float*)lse;
  a.seqs = B;
  a.G = G;
  a.H = H;
  a.N = N;
  a.kv_rows = NK;
  a.tx_bytes = 5 * NK * kRowBytes;
  a.scale = scale;
  return run_res_bwd_tma<NK, false>(m, a, stream);
}

// #12: qkv, dqkv (B, GH, GW, 3C), out, dout (B, GH, GW, C), lse (windows,
// H, ws^2); ws^2 <= 256
inline cudaError_t launch_window_v2_bwd(const void* qkv, const void* out,
                                        const void* lse, const void* dout,
                                        void* dqkv, int B, int GH, int GW,
                                        int ws, int H, int G, float scale,
                                        void* stream) {
  const cuuint64_t C = 64 * H;
  const cuuint64_t din[4] = {3 * C, (cuuint64_t)GW, (cuuint64_t)GH,
                             (cuuint64_t)B};
  const cuuint64_t sin[3] = {3 * C * 2, GW * 3 * C * 2, GH * GW * 3 * C * 2};
  const cuuint64_t dout_[4] = {C, (cuuint64_t)GW, (cuuint64_t)GH,
                               (cuuint64_t)B};
  const cuuint64_t sout[3] = {C * 2, GW * C * 2, GH * GW * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)ws, (cuuint32_t)ws, 1};
  CUtensorMap m[4];
  if (!encode_map(&m[0], qkv, 4, din, sin, box) ||
      !encode_map(&m[1], out, 4, dout_, sout, box) ||
      !encode_map(&m[2], dout, 4, dout_, sout, box) ||
      !encode_map(&m[3], dqkv, 4, din, sin, box))
    return cudaErrorInvalidValue;
  ResTmaArgs a{};
  a.lse = (float*)lse;
  a.nh = GH / ws;
  a.nw = GW / ws;
  a.ws = ws;
  a.seqs = B * a.nh * a.nw;
  a.G = G;
  a.H = H;
  a.N = ws * ws;
  a.kv_rows = ws * ws;
  a.tx_bytes = 5 * ws * ws * kRowBytes;
  a.scale = scale;
  return run_res_bwd_tma<256, true>(m, a, stream);
}

// #11: dq (and delta = rowsum(P * dP)), then dk and dv, both reading P
template <int NK, class Rows>
cudaError_t launch_savep_bwd(const void* qkv, const void* p, const void* dout,
                             void* delta, void* dqkv, Rows rows, int seqs,
                             int N, int H, int G, float scale, void* stream) {
  const size_t dq_smem = res_dq_smem<NK>(G);
  const size_t dkv_smem = res_dkv_smem<NK>(G);
  static bool dq_attributed[kDevices] = {}, dkv_attributed[kDevices] = {};
  cudaError_t err = allow_smem_once(res_savep_dq<NK, Rows>,
                                    res_dq_smem<NK>(2), dq_attributed);
  if (err != cudaSuccess) return err;
  err = allow_smem_once(res_savep_dkv<NK, Rows>, res_dkv_smem<NK>(2),
                        dkv_attributed);
  if (err != cudaSuccess) return err;
  const int C = 64 * H;
  const bf16* x = (const bf16*)qkv;
  bf16* dx = (bf16*)dqkv;
  dim3 grid((seqs + G - 1) / G, H);
  cudaStream_t s = (cudaStream_t)stream;
  res_savep_dq<NK, Rows><<<grid, kResThreads, dq_smem, s>>>(
      x + C, x + 2 * C, 3 * C, (const bf16*)p, (const bf16*)dout, C,
      (float*)delta, dx, 3 * C, rows, seqs, G, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  res_savep_dkv<NK, Rows><<<grid, kResThreads, dkv_smem, s>>>(
      x, x + 2 * C, 3 * C, (const bf16*)dout, C, (const bf16*)p,
      (const float*)delta, dx + C, dx + 2 * C, 3 * C, rows, seqs, G, N,
      scale);
  return cudaGetLastError();
}

}  // namespace
