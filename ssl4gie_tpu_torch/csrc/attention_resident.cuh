// Resident-sequence attention core for short sequences (N <= NK <= 256,
// head width 64) on Hopper's tensor cores (sm_90a): the kernels of the A/B
// variants in attention_variants.cu (#10 packed-QKV v2, #11 save-P) and
// window_attention_v2.cu (#12 window v2).
//
// The streaming core of attention_core.cuh walks 64-key tiles through a
// cp.async ring, and each 64-row query block re-reads all of K and V. Here
// one block holds a whole sequence's operands for one head in shared memory
// and serves every 64-row tile of that sequence from them, then the next
// sequence of its walk (G adjacent images, or G horizontally adjacent
// windows, of one head together): the counterpart of the TPU kernels' G
// sequences a program.
// - Two persistent, warp-specialised kernels serve all three variants: a
//   producer warpgroup moves every operand in and every output out by TMA
//   (csrc/tma.cuh), two consumer warpgroups multiply (setmaxnreg 240).
//   `res_fwd_tma` is the forward and `res_bwd_tma` the backward (dQ, dK and
//   dV in one pass); their comments have the design, and #11 is their
//   kSaveP instance.
// - NK is the width of the resident score tile, 208 or 256 keys (the TPU
//   kernels' Nb): a 64 x NK product is one m64nNKk16 wgmma a k-step, so
//   columns beyond NK cost nothing.
// - q is scaled, bf16(q * bf16(scale)), the TPU kernels' rounding point, so
//   the scores need no scale and dK = dS^T.(scaled q) none either.
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
// - Backward, no atomics, bitwise repeatable: per (64-key tile, query
//   chunk) dP^T and P^T, then dS^T = P^T (dP^T - delta), dV, dK and the
//   chunk's dQ partial, the partials summed in key-tile order.
//   - #10 / #12: P^T from S^T and the forward's lse: five products and one
//     exponent, as the TPU's v2 kernels compute dq, dk and dv of a sequence
//     in one program. delta = rowsum(dO * O), as the port's #2 (the TPU's
//     v2 takes rowsum(P * dP): equal in exact arithmetic).
//   - #11 reads the saved P in place of S^T and the exponent: four
//     products, P streamed in 64 x 64 boxes; delta = rowsum(P * dP) from the
//     bf16 P (the TPU's rounding point), one more product a query tile.
//
// Shared memory per block (64-wide bf16 rows of 128 B): `res_fwd_tma` two
// stages of 2 NK + 256 rows (168 or 192 KiB), and for #11 two 8 KiB P
// staging tiles a consumer (201 KiB at NK = 208); `res_bwd_tma` 4 NK rows,
// 2 NK f32 rows, two 64-row tiles and 8 NK bytes (175 or 211 KiB), and
// for #11 a ring of kPRing 64-row P boxes a consumer in place of lse (222
// KiB at NK = 208: three slots).

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

constexpr int kRowBytes = 128;            // one 64-wide bf16 row

// order this thread's shared-memory writes (cp.async or plain) before the
// wgmma reads that follow the next barrier
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The shared array p from its first 1 KiB boundary on, as an offset of p
// itself: the compiler keeps knowing that the pointers derived from it are
// shared and addresses them in 32 bits (rounding the address as an integer
// makes them generic, 64 bits a pointer, which cost the backward its
// registers: 564 bytes of spills).
__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// bf16 pair -> two floats
__device__ __forceinline__ float2 unpack_bf16(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

// The first ks k-steps (16 columns each) of a warpgroup's bf16 A fragments
// (pack_a's layout, 64 rows) into the 64-row swizzled tile at `tile`, by
// stmatrix: per k-step four 8 x 8 matrices, lane l addressing row l % 8 of
// matrix l / 8 (rows + 8 for odd matrices, 16-byte chunk + 1 for matrices 2
// and 3)
template <int K>
__device__ __forceinline__ void stage_a(unsigned char* tile,
                                        const unsigned (&a)[K][4], int ks) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  unsigned char* row = tile + ((threadIdx.x >> 5 & 3) * 16 + (lane & 7) +
                               8 * (m & 1)) * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    if (kk < ks)
      stmatrix_x4(row + (((2 * kk + (m >> 1)) ^ (lane & 7)) << 4), a[kk]);
}

constexpr int kPBox = 64 * kRowBytes;     // a 64 x 64 tile of #11's P

// ------------------------------------------------ forward (#10, #11, #12)
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
// - #11 (kSaveP, dense, NK = 208): P = bf16(e / l) needs the row's whole
//   sum before its first P.V, so the consumers take the exponent of every
//   chunk first (in the score registers); then per 64-key chunk bf16(P) is
//   the A operand of the chunk's O += P.V and goes out, staged by stmatrix
//   into one of the consumer's two 8 KiB tiles (the 128-byte swizzle) and
//   stored by one TMA box of a 3-D map over P, (NK, N, seqs H), by the
//   consumer's first thread (POut). The box clips rows >= N and columns
//   >= NK, so no thread masks the store, and a tile's store runs under the
//   next chunk. O needs no division; there is no lse.
// No atomics: every output is computed once, in one order.

constexpr int kTmaStages = 2;             // whole sequences in flight
// The design's two choices, switchable for measuring them
// (benchmarks/ablate_resident_forward.py, ablate_resident_backward.py),
// in the forward and the backward alike: a producer warpgroup loads and
// stores (else thread 0 of consumer 0 does, before each sequence), and the
// grid is persistent (else a block an item).
constexpr bool kResProducer = true;
constexpr bool kResPersistent = true;

template <int NK, bool kSaveP = false>
struct ResTma {
  static constexpr int kKV = NK * kRowBytes;        // K or V of a sequence
  static constexpr int kQ = 256 * kRowBytes;        // Q, then O: four tiles
  static constexpr int kStage = 2 * kKV + kQ;       // 1 KiB multiples
  static constexpr int kPOut = kTmaStages * kStage; // #11's P tiles
  static constexpr int kBar = kPOut + (kSaveP ? 4 * kPBox : 0);
  static constexpr int kSmem = 1024 + kBar + 64;
  static constexpr int kThreads = kResProducer ? 384 : 256;
};
static_assert(ResTma<256>::kSmem <= 232448 &&
                  ResTma<208, true>::kSmem <= 232448,
              "two stages fit the block's shared memory");

struct ResTmaArgs {
  float* lse;               // (seqs, H, N); #11: none
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

// #11's P out of a consumer warpgroup: the 64 x 64 tile of P at (rows
// row0.., columns 64 c..) of sequence-head `plane`, staged from its A
// fragments into tile c % 2 of the consumer's two and stored by one TMA
// box of `map`. The storing thread waits, before the barrier that hands
// the tile over, until its earlier stores have read theirs, so the tile
// that the next chunk writes is free.
struct POut {
  const CUtensorMap* map;
  unsigned char* tiles;     // the consumer's two staging tiles
  int bar, plane;           // the consumer's named barrier; seq H + h
  bool issuer;              // the consumer's first thread
  __device__ __forceinline__ void put(const unsigned (&pa)[4][4], int ks,
                                      int c, int row0) const {
    unsigned char* tile = tiles + (c & 1) * kPBox;
    stage_a(tile, pa, ks);
    fence_async();                      // before TMA reads the tile
    if (issuer) bulk_wait_read();
    named_sync(bar, 128);
    if (issuer) {
      tma_store_3d(map, tile, 64 * c, row0, plane);
      bulk_commit();
    }
  }
};

// One 64-row query tile of a sequence (its Q rows at Qt), by a consumer
// warpgroup: O staged over the tile's Q rows, lse of rows < N stored at
// lse + row (#11: P stored through po). `first`: consumer 0's first tile
// (it lets consumer 1 start).
template <int NK, bool kSaveP>
__device__ __forceinline__ void res_tile(unsigned char* Qt,
                                         unsigned long long dk,
                                         unsigned long long dv, int row0,
                                         int N, float qscale, float* lse,
                                         bool first, const POut& po) {
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
  // exponent (#11: every chunk's exponent first, then P = e / l)
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
  // the exponent of column groups j0 .. j0 + jn - 1 and its row sums
  auto exponent = [&](int j0, int jn) {
#pragma unroll
    for (int j = j0; j < j0 + jn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = live && j * 8 < N
                       ? exp2_approx(fmaf(sc[j][e], kLog2e, -ms[e >> 1]))
                       : 0.f;
        l[e >> 1] += sc[j][e];
      }
  };
  // the row sums of the warp's rows, over the four threads of a row
  auto row_sums = [&](float (&sum)[2]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float s = l[hf] + __shfl_xor_sync(kFull, l[hf], 1);
      sum[hf] = s + __shfl_xor_sync(kFull, s, 2);
    }
  };
  float sum[2], inv[2];
  if constexpr (kSaveP) {
    exponent(0, NJ);
    row_sums(sum);
    inv[0] = live ? 1.f / sum[0] : 0.f;
    inv[1] = live ? 1.f / sum[1] : 0.f;
  }
  float acc[8][4];
  zero(acc);
  wg_hold(acc);
#pragma unroll
  for (int c = 0; c < (NJ + 7) / 8; ++c) {
    const int j0 = 8 * c, jn = NJ - j0 < 8 ? NJ - j0 : 8;   // NK = 208: 2
    if constexpr (kSaveP) {
#pragma unroll
      for (int j = j0; j < j0 + jn; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= inv[e >> 1];   // P = e / l
    } else {
      exponent(j0, jn);
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
    if constexpr (kSaveP) po.put(pa, jn / 2, c, row0);   // under the P.V
  }
  wg_wait0();
  wg_hold(acc);
  if constexpr (!kSaveP) {
    row_sums(sum);
    inv[0] = live ? 1.f / sum[0] : 0.f;
    inv[1] = live ? 1.f / sum[1] : 0.f;
  } else {
    inv[0] = inv[1] = 1.f;              // P is normalised already
  }
  // O / l over the warp's own Q rows; each row's log-sum-exp
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + wr + g + 8 * hf;
    if (!kSaveP && c2 == 0 && row < N) lse[row] = mx[hf] + logf(sum[hf]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          Qt + Swz<64>::offset(wr + g + 8 * hf, n) + c2 * 2) =
          __floats2bfloat162_rn(acc[n][2 * hf] * inv[hf],
                                acc[n][2 * hf + 1] * inv[hf]);
  }
}

// mKV, mQ: qkv's maps (K and V boxes; Q boxes), mO: out's (Q's box shape),
// mP: #11's P (64 x 64 boxes; unused otherwise).
template <int NK, bool kWindow, bool kSaveP>
__global__ void __launch_bounds__(ResTma<NK>::kThreads, 1)
res_fwd_tma(const __grid_constant__ CUtensorMap mKV,
            const __grid_constant__ CUtensorMap mQ,
            const __grid_constant__ CUtensorMap mO,
            const __grid_constant__ CUtensorMap mP,
            const __grid_constant__ ResTmaArgs a) {
  using T = ResTma<NK, kSaveP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + T::kBar);
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
  POut po{&mP, smem + T::kPOut + w * 2 * kPBox, 2 + w, 0,
          (threadIdx.x & 127) == 0};
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
    po.plane = sw.seq * a.H + sw.h;
    float* lse = kSaveP ? nullptr : a.lse + (size_t)po.plane * a.N;
    for (int qt = w; qt < n_qt; qt += 2)
      res_tile<NK, kSaveP>(buf + 2 * T::kKV + qt * 64 * kRowBytes, dk, dv,
                           qt * 64, a.N, qscale, lse,
                           w == 0 && j == 0 && qt == 0, po);
    fence_async();                      // the O rows, before TMA reads them
    mbar_arrive(done + s);
  }
  if (loads) loader.drain(a);
  if (kSaveP && po.issuer) bulk_wait();   // the last P stores
}

// ------------------------------------------------ backward (#10, #11, #12)
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
// - #11 (kSaveP, dense, NK = 208) reads the forward's P in place of S^T
//   and the exponent, and takes no O and no lse:
//   - The producer thread loads Q, K, V and dO. P streams in 64 x 64 boxes
//     of a 3-D map over P (NK, N, seqs H) through a ring of kPRing slots a
//     consumer (PRing), each fed by a thread of producer warp 1 + w
//     (load_p_ring) in the order the consumer takes them; TMA zero-fills a
//     box's rows >= N and columns >= NK.
//   - Per sequence the consumers first take delta = rowsum(P * dP), from
//     the bf16 P as the TPU kernel, a 64-row query tile at a time
//     (savep_delta): dP = dO.V^T over all NK keys, one register-A product
//     as the forward's S, and P of the tile's rows from its boxes by
//     ldmatrix in dP's accumulator layout.
//   - Then the key-major loop above with P^T from the box of (chunk c, key
//     tile), by ldmatrix .trans straight into the A layout of dV += P^T.dO
//     (registers, as #10's) and, unpacked, dS^T's accumulator layout; the
//     box goes back to the ring at once. Four products a (key tile,
//     chunk), no exponent. A step first waits for chunk c - 1's products,
//     whose P^T registers it reuses: the other consumer's products fill
//     the tensor cores meanwhile. Keys >= N are masked here (the plain
//     backward reads P's first N columns only, whatever lies beyond).
//   - Three P slots a consumer (a two-slot ring, or dV reading P^T from
//     its box and so holding the slot through chunk c's products, was
//     6-13% slower; PERF.md, section 6). At NK = 208: 206 KiB with two
//     slots, 222 KiB with three.

constexpr int kPRing = 3;                 // #11's P boxes a consumer
template <int NK, bool kSaveP = false>
struct ResBwd {
  static constexpr int kOp = NK * kRowBytes;        // Q, K, V or dO rows
  static constexpr int kQ = 0, kK = kOp, kV = 2 * kOp, kG = 3 * kOp;
  static constexpr int kAcc = 4 * kOp;              // dQ's f32 sums; O first
  static constexpr int kStage = kAcc + NK * 256;    // a dS^T tile a consumer
  static constexpr int kRing = kStage + 2 * 64 * kRowBytes;   // #11's P
  static constexpr int kLse =                       // -lse log2(e)
      kRing + (kSaveP ? 2 * kPRing * kPBox : 0);
  static constexpr int kDelta = kLse + (kSaveP ? 0 : NK * 4);
  static constexpr int kBar = kDelta + NK * 4;      // full, done; #11: rings
  static constexpr int kSmem = 1024 + kBar + 16 + (kSaveP ? 32 * kPRing : 0);
  static constexpr int kThreads = kResProducer || kSaveP ? 384 : 256;
  static constexpr int kChunks = (NK + 63) / 64;    // query chunks
  // the width of query chunk c: 64, the last 16 at NK = 208
  __host__ __device__ static constexpr int width(int c) {
    return NK - 64 * c < 64 ? NK - 64 * c : 64;
  }
};
static_assert(ResBwd<256>::kSmem <= 232448 && ResBwd<208>::kSmem <= 232448 &&
                  ResBwd<208, true>::kSmem <= 232448,
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
// stored and read (one stage). #11 loads no O.
template <int NK, bool kWindow, bool kSaveP>
struct BwdLoader {
  using T = ResBwd<NK, kSaveP>;
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
    if constexpr (!kSaveP)
      seq_load<kWindow>(mO, smem + T::kAcc, full, col, ld.seq, a);
    ld.next(a);
    ++j;
    // the next sequence into L2 while this one is computed: its loads
    // wait for this one's stores, but then read L2 (not #11: its P boxes
    // stream meanwhile, and the prefetch cost it 10%: PERF.md, section 6)
    if (!kSaveP && ld.more(a)) {
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

// #11: a consumer's ring of P boxes (kPRing slots of kPBox bytes): box n
// is taken (once it has landed) and given back (once read), in the order
// load_p_ring fills them; `empty` counts the consumer's 128 threads.
struct PRing {
  unsigned char* slots;
  unsigned long long *full, *empty;
  int n;                    // boxes given back
  __device__ __forceinline__ const unsigned char* take() const {
    mbar_wait(full + n % kPRing, (n / kPRing) & 1);
    return slots + n % kPRing * kPBox;
  }
  __device__ __forceinline__ void give() {
    mbar_arrive(empty + n % kPRing);
    ++n;
  }
};

// #11: the P boxes of consumer w, by one thread of the producer warpgroup,
// in the order the consumer takes them: per sequence its query tiles'
// boxes of every key chunk (savep_delta), then its key tiles' boxes of
// every query chunk (bwd_key_tile). A box of rows >= N only is not loaded:
// its full barrier is arrived at, and the consumer reads it as zeros.
template <int NK>
__device__ __forceinline__ void load_p_ring(const CUtensorMap* map,
                                            const PRing& r, int w,
                                            const ResTmaArgs& a) {
  const int n_t = (a.N + 63) >> 6;
  int n = 0;
  auto put = [&](int row, int col, int plane) {
    const int s = n % kPRing;
    if (n >= kPRing) mbar_wait(r.empty + s, (n / kPRing - 1) & 1);
    if (row < a.N) {
      mbar_expect_tx(r.full + s, kPBox);
      tma_load_3d(map, r.slots + s * kPBox, r.full + s, col, row, plane);
    } else {
      mbar_arrive(r.full + s);
    }
    ++n;
  };
  for (SeqWalk sw(a); sw.more(a); sw.next(a)) {
    const int plane = sw.seq * a.H + sw.h;
    for (int qt = w; qt < n_t; qt += 2)
      for (int kc = 0; kc < n_t; ++kc) put(qt * 64, kc * 64, plane);
    for (int kt = w; kt < n_t; kt += 2)
      for (int c = 0; c < ResBwd<NK, true>::kChunks; ++c)
        put(c * 64, kt * 64, plane);
  }
}

// #11: delta = rowsum(P * dP) of query tile qt (rows 64 qt..), by a
// consumer: dP = dO.V^T over all NK keys (dO by ldmatrix into registers,
// one register-A product as the forward's S), then P of the tile's rows
// from its box of every key chunk by ldmatrix, in dP's accumulator layout
// (lanes 0-15 address rows 0-15 at keys 0-7 of a 16-key step, lanes 16-31
// the same rows at keys 8-15). Keys >= N are masked: the plain backward
// reads P's first N columns only. Rows >= N of the tile get delta 0 (the
// prologue zeroes the rows past the last tile).
template <int NK>
__device__ __forceinline__ void savep_delta(unsigned char* smem, int qt,
                                            int N, PRing& ring) {
  using T = ResBwd<NK, true>;
  using S = Swz<64>;
  constexpr int NJ = NK / 8;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5 & 3) * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool live = qt * 64 + wr < N;   // the warp holds a row < N
  unsigned ga[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (live)
      ldmatrix_x4(ga[kk], smem + T::kG + S::offset(qt * 64 + wr + (lane & 15),
                                                   2 * kk + (lane >> 4)));
    else
      ga[kk][0] = ga[kk][1] = ga[kk][2] = ga[kk][3] = 0u;
  }
  float dp[NJ][4];
  const unsigned long long vd = S::desc(smem + T::kV);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_wide(dp, ga[kk], vd + 2 * kk, kk);
  wg_commit();
  wg_wait0();
  wg_hold(dp);
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < (NK + 63) / 64; ++kc) {
    if (kc * 64 >= N) break;
    const unsigned char* b = ring.take();
    const bool edge = kc * 64 + 64 > N;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kc * 64 + kk * 16 >= NK) break;
        unsigned pr[4];
        ldmatrix_x4(pr, b + S::offset(wr + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * kc + 2 * kk + (e >> 1), hf = e & 1;
          float2 pf = unpack_bf16(pr[e]);
          if (edge) {
            pf.x = j * 8 + c2 < N ? pf.x : 0.f;
            pf.y = j * 8 + c2 + 1 < N ? pf.y : 0.f;
          }
          s[hf] = fmaf(pf.x, dp[j][2 * hf], s[hf]);
          s[hf] = fmaf(pf.y, dp[j][2 * hf + 1], s[hf]);
        }
      }
    }
    ring.give();
  }
  float* dl = reinterpret_cast<float*>(smem + T::kDelta);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = s[hf] + __shfl_xor_sync(kFull, s[hf], 1);
    v += __shfl_xor_sync(kFull, v, 2);
    const int row = qt * 64 + wr + g + 8 * hf;
    if (c2 == 0 && row < NK) dl[row] = row < N ? v : 0.f;
  }
}

// One key tile kt (keys 64 kt..) of a sequence, by consumer w: every query
// chunk's products (#10 / #12 five, #11 four with P^T from `ring`), the
// chunks' dQ turns, then dK and dV over the tile's K and V rows.
template <int NK, bool kSaveP>
__device__ __forceinline__ void bwd_key_tile(unsigned char* smem, int w,
                                             int kt, int n_kt, int N,
                                             float scale, PRing& ring) {
  using T = ResBwd<NK, kSaveP>;
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

  // S^T and dP^T of chunk c, two groups (#11: dP^T, one)
  auto issue_s = [&](auto cc) {
    constexpr int c = decltype(cc)::value, W = T::width(c);
    const unsigned long long off = c * 4 * kStep;           // 64 c rows
    wg_fence();
    if constexpr (!kSaveP) {
      mma_scores<64, W>(cols<W>(st), kd, qd + off);
      wg_commit();
    }
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
    if constexpr (kSaveP) {
      // chunk c - 1's products and dP^T(c) are through (nothing of this
      // consumer's runs under the few operations to dS^T: the other
      // consumer's products fill the tensor cores), so the P^T fragments
      // are free: P^T of the box (queries 64 c.., keys 64 kt..) by
      // ldmatrix .trans straight in the A layout of dV += P^T.dO and in
      // dS^T's accumulator layout (lanes 0-7 / 16-23 address queries 0-7 /
      // 8-15 of a 16-query step at the warp's keys 0-7, lanes 8-15 / 24-31
      // the same queries at keys 8-15), and the box goes back to the ring
      // at once. Keys >= N are 0, and so is a box of queries >= N only
      // (not loaded).
      wg_wait0();
      wg_hold_a(pa);
      const unsigned char* pb = ring.take();
      const int q = (lane & 7) + (lane >> 4) * 8;
      const int ch = (wr >> 3) + (lane >> 3 & 1);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        if (c * 64 < N)
          ldmatrix_x4_trans(pa[kk], pb + S::offset(16 * kk + q, ch));
        else
          pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && kt * 64 + wr + g + 8 * (e & 1) >= N) pa[kk][e] = 0u;
          const float2 pf = unpack_bf16(pa[kk][e]);
          st[2 * kk + (e >> 1)][2 * (e & 1)] = pf.x;
          st[2 * kk + (e >> 1)][2 * (e & 1) + 1] = pf.y;
        }
      }
      ring.give();
    } else {
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
        const float2 l = *reinterpret_cast<const float2*>(nl + c * 64 +
                                                          j * 8 + c2);
        st[j][0] = exp2_approx(fmaf(st[j][0], kLog2e, l.x));
        st[j][1] = exp2_approx(fmaf(st[j][1], kLog2e, l.y));
        st[j][2] = exp2_approx(fmaf(st[j][2], kLog2e, l.x));
        st[j][3] = exp2_approx(fmaf(st[j][3], kLog2e, l.y));
      }
      if constexpr (c == 0) wg_wait0();
      else wg_wait<2>();
    }
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
    if constexpr (!kSaveP) pack_a(cols<W>(st), steps<W>(pa));   // bf16(P^T)
    if constexpr (c + 1 < T::kChunks)
      issue_s(std::integral_constant<int, c + 1>());
    stage_a(Dt, da, W / 16);            // bf16(dS^T)
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
// (the boxes of mIn); a.lse the forward's lse. #11 (kSaveP): mO is P's map
// (64 x 64 boxes), and there is no lse.
template <int NK, bool kWindow, bool kSaveP>
__global__ void __launch_bounds__(ResBwd<NK, kSaveP>::kThreads, 1)
res_bwd_tma(const __grid_constant__ CUtensorMap mIn,
            const __grid_constant__ CUtensorMap mO,
            const __grid_constant__ CUtensorMap mG,
            const __grid_constant__ CUtensorMap mD,
            const __grid_constant__ ResTmaArgs a) {
  using T = ResBwd<NK, kSaveP>;
  using S = Swz<64>;
  constexpr bool kProducer = kResProducer || kSaveP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + T::kBar);
  unsigned long long* done = full + 1;
  unsigned long long* pfull = full + 2;         // #11: the rings' barriers
  unsigned long long* pempty = pfull + 2 * kPRing;
  // Q, K, V and dO rows that no box writes (windows of fewer than NK
  // tokens): zeros
  for (int i = a.kv_rows * 8 + threadIdx.x; i < NK * 8; i += T::kThreads)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<uint4*>(smem + b * T::kOp + i * 16) =
          make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    // + the loads' expect_tx
    mbar_init(full, kSaveP ? 1 : kLseArrivals + 1);
    mbar_init(done, 256);             // every consumer thread arrives
    if constexpr (kSaveP)
      for (int i = 0; i < 2 * kPRing; ++i) {
        mbar_init(pfull + i, 1);
        mbar_init(pempty + i, 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async();
  __syncthreads();
  BwdLoader<NK, kWindow, kSaveP> loader(smem, full, done, &mIn, &mO, &mG,
                                        &mD, a);
  // #11: consumer c's ring of P boxes
  auto ring_of = [&](int c) {
    return PRing{smem + T::kRing + c * kPRing * kPBox, pfull + c * kPRing,
                 pempty + c * kPRing, 0};
  };
  const int wg = threadIdx.x >> 7;
  if constexpr (kProducer) {
    if (wg == 0) {
      setmaxnreg_dec<24>();
      const int warp = threadIdx.x >> 5;
      if (threadIdx.x == 0) {
        while (loader.ld.more(a)) loader.step(a);
        loader.drain(a);
      } else if constexpr (kSaveP) {
        if ((threadIdx.x & 31) == 0 && warp <= 2)
          load_p_ring<NK>(&mO, ring_of(warp - 1), warp - 1, a);
      } else if (threadIdx.x >> 5 == 1) {
        int j = 0;
        for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j)
          load_lse<NK>(smem, full, done, sw, j, a);
      }
      return;
    }
    setmaxnreg_inc<240>();
  }
  const int w = kProducer ? wg - 1 : wg;
  const int t = threadIdx.x - (kProducer ? 128 : 0);   // 0..255
  const bool loads = !kProducer && threadIdx.x == 0;
  PRing ring = ring_of(w);
  const int n_kt = (a.N + 63) >> 6;
  const float qscale = __bfloat162float(__float2bfloat16(a.scale));
  int j = 0;
  for (SeqWalk sw(a); sw.more(a); sw.next(a), ++j) {
    if (loads) loader.step(a);
    if (!kProducer && t < 32) load_lse<NK>(smem, full, done, sw, j, a);
    mbar_wait(full, j & 1);
    // row t: q scaled in place, delta = rowsum(dO * O) (O where the sums
    // go; rows >= N: 0; #11: savep_delta below)
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
        if constexpr (!kSaveP)
          sum = dot8(*reinterpret_cast<const uint4*>(smem + T::kAcc + o),
                     *reinterpret_cast<const uint4*>(smem + T::kG + o), sum);
      }
      if constexpr (!kSaveP) dl[t] = t < a.N ? sum : 0.f;
      else if (t >= n_kt * 64) dl[t] = 0.f;   // rows savep_delta leaves
    }
    if constexpr (kSaveP)
      for (int qt = w; qt < n_kt; qt += 2)
        savep_delta<NK>(smem, qt, a.N, ring);
    fence_async();                      // the scaled Q, before wgmma reads
    named_sync(kBarPro, 256);           // ... and O is read: the sums start
    for (int kt = w; kt < n_kt; kt += 2)
      bwd_key_tile<NK, kSaveP>(smem, w, kt, n_kt, a.N, a.scale, ring);
    fence_async();                      // the outputs, before TMA reads them
    mbar_arrive(done);
  }
  if (loads) loader.drain(a);
}

// ---------------------------------------------------------------- launch
// Packed-QKV layouts: qkv (B, N, 3C) with C = 64 H, or its (B, GH, GW, 3C)
// grid; out and dout (..., C); dqkv as qkv; #11's P (B, H, N, NK). Every
// kernel walks its sequences round-robin, G of one head adjacent.

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

// The forward on its tensor maps (a's items set here)
template <int NK, bool kWindow, bool kSaveP = false>
cudaError_t run_res_fwd_tma(const CUtensorMap& mKV, const CUtensorMap& mQ,
                            const CUtensorMap& mO, const CUtensorMap& mP,
                            ResTmaArgs a, void* stream) {
  using T = ResTma<NK, kSaveP>;
  a.items = (a.seqs + a.G - 1) / a.G * a.H;
  const int sms = sm_count();
  if (!sms) return cudaErrorNoDevice;
  static bool attributed[kDevices] = {};
  cudaError_t err = allow_smem_once(res_fwd_tma<NK, kWindow, kSaveP>,
                                    T::kSmem, attributed);
  if (err != cudaSuccess) return err;
  const int grid = kResPersistent ? min(sms, a.seqs * a.H) : a.items;
  res_fwd_tma<NK, kWindow, kSaveP><<<grid, T::kThreads, T::kSmem,
                                     (cudaStream_t)stream>>>(mKV, mQ, mO, mP,
                                                             a);
  return cudaGetLastError();
}

// #11's P (B H planes of N rows of NK bf16) as 64 x 64 boxes in the
// 128-byte swizzle: a row pitch of 2 NK bytes, a plane's of 2 N NK (both
// multiples of 16); rows >= N and columns >= NK read as zeros and are not
// written
inline bool encode_p_map(CUtensorMap* map, const void* p, int planes, int N,
                         int NK) {
  const cuuint64_t dims[3] = {(cuuint64_t)NK, (cuuint64_t)N,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)NK * 2, (cuuint64_t)N * NK * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return encode_map(map, p, 3, dims, strides, box);
}

// #10: qkv (B, N, 3C) -> out (B, N, C), lse (B, H, N); #11 (kSaveP): P
// (B, H, N, NK) in place of lse; N <= NK
template <int NK, bool kSaveP>
cudaError_t launch_dense_fwd(const void* qkv, void* out, void* stats, int B,
                             int N, int H, int G, float scale, void* stream) {
  const cuuint64_t C = 64 * H, q_rows = (N + 63) / 64 * 64;
  const cuuint64_t din[3] = {3 * C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sin[2] = {3 * C * 2, N * 3 * C * 2};
  const cuuint64_t dout[3] = {C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sout[2] = {C * 2, N * C * 2};
  const cuuint32_t bkv[3] = {64, NK, 1}, bq[3] = {64, (cuuint32_t)q_rows, 1};
  CUtensorMap mKV, mQ, mO, mP;
  if (!encode_map(&mKV, qkv, 3, din, sin, bkv) ||
      !encode_map(&mQ, qkv, 3, din, sin, bq) ||
      !encode_map(&mO, out, 3, dout, sout, bq) ||
      (kSaveP && !encode_p_map(&mP, stats, B * H, N, NK)))
    return cudaErrorInvalidValue;
  ResTmaArgs a{};
  a.lse = kSaveP ? nullptr : (float*)stats;
  a.seqs = B;
  a.G = G;
  a.H = H;
  a.N = N;
  a.kv_rows = NK;
  a.tx_bytes = (int)(2 * NK + q_rows) * kRowBytes;
  a.scale = scale;
  return run_res_fwd_tma<NK, false, kSaveP>(mKV, mQ, mO, kSaveP ? mP : mO,
                                            a, stream);
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
  return run_res_fwd_tma<256, true>(mKV, mKV, mO, mO, a, stream);
}

// The backward on its four tensor maps (a's items set here)
template <int NK, bool kWindow, bool kSaveP = false>
cudaError_t run_res_bwd_tma(const CUtensorMap (&m)[4], ResTmaArgs a,
                            void* stream) {
  using T = ResBwd<NK, kSaveP>;
  a.items = (a.seqs + a.G - 1) / a.G * a.H;
  const int sms = sm_count();
  if (!sms) return cudaErrorNoDevice;
  static bool attributed[kDevices] = {};
  cudaError_t err = allow_smem_once(res_bwd_tma<NK, kWindow, kSaveP>,
                                    T::kSmem, attributed);
  if (err != cudaSuccess) return err;
  const int grid = kResPersistent ? min(sms, a.seqs * a.H) : a.items;
  res_bwd_tma<NK, kWindow, kSaveP><<<grid, T::kThreads, T::kSmem,
                                     (cudaStream_t)stream>>>(
      m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

// #10: qkv, dqkv (B, N, 3C), out, dout (B, N, C), lse (B, H, N); #11
// (kSaveP): P (B, H, N, NK) in place of out, no lse; N <= NK
template <int NK, bool kSaveP>
cudaError_t launch_dense_bwd(const void* qkv, const void* out,
                             const void* lse, const void* dout, void* dqkv,
                             int B, int N, int H, int G, float scale,
                             void* stream) {
  const cuuint64_t C = 64 * H;
  const cuuint64_t din[3] = {3 * C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sin[2] = {3 * C * 2, N * 3 * C * 2};
  const cuuint64_t dout_[3] = {C, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t sout[2] = {C * 2, N * C * 2};
  const cuuint32_t box[3] = {64, NK, 1};
  CUtensorMap m[4];
  if (!encode_map(&m[0], qkv, 3, din, sin, box) ||
      !(kSaveP ? encode_p_map(&m[1], out, B * H, N, NK)
               : encode_map(&m[1], out, 3, dout_, sout, box)) ||
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
  a.tx_bytes = (kSaveP ? 4 : 5) * NK * kRowBytes;
  a.scale = scale;
  return run_res_bwd_tma<NK, false, kSaveP>(m, a, stream);
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

}  // namespace
