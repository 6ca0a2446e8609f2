// Flash attention: O = softmax(Q K^T * scale + mask) V with an online
// max/sum over key tiles, so the Sq x Sk score matrix never reaches device
// memory.
//
// Replaces: src/repro/kernels/flash_attn.py:flash_attention (wrapper
// flash_attn.py:79, body _flash_kernel flash_attn.py:26).
//
// What it computes is the Pallas kernel's function, not its blocking:
// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), each at its own (batch, head,
// seq) strides with a unit stride along D, so the model's (B, S, H, D)
// projections and a prefix of the KV cache go in without a copy. The kv
// head of query head h is h / (Hq / Hkv) (GQA). Query row i sits at
// position i + Sk - Sq (right-aligned, so decode is the same function);
// `causal` masks keys after it and `window` keys at or before qpos -
// window. Scores are accumulated in f32 and scaled; a masked score becomes
// the sentinel -1e30 (never -inf, so no inf - inf arises), and the running
// max m, row sum l (of the f32 probabilities) and f32 accumulator are
// rescaled per key tile. P is rounded to V's dtype before P V, as the
// Pallas kernel does (flash_attn.py:61-63); the end divides by l. Keys
// beyond Sk contribute exactly nothing (p = 0), rows beyond Sq are not
// stored. Because masked scores are -1e30 and not -inf, a row whose every
// key is masked (causal with Sq > Sk) gets the mean of V over the Sk keys,
// which is what the Pallas kernel returns. Key tiles wholly past the
// causal diagonal, or wholly before the window, are skipped only in a
// block whose rows all see their own diagonal key: there a skipped tile's
// contribution would have been rescaled to exactly zero. The softmax
// works in base 2 (scores scaled by scale * log2 e, exp2f), which moves p
// by a few f32 ulps before its rounding to V's dtype.
//
// What bounds it on the H100: for prefill, operations. At the serving
// path's q (4, 32, 2048, 64) and kv (4, 4, 2048, 64) in bf16, causal, the
// two products take 4 B Hq S^2 D operations, half of them under the mask:
// 68.7 GFLOP against 75.5 MB of q, k, v and o, so 69 us at the 989
// TFLOP/s bf16 tensor-core peak and 23 us at 3.35 TB/s. The softmax's
// B Hq S (S + 1) / 2 = 268.6 M exp2f there take about as long again on
// the SFUs (16 a clock an SM, ~3.9 T/s): run after the products instead of
// under them, they would double that floor. For decode (Sq = 1 over a
// cache prefix), bytes: 8.4 MB of cache at 2048 keys is 2.5 us, and
// gemma3's ring of 1024 slots at D = 256 and batch 4 is 4.2 MB, 1.26 us;
// the products are about 16 operations a byte at D = 256, 60 times below
// the tensor cores' line. What limits a decode is the bytes in flight on
// each SM (about 25 KB by Little's law to feed 3.35 TB/s) and the
// launches.
//
// bf16 and f16 prefill (Sq > 16), flash_wgmma_kernel<T, DT>: Hopper's
// instructions, designed for this card rather than carried over:
//  * a block of three warpgroups. Warpgroup 0 is the producer: one thread
//    issues every TMA copy and the warpgroup gives registers back
//    (setmaxnreg.dec to 40); warpgroups 1 and 2 are consumers
//    (setmaxnreg.inc to 232). Up to DT = 128 a block owns 128 query rows
//    of one (batch, head), 64 a consumer; at DT = 256 it owns 64 rows and
//    the consumers split O's 256 columns, each computing the rows' S and
//    softmax itself, so that no thread holds more than 64 f32 of O.
//    Blocks walk the causal grid heaviest first;
//  * Q's tile is loaded once; K and V tiles of BK keys (128 at DT = 64,
//    64 at DT = 128 and 256) pass through a ring of PF_STAGES = 2 stages.
//    Each K and each V tile has a "full" mbarrier that the producer's
//    copies complete and an "empty" one that every consumer warp arrives
//    on once the product that read it has been waited for: K after
//    S = Q K^T, V after P V, so K is refilled while V is still in use.
//    Every tile is DT / 64 panels of 128-byte rows under the 128-byte
//    swizzle that TMA writes and a wgmma descriptor reads;
//  * TMA: the host encodes one 4-D tensor map per operand and call, over
//    (D, S, H, B) at the operand's own strides (so (B, S, H, D) views and
//    cache prefixes need no copy), boxes of 64 columns by a tile's rows,
//    zero-filled past D, Sq and Sk. An operand TMA cannot take (a start or
//    a stride off 16 bytes) is copied by the producer warpgroup's threads
//    into the same swizzled tiles against the same barriers, so both
//    routes give the same bits;
//  * S = Q K^T: wgmma m64n{BK}k16, Q and K both K-major from shared
//    memory, f32 accumulators in registers, all DT / 16 k-steps (the
//    columns past D are zeros; a branch or loop that stops at
//    ceil(D / 16) makes ptxas serialize every wgmma of the kernel);
//  * the online softmax in registers, in the arithmetic described above,
//    the mask a loop of its own that runs only on tiles that need it, and
//    exp2 by the SFU's ex2.approx.ftz;
//  * O += P V: wgmma m64n{64|128}k16 with A from registers: the S
//    accumulators' layout is the A fragments', so P is packed to T in
//    place; B is the V tile as stored (keys x D), read with the transpose
//    bit, its 64-column panels a leading byte offset apart;
//  * the next tile's S product is issued, with this tile's P V, before
//    this tile's softmax, so the exp2 of tile j run while the tensor
//    cores take P_{j-1} V_{j-1}; the two consumers interleave on the SM
//    besides (making them take turns through named barriers timed the
//    same, PERF.md);
//  * the epilogue divides by l, rounds once to T, stages the rows through
//    Q's tile and stores 16 bytes a thread at q's layout.
// Every configuration runs in registers alone: on this toolkit ptxas
// gives the pipelined consumer about 168 registers whatever setmaxnreg
// grants, and a thread's O, S and P (64 + 32 + 16 at DT = 128) fit that.
// bf16 and f16 decode (Sq <= 16), flash_decode_kernel<T, DT>, one launch:
//  * the keys are split into chunks of a fixed 128 keys (the wrapper's
//    decode_split: a row's arithmetic depends on Sk alone, not on the
//    batch, the head count or the card, so its output is the same from run
//    to run and at any batch size). A block serves one (batch, kv head)
//    and 16 packed rows of its GQA group (row r is row r % sq of query
//    head kvh * group + r / sq; at Sq = 1 the whole group of every
//    configuration, tinyllama's 8, nemotron's 12), so a kv head's keys
//    are read once, not once per query head;
//  * warps split the keys, not the rows: four consumer warps each take 32
//    keys of a chunk and keep their own max, sum and f32 accumulator of
//    the block's 16 rows, both products on mma.sync m16n8k16 (Q staged
//    once in shared memory, zeros past the group's rows, its A fragments
//    by ldmatrix and held in registers up to D = 128; K by ldmatrix, V by
//    ldmatrix.trans). At the chunk's end the warps' partials merge
//    through shared memory in warp order into the chunk's (acc, m, l). A
//    warp none of whose keys exist (a ragged last chunk) leaves acc = l =
//    0 and m at the sentinel, and weighs nothing;
//  * a producer warp feeds them by TMA: each warp's 32 K rows and 32 V
//    rows are one box of 32 rows by 64 columns a 64-column panel (the
//    host encodes a 4-D tensor map of K and of V a call, as the prefill
//    does), onto an mbarrier that expects the bytes, into a ring of whole
//    chunks (two stages up to D = 128, one at 256: 64 to 128 KB in flight
//    a block), under the 128-byte swizzle so that ldmatrix reads no bank
//    twice; a warp's slot is refilled once it has released it. One copy a
//    key row (cp.async.bulk, no tensor map) ran 1.8 times slower than
//    these boxes at D = 64: the copy engine's rate a request, not the
//    bytes, bounded it (PERF.md). An operand TMA cannot take is copied by
//    the producer's lanes into the same swizzled rows against the same
//    barriers, with the same bits;
//  * the blocks over the chunks of one (batch, kv head, row block) are a
//    thread block cluster of min(chunks, 8): block x computes chunks x, x
//    + 8, ..., leaves each chunk's partial in f32 scratch, and after the
//    cluster's barrier (release, acquire) the cluster merges them, each
//    row by one warp in chunk order (merge_row, the same arithmetic as
//    flash_combine_kernel's, every rounding explicit). One chunk needs no
//    cluster and no merge. A fully masked row has m = -1e30 in every chunk
//    and warp, so the merges weight them by their l alone and return the
//    mean of V over all Sk keys.
//
// f32 (flash_fma32_kernel) stays in exact f32 on the FMA pipes: TF32's
// 10-bit mantissa would not meet the f32 gates. Its bound at the serving
// shape is operations, 68.7 GFLOP at the 67 TFLOP/s f32 peak: 1.03 ms;
// its decode's, bytes: 16.8 MB of f32 cache at 2048 keys, 5.0 us. The
// design before this one reached 31 % of the prefill bound and 35 times
// the decode's: 4 x 4 register tiles fed by scalar shared-memory loads (a
// load for two FMAs), K and V copied element by element and transposed
// with no copy in flight during the arithmetic, three barriers a tile, P
// through shared memory behind a block barrier, and a decode that filled
// one of a block's 16 query rows, read each kv head once per query head
// and walked all keys in one block. Now:
//  * Each thread holds RS query rows x 4 keys of S and RS rows x D / 16
//    columns of O in registers (RS = 4: a block of 256 threads owns 64
//    query rows; at D = 64 two blocks share an SM). Every shared read is
//    a float4 and feeds 8 FMAs or more: per four d, RS float4s of Q and
//    four of K give 16 RS FMAs; per four keys, RS float4s of P and
//    D / 16 of V give RS D / 4.
//  * K and V tiles (64 keys; 32 at D = 256, to fit 227 KB) in a cp.async
//    ring of 16-byte copies (4-byte copies where a row does not start on
//    16 bytes), one barrier a tile, the next tile's copy in flight during
//    this tile's products. Rows lie DT + 4 floats apart, so the float4
//    reads of a quarter-warp fall on distinct banks.
//  * A query row belongs to one half-warp: its max and sum are shuffles,
//    and its P goes through shared memory that only its warp touches,
//    behind __syncwarp rather than a block barrier.
//  * The softmax works in base 2 as above; prefill walks the causal grid
//    heaviest first and skips tiles by the same rule.
//  * Decode packs the GQA group as above, 16 rows a block (one a thread
//    row), and splits the keys into the same fixed 128-key chunks, with
//    the same f32 partials and flash_combine_kernel<float>: a kv head's
//    prefix is read once, and a row's bits depend on Sk alone. A 3-stage
//    ring keeps a chunk's two tiles in flight from the start; warps
//    whose rows all lie past the group's copy and compute nothing.
//
// The split decode's two halves are entry points of their own as well,
// for a decode whose keys lie on several ranks (models/attention.py's
// decode under a mesh: each rank holds a slice of the cache's slots):
//  * flash_<dtype>_partial runs the decode's chunks alone for one query
//    row over one key range, a block a chunk and no cluster, and leaves
//    every chunk's f32 partial (acc, m, l) in a buffer the caller owns,
//    in the decode's own 128-key chunks; chunks past the range's keys
//    leave acc = 0, l = 0, m = -1e30, which weigh nothing in a merge.
//    Bound: bytes, the range's K and V rows and q read once, the partials
//    written once (at 1024 bf16 keys of tinyllama's 4 x 4 kv heads, 4.5
//    MB: 1.3 us).
//  * flash_<dtype>_combine runs flash_combine_kernel alone over a
//    (chunks, rows, d + 2) partial buffer, merging the chunks in order by
//    merge_row. Bound: bytes, the partials read once and the output
//    written once.
// Partial then combine over one range is the decode entry's arithmetic;
// over ranges that start on multiples of the chunk, laid end to end, it
// is that of the decode over their union, bit for bit (the chunks' code
// and the merge are the decode's). The partial takes one query row only:
// its row sees every key of its range, so ranges merge into the decode
// over their union. (Rows right-aligned to each range's own keys would
// not: every range but the last would mask keys that lie in the past of
// every row.)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T narrow(float v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half(v);
}

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  long long qb, qh, qs;
  const void* k;
  long long kb, kh, ks;
  const void* v;
  long long vb, vh, vs;
  void* o;
  long long ob, oh, os;
  float* part;  // split decode: nchunks x rows x (d + 2) f32 partials
  int batch, hq, hkv, group, sq, sk, d;
  float scale2;  // scale * log2(e)
  int causal, has_window, window;
  int chunk;       // > 0: decode, keys per chunk
  int nchunks;     // decode: chunks of keys
  int row_blocks;  // decode: ceil(group * sq / packed rows a block)
  int aligned;     // every row and 16-byte chunk lies on 16 bytes
  int partial;     // decode: leave every chunk's partial, merge none
};

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void run(float (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

// ---------------------------------------------------------------------------
// bf16 / f16 prefill: wgmma fed by a TMA ring

constexpr int PF_THREADS = 384;  // producer + two consumer warpgroups
// by DT = 64, 128, 256: query rows a block and keys a tile
constexpr int PF_ROWS[3] = {128, 128, 64};
constexpr int PF_KEYS[3] = {128, 64, 64};
constexpr int PF_STAGES = 2;  // K and V tiles in the ring
constexpr int PF_PRODUCER_REGS = 40;
constexpr int PF_CONSUMER_REGS = 232;  // 40 x 128 + 232 x 256 = 168 x 384

// One configuration: DT the head dimension padded to 64, 128 or 256. Up
// to DT = 128 the two consumers split the block's BQ = 128 rows, 64 each,
// every one with all DT columns of O; at DT = 256 they share BQ = 64 rows
// and split O's columns, 128 each (both compute the rows' S and softmax),
// so that O is at most 64 f32 registers a thread either way. Shared
// memory: Q's tile, then the ring's stages (K's tile, V's tile), then the
// mbarriers, after up to SWIZZLE_ATOM bytes of slack that align Q to the
// swizzle.
template <int DT>
struct PfTile {
  static constexpr int BQ = PF_ROWS[DT / 128];
  static constexpr int BK = PF_KEYS[DT / 128];
  static constexpr bool SPLIT_COLS = BQ == 64;
  static constexpr int NCOL = SPLIT_COLS ? DT / 2 : DT;  // O's columns
  static constexpr int PANEL_Q = BQ * 128;  // one 64-column panel
  static constexpr int PANEL_KV = BK * 128;
  static constexpr int Q_BYTES = BQ * DT * 2;
  static constexpr int KV_BYTES = BK * DT * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BARS = 1 + 4 * PF_STAGES;
  static constexpr size_t SMEM =
      SWIZZLE_ATOM + Q_BYTES + PF_STAGES * STAGE + 8 * BARS;
};

// The mbarriers: Q's, then for each stage a "full" barrier of its K tile
// and of its V tile, which the producer completes, and an "empty" one of
// each, which every consumer warp arrives on once the product that read
// the tile has been waited for (K's after S = Q K^T, V's after P V, so a
// stage's K is refilled a tile before its V).
struct PfBars {
  unsigned at;
  __device__ __forceinline__ unsigned q() const { return at; }
  __device__ __forceinline__ unsigned full_k(int st) const {
    return at + 8 * (1 + 4 * st);
  }
  __device__ __forceinline__ unsigned full_v(int st) const {
    return full_k(st) + 8;
  }
  __device__ __forceinline__ unsigned empty_k(int st) const {
    return full_k(st) + 16;
  }
  __device__ __forceinline__ unsigned empty_v(int st) const {
    return full_k(st) + 24;
  }
};

// wgmma operand lists: N f32 accumulators d[0..N) as %0..%N-1
#define WG_R32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define WG_R64                                                               \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
         "%57, %58, %59, %60, %61, %62, %63"
#define WG_F8(d, i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),               \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(d, i) \
  WG_F8(d, i), WG_F8(d, i + 8), WG_F8(d, i + 16), WG_F8(d, i + 24)
#define WG_F64(d, i) WG_F32(d, i), WG_F32(d, i + 32)
// d (+)= A B, A and B from shared memory, both K-major; the first k-step
// passes P = 0 (scale-d) and overwrites d.
#define WG_SS(N, TY, R, A, B, P)                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R "}, " \
  A ", " B ", p, 1, 1, 0, 0;\n}\n"
// d += A B, A from registers (four 32-bit fragments), B from shared
// memory MN-major (the transpose bit); P is 1 (accumulate).
#define WG_RS(N, TY, R, A, B, P)                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R "}, " \
  A ", " B ", p, 1, 1, 1;\n}\n"

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// S = Q K^T, the warpgroup's 64 rows by N keys: d[4 j + 2 h + e] is row
// 16 w + lane / 4 + 8 h, key 8 j + 2 (lane % 4) + e, for warp w.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], unsigned long long a,
                                         unsigned long long b, int scale_d) {
  if constexpr (is_bf16<T>) {
    asm volatile(WG_SS(64, "bf16", WG_R32, "%32", "%33", "%34")
                 : WG_F32(d, 0)
                 : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(WG_SS(64, "f16", WG_R32, "%32", "%33", "%34")
                 : WG_F32(d, 0)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], unsigned long long a,
                                         unsigned long long b, int scale_d) {
  if constexpr (is_bf16<T>) {
    asm volatile(WG_SS(128, "bf16", WG_R64, "%64", "%65", "%66")
                 : WG_F64(d, 0)
                 : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(WG_SS(128, "f16", WG_R64, "%64", "%65", "%66")
                 : WG_F64(d, 0)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
}

// x, opaque to the optimizer: a descriptor derived from it is built where
// it is used, not hoisted out of the loop and held in registers.
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

// O += P V, the warpgroup's 64 rows by N columns, in S's layout.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         unsigned long long b) {
  if constexpr (is_bf16<T>) {
    asm volatile(WG_RS(64, "bf16", WG_R32, "{%32, %33, %34, %35}", "%36",
                       "%37")
                 : WG_F32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(WG_RS(64, "f16", WG_R32, "{%32, %33, %34, %35}", "%36",
                       "%37")
                 : WG_F32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         unsigned long long b) {
  if constexpr (is_bf16<T>) {
    asm volatile(WG_RS(128, "bf16", WG_R64, "{%64, %65, %66, %67}", "%68",
                       "%69")
                 : WG_F64(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(WG_RS(128, "f16", WG_R64, "{%64, %65, %66, %67}", "%68",
                       "%69")
                 : WG_F64(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// 2^x by the SFU alone (ex2.approx.ftz): exp2f's accurate path adds
// instructions for denormal results, which p does not need (a p below
// 2^-126 of its row's max weighs nothing in bf16 or f16 P V).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Barrier of one consumer warpgroup's 128 threads (ids 1 and 2; 0 is
// __syncthreads').
__device__ __forceinline__ void consumer_sync(int consumer) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + consumer) : "memory");
}

// Copy rows [row0, row0 + R) of a 2-byte operand (row r at g + r * rs, a
// unit stride along d) into a tile of DT / 64 swizzled panels, zeros past
// `rows` and past d: the producer warpgroup's 128 threads, a plain 2-byte
// load and store an element, consecutive threads along d.
template <int R, int DT>
__device__ __forceinline__ void pf_copy(unsigned char* tile,
                                        const unsigned short* g, long long rs,
                                        int row0, int rows, int d, int tid) {
#pragma unroll 1
  for (int e = tid; e < R * DT; e += 128) {
    const int r = e / DT, c = e % DT;
    const bool ok = row0 + r < rows && c < d;
    *reinterpret_cast<unsigned short*>(tile + (c / 64) * (R * 128) +
                                       swizzled(r, c % 64)) =
        ok ? g[(row0 + r) * rs + c] : 0;
  }
}

// The producer warpgroup: Q's tile once, then tiles kt0 .. kt0 + ntiles - 1
// of K and V into the ring, each K or V tile of a stage refilled once
// every consumer warp has released it. All by TMA (tma == 7): thread 0
// alone, each barrier expecting one arrival and the boxes' bytes.
// Otherwise all 128 threads copy the operands TMA does not take, then
// arrive (thread 0 with the TMA bytes of the others).
template <int DT>
__device__ __forceinline__ void pf_produce(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, const Params& p, int tma, unsigned char* base,
    unsigned base_addr, int b, int h, int kvh, int q0, int kt0, int ntiles) {
  using Tile = PfTile<DT>;
  const int tid = threadIdx.x;
  const bool all_tma = tma == 7;
  if (all_tma && tid != 0) return;
  const PfBars bars{base_addr + Tile::Q_BYTES + PF_STAGES * Tile::STAGE};
  const auto publish = [&](unsigned bar, unsigned bytes, auto&& issue) {
    if (!all_tma) fence_proxy_async();
    if (tid == 0) {
      mbar_expect_tx(bar, bytes);
      issue();
    } else {
      mbar_arrive(bar);
    }
  };
  if (!(tma & 1)) {
    pf_copy<Tile::BQ, DT>(
        base, static_cast<const unsigned short*>(p.q) + b * p.qb + h * p.qh,
        p.qs, q0, p.sq, p.d, tid);
  }
  publish(bars.q(), tma & 1 ? Tile::Q_BYTES : 0, [&] {
    if (!(tma & 1)) return;
#pragma unroll
    for (int c = 0; c < DT / 64; ++c) {
      tma_load_4d(base_addr + c * Tile::PANEL_Q, q_map, bars.q(), 64 * c, q0,
                  h, b);
    }
  });
  const unsigned short* kg =
      static_cast<const unsigned short*>(p.k) + b * p.kb + kvh * p.kh;
  const unsigned short* vg =
      static_cast<const unsigned short*>(p.v) + b * p.vb + kvh * p.vh;
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % PF_STAGES;
    const unsigned parity = (i / PF_STAGES - 1) & 1;
    const int k0 = (kt0 + i) * Tile::BK;
    unsigned char* kd = base + Tile::Q_BYTES + st * Tile::STAGE;
    const unsigned kd_addr = base_addr + Tile::Q_BYTES + st * Tile::STAGE;
    if (i >= PF_STAGES) mbar_wait(bars.empty_k(st), parity);
    if (!(tma & 2)) pf_copy<Tile::BK, DT>(kd, kg, p.ks, k0, p.sk, p.d, tid);
    publish(bars.full_k(st), tma & 2 ? Tile::KV_BYTES : 0, [&] {
      if (!(tma & 2)) return;
#pragma unroll
      for (int c = 0; c < DT / 64; ++c) {
        tma_load_4d(kd_addr + c * Tile::PANEL_KV, k_map, bars.full_k(st),
                    64 * c, k0, kvh, b);
      }
    });
    if (i >= PF_STAGES) mbar_wait(bars.empty_v(st), parity);
    if (!(tma & 4)) {
      pf_copy<Tile::BK, DT>(kd + Tile::KV_BYTES, vg, p.vs, k0, p.sk, p.d,
                            tid);
    }
    publish(bars.full_v(st), tma & 4 ? Tile::KV_BYTES : 0, [&] {
      if (!(tma & 4)) return;
#pragma unroll
      for (int c = 0; c < DT / 64; ++c) {
        tma_load_4d(kd_addr + Tile::KV_BYTES + c * Tile::PANEL_KV, v_map,
                    bars.full_v(st), 64 * c, k0, kvh, b);
      }
    });
  }
}

// Scale, mask and the online softmax of one S tile in place: s becomes
// p = exp2(s - m) in f32 against the new running max; m and l move to it,
// and corr is the factor the accumulator must take. Rows A (h = 0) and B
// (h = 1) of this thread are at positions qpos[h]; tq = lane % 4. The mask
// is a loop of its own behind the tile's need_mask: folded into the
// scale-and-max loop as selects, its index arithmetic ran on every tile
// and took most of the softmax's time.
template <int BK>
__device__ __forceinline__ void pf_softmax(float (&s)[BK / 2], float (&m)[2],
                                           float (&l)[2], float (&corr)[2],
                                           const Params& p, int k0,
                                           bool need_mask, const int (&qpos)[2],
                                           int tq) {
  const float scale2 = p.scale2;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] *= scale2;
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
        const int qp = qpos[e >> 1];
        if ((p.causal && kpos > qp) ||
            (p.has_window && kpos <= qp - p.window)) {
          s[4 * j + e] = -1e30f;
        }
        if (kpos >= p.sk) s[4 * j + e] = -INFINITY;  // beyond Sk: not a key
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = fast_exp2(s[4 * j + e] - m[e >> 1]);
      l[e >> 1] += pe;
      s[4 * j + e] = pe;
    }
  }
}

// P rounded to T as the A fragments of P V, key step kk = keys 16 kk ..
// 16 kk + 15: the layout mma.sync's m16n8k16 A operand and wgmma's
// register A share.
template <typename T, int BK>
__device__ __forceinline__ void pf_pack(uint32_t (&pa)[BK / 16][4],
                                        const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      pa[kk][x] = Mma<T>::pack(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }
  }
}

// A consumer warpgroup: its 64 query rows by NCOL columns of O, over the
// ring's tiles in order. Per tile j: wait for K_j (and V_{j-1}), issue S_j =
// Q K_j^T and O += P_{j-1} V_{j-1}, wait for S_j and release K_j, run
// S_j's softmax while the P V product runs, wait for that and release
// V_{j-1}, rescale O and pack P_j. A warpgroup whose rows all lie past Sq
// releases each tile as it lands and computes nothing.
template <typename T, int DT>
__device__ __forceinline__ void pf_consume(const Params& p,
                                           unsigned char* base,
                                           unsigned base_addr, int b, int h,
                                           int q0, int kt0, int ntiles) {
  using Tile = PfTile<DT>;
  constexpr int BK = Tile::BK;
  const int consumer = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int tq = lane % 4;
  const PfBars bars{base_addr + Tile::Q_BYTES + PF_STAGES * Tile::STAGE};
  const auto parity = [](int i) { return (i / PF_STAGES) & 1; };
  const int row0 = q0 + (Tile::SPLIT_COLS ? 0 : 64 * consumer);
  const int col0 = Tile::SPLIT_COLS ? Tile::NCOL * consumer : 0;
  if (row0 >= p.sq) {
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % PF_STAGES;
      mbar_wait(bars.full_k(st), parity(i));
      if (lane == 0) mbar_arrive(bars.empty_k(st));
      mbar_wait(bars.full_v(st), parity(i));
      if (lane == 0) mbar_arrive(bars.empty_v(st));
    }
    return;
  }
  const int off = p.sk - p.sq;
  const int first_pos = row0 + off;
  const int last_pos = min(row0 + 64, p.sq) - 1 + off;
  const int qpos[2] = {row0 + 16 * warp + lane / 4 + off,
                       row0 + 16 * warp + lane / 4 + 8 + off};
  const unsigned q_tile =
      base_addr + (Tile::SPLIT_COLS ? 0 : consumer * 64 * 128);
  const unsigned ring = base_addr + Tile::Q_BYTES;

  float o[Tile::NCOL / 2], s[BK / 2];
  uint32_t pa[BK / 16][4];
  float m[2] = {-1e30f, -1e30f};  // running max, base-2 domain
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums
  float corr[2];
#pragma unroll
  for (int i = 0; i < Tile::NCOL / 2; ++i) o[i] = 0.f;

  // descriptors of k-step kk: Q's and K's advance by 32 bytes inside a
  // 128-byte row, then by a panel; V's by 16 key rows. All DT / 16
  // k-steps run, columns past D being zeros: skipping those past
  // ceil(D / 16), by a branch or a loop of ceil(D / 16) trips, makes the
  // compiler merge versions of S with moves, and ptxas then serializes
  // every wgmma of the kernel (C7515).
  const auto issue_s = [&](int st) {
    const unsigned long long qd =
        wgmma_desc(opaque(q_tile), SWIZZLE_ATOM, SWIZZLE_ATOM);
    const unsigned long long kd = wgmma_desc(
        opaque(ring + st * Tile::STAGE), SWIZZLE_ATOM, SWIZZLE_ATOM);
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      const unsigned at = (kk % 4) * 32;
      wgmma_ss<T>(s, qd + (((kk / 4) * Tile::PANEL_Q + at) >> 4),
                  kd + (((kk / 4) * Tile::PANEL_KV + at) >> 4), kk > 0);
    }
    wgmma_commit();
  };
  const auto issue_pv = [&](int st) {
    const unsigned long long vd = wgmma_desc(
        opaque(ring + st * Tile::STAGE + Tile::KV_BYTES +
               (col0 / 64) * Tile::PANEL_KV),
        Tile::PANEL_KV, SWIZZLE_ATOM);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<T>(o, pa[kk], vd + ((kk * 16 * 128) >> 4));
    }
    wgmma_commit();
  };
  const auto need_mask = [&](int k0) {
    return k0 + BK > p.sk || (p.causal && k0 + BK - 1 > first_pos) ||
           (p.has_window && k0 <= last_pos - p.window);
  };

  mbar_wait(bars.q(), 0);
  mbar_wait(bars.full_k(0), 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  wgmma_fence_operands(s);
  if (lane == 0) mbar_arrive(bars.empty_k(0));
  pf_softmax<BK>(s, m, l, corr, p, kt0 * BK, need_mask(kt0 * BK), qpos, tq);
  pf_pack<T, BK>(pa, s);
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % PF_STAGES, prev = (i - 1) % PF_STAGES;
    mbar_wait(bars.full_k(st), parity(i));
    mbar_wait(bars.full_v(prev), parity(i - 1));
    wgmma_fence_operands(s);
    wgmma_fence_operands(o);
    wgmma_fence();
    issue_s(st);
    issue_pv(prev);
    wgmma_wait<1>();  // S_i; P_{i-1} V_{i-1} may still run
    wgmma_fence_operands(s);
    if (lane == 0) mbar_arrive(bars.empty_k(st));
    const int k0 = (kt0 + i) * BK;
    pf_softmax<BK>(s, m, l, corr, p, k0, need_mask(k0), qpos, tq);
    wgmma_wait<0>();
    wgmma_fence_operands(o);
    if (lane == 0) mbar_arrive(bars.empty_v(prev));
#pragma unroll
    for (int j = 0; j < Tile::NCOL / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pf_pack<T, BK>(pa, s);
  }
  mbar_wait(bars.full_v((ntiles - 1) % PF_STAGES), parity(ntiles - 1));
  wgmma_fence_operands(o);
  wgmma_fence();
  issue_pv((ntiles - 1) % PF_STAGES);
  wgmma_wait<0>();
  wgmma_fence_operands(o);

  // O / l rounded once to T, through this warpgroup's rows of Q's tile
  // (swizzled: the pair writes and the 16-byte reads are free of bank
  // conflicts), then stored 16 bytes a thread at q's layout
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv_l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  // every product that reads the Q rows about to be overwritten is done:
  // this warpgroup's, or with split columns both consumers'
  if (Tile::SPLIT_COLS) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    consumer_sync(consumer);
  }
  const int row_base = Tile::SPLIT_COLS ? 0 : 64 * consumer;
#pragma unroll
  for (int j = 0; j < Tile::NCOL / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + 16 * warp + lane / 4 + 8 * r;
      const int col = col0 + 8 * j + 2 * tq;
      *reinterpret_cast<uint32_t*>(base + (col / 64) * Tile::PANEL_Q +
                                   swizzled(row, col % 64)) =
          Mma<T>::pack(o[4 * j + 2 * r] * inv_l[r],
                       o[4 * j + 2 * r + 1] * inv_l[r]);
    }
  }
  consumer_sync(consumer);
  T* out = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll 4
  for (int e = tid; e < 64 * (Tile::NCOL / 8); e += 128) {
    const int r = e / (Tile::NCOL / 8);
    const int col = col0 + 8 * (e % (Tile::NCOL / 8));
    const int i = row0 + r;
    if (i >= p.sq || col >= p.d) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        base + (col / 64) * Tile::PANEL_Q + swizzled(row_base + r, col % 64));
    T* dst = out + i * p.os + col;
    if ((reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const T* vals = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) dst[x] = vals[x];
    }
  }
}

// Block (x, y, z): query rows [128 (X - 1 - x), +128) of query head y of
// batch z (X = gridDim.x, heaviest tiles first). `tma`: bit 0 where q_map
// holds Q, bit 1 k_map K, bit 2 v_map V; the producer's threads copy the
// others.
template <typename T, int DT>
__global__ void __launch_bounds__(PF_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Params p,
                   int tma) {
  using Tile = PfTile<DT>;
  constexpr int BK = Tile::BK;
  extern __shared__ __align__(16) unsigned char pf_smem[];
  const unsigned raw = smem_addr(pf_smem);
  unsigned char* base =
      pf_smem + (SWIZZLE_ATOM - raw % SWIZZLE_ATOM) % SWIZZLE_ATOM;
  const unsigned base_addr = smem_addr(base);
  const PfBars bars{base_addr + Tile::Q_BYTES + PF_STAGES * Tile::STAGE};
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Tile::BQ;

  // key tiles to visit; only where every row of the block sees its own
  // diagonal key (causal, first position >= 0) may tiles be skipped
  const int off = p.sk - p.sq;
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + Tile::BQ, p.sq) - 1 + off;
  int kt0 = 0;
  int kt1 = (p.sk + BK - 1) / BK;
  if (p.causal && first_pos >= 0) {
    kt1 = min(kt1, last_pos / BK + 1);
    if (p.has_window && first_pos - p.window + 1 > 0) {
      kt0 = max(kt0, (first_pos - p.window + 1) / BK);
    }
  }
  if (threadIdx.x == 0) {
    const unsigned producers = tma == 7 ? 1 : 128;
    mbar_init(bars.q(), producers);
    for (int st = 0; st < PF_STAGES; ++st) {
      mbar_init(bars.full_k(st), producers);
      mbar_init(bars.full_v(st), producers);
      mbar_init(bars.empty_k(st), 8);  // the consumers' warps
      mbar_init(bars.empty_v(st), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PF_PRODUCER_REGS));
    pf_produce<DT>(&q_map, &k_map, &v_map, p, tma, base, base_addr, b, h, kvh,
                   q0, kt0, kt1 - kt0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        PF_CONSUMER_REGS));
    pf_consume<T, DT>(p, base, base_addr, b, h, q0, kt0, kt1 - kt0);
  }
}

// A TMA map of one operand over (d, rows, heads, batch), at element
// strides (rs, hs, bs) and a unit stride along d: boxes of 64 x box_rows,
// the 128-byte swizzle, zeros past the edges. False where the operand does
// not qualify (a 16-byte aligned start, strides of whole 16-byte vectors
// under 2^40 bytes, save for an axis of extent 1, whose stride is never
// used) or the driver refuses the map.
template <typename T>
bool head_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              long long bs, long long hs, long long rs, int batch, int heads,
              int rows, int d, int box_rows) {
  if ((reinterpret_cast<unsigned long long>(ptr) & 15) != 0) return false;
  const long long elem = static_cast<long long>(sizeof(T));
  long long bytes[3] = {rs * elem, hs * elem, bs * elem};
  const int extent[3] = {rows, heads, batch};
  for (int i = 0; i < 3; ++i) {
    if (bytes[i] > 0 && bytes[i] % 16 == 0 && bytes[i] < (1ll << 40)) continue;
    if (extent[i] != 1) return false;
    bytes[i] = 16;
  }
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(bytes[0]),
                                 static_cast<cuuint64_t>(bytes[1]),
                                 static_cast<cuuint64_t>(bytes[2])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands a prefill call loads by TMA (bit 0 Q, bit 1 K, bit 2 V),
// their maps filled.
template <typename T, int DT>
int pf_tma(EncodeTiled encode, const Params& p, CUtensorMap* q_map,
           CUtensorMap* k_map, CUtensorMap* v_map) {
  constexpr int BK = PfTile<DT>::BK;
  return (head_map<T>(encode, q_map, p.q, p.qb, p.qh, p.qs, p.batch, p.hq,
                      p.sq, p.d, PfTile<DT>::BQ) ? 1 : 0) |
         (head_map<T>(encode, k_map, p.k, p.kb, p.kh, p.ks, p.batch, p.hkv,
                      p.sk, p.d, BK) ? 2 : 0) |
         (head_map<T>(encode, v_map, p.v, p.vb, p.vh, p.vs, p.batch, p.hkv,
                      p.sk, p.d, BK) ? 4 : 0);
}

template <typename T, int DT>
int launch_prefill(const Params& p, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map{}, k_map{}, v_map{};
  const int tma = pf_tma<T, DT>(encode, p, &q_map, &k_map, &v_map);
  const int smem = static_cast<int>(PfTile<DT>::SMEM);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + PfTile<DT>::BQ - 1) / PfTile<DT>::BQ, p.hq,
                  p.batch);
  flash_wgmma_kernel<T, DT><<<grid, PF_THREADS, smem, stream>>>(
      q_map, k_map, v_map, p, tma);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 / f16 decode: warps split each chunk's keys, a producer warp's TMA
// boxes feed them, and the chunks' blocks merge as one cluster

constexpr int DC_ROWS = 16;   // packed rows a block: one m16 tile
constexpr int DC_KEYS = 32;   // keys of a chunk that one consumer warp takes
constexpr int DC_WARPS = 4;   // consumer warps; warp DC_WARPS is the producer
constexpr int DC_THREADS = 32 * (DC_WARPS + 1);
// keys per chunk of the decode partial: the unsplit decode's chunk
// (kernels/flash_attn.py's decode_split), so ranges that start on its
// multiples give that decode's chunks
constexpr int DECODE_CHUNK = 128;
static_assert(DECODE_CHUNK == DC_KEYS * DC_WARPS, "a warp's keys a chunk");
// blocks a decode's cluster has at most: the portable cluster size (16,
// the non-portable one, ran slower on the H100, PERF.md)
constexpr int DECODE_CLUSTER = 8;

// One configuration at DT = 64, 128 or 256. Shared memory, after up to
// SWIZZLE_ATOM bytes of slack that align it to the swizzle: the ring's
// stages, each one chunk: for each consumer warp its K rows, then its V
// rows, DC_KEYS of each as DT / 64 panels of 128-byte rows under the
// 128-byte swizzle that TMA writes (so the 8 rows an ldmatrix reads fall
// on distinct banks); the block's 16 Q rows in the same layout; then the
// warps' partials of the chunk (f32 rows ACC_LD apart), their m and l,
// and the mbarriers, full then empty, one of each a stage and warp. Two
// stages up to DT = 128 (two blocks an SM at 64), one at 256, where one
// chunk's 128 KB is what fits beside the partials.
template <int DT>
struct DcTile {
  static constexpr int PANEL = DC_KEYS * 128;  // 64 columns of DC_KEYS rows
  static constexpr int SUB = DT / 64 * PANEL;  // one warp's K (or V) rows
  static constexpr int SLOT = 2 * SUB;
  static constexpr int STAGE = DC_WARPS * SLOT;
  static constexpr int STAGES = DT == 256 ? 1 : 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int Q = DT / 64 * DC_ROWS * 128;  // the block's Q rows
  static constexpr int ACC_LD = DT + 8;
  static constexpr int ACC = DC_WARPS * DC_ROWS * ACC_LD * 4;
  static constexpr int M = RING + Q + ACC;  // m of each warp's rows
  static constexpr int L = M + 4 * DC_WARPS * DC_ROWS;  // their l
  static constexpr int BARS = L + 4 * DC_WARPS * DC_ROWS;
  static constexpr size_t SMEM =
      SWIZZLE_ATOM + BARS + 8 * 2 * STAGES * DC_WARPS;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The merge of n chunk partials of one output row by one warp, the one
// arithmetic of the decode's cluster and of flash_combine_kernel: chunk
// c's partial at src + c * stride holds d accumulator columns, then m
// (base 2) and l. M = max_c m_c, w_c = exp2f(m_c - M); l = sum_c l_c w_c
// and each column's o = sum_c acc_c w_c, both in chunk order, every term
// one rounded fused multiply-add; dst[col] = o / l (l = 0 read as 1). A
// chunk with no key (acc = l = 0, m = -1e30) adds exactly zero beside any
// chunk with one. A lane holds columns col0 + lane + 32 j, j < NCOL (the
// warp's columns [col0, col0 + 32 NCOL), as many of them as are below d).
// The lanes load BATCH chunks' columns, m and l at once, the first batch
// while M is found, and each lane weighs the chunks itself: a row costs a
// few trips to memory, not one a chunk.
template <typename T, int NCOL>
__device__ __forceinline__ void merge_row(const float* src, long long stride,
                                          int n, int d, int col0, int lane,
                                          T* dst) {
  constexpr int BATCH = NCOL <= 2 ? 16 : 8;  // chunks loaded at once
  const int col = col0 + lane;
  float v[BATCH][NCOL], mv[BATCH], lv[BATCH];
  const auto load = [&](int c0) {
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const float* row = src + (c0 + t) * stride;
      const bool ok = c0 + t < n;
      mv[t] = ok ? row[d] : 0.f;
      lv[t] = ok ? row[d + 1] : 0.f;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        v[t][j] = ok && col + 32 * j < d ? row[col + 32 * j] : 0.f;
      }
    }
  };
  load(0);  // in flight while M is found
  float mmax = -INFINITY;
#pragma unroll 1
  for (int c = lane; c < n; c += 32) mmax = fmaxf(mmax, src[c * stride + d]);
#pragma unroll
  for (int x = 16; x > 0; x /= 2) {
    mmax = fmaxf(mmax, __shfl_xor_sync(0xffffffffu, mmax, x));
  }
  float lsum = 0.f;
  float o[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) o[j] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < n; c0 += BATCH) {
    if (c0 > 0) load(c0);
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      if (c0 + t < n) {
        const float w = exp2f(mv[t] - mmax);
        lsum = __fmaf_rn(lv[t], w, lsum);
#pragma unroll
        for (int j = 0; j < NCOL; ++j) o[j] = __fmaf_rn(v[t][j], w, o[j]);
      }
    }
  }
  const float inv_l = __fdiv_rn(1.f, lsum == 0.f ? 1.f : lsum);
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    if (col + 32 * j < d) dst[col + 32 * j] = narrow<T>(__fmul_rn(o[j], inv_l));
  }
}

// Block (x, y, z) of a grid X wide: chunks x, x + X, ... of kv head
// y / row_blocks of batch z, packed rows [16 (y % row_blocks), +16) of
// that head's group (row r is row r % sq of query head kvh * group +
// r / sq). X is 1 for one chunk; p.nchunks for the partial, which leaves
// every chunk's partial in p.part; otherwise min(nchunks,
// DECODE_CLUSTER), the X blocks of a (batch, kv head, row block) being
// one cluster that merges the chunks' partials from p.part into p.o.
// Warp DC_WARPS produces: for each chunk and consumer warp w, the K and
// V rows of keys [chunk + 32 w, +32), one TMA box of 32 rows by 64
// columns a panel (zeros past Sk and past d), onto that stage and warp's
// full barrier; an operand TMA does not take (`tma` bit 0 K, bit 1 V
// clear) its lanes copy into the same swizzled rows, zeros past the
// warp's keys and past d, against the same barrier. It refills a slot
// once its warp released it. Consumer warp w computes those keys' partial
// of the block's rows alone (S = Q K^T and O = P V on mma.sync m16n8k16,
// Q's A fragments by ldmatrix, K by ldmatrix, V by ldmatrix.trans;
// the softmax against its own max m_w, p = exp2(s - m_w) in f32, P
// rounded to T). The four warps' partials then merge through shared
// memory in warp order, in merge_row's arithmetic: M = max_w m_w, w_w =
// exp2f(m_w - M), l = sum_w l_w w_w and acc = sum_w acc_w w_w, w = 0..3,
// each term one rounded fused multiply-add.
template <typename T, int DT>
__global__ void __launch_bounds__(DC_THREADS, 1)
flash_decode_kernel(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const Params p,
                    int tma) {
  using Tile = DcTile<DT>;
  constexpr int KS = DT / 16;  // 16-wide steps along D
  constexpr bool QREG = DT <= 128;  // Q fragments held across chunks
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ __align__(16) unsigned char dc_raw[];
  const unsigned raw = smem_addr(dc_raw);
  unsigned char* dc_smem =
      dc_raw + (SWIZZLE_ATOM - raw % SWIZZLE_ATOM) % SWIZZLE_ATOM;
  const unsigned base = smem_addr(dc_smem);
  float* acc_s = reinterpret_cast<float*>(dc_smem + Tile::RING + Tile::Q);
  float* m_s = reinterpret_cast<float*>(dc_smem + Tile::M);
  float* l_s = reinterpret_cast<float*>(dc_smem + Tile::L);
  const auto full = [&](int st, int w) {
    return base + Tile::BARS + 8 * (st * DC_WARPS + w);
  };
  const auto empty = [&](int st, int w) {
    return full(st, w) + 8 * STAGES * DC_WARPS;
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / p.row_blocks, rb = blockIdx.y % p.row_blocks;
  const int rank = blockIdx.x, ctas = gridDim.x;
  const int nlocal = rank < p.nchunks ? (p.nchunks - 1 - rank) / ctas + 1 : 0;
  const int off = p.sk - p.sq;
  const int packed_rows = p.group * p.sq;
  // keys before this are masked for every row: where every row sees its
  // own diagonal key (causal, first position >= 0), the window's start
  // for the block's first row
  const int before =
      p.causal && off >= 0 && p.has_window ? off - p.window + 1 : 0;
  // keys [lo, lo + n) that warp w takes of chunk c; none past Sk, past
  // the chunk or wholly before every row's window
  const auto sub_keys = [&](int c, int w, int& lo) {
    lo = c * p.chunk + w * DC_KEYS;
    const int hi = min(min(lo + DC_KEYS, (c + 1) * p.chunk), p.sk);
    return hi <= lo || hi <= before ? 0 : hi - lo;
  };

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      for (int w = 0; w < DC_WARPS; ++w) {
        // the producer's lane 0, or all its lanes where they copy
        mbar_init(full(st, w), tma == 3 ? 1 : 32);
        mbar_init(empty(st, w), 1);  // the consumer warp's lane 0
      }
    }
    mbar_init_fence();
  }
  if (tid == 32 * DC_WARPS) {  // the producer's lane 0: the maps' first read
    if (tma & 1) tma_prefetch(&k_map);
    if (tma & 2) tma_prefetch(&v_map);
  }
  // the panels past d, which no copy writes: zeros, so that the products
  // may run over all DT columns
  const int panels = (p.d + 63) / 64;
  if (panels < DT / 64) {
#pragma unroll 1
    for (int e = tid; e < STAGES * DC_WARPS * 2 * (DT / 64 - panels) *
                              (Tile::PANEL / 16);
         e += DC_THREADS) {
      const int sub = e / ((DT / 64 - panels) * (Tile::PANEL / 16));
      const int at = e % ((DT / 64 - panels) * (Tile::PANEL / 16));
      *reinterpret_cast<uint4*>(dc_smem + sub * Tile::SUB +
                                panels * Tile::PANEL + 16 * at) =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  if (warp == DC_WARPS) {
    // the producer
    const unsigned short* kg =
        static_cast<const unsigned short*>(p.k) + b * p.kb + kvh * p.kh;
    const unsigned short* vg =
        static_cast<const unsigned short*>(p.v) + b * p.vb + kvh * p.vh;
    // rows [0, n) of keys from lo of an operand into a sub-tile's
    // swizzled panels, zeros in its other rows and past d
    const auto copy = [&](unsigned char* dst, const unsigned short* g,
                          long long rs, int lo, int n) {
#pragma unroll 1
      for (int e = lane; e < DC_KEYS * 64 * panels; e += 32) {
        const int r = e / (64 * panels), col = e % (64 * panels);
        const bool ok = r < n && col < p.d;
        *reinterpret_cast<unsigned short*>(
            dst + (col / 64) * Tile::PANEL + swizzled(r, col % 64)) =
            ok ? g[(lo + r) * rs + col] : 0;
      }
    };
    for (int j = 0; j < nlocal; ++j) {
      const int c = rank + j * ctas, st = j % STAGES;
      for (int w = 0; w < DC_WARPS; ++w) {
        if (j >= STAGES) mbar_wait(empty(st, w), (j / STAGES - 1) & 1);
        int lo;
        const int n = sub_keys(c, w, lo);
        const int kd = st * Tile::STAGE + w * Tile::SLOT, vd = kd + Tile::SUB;
        if (n > 0 && tma != 3) {
          if (!(tma & 1)) copy(dc_smem + kd, kg, p.ks, lo, n);
          if (!(tma & 2)) copy(dc_smem + vd, vg, p.vs, lo, n);
          fence_proxy_async();  // before a later TMA write of these rows
        }
        if (lane == 0) {
          const unsigned bytes =
              n > 0 ? ((tma & 1) + (tma >> 1)) * panels * Tile::PANEL : 0;
          mbar_expect_tx(full(st, w), bytes);
          for (int x = 0; x < panels && n > 0; ++x) {
            if (tma & 1) {
              tma_load_4d(base + kd + x * Tile::PANEL, &k_map, full(st, w),
                          64 * x, lo, kvh, b);
            }
            if (tma & 2) {
              tma_load_4d(base + vd + x * Tile::PANEL, &v_map, full(st, w),
                          64 * x, lo, kvh, b);
            }
          }
        } else if (tma != 3) {
          mbar_arrive(full(st, w));
        }
      }
    }
  } else {
    // the block's Q rows into shared memory, zeros past the group's rows
    // and past d: 16 bytes a thread where the rows lie on 16 bytes
    const unsigned short* qg =
        static_cast<const unsigned short*>(p.q) + b * p.qb;
    const auto q_row = [&](int r) {
      const int rr = rb * DC_ROWS + r;
      return qg + (kvh * p.group + rr / p.sq) * p.qh + (rr % p.sq) * p.qs;
    };
    const auto q_at = [&](int r, int col) {
      return dc_smem + Tile::RING + (col / 64) * (DC_ROWS * 128) +
             swizzled(r, col % 64);
    };
    if (p.aligned) {
      constexpr int CH = DT / 8;  // 16-byte pieces a row
#pragma unroll
      for (int it = 0; it < DC_ROWS * CH / (32 * DC_WARPS); ++it) {
        const int e = tid + 32 * DC_WARPS * it, r = e / CH, col = 8 * (e % CH);
        const bool ok = rb * DC_ROWS + r < packed_rows && col < p.d;
        *reinterpret_cast<uint4*>(q_at(r, col)) =
            ok ? *reinterpret_cast<const uint4*>(q_row(r) + col)
               : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < DC_ROWS * DT; e += 32 * DC_WARPS) {
        const int r = e / DT, col = e % DT;
        const bool ok = rb * DC_ROWS + r < packed_rows && col < p.d;
        *reinterpret_cast<unsigned short*>(q_at(r, col)) =
            ok ? q_row(r)[col] : 0;
      }
    }
    consumer_sync(0);
    // a consumer warp: rows A = g and B = g + 8 of the block in its lane
    const int g = lane / 4, tq = lane % 4, mi = lane / 8;
    int ir[2];
    for (int r = 0; r < 2; ++r) ir[r] = (rb * DC_ROWS + g + 8 * r) % p.sq;
    const auto q_frag = [&](int ks, uint32_t (&a)[4]) {
      const int col = 16 * ks + 8 * (mi >> 1);
      ldsm_x4(a, base + Tile::RING + (col / 64) * (DC_ROWS * 128) +
                     swizzled((lane & 7) + (mi & 1) * 8, col % 64));
    };
    uint32_t qf[QREG ? KS : 1][4];
    if constexpr (QREG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) q_frag(ks, qf[ks]);
    }
    const int qpos[2] = {ir[0] + off, ir[1] + off};
    const bool split = p.partial || p.nchunks > 1;

    for (int j = 0; j < nlocal; ++j) {
      const int c = rank + j * ctas, st = j % STAGES;
      int lo;
      const int n = sub_keys(c, warp, lo);
      float m[2] = {-1e30f, -1e30f};  // this warp's max, base-2 domain
      float l[2] = {0.f, 0.f};        // this lane's share of the row sums
      float* my = acc_s + warp * DC_ROWS * Tile::ACC_LD;
      mbar_wait(full(st, warp), (j / STAGES) & 1);
      if (n > 0) {
        const unsigned kt = base + st * Tile::STAGE + warp * Tile::SLOT;
        const unsigned vt = kt + Tile::SUB;
        // S = Q K^T for the block's 16 rows and this warp's 32 keys
        float s[DC_KEYS / 8][4];
#pragma unroll
        for (int i = 0; i < DC_KEYS / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          if constexpr (QREG) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] = qf[ks][x];
          } else {
            q_frag(ks, a);
          }
#pragma unroll
          for (int np = 0; np < DC_KEYS / 16; ++np) {
            uint32_t bk[4];
            const int col = 16 * ks + 8 * (mi & 1);
            ldsm_x4(bk, kt + (col / 64) * Tile::PANEL +
                            swizzled(16 * np + (lane & 7) + (mi >> 1) * 8,
                                     col % 64));
            Mma<T>::run(s[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
            Mma<T>::run(s[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
          }
        }
        // scale, mask, softmax against this warp's max
        const bool need_mask = n < DC_KEYS ||
                               (p.causal && lo + DC_KEYS - 1 > off) ||
                               (p.has_window && lo <= p.sk - 1 - p.window);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < DC_KEYS / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float val = s[i][e] * p.scale2;
            if (need_mask) {
              const int kpos = lo + 8 * i + 2 * tq + (e & 1);
              const int qp = qpos[e >> 1];
              if ((p.causal && kpos > qp) ||
                  (p.has_window && kpos <= qp - p.window)) {
                val = -1e30f;
              }
              if (kpos >= lo + n) val = -INFINITY;  // not a key of this warp
            }
            s[i][e] = val;
            mx[e >> 1] = fmaxf(mx[e >> 1], val);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          m[r] = fmaxf(m[r], mx[r]);
        }
        // P = exp2(S - m) rounded to T as the A fragments of P V
        uint32_t pa[DC_KEYS / 16][4];
#pragma unroll
        for (int kk = 0; kk < DC_KEYS / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 2 * kk + (x >> 1), e = 2 * (x & 1);
            const float p0 = fast_exp2(s[i][e] - m[x & 1]);
            const float p1 = fast_exp2(s[i][e + 1] - m[x & 1]);
            l[x & 1] += p0 + p1;
            pa[kk][x] = Mma<T>::pack(p0, p1);
          }
        }
        // O = P V, then this warp's partial to shared memory unscaled
        float acc[DT / 8][4];
#pragma unroll
        for (int i = 0; i < DT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DC_KEYS / 16; ++kk) {
#pragma unroll
          for (int dp = 0; dp < DT / 16; ++dp) {
            uint32_t bv[4];
            const int col = 16 * dp + 8 * (mi >> 1);
            ldsm_x4_t(bv, vt + (col / 64) * Tile::PANEL +
                              swizzled(16 * kk + (lane & 7) + (mi & 1) * 8,
                                       col % 64));
            Mma<T>::run(acc[2 * dp], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3],
                        bv[0], bv[1]);
            Mma<T>::run(acc[2 * dp + 1], pa[kk][0], pa[kk][1], pa[kk][2],
                        pa[kk][3], bv[2], bv[3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st, warp));  // the slot may refill
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        // every thread is done with the last chunk's partials
        consumer_sync(0);
#pragma unroll
        for (int i = 0; i < DT / 8; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            *reinterpret_cast<float2*>(my + (g + 8 * r) * Tile::ACC_LD +
                                       8 * i + 2 * tq) =
                make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
          }
        }
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st, warp));
        consumer_sync(0);
#pragma unroll 1
        for (int r = 0; r < DC_ROWS; ++r) {
#pragma unroll 1
          for (int col = lane; col < p.d; col += 32) my[r * Tile::ACC_LD + col] = 0.f;
        }
      }
      if (tq == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_s[warp * DC_ROWS + g + 8 * r] = m[r];
          l_s[warp * DC_ROWS + g + 8 * r] = l[r];
        }
      }
      consumer_sync(0);
      // the chunk's partial of each row, a warp a row and lanes along d:
      // M, the warps' weights and l, then acc; left in p.part (split), or
      // O / l in p.o for a one-chunk decode
#pragma unroll 1
      for (int k = 0; k < DC_ROWS / DC_WARPS; ++k) {
        const int r = warp + DC_WARPS * k;
        const int rr = rb * DC_ROWS + r;
        if (rr >= packed_rows) continue;
        const int h = kvh * p.group + rr / p.sq, i = rr % p.sq;
        float top = -INFINITY;
#pragma unroll
        for (int w = 0; w < DC_WARPS; ++w) top = fmaxf(top, m_s[w * DC_ROWS + r]);
        float wt[DC_WARPS], lc = 0.f;
#pragma unroll
        for (int w = 0; w < DC_WARPS; ++w) {
          wt[w] = exp2f(m_s[w * DC_ROWS + r] - top);
          lc = __fmaf_rn(l_s[w * DC_ROWS + r], wt[w], lc);
        }
        float* part = p.part + (((static_cast<long long>(c) * p.batch + b) *
                                     p.hq + h) * p.sq + i) * (p.d + 2);
        T* out = static_cast<T*>(p.o) + b * p.ob + h * p.oh + i * p.os;
        const float inv_l = split ? 0.f : __fdiv_rn(1.f, lc == 0.f ? 1.f : lc);
#pragma unroll 1
        for (int col = lane; col < p.d; col += 32) {
          float o = 0.f;
#pragma unroll
          for (int w = 0; w < DC_WARPS; ++w) {
            o = __fmaf_rn(acc_s[(w * DC_ROWS + r) * Tile::ACC_LD + col], wt[w], o);
          }
          if (split) {
            part[col] = o;
          } else {
            out[col] = narrow<T>(__fmul_rn(o, inv_l));
          }
        }
        if (split && lane == 0) {
          part[p.d] = top;
          part[p.d + 1] = lc;
        }
      }
    }
  }

  if (!p.partial && p.nchunks > 1) {
    // every chunk's partial is in p.part (the cluster barrier's release
    // and acquire make the blocks' stores visible to each other): the
    // cluster merges them, a warp each row's 32-column group, block x
    // taking groups x, x + X, ...
    cluster_sync();
    const long long stride =
        static_cast<long long>(p.batch) * p.hq * p.sq * (p.d + 2);
    const int groups = (p.d + 31) / 32;
#pragma unroll 1
    for (int e = rank + ctas * warp; e < DC_ROWS * groups;
         e += ctas * (DC_WARPS + 1)) {
      const int r = e / groups, col0 = 32 * (e % groups);
      const int rr = rb * DC_ROWS + r;
      if (rr >= packed_rows) break;
      const int h = kvh * p.group + rr / p.sq, i = rr % p.sq;
      merge_row<T, 1>(
          p.part + ((static_cast<long long>(b) * p.hq + h) * p.sq + i) *
                       (p.d + 2),
          stride, p.nchunks, p.d, col0, lane,
          static_cast<T*>(p.o) + b * p.ob + h * p.oh + i * p.os);
    }
  }
}

// Merge the key chunks of each row: one warp a row (b, h, i), by
// merge_row, the decode cluster's own merge (d <= 32 NCOL).
template <typename T, int NCOL>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const Params p) {
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  const long long row = blockIdx.x * 4ll + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = static_cast<int>(row % p.sq);
  const int h = static_cast<int>((row / p.sq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.sq) * p.hq));
  merge_row<T, NCOL>(p.part + row * (p.d + 2), rows * (p.d + 2), p.nchunks,
                     p.d, 0, threadIdx.x & 31,
                     static_cast<T*>(p.o) + b * p.ob + h * p.oh + i * p.os);
}

// The merge of p.nchunks chunks' partials into p.o, and its error.
template <typename T>
int launch_merge(const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  const unsigned blocks = static_cast<unsigned>((rows + 3) / 4);
  if (p.d <= 64) {
    flash_combine_kernel<T, 2><<<blocks, 128, 0, stream>>>(p);
  } else if (p.d <= 128) {
    flash_combine_kernel<T, 4><<<blocks, 128, 0, stream>>>(p);
  } else {
    flash_combine_kernel<T, 8><<<blocks, 128, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// After the f32 decode's chunks: cudaGetLastError() of their launch,
// then, when the keys were split and the caller asked for the output,
// the merge's launch and its error.
template <typename T>
int launch_combine(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.chunk <= 0 || p.nchunks <= 1 || p.partial) {
    return static_cast<int>(err);
  }
  return launch_merge<T>(p, stream);
}

// The bf16/f16 decode, one launch: one block for one chunk, p.nchunks
// blocks for the partial, else a cluster of min(nchunks, DECODE_CLUSTER)
// blocks a (batch, kv head, row block). K and V by TMA where head_map
// takes them, boxes of DC_KEYS rows.
template <typename T, int DT>
int launch_decode(const Params& p, cudaStream_t stream) {
  if (p.chunk > DECODE_CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap k_map{}, v_map{};
  const int tma = (head_map<T>(encode, &k_map, p.k, p.kb, p.kh, p.ks, p.batch,
                               p.hkv, p.sk, p.d, DC_KEYS) ? 1 : 0) |
                  (head_map<T>(encode, &v_map, p.v, p.vb, p.vh, p.vs, p.batch,
                               p.hkv, p.sk, p.d, DC_KEYS) ? 2 : 0);
  const int smem = static_cast<int>(DcTile<DT>::SMEM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool merge = !p.partial && p.nchunks > 1;
  const int ctas = p.partial ? p.nchunks
                   : merge   ? min(p.nchunks, DECODE_CLUSTER)
                             : 1;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ctas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ctas, p.hkv * p.row_blocks, p.batch);
  cfg.blockDim = dim3(DC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = merge ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<T, DT>, k_map, v_map, p,
                           tma);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and f16: the prefill kernel, or the decode's (chunk > 0), at D
// padded to 64, 128 or 256.
template <typename T>
int launch_half(const Params& p, cudaStream_t stream) {
  if (p.chunk <= 0) {
    if (p.d <= 64) return launch_prefill<T, 64>(p, stream);
    if (p.d <= 128) return launch_prefill<T, 128>(p, stream);
    return launch_prefill<T, 256>(p, stream);
  }
  if (p.d <= 64) return launch_decode<T, 64>(p, stream);
  if (p.d <= 128) return launch_decode<T, 128>(p, stream);
  return launch_decode<T, 256>(p, stream);
}

// ---------------------------------------------------------------------------
// f32: FMA pipes

constexpr int FT = 16;             // threads a block side (16 x 16)
constexpr int F_THREADS = FT * FT;
constexpr int F_DECODE_ROWS = FT;  // packed decode rows a block
constexpr unsigned FULL = 0xffffffffu;

// One configuration of the f32 kernel: DT the head dimension padded to
// 64, 128 or 256; RS query rows a thread, so BQ = 16 RS rows a block; BK
// keys a tile; STAGES tiles of K and V in the cp.async ring. Q, K and V
// rows are DT + 4 floats apart and P's BK + 4: whole 16-byte vectors, 4
// mod 32 banks apart, so that the float4 reads below are free of bank
// conflicts.
template <int DT, int RS, int BK, int STAGES>
struct FmaTile {
  static_assert(RS == 1 || RS == 4, "rows a thread: 1 or 4");
  static constexpr int BQ = FT * RS;
  static constexpr int CK = BK / FT;  // keys a thread
  static constexpr int CD = DT / FT;  // output columns a thread
  static constexpr int D_LD = DT + 4;
  static constexpr int P_LD = BK + 4;
  static constexpr int KV = BK * D_LD;  // floats of one K or V tile
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(BQ) * D_LD +
                       static_cast<size_t>(STAGES) * 2 * KV +
                       static_cast<size_t>(BQ) * P_LD);
};

// Block row of a thread's row i: 4 ty + i, so that the two half-warps of
// a warp (ty and ty + 1) read rows 4 apart, 16 banks; with one row a
// thread, row ty.
template <int RS>
__device__ __forceinline__ int fma_row(int ty, int i) {
  return RS == 1 ? ty : 4 * ty + i;
}

// Copy 4 floats (16 bytes) from g to shared s, or zeros when !pred:
// aligned, one cp.async of 16 bytes; otherwise four of 4 bytes, legal at
// any float's address. Both join the ring's commit groups.
__device__ __forceinline__ void copy4f(float* s, const float* g, bool pred,
                                       bool aligned) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if (aligned) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(g), "r"(pred ? 16 : 0));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       sa + 4 * e),
                   "l"(g + (pred ? e : 0)), "r"(pred ? 4 : 0));
    }
  }
}

__device__ __forceinline__ void float4_to(float (&a)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// Block (x, y, z): prefill, query rows [BQ (X - 1 - x), +BQ) of query head
// y of batch z (X = gridDim.x, heaviest tiles first); decode, key chunk x
// of kv head y / row_blocks of batch z, packed rows [BQ (y % row_blocks),
// +BQ) of that head's group, as in flash_decode_kernel. Thread (ty, tx) =
// (tid / 16, tid % 16) owns block rows fma_row(ty, i), i < RS: in S the
// keys tx + 16 j of each tile (j < CK), in O the columns 64 g + 4 tx + e
// (e < 4, g < CD / 4). A row's 16 threads are one half-warp, so its
// reductions are shuffles and its P goes through shared memory that only
// its warp touches.
template <int DT, int RS, int BK, int STAGES, int MINB>
__global__ void __launch_bounds__(F_THREADS, MINB)
flash_fma32_kernel(const Params p) {
  using Tile = FmaTile<DT, RS, BK, STAGES>;
  constexpr int BQ = Tile::BQ, CK = Tile::CK, CD = Tile::CD;
  constexpr int D_LD = Tile::D_LD, P_LD = Tile::P_LD, KV = Tile::KV;
  constexpr int CH = DT / 4;  // 16-byte chunks a row
  extern __shared__ __align__(16) float f_smem[];
  float* qsm = f_smem;                  // [BQ][D_LD]
  float* ring = qsm + BQ * D_LD;        // STAGES x (K, V), each [BK][D_LD]
  float* psm = ring + STAGES * 2 * KV;  // [BQ][P_LD]

  const int tid = threadIdx.x, tx = tid % FT, ty = tid / FT;
  const int b = blockIdx.z;
  const bool packed = p.chunk > 0;
  int kvh, hfix = 0, q0 = 0, rb = 0, key_lo = 0, key_hi = p.sk, chunk = 0;
  if (packed) {
    kvh = blockIdx.y / p.row_blocks;
    rb = blockIdx.y % p.row_blocks;
    chunk = blockIdx.x;
    key_lo = chunk * p.chunk;
    key_hi = min(p.sk, key_lo + p.chunk);
  } else {
    hfix = blockIdx.y;
    kvh = hfix / p.group;
    q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  }
  const int off = p.sk - p.sq;
  const int packed_rows = p.group * p.sq;
  // block row r -> (query head h, query row i); false past the last row
  auto map_row = [&](int r, int& h, int& i) -> bool {
    if (packed) {
      const int rr = rb * BQ + r;
      h = kvh * p.group + rr / p.sq;
      i = rr % p.sq;
      return rr < packed_rows;
    }
    h = hfix;
    i = q0 + r;
    return i < p.sq;
  };

  const float* qg = static_cast<const float*>(p.q) + b * p.qb;
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  const bool aligned = p.aligned != 0;

  // Q tile, zero past the last row and past d
  for (int e = tid; e < BQ * CH; e += F_THREADS) {
    const int r = e / CH, c = e % CH;
    int h, i;
    const bool ok = map_row(r, h, i) && 4 * c < p.d;
    copy4f(qsm + r * D_LD + 4 * c, ok ? qg + h * p.qh + i * p.qs + 4 * c : qg,
           ok, aligned);
  }
  cp_async_commit();

  // key tiles to visit; only where every row of the block sees its own
  // diagonal key (causal, first position >= 0) may tiles be skipped
  int first_pos, last_pos;
  if (packed) {
    first_pos = off;
    last_pos = p.sk - 1;
  } else {
    first_pos = q0 + off;
    last_pos = min(q0 + BQ, p.sq) - 1 + off;
  }
  int kt0 = key_lo / BK;
  int kt1 = (key_hi + BK - 1) / BK;
  if (p.causal && first_pos >= 0) {
    kt1 = min(kt1, last_pos / BK + 1);
    if (p.has_window && first_pos - p.window + 1 > 0) {
      kt0 = max(kt0, (first_pos - p.window + 1) / BK);
    }
  }

  // K and V rows of tile kt into ring stage `stage`; zeros for keys
  // outside [key_lo, key_hi) and past d
  auto load_kv = [&](int kt, int stage) {
    float* kd = ring + stage * 2 * KV;
    float* vd = kd + KV;
    const int k0 = kt * BK;
    for (int e = tid; e < BK * CH; e += F_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r >= key_lo && k0 + r < key_hi && 4 * c < p.d;
      const long long row = ok ? k0 + r : 0;
      copy4f(kd + r * D_LD + 4 * c, ok ? kg + row * p.ks + 4 * c : kg, ok,
             aligned);
      copy4f(vd + r * D_LD + 4 * c, ok ? vg + row * p.vs + 4 * c : vg, ok,
             aligned);
    }
  };

  int qpos[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    int h, ii;
    map_row(fma_row<RS>(ty, i), h, ii);
    qpos[i] = ii + off;
  }
  // a warp whose first row (its smallest) is past the last computes
  // nothing; it still copies its share of every tile
  int hw, iw;
  const bool warp_live = map_row(fma_row<RS>(2 * (tid / 32), 0), hw, iw);

  float m[RS], l[RS], acc[RS][CD];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    m[i] = -1e30f;  // running max, base-2 domain
    l[i] = 0.f;     // this thread's share of the row sum
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) load_kv(kt0 + s, s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's have, and tile kt - 1's stage is free
    const int next = kt + STAGES - 1;
    if (next < kt1) load_kv(next, (next - kt0) % STAGES);
    cp_async_commit();
    if (!warp_live) continue;
    const float* ks = ring + ((kt - kt0) % STAGES) * 2 * KV;
    const float* vs = ks + KV;
    const int k0 = kt * BK;

    // S = Q K^T: per four d, RS float4s of Q and CK of K
    float s[RS][CK];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int dd = 0; dd < p.d; dd += 4) {
      float qa[RS][4], ka[CK][4];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        float4_to(qa[i], qsm + fma_row<RS>(ty, i) * D_LD + dd);
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float4_to(ka[j], ks + (tx + FT * j) * D_LD + dd);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < RS; ++i) {
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            s[i][j] = fmaf(qa[i][u], ka[j][u], s[i][j]);
          }
        }
      }
    }

    // scale, mask, online softmax; P to this warp's rows of psm
    const bool need_mask =
        k0 < key_lo || k0 + BK > key_hi ||
        (p.causal && k0 + BK - 1 > first_pos) ||
        (p.has_window && k0 <= last_pos - p.window);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float val = s[i][j] * p.scale2;
        if (need_mask) {
          const int kpos = k0 + tx + FT * j;
          if ((p.causal && kpos > qpos[i]) ||
              (p.has_window && kpos <= qpos[i] - p.window)) {
            val = -1e30f;
          }
          // beyond Sk, or another chunk's: not a key of this block
          if (kpos < key_lo || kpos >= key_hi) val = -INFINITY;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int w = FT / 2; w > 0; w /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
      }
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
      float* prow = psm + fma_row<RS>(ty, i) * P_LD;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float pe = exp2f(s[i][j] - m_new);
        l[i] += pe;
        prow[tx + FT * j] = pe;
      }
    }
    __syncwarp();  // P's rows are written and read by this warp alone

    // O += P V: per four keys, RS float4s of P and CD of V
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float pa[RS][4];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        float4_to(pa[i], psm + fma_row<RS>(ty, i) * P_LD + kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float va[CD / 4][4];
#pragma unroll
        for (int g = 0; g < CD / 4; ++g) {
          float4_to(va[g], vs + (kk + u) * D_LD + 64 * g + 4 * tx);
        }
#pragma unroll
        for (int i = 0; i < RS; ++i) {
#pragma unroll
          for (int g = 0; g < CD / 4; ++g) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][4 * g + e] = fmaf(pa[i][u], va[g][e], acc[i][4 * g + e]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight, even with no tile visited

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
#pragma unroll
    for (int w = FT / 2; w > 0; w /= 2) l[i] += __shfl_xor_sync(FULL, l[i], w);
  }
  const bool split = packed && (p.nchunks > 1 || p.partial);
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    int h, ii;
    if (!map_row(fma_row<RS>(ty, i), h, ii)) continue;
    if (split) {
      // partial of row (b, h, ii) for this chunk: acc, then m and l
      const long long row =
          ((static_cast<long long>(chunk) * p.batch + b) * p.hq + h) * p.sq +
          ii;
      float* dst = p.part + row * (p.d + 2);
#pragma unroll
      for (int g = 0; g < CD / 4; ++g) {
        const int c = 64 * g + 4 * tx;
        if (c < p.d) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[c + e] = acc[i][4 * g + e];
        }
      }
      if (tx == 0) {
        dst[p.d] = m[i];
        dst[p.d + 1] = l[i];
      }
    } else {
      const float inv_l = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      float* dst = static_cast<float*>(p.o) + b * p.ob + h * p.oh + ii * p.os;
#pragma unroll
      for (int g = 0; g < CD / 4; ++g) {
        const int c = 64 * g + 4 * tx;
        if (c >= p.d) continue;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = acc[i][4 * g + e] * inv_l;
        if ((reinterpret_cast<unsigned long long>(dst + c) & 15) == 0) {
          *reinterpret_cast<float4*>(dst + c) =
              make_float4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[c + e] = w[e];
        }
      }
    }
  }
}

template <int DT, int RS, int BK, int STAGES, int MINB = 1>
int launch_fma(const Params& p, cudaStream_t stream) {
  using Tile = FmaTile<DT, RS, BK, STAGES>;
  const int smem = static_cast<int>(Tile::SMEM);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fma32_kernel<DT, RS, BK, STAGES, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (p.chunk > 0) {
    grid = dim3(p.nchunks, p.hkv * p.row_blocks, p.batch);
  } else {
    grid = dim3((p.sq + Tile::BQ - 1) / Tile::BQ, p.hq, p.batch);
  }
  flash_fma32_kernel<DT, RS, BK, STAGES, MINB>
      <<<grid, F_THREADS, smem, stream>>>(p);
  return launch_combine<float>(p, stream);
}

// Prefill: 64 query rows a block (4 a thread), 64-key tiles (32 at
// D = 256) in a 2-stage ring; at D = 64, two blocks an SM (128 registers,
// 104 KB), which ran 6 % faster on the H100 than one block of 128 rows
// (8 a thread, 210 registers). Decode: 16 packed rows a block (1 a
// thread) and a 3-stage ring, so a 128-key chunk of 64-key tiles is in
// flight whole from the start.
template <typename T>
int launch_fma_d(const Params& p, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "the FMA kernel is f32's");
  const bool decode = p.chunk > 0;
  if (p.d <= 64) {
    return decode ? launch_fma<64, 1, 64, 3>(p, stream)
                  : launch_fma<64, 4, 64, 2, 2>(p, stream);
  }
  if (p.d <= 128) {
    return decode ? launch_fma<128, 1, 64, 3>(p, stream)
                  : launch_fma<128, 4, 64, 2>(p, stream);
  }
  return decode ? launch_fma<256, 1, 32, 3>(p, stream)
                : launch_fma<256, 4, 32, 2>(p, stream);
}

}  // namespace

// O = attention(Q, K, V) for `batch` x `hq` query heads over `hkv` kv
// heads: q and o (batch, hq, sq, d), k and v (batch, hkv, sk, d), each at
// (batch, head, seq) strides in elements with a unit stride along d;
// d <= 256 and a multiple of 8. chunk > 0 selects the packed decode with
// `nchunks` chunks of `chunk` keys, and part holds nchunks x batch x hq x
// sq x (d + 2) f32 partials when nchunks > 1; aligned says every operand
// row lies on 16 bytes (the decode's bulk and cp.async copies; the
// prefill asks of each operand whether TMA takes it). f32 runs the FMA
// kernel and, for split keys, flash_combine_kernel; bf16 and f16 run
// flash_wgmma_kernel for a prefill (chunk 0) and flash_decode_kernel,
// one launch, for a decode (ROWS packed decode rows a block either way).
// Returns the first error of a launch that is not cudaSuccess, else 0.
//
// NAME_partial is the packed decode's first half alone for one query row
// (sq == 1, sk >= 1, else cudaErrorInvalidValue; no mask, no window), in
// chunks of DECODE_CHUNK keys: every one of the nchunks chunks leaves its
// partial in part, which is nchunks x batch x hq x (d + 2) f32: the
// unnormalised accumulator, then m (base 2) and l. A chunk wholly past sk
// reads no key and leaves acc = 0, l = 0 and m at the -1e30 sentinel,
// so it weighs nothing in a merge with any chunk that holds a key. One
// launch. Its bound is bytes: the sk keys' K and V rows and q read once,
// the partials written once.
//
// NAME_combine is the second half: it merges the nchunks chunks of each
// of the batch x hq x sq rows of part, in chunk order, into o (at its
// strides, unit along d). One launch; bound by bytes, the partials read
// once and o written once. A decode whose keys are split across callers
// (ranks of a mesh, each with its own key range) runs NAME_partial on
// each range and NAME_combine over their partials laid end to end; where
// every range starts on a multiple of the chunk, the chunks and their
// order are those of NAME on the whole range, and so are the output's
// bits.
#define FLASH_ENTRY(NAME, T, ROWS, LAUNCH)                                   \
  int NAME(const T* q, long long qb, long long qh, long long qs, const T* k, \
           long long kb, long long kh, long long ks, const T* v,             \
           long long vb, long long vh, long long vs, T* o, long long ob,     \
           long long oh, long long os, int batch, int hq, int hkv, int sq,   \
           int sk, int d, float scale, int causal, int has_window,           \
           int window, float* part, int chunk, int nchunks, int aligned,     \
           cudaStream_t stream) {                                            \
    Params p{q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, os,    \
             part, batch, hq, hkv, hq / hkv, sq, sk, d, scale * LOG2E,       \
             causal, has_window, window, chunk, nchunks,                     \
             chunk > 0 ? ((hq / hkv) * sq + ROWS - 1) / ROWS : 1, aligned,   \
             0};                                                             \
    return LAUNCH<T>(p, stream);                                             \
  }                                                                          \
  int NAME##_partial(const T* q, long long qb, long long qh, long long qs,   \
                     const T* k, long long kb, long long kh, long long ks,   \
                     const T* v, long long vb, long long vh, long long vs,   \
                     int batch, int hq, int hkv, int sq, int sk, int d,      \
                     float scale, float* part, int nchunks, int aligned,     \
                     cudaStream_t stream) {                                  \
    if (sq != 1 || sk < 1) return static_cast<int>(cudaErrorInvalidValue);   \
    Params p{q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, nullptr, 0, 0, 0, \
             part, batch, hq, hkv, hq / hkv, sq, sk, d, scale * LOG2E,       \
             1, 0, 0, DECODE_CHUNK, nchunks,                                 \
             ((hq / hkv) * sq + ROWS - 1) / ROWS, aligned, 1};               \
    return LAUNCH<T>(p, stream);                                             \
  }                                                                          \
  int NAME##_combine(const float* part, T* o, long long ob, long long oh,    \
                     long long os, int batch, int hq, int sq, int d,         \
                     int nchunks, cudaStream_t stream) {                     \
    Params p{nullptr, 0, 0, 0, nullptr, 0, 0, 0, nullptr, 0, 0, 0, o, ob,   \
             oh, os, const_cast<float*>(part), batch, hq, 1, hq, sq, 0, d,   \
             0.f, 0, 0, 0, 1, nchunks, 1, 0, 0};                             \
    return launch_merge<T>(p, stream);                                       \
  }

extern "C" {

FLASH_ENTRY(flash_f32, float, F_DECODE_ROWS, launch_fma_d)
FLASH_ENTRY(flash_bf16, __nv_bfloat16, DC_ROWS, launch_half)
FLASH_ENTRY(flash_f16, __half, DC_ROWS, launch_half)

// Which operands a bf16 or f16 prefill with these arguments loads by TMA:
// bit 0 Q, bit 1 K, bit 2 V; the producer warpgroup's threads copy the
// others into the same tiles. 0 where the driver has no
// cuTensorMapEncodeTiled (and the prefill would not launch).
int flash_prefill_tma_operands(const __nv_bfloat16* q, long long qb,
                               long long qh, long long qs,
                               const __nv_bfloat16* k, long long kb,
                               long long kh, long long ks,
                               const __nv_bfloat16* v, long long vb,
                               long long vh, long long vs, int batch, int hq,
                               int hkv, int sq, int sk, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 0;
  const Params p{q,  qb, qh,      qs,      k,  kb, kh, ks, v, vb, vh, vs,
                 nullptr, 0, 0, 0, nullptr, batch, hq, hkv, hq / hkv, sq,
                 sk, d,  0.f, 0, 0, 0, 0, 0, 1, 0, 0};
  CUtensorMap q_map{}, k_map{}, v_map{};
  if (d <= 64) return pf_tma<__nv_bfloat16, 64>(encode, p, &q_map, &k_map, &v_map);
  if (d <= 128) return pf_tma<__nv_bfloat16, 128>(encode, p, &q_map, &k_map, &v_map);
  return pf_tma<__nv_bfloat16, 256>(encode, p, &q_map, &k_map, &v_map);
}

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
