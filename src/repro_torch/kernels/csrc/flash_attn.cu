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
// contribution would have been rescaled to exactly zero.
//
// What bounds it on the H100: for prefill, operations. At the serving
// path's q (4, 32, 2048, 64) and kv (4, 4, 2048, 64) in bf16, causal, the
// two products take 4 B Hq S^2 D operations, half of them under the mask:
// 68.7 GFLOP against 75.5 MB of q, k, v and o, so 69 us at the 989
// TFLOP/s bf16 tensor-core peak and 23 us at 3.35 TB/s. For decode (Sq = 1
// over a cache prefix), bytes: 8.4 MB of cache at 2048 keys is 2.5 us, the
// arithmetic a thousandth of that.
//
// What the design does about it, bf16 and f16 (flash_tc_kernel):
//  * Both products on the tensor cores, mma.sync m16n8k16 with f32
//    accumulators, operands fetched from shared memory by ldmatrix (K
//    plain, V transposed). mma.sync rather than wgmma: a 16-row warp tile
//    keeps the online softmax in each warp's registers, P goes from the
//    S accumulators into the A operand of P V without touching shared
//    memory, and at D = 64 a 64-row block already has 3-4 blocks a SM
//    in flight; the warpgroup-wide wgmma, with its shared-memory
//    descriptors, is left to a later change if the kernel stays far from
//    its bound.
//  * A block is 4 warps and 64 query rows, 16 a warp; Q stays in
//    registers as A fragments for the whole key loop (D <= 128; at
//    D = 256 it would take 64 of them, so there Q is re-read from shared
//    memory each tile).
//  * K and V tiles of 64 keys stay in their own dtype in shared memory,
//    rows XOR-swizzled by 16-byte chunk so ldmatrix is conflict-free,
//    double-buffered with cp.async: the next tile's copy is in flight
//    while the current one is multiplied (operands whose rows do not
//    start on 16 bytes are copied element by element instead).
//  * Prefill blocks walk the causal grid heaviest first.
//  * Decode (Sq <= 16): one block serves one (batch, kv head) and packs
//    the rows of every query head of its GQA group (tinyllama: 8 heads
//    x 1 row), so a kv head's prefix is read once, not once per query
//    head. The keys are split into chunks of a fixed 128 keys across
//    blocks (at tinyllama's 4 x 4 kv heads over 2048 keys, 256 blocks
//    for the 132 SMs); each block leaves its partial (m, l, unnormalised
//    accumulator) in f32 scratch, and flash_combine_kernel merges the
//    chunks of each row in a fixed order (no atomics). A row's arithmetic
//    depends on Sk alone, not on the batch, the head count or the card,
//    so its output is the same from run to run and at any batch size
//    (the wrapper picks the chunks). A fully masked row has m = -1e30
//    in every chunk, so the combine weights the chunks by their l alone
//    and returns the mean of V over all Sk keys. One call is one launch,
//    or two when the keys are split.
// The softmax works in base 2 (scores scaled by scale * log2 e, exp2f),
// which moves p by a few f32 ulps before its rounding to V's dtype.
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
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores

constexpr int MQ = 64;           // query rows per block, 16 per warp
constexpr int NK = 64;           // keys per tile
constexpr int TC_THREADS = 128;  // 4 warps
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// Copy 8 elements (16 bytes) from g to shared s, or zeros when !pred.
// aligned: cp.async, asynchronous; otherwise element by element.
template <typename T>
__device__ __forceinline__ void copy16(T* s, const T* g, bool pred,
                                       bool aligned) {
  if (aligned) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(g), "r"(n));
  } else {
    T tmp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) tmp[j] = pred ? g[j] : T(0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = tmp[j];
  }
}

// Element offset of 16-byte chunk c of row r in a [rows][DT] tile whose
// chunks are XOR-swizzled by the row, so the 8 rows an ldmatrix reads
// fall in 8 different bank groups.
template <int DT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DT + ((c ^ (r & 7)) << 3);
}

// Block (x, y, z): prefill, query rows [64 (X - 1 - x), +64) of query
// head y of batch z (X = gridDim.x, heaviest tiles first); decode, key
// chunk x of kv head y / row_blocks of batch z, packed rows
// [64 (y % row_blocks), +64) of that head's group (row r is row r % sq
// of query head kvh * group + r / sq).
template <typename T, int DT>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const Params p) {
  constexpr bool QREG = DT <= 128;  // Q fragments held in registers
  constexpr int KS = DT / 16;       // 16-wide steps along D
  constexpr int CH = DT / 8;        // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qsm = reinterpret_cast<T*>(smem_raw);
  T* ksm = qsm + MQ * DT;  // [2][NK][DT]
  T* vsm = ksm + 2 * NK * DT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
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
    q0 = (gridDim.x - 1 - blockIdx.x) * MQ;
  }
  const int off = p.sk - p.sq;
  const int packed_rows = p.group * p.sq;
  // block row r -> (query head h, query row i); false past the last row
  auto map_row = [&](int r, int& h, int& i) -> bool {
    if (packed) {
      const int rr = rb * MQ + r;
      h = kvh * p.group + rr / p.sq;
      i = rr % p.sq;
      return rr < packed_rows;
    }
    h = hfix;
    i = q0 + r;
    return i < p.sq;
  };

  const T* qg = static_cast<const T*>(p.q) + b * p.qb;
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;
  const bool aligned = p.aligned != 0;

  // Q tile, zero past the last row and past d
  for (int e = tid; e < MQ * CH; e += TC_THREADS) {
    const int r = e / CH, c = e % CH;
    int h, i;
    const bool ok = map_row(r, h, i) && c * 8 < p.d;
    const T* src = ok ? qg + h * p.qh + i * p.qs + c * 8 : qg;
    copy16(qsm + swz<DT>(r, c), src, ok, aligned);
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
    last_pos = min(q0 + MQ, p.sq) - 1 + off;
  }
  int kt0 = key_lo / NK;
  int kt1 = (key_hi + NK - 1) / NK;
  if (p.causal && first_pos >= 0) {
    kt1 = min(kt1, last_pos / NK + 1);
    if (p.has_window && first_pos - p.window + 1 > 0) {
      kt0 = max(kt0, (first_pos - p.window + 1) / NK);
    }
  }

  auto load_kv = [&](int kt, int buf) {
    T* kd = ksm + buf * NK * DT;
    T* vd = vsm + buf * NK * DT;
    const int k0 = kt * NK;
    for (int e = tid; e < NK * CH; e += TC_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r >= key_lo && k0 + r < key_hi && c * 8 < p.d;
      const long long row = ok ? k0 + r : 0;
      copy16(kd + swz<DT>(r, c), ok ? kg + row * p.ks + c * 8 : kg, ok,
             aligned);
      copy16(vd + swz<DT>(r, c), ok ? vg + row * p.vs + c * 8 : vg, ok,
             aligned);
    }
    cp_async_commit();
  };

  const int wr = warp * 16;  // this warp's first block row
  int hA, iA, hB, iB;
  const bool okA = map_row(wr + g, hA, iA);
  const bool okB = map_row(wr + g + 8, hB, iB);
  int h0, i0;
  const bool warp_live = map_row(wr, h0, i0);
  const int qposA = iA + off, qposB = iB + off;

  float m[2] = {-1e30f, -1e30f};  // running max, base-2 domain
  float l[2] = {0.f, 0.f};        // this lane's share of the row sums
  float acc[DT / 8][4];
#pragma unroll
  for (int j = 0; j < DT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint32_t qf[QREG ? KS : 1][4];
  if (kt0 < kt1) load_kv(kt0, 0);
  cp_async_wait<1>();  // Q has landed (the first tile may still fly)
  __syncthreads();
  if (QREG) {
#pragma unroll
    for (int s = 0; s < (QREG ? KS : 1); ++s) {
      const int mi = lane >> 3;
      ldsm_x4(qf[s], qsm + swz<DT>(wr + (lane & 7) + (mi & 1) * 8,
                                   2 * s + (mi >> 1)));
    }
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const T* kt_s = ksm + buf * NK * DT;
      const T* vt_s = vsm + buf * NK * DT;
      const int k0 = kt * NK;
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float s[NK / 8][4];
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if (QREG) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[x] = qf[QREG ? ks : 0][x];
        } else {
          const int mi = lane >> 3;
          ldsm_x4(a, qsm + swz<DT>(wr + (lane & 7) + (mi & 1) * 8,
                                   2 * ks + (mi >> 1)));
        }
#pragma unroll
        for (int np = 0; np < NK / 16; ++np) {
          uint32_t bk[4];
          const int mi = lane >> 3;
          ldsm_x4(bk, kt_s + swz<DT>(16 * np + (lane & 7) + (mi >> 1) * 8,
                                     2 * ks + (mi & 1)));
          Mma<T>::run(s[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
          Mma<T>::run(s[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
        }
      }
      // scale, mask, online softmax (rows A = g and B = g + 8)
      const bool need_mask =
          k0 < key_lo || k0 + NK > key_hi ||
          (p.causal && k0 + NK - 1 > first_pos) ||
          (p.has_window && k0 <= last_pos - p.window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[j][e] * p.scale2;
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            const int qpos = e < 2 ? qposA : qposB;
            if ((p.causal && kpos > qpos) ||
                (p.has_window && kpos <= qpos - p.window)) {
              val = -1e30f;
            }
            // beyond Sk, or another chunk's: not a key of this block
            if (kpos < key_lo || kpos >= key_hi) val = -INFINITY;
          }
          s[j][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += pe;
          s[j][e] = pe;
        }
      }
      // O += P V, P rounded to V's dtype as the A operand
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        const uint32_t a0 = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        const uint32_t a1 = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        const uint32_t a2 = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const uint32_t a3 = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DT / 16; ++dp) {
          uint32_t bv[4];
          const int mi = lane >> 3;
          ldsm_x4_t(bv, vt_s + swz<DT>(16 * kk + (lane & 7) + (mi & 1) * 8,
                                       2 * dp + (mi >> 1)));
          Mma<T>::run(acc[2 * dp], a0, a1, a2, a3, bv[0], bv[1]);
          Mma<T>::run(acc[2 * dp + 1], a0, a1, a2, a3, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are free for the next copy
  }
  cp_async_wait<0>();  // nothing left in flight, even with no tile visited

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const bool split = packed && p.nchunks > 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = r == 0 ? okA : okB;
    if (!ok) continue;
    const int h = r == 0 ? hA : hB;
    const int i = r == 0 ? iA : iB;
    if (split) {
      // partial of row (b, h, i) for this chunk: acc, then m and l
      const long long row =
          ((static_cast<long long>(chunk) * p.batch + b) * p.hq + h) * p.sq + i;
      float* dst = p.part + row * (p.d + 2);
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < p.d) {
          dst[c] = acc[j][2 * r];
          dst[c + 1] = acc[j][2 * r + 1];
        }
      }
      if (tq == 0) {
        dst[p.d] = m[r];
        dst[p.d + 1] = l[r];
      }
    } else {
      const float inv_l = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* dst = static_cast<T*>(p.o) + b * p.ob + h * p.oh + i * p.os;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < p.d) {
          dst[c] = narrow<T>(acc[j][2 * r] * inv_l);
          dst[c + 1] = narrow<T>(acc[j][2 * r + 1] * inv_l);
        }
      }
    }
  }
}

// Merge the key chunks of each row: one warp a row (b, h, i), lanes over
// D. M = max of the chunks' m; each chunk weighs exp2(m_c - M); the sums
// run over the chunks in order, so the result is the same on every run.
template <typename T>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  const long long row = blockIdx.x * 4ll + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long stride = rows * (p.d + 2);
  const float* src = p.part + row * (p.d + 2);
  float mmax = -INFINITY;
  for (int c = 0; c < p.nchunks; ++c) mmax = fmaxf(mmax, src[c * stride + p.d]);
  float lsum = 0.f;
  for (int c = 0; c < p.nchunks; ++c) {
    lsum += src[c * stride + p.d + 1] * exp2f(src[c * stride + p.d] - mmax);
  }
  const float inv_l = 1.f / (lsum == 0.f ? 1.f : lsum);
  const int i = static_cast<int>(row % p.sq);
  const int h = static_cast<int>((row / p.sq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.sq) * p.hq));
  T* dst = static_cast<T*>(p.o) + b * p.ob + h * p.oh + i * p.os;
  for (int col = lane; col < p.d; col += 32) {
    float o = 0.f;
    for (int c = 0; c < p.nchunks; ++c) {
      o += src[c * stride + col] * exp2f(src[c * stride + p.d] - mmax);
    }
    dst[col] = narrow<T>(o * inv_l);
  }
}

// After a decode's chunks: cudaGetLastError() of their launch, then, when
// the keys were split, the merge's launch and its error.
template <typename T>
int launch_combine(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.chunk <= 0 || p.nchunks <= 1) {
    return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  flash_combine_kernel<T><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                            stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DT>
int launch_tc(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>((MQ + 4 * NK) * DT * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (p.chunk > 0) {
    grid = dim3(p.nchunks, p.hkv * p.row_blocks, p.batch);
  } else {
    grid = dim3((p.sq + MQ - 1) / MQ, p.hq, p.batch);
  }
  flash_tc_kernel<T, DT><<<grid, TC_THREADS, smem, stream>>>(p);
  return launch_combine<T>(p, stream);
}

template <typename T>
int launch_tc_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_tc<T, 64>(p, stream);
  if (p.d <= 128) return launch_tc<T, 128>(p, stream);
  return launch_tc<T, 256>(p, stream);
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
// +BQ) of that head's group, as in flash_tc_kernel. Thread (ty, tx) =
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
  const bool split = packed && p.nchunks > 1;
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
// row lies on 16 bytes. f32 runs the FMA kernel (ROWS packed decode rows
// a block), bf16 and f16 the tensor-core kernel. Returns the first
// cudaGetLastError() after a launch that is not cudaSuccess, else 0.
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
             chunk > 0 ? ((hq / hkv) * sq + ROWS - 1) / ROWS : 1, aligned};  \
    return LAUNCH<T>(p, stream);                                             \
  }

extern "C" {

FLASH_ENTRY(flash_f32, float, F_DECODE_ROWS, launch_fma_d)
FLASH_ENTRY(flash_bf16, __nv_bfloat16, MQ, launch_tc_d)
FLASH_ENTRY(flash_f16, __half, MQ, launch_tc_d)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
