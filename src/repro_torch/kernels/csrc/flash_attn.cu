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
// f32 keeps exact f32 arithmetic on the FMA pipes (flash_fma_kernel, the
// design before this one): TF32's 10-bit mantissa would not meet the f32
// gates. One block of 16 x 16 threads per (batch, query head, tile of 64
// query rows; 16 rows when Sq <= 16), Q, K and V widened to f32 in
// shared memory, 4 x 4 register tiles.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: FMA pipes

constexpr int TD = 16;        // threads per block side
constexpr int NT = TD * TD;   // threads per block
constexpr int BK = 64;        // keys per tile
constexpr int CK = BK / TD;   // key columns per thread
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float widen(T v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

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

// Shared memory, in floats, of one block: Q^T (DT x BQ+1), K^T (DT x BK+1),
// V (BK x DT), P^T (BK x BQ+1). The +1 columns keep the transposed stores
// free of bank conflicts.
template <int RQ, int DT>
constexpr size_t smem_floats() {
  return static_cast<size_t>(DT) * (RQ * TD + 1) + DT * (BK + 1) + BK * DT +
         BK * (RQ * TD + 1);
}

// Block (x, y, z) computes rows [BQ x, BQ x + BQ) of query head y of batch
// z, BQ = 16 RQ. Thread (tx, ty) owns rows ty + 16 i (i < RQ), key columns
// tx + 16 j of each tile and output columns tx + 16 j (j < DT / 16).
template <typename T, int RQ, int DT>
__global__ void __launch_bounds__(NT)
flash_fma_kernel(const T* __restrict__ q, long long qb, long long qh,
             long long qs, const T* __restrict__ k, long long kb,
             long long kh, long long ks, const T* __restrict__ v,
             long long vb, long long vh, long long vs, T* __restrict__ o,
             long long ob, long long oh, long long os, int group, int sq,
             int sk, int d, float scale, int causal, int has_window,
             int window) {
  constexpr int BQ = RQ * TD;
  constexpr int CD = DT / TD;  // output columns per thread
  extern __shared__ float smem[];
  float* qsm = smem;                   // [DT][BQ + 1]
  float* ksm = qsm + DT * (BQ + 1);    // [DT][BK + 1]
  float* vsm = ksm + DT * (BK + 1);    // [BK][DT]
  float* psm = vsm + BK * DT;          // [BK][BQ + 1]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TD + tx;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  q += blockIdx.z * qb + h * qh;
  k += blockIdx.z * kb + (h / group) * kh;
  v += blockIdx.z * vb + (h / group) * vh;
  o += blockIdx.z * ob + h * oh;
  const int off = sk - sq;  // position of query row i is i + off

  for (int e = tid; e < BQ * DT; e += NT) {
    const int r = e / DT;
    const int c = e % DT;
    const int gr = q0 + r;
    qsm[c * (BQ + 1) + r] =
        (gr < sq && c < d) ? widen<T>(q[gr * qs + c]) : 0.f;
  }

  // Key tiles to visit. Only where every row of the block has its own
  // diagonal key (causal, first position >= 0) may tiles be skipped.
  int kt0 = 0;
  int kt1 = (sk + BK - 1) / BK;
  const int first_pos = q0 + off;
  if (causal && first_pos >= 0) {
    const int last_pos = min(q0 + BQ, sq) - 1 + off;
    kt1 = min(kt1, last_pos / BK + 1);
    if (has_window && first_pos - window + 1 > 0) {
      kt0 = (first_pos - window + 1) / BK;
    }
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BK * DT; e += NT) {
      const int c = e / DT;
      const int dd = e % DT;
      const int gk = k0 + c;
      const bool in = gk < sk && dd < d;
      ksm[dd * (BK + 1) + c] = in ? widen<T>(k[gk * ks + dd]) : 0.f;
      vsm[c * DT + dd] = in ? widen<T>(v[gk * vs + dd]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float a[RQ], b[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qsm[dd * (BQ + 1) + ty + TD * i];
#pragma unroll
      for (int j = 0; j < CK; ++j) b[j] = ksm[dd * (BK + 1) + tx + TD * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty + TD * i + off;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + TD * j;
        float val = s[i][j] * scale;
        if ((causal && kpos > qpos) || (has_window && kpos <= qpos - window)) {
          val = NEG_INF;
        }
        if (kpos >= sk) val = -INFINITY;  // ragged edge: not a key at all
        s[i][j] = val;
        mc = fmaxf(mc, val);
      }
#pragma unroll
      for (int w = TD / 2; w > 0; w /= 2) {
        mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, w, TD));
      }
      const float m_new = fmaxf(m[i], mc);
      const float corr = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + TD * j;
        const float p = (k0 + c < sk) ? expf(s[i][j] - m_new) : 0.f;
        ls += p;
        psm[c * (BQ + 1) + ty + TD * i] = widen<T>(narrow<T>(p));
      }
#pragma unroll
      for (int w = TD / 2; w > 0; w /= 2) {
        ls += __shfl_xor_sync(FULL, ls, w, TD);
      }
      l[i] = l[i] * corr + ls;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = psm[kk * (BQ + 1) + ty + TD * i];
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        const float vv = vsm[kk * DT + tx + TD * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + TD * i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const int c = tx + TD * j;
      if (c < d) o[row * os + c] = narrow<T>(acc[i][j] / li);
    }
  }
}

template <typename T, int RQ, int DT>
int launch_tile(const T* q, long long qb, long long qh, long long qs,
                const T* k, long long kb, long long kh, long long ks,
                const T* v, long long vb, long long vh, long long vs, T* o,
                long long ob, long long oh, long long os, int batch, int hq,
                int group, int sq, int sk, int d, float scale, int causal,
                int has_window, int window, cudaStream_t stream) {
  constexpr int BQ = RQ * TD;
  const int smem = static_cast<int>(sizeof(float) * smem_floats<RQ, DT>());
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<T, RQ, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TD, TD);
  const dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  flash_fma_kernel<T, RQ, DT><<<grid, block, smem, stream>>>(
      q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, os, group, sq,
      sk, d, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// f32: 64-row query tiles, or 16-row tiles when Sq <= 16 (decode); the
// head dimension padded to 64, 128 or 256.
template <typename T>
int launch_fma(const T* q, long long qb, long long qh, long long qs, const T* k,
           long long kb, long long kh, long long ks, const T* v,
           long long vb, long long vh, long long vs, T* o, long long ob,
           long long oh, long long os, int batch, int hq, int hkv, int sq,
           int sk, int d, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  const int group = hq / hkv;
#define FLASH_ARGS                                                        \
  q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, os, batch, hq,  \
      group, sq, sk, d, scale, causal, has_window, window, stream
  const bool small = sq <= TD;
  if (d <= 64) {
    return small ? launch_tile<T, 1, 64>(FLASH_ARGS)
                 : launch_tile<T, 4, 64>(FLASH_ARGS);
  }
  if (d <= 128) {
    return small ? launch_tile<T, 1, 128>(FLASH_ARGS)
                 : launch_tile<T, 4, 128>(FLASH_ARGS);
  }
  return small ? launch_tile<T, 1, 256>(FLASH_ARGS)
               : launch_tile<T, 4, 256>(FLASH_ARGS);
#undef FLASH_ARGS
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
  int row_blocks;  // decode: ceil(group * sq / MQ)
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
  err = cudaGetLastError();
  if (err != cudaSuccess || p.chunk <= 0 || p.nchunks <= 1) {
    return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  flash_combine_kernel<T><<<static_cast<unsigned>((rows + 3) / 4), 128, 0,
                            stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 64) return launch_tc<T, 64>(p, stream);
  if (p.d <= 128) return launch_tc<T, 128>(p, stream);
  return launch_tc<T, 256>(p, stream);
}

}  // namespace

// O = attention(Q, K, V) for `batch` x `hq` query heads over `hkv` kv
// heads: q and o (batch, hq, sq, d), k and v (batch, hkv, sk, d), each at
// (batch, head, seq) strides in elements with a unit stride along d;
// d <= 256 and a multiple of 8. bf16/f16 only: chunk > 0 selects the
// packed decode with `nchunks` chunks of `chunk` keys, and part holds
// nchunks x batch x hq x sq x (d + 2) f32 partials when nchunks > 1;
// aligned says every operand row lies on 16 bytes. Returns the first
// cudaGetLastError() after a launch that is not cudaSuccess, else 0.
#define FLASH_TC_ENTRY(NAME, T)                                              \
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
             chunk > 0 ? ((hq / hkv) * sq + MQ - 1) / MQ : 1, aligned};      \
    return launch_tc_d<T>(p, stream);                                        \
  }

extern "C" {

// f32: the FMA kernel; part, chunk, nchunks and aligned are not used.
int flash_f32(const float* q, long long qb, long long qh, long long qs,
              const float* k, long long kb, long long kh, long long ks,
              const float* v, long long vb, long long vh, long long vs,
              float* o, long long ob, long long oh, long long os, int batch,
              int hq, int hkv, int sq, int sk, int d, float scale,
              int causal, int has_window, int window, float* part, int chunk,
              int nchunks, int aligned, cudaStream_t stream) {
  return launch_fma<float>(q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o,
                           ob, oh, os, batch, hq, hkv, sq, sk, d, scale,
                           causal, has_window, window, stream);
}

FLASH_TC_ENTRY(flash_bf16, __nv_bfloat16)
FLASH_TC_ENTRY(flash_f16, __half)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
