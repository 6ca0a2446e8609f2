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
// position i + Sk - Sq (right-aligned, so decode is the same kernel);
// `causal` masks keys after it and `window` keys at or before qpos -
// window. Scores are accumulated in f32 and scaled; a masked score becomes
// the sentinel -1e30 (never -inf, so no inf - inf arises), and the running
// max m, row sum l (of the f32 probabilities) and f32 accumulator are
// rescaled per key tile. P is rounded to V's dtype before P V, as the
// Pallas kernel does; the end divides by l. Keys beyond Sk on the ragged
// edge contribute exactly nothing (p = 0), rows beyond Sq are not stored:
// there is no "halve the tile until it divides". Because masked scores
// are -1e30 and not -inf, a row whose every key is masked (causal with
// Sq > Sk) gets the mean of V over the Sk keys, which is what the Pallas
// kernel returns (its comment says zero, its arithmetic says the mean).
// Key tiles wholly past the causal diagonal, or wholly before the window,
// are skipped only in a block whose rows all see their own diagonal key:
// there a skipped tile's contribution would have been rescaled to exactly
// zero, so skipping changes nothing; a block with fully masked rows walks
// every tile.
//
// What bounds it on the H100: for prefill, operations. At the serving
// path's q (4, 32, 2048, 64) and kv (4, 4, 2048, 64) in bf16, causal, the
// two products take 4 B Hq S^2 D operations, half of them under the mask:
// 68.7 GFLOP against 75.5 MB of q, k, v and o, so 69 us at the 989
// TFLOP/s bf16 tensor-core peak and 23 us at 3.35 TB/s. For decode (Sq = 1
// over a cache prefix), bytes: 8.4 MB of cache at 2048 keys is 2.5 us, the
// arithmetic a thousandth of that.
//
// What the design does about it, for now: a simple kernel that is right.
// One block of 16 x 16 threads per (batch, query head, tile of 64 query
// rows; 16 rows when Sq <= 16), looping over tiles of 64 keys; Q, K and V
// tiles are widened to f32 in shared memory, S = Q K^T and O += P V run as
// 4 x 4 (and 4 x D/16) register tiles on the FMA pipes, the row max and
// sum are reduced across the 16 lanes that share a row by warp shuffles.
// The FMA pipes are 15x below the bf16 tensor cores the bound assumes, so
// prefill can reach at most a fifteenth of its bound; mma.sync or wgmma
// with the tiles kept in bf16 is the work of a later change. Decode has
// one useful query row per block, so it reads each K/V byte once per query
// head (8x per kv head under GQA, through L2) and wastes the rest of the
// tile; packing a GQA group's heads into one block's rows is the remedy.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

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
flash_kernel(const T* __restrict__ q, long long qb, long long qh,
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
      flash_kernel<T, RQ, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TD, TD);
  const dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  flash_kernel<T, RQ, DT><<<grid, block, smem, stream>>>(
      q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, os, group, sq,
      sk, d, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// 64-row query tiles, or 16-row tiles when Sq <= 16 (decode); the head
// dimension padded to 64, 128 or 256.
template <typename T>
int launch(const T* q, long long qb, long long qh, long long qs, const T* k,
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

}  // namespace

// O = attention(Q, K, V) for `batch` x `hq` query heads over `hkv` kv
// heads: q and o (batch, hq, sq, d), k and v (batch, hkv, sk, d), each at
// (batch, head, seq) strides in elements with a unit stride along d;
// d <= 256. Returns cudaGetLastError() right after the launch.
#define FLASH_ENTRY(NAME, T)                                                 \
  int NAME(const T* q, long long qb, long long qh, long long qs, const T* k, \
           long long kb, long long kh, long long ks, const T* v,             \
           long long vb, long long vh, long long vs, T* o, long long ob,     \
           long long oh, long long os, int batch, int hq, int hkv, int sq,   \
           int sk, int d, float scale, int causal, int has_window,           \
           int window, cudaStream_t stream) {                                \
    return launch<T>(q, qb, qh, qs, k, kb, kh, ks, v, vb, vh, vs, o, ob, oh, \
                     os, batch, hq, hkv, sq, sk, d, scale, causal,           \
                     has_window, window, stream);                            \
  }

extern "C" {

FLASH_ENTRY(flash_f32, float)
FLASH_ENTRY(flash_bf16, __nv_bfloat16)
FLASH_ENTRY(flash_f16, __half)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
