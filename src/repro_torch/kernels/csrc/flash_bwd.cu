// The gradient of B6: dQ, dK and dV of <dO, O> for O = flash attention's
// output (flash_attn.cu), by the usual recompute design.
//
// Replaces: no TPU kernel. The reference's Pallas flash kernel
// (src/repro/kernels/flash_attn.py:79) has no backward: the reference
// trains by differentiating its jnp attention (src/repro/models/
// attention.py: _sdpa, _blockwise, _local) under jax.checkpoint. On the
// card the port's attention is the kernel, so its training needs the
// gradient as a kernel too; before this file it was autograd through the
// plain version, which builds the (B, Hq, Sq, Sk) f32 scores.
//
// What it computes, for q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), O and
// dO like q, each at its own (batch, head, seq) strides with a unit stride
// along D; query head h reads kv head h / (Hq / Hkv); query row i sits at
// position i + Sk - Sq. From the forward it takes O and each row's base-2
// log-sum-exp lse = m + log2 l (flash_attn.cu's prefill epilogues write
// it under autograd). With s = q . k * scale * log2(e) in f32:
//  * P = exp2(s - lse) where the key is seen, 0 where the causal or window
//    mask hides it. A row that sees no key (causal, position < 0) got the
//    mean of V in the forward (every score the -1e30 sentinel), so its P is
//    1 / Sk on every key and none of its scores carries a gradient;
//  * Delta_i = sum_d dO_id O_id, f32 (flash_bwd_delta_kernel);
//  * dV_j = sum_i P_ij dO_i, P rounded to T first (the tensor cores take
//    T; the plain version rounds it too);
//  * dP = dO V^T and dS = P (dP - Delta) in f32, 0 where masked or in a
//    row that sees no key; dS rounded to T for its products in bf16/f16;
//  * dQ = scale dS K, dK = scale dS^T Q, each summed in f32 and rounded
//    once to T. dK and dV sum the query heads of their kv head's group
//    inside one block: no atomics, and the same bits from run to run.
// ref.flash_attention_backward_ref is this arithmetic in plain PyTorch.
//
// What bounds it on the H100: operations. The gradient needs five
// products of 2 D operations a seen (row, key) pair (S, dP, dV, dK, dQ);
// at tinyllama's training shape (q (4, 32, 2048, 64), kv (4, 4, 2048, 64)
// bf16, causal: 268.6 M pairs) that is 171.9 GFLOP, 0.174 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 151 MB of q, k, v, O, dO and the
// three gradients, 0.045 ms at 3.35 TB/s. These kernels run seven: S and
// dP are computed twice, once for dK and dV (a block owns keys) and once
// for dQ (a block owns query rows), so that no sum crosses blocks.
//
// Design: simple and right first; wgmma and TMA are later work.
//  * flash_bwd_delta_kernel<T>: a warp a row, bound by bytes.
//  * flash_bwd_dkdv_kernel<T, DT> (bf16, f16; DT the head dimension padded
//    to 64, 128 or 256): a block owns 64 keys (32 at DT = 256) of one
//    (batch, kv head), K and V resident in shared memory. It walks the
//    64-row query tiles of every query head of the group, skipping a tile
//    only where every pair is masked and every row sees a key (then P and
//    dS are exactly 0 there); Q, dO and the rows' lse and Delta pass
//    through a 2-stage cp.async ring. A warp owns 16 keys: S^T = K Q^T
//    and dP^T = V dO^T on mma.sync m16n8k16, whose f32 accumulators are,
//    packed to T, the A fragments of dV += P^T dO and dK += dS^T Q (dO and
//    Q by ldmatrix.trans). A warp holds 64 columns of dK and dV: at DT = 128
//    and 256 two or four warps share 16 keys, each with its own columns,
//    and each computes the keys' S^T and dP^T itself.
//  * flash_bwd_dq_kernel<T, DT>: a block owns 64 query rows (32 at DT =
//    256) of one (batch, head), heaviest first; K and V tiles of 64 keys
//    pass through a 2-stage ring, limited to the tiles a seen key lies in.
//    A warp owns 16 rows: S = Q K^T and dP = dO V^T, then dQ += dS K with
//    K by ldmatrix.trans, 64 columns of dQ a warp as above.
//  * f32 (flash_bwd_dkdv_fma_kernel<DT>, flash_bwd_dq_fma_kernel<DT>): the
//    same blocks and walks on the FMA pipes in exact f32 (no TF32, so the
//    f32 card-against-CPU training gate holds), 16 x 16 threads, each with
//    a few rows by a few keys of S and dP and a few rows by D / 16 columns
//    of the gradients; P and dS pass between the two steps through shared
//    memory, every tile padded to an odd pitch so that a half-warp's
//    column of reads falls on distinct banks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  long long qb, qh, qs;
  const void* k;
  long long kb, kh, ks;
  const void* v;
  long long vb, vh, vs;
  const void* o;
  long long ob, oh, os;
  const void* g;  // dO
  long long gb, gh, gs;
  void* dq;
  long long dqb, dqh, dqs;
  void* dk;
  long long dkb, dkh, dks;
  void* dv;
  long long dvb, dvh, dvs;
  const float* lse;  // (batch, hq, sq): the forward's m + log2 l
  float* delta;      // (batch, hq, sq): sum_d dO O, written here
  int batch, hq, hkv, group, sq, sk, d;
  float scale, scale2;  // scale and scale * log2(e)
  int causal, has_window, window;
  int aligned;  // q, k, v and dO rows all start on 16 bytes
};

template <typename T>
__device__ __forceinline__ float wide(T x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float wide<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float wide<__half>(__half x) {
  return __half2float(x);
}

__device__ __forceinline__ unsigned shared_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// P and dS of one (row, key) pair, in place of its raw score s = q . k and
// dp = dO . v: row_ok false for a row past sq; qpos the row's position.
__device__ __forceinline__ void grad_pair(const BwdParams& p, bool row_ok,
                                          int qpos, int kpos, float lse,
                                          float delta, float inv_sk,
                                          float& s, float& dp) {
  float pr = 0.f, ds = 0.f;
  if (row_ok && kpos < p.sk) {
    if (p.causal && qpos < 0) {
      pr = inv_sk;  // a row that sees no key: the mean of V
    } else if (!((p.causal && kpos > qpos) ||
                 (p.has_window && kpos <= qpos - p.window))) {
      pr = exp2f(s * p.scale2 - lse);
      ds = pr * (dp - delta);
    }
  }
  s = pr;
  dp = ds;
}

// Delta of every row, one warp a row (8 a block).
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdParams p) {
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  const long long row = blockIdx.x * 8ll + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % p.sq);
  const int h = static_cast<int>((row / p.sq) % p.hq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.sq) * p.hq));
  const T* o = static_cast<const T*>(p.o) + b * p.ob + h * p.oh + i * p.os;
  const T* g = static_cast<const T*>(p.g) + b * p.gb + h * p.gh + i * p.gs;
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) acc = fmaf(wide(g[c]), wide(o[c]), acc);
#pragma unroll
  for (int x = 16; x > 0; x /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) p.delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 / f16: mma.sync m16n8k16

// 8 elements (16 bytes) of a row from g into shared s, zeros where !ok:
// one cp.async where every row lies on 16 bytes, else 2-byte loads (done
// when this returns). g is a valid address either way.
template <typename T>
__device__ __forceinline__ void copy8(T* s, const T* g, bool ok, bool aligned) {
  if (aligned) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     shared_u32(s)),
                 "l"(g), "r"(ok ? 16 : 0));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = ok ? g[e] : narrow<T>(0.f);
  }
}

// Rows [row0, row0 + R) of an operand (row r at g + r * rs) into a tile of
// rows LD elements apart, DT columns, zeros past `rows` and past d.
template <typename T, int R, int DT, int LD, int THREADS>
__device__ __forceinline__ void load_rows(T* tile, const T* g, long long rs,
                                          int row0, int rows, int d,
                                          bool aligned) {
  constexpr int CH = DT / 8;
#pragma unroll 2
  for (int e = threadIdx.x; e < R * CH; e += THREADS) {
    const int r = e / CH, c = 8 * (e % CH);
    const bool ok = row0 + r < rows && c < d;
    copy8<T>(tile + r * LD + c, ok ? g + (row0 + r) * rs + c : g, ok, aligned);
  }
}

// A warp's 16 rows of A (rows row0.., columns col0..) from a tile of rows
// LD elements apart: its m16n8k16 A fragment.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], unsigned tile,
                                       int row0, int col0, int lane) {
  const int mi = lane / 8;
  ldsm_x4(r, tile + 2 * ((row0 + (lane & 7) + (mi & 1) * 8) * LD + col0 +
                         8 * (mi >> 1)));
}
// B fragments of two n-tiles (n0.., n0 + 8..) over k-step k0.. where the
// tile stores B transposed (row n, column k): registers 0-1 the first
// n-tile's, 2-3 the second's.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], unsigned tile, int n0,
                                       int k0, int lane) {
  const int mi = lane / 8;
  ldsm_x4(r, tile + 2 * ((n0 + (lane & 7) + (mi >> 1) * 8) * LD + k0 +
                         8 * (mi & 1)));
}
// The same where the tile stores B as it is (row k, column n).
template <int LD>
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4], unsigned tile,
                                         int n0, int k0, int lane) {
  const int mi = lane / 8;
  ldsm_x4_t(r, tile + 2 * ((k0 + (lane & 7) + (mi & 1) * 8) * LD + n0 +
                           8 * (mi >> 1)));
}

// C tiles 2 kk and 2 kk + 1 of a 16-row accumulator, packed to T: the A
// fragment of its k-step kk.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

template <int DT>
struct DkdvTile {
  static constexpr int SPLIT = DT / 64;         // warps sharing 16 keys
  static constexpr int KG = DT == 256 ? 2 : 4;  // 16-key groups a block
  static constexpr int KEYS = 16 * KG;
  static constexpr int THREADS = 32 * KG * SPLIT;
  static constexpr int BQ = 64;      // query rows a tile
  static constexpr int LD = DT + 8;  // 16 bytes of pad: ldmatrix conflict-free
  static constexpr int KV = KEYS * LD;
  static constexpr int QT = BQ * LD;
  // a ring stage: the Q tile, the dO tile, then the rows' lse and Delta
  static constexpr size_t STAGE = 2 * QT * 2 + 2 * BQ * 4;
  static constexpr size_t SMEM = 2 * KV * 2 + 2 * STAGE;
};

// Block (x, y, z): keys [KEYS x, +KEYS) of kv head y of batch z.
template <typename T, int DT>
__global__ void __launch_bounds__(DkdvTile<DT>::THREADS)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using Tile = DkdvTile<DT>;
  constexpr int BQ = Tile::BQ, LD = Tile::LD, THREADS = Tile::THREADS;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* ks = reinterpret_cast<T*>(bwd_smem);
  T* vs = ks + Tile::KV;
  unsigned char* ring = bwd_smem + 2 * Tile::KV * sizeof(T);
  const auto q_tile = [&](int st) {
    return reinterpret_cast<T*>(ring + st * Tile::STAGE);
  };
  const auto stats = [&](int st) {
    return reinterpret_cast<float*>(ring + st * Tile::STAGE +
                                    2 * Tile::QT * sizeof(T));
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int kg = warp / Tile::SPLIT, cs = warp % Tile::SPLIT;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * Tile::KEYS;
  const int kend = min(k0 + Tile::KEYS, p.sk);
  const int off = p.sk - p.sq;
  const bool aligned = p.aligned != 0;
  const float inv_sk = 1.f / static_cast<float>(p.sk);
  const T* qg = static_cast<const T*>(p.q) + b * p.qb;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb;

  load_rows<T, Tile::KEYS, DT, LD, THREADS>(
      ks, static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh, p.ks, k0, p.sk,
      p.d, aligned);
  load_rows<T, Tile::KEYS, DT, LD, THREADS>(
      vs, static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh, p.vs, k0, p.sk,
      p.d, aligned);
  cp_async_commit();

  // items: (query head of the group, query tile), tiles of a head in order
  const int nqt = (p.sq + BQ - 1) / BQ;
  const int items = p.group * nqt;
  const auto visit = [&](int qt) {
    const int p0 = qt * BQ + off, p1 = min(qt * BQ + BQ, p.sq) - 1 + off;
    if (p.causal && p0 < 0) return true;  // rows that see no key: P = 1 / Sk
    if (p.causal && k0 > p1) return false;
    if (p.has_window && kend - 1 <= p0 - p.window) return false;
    return true;
  };
  const auto next_item = [&](int it) {
    while (it < items && !visit(it % nqt)) ++it;
    return it;
  };
  const auto load_item = [&](int it, int st) {
    const int h = kvh * p.group + it / nqt, i0 = (it % nqt) * BQ;
    load_rows<T, BQ, DT, LD, THREADS>(q_tile(st), qg + h * p.qh, p.qs, i0,
                                      p.sq, p.d, aligned);
    load_rows<T, BQ, DT, LD, THREADS>(q_tile(st) + Tile::QT, gg + h * p.gh,
                                      p.gs, i0, p.sq, p.d, aligned);
    float* rs = stats(st);
    const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq + i0;
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = i0 + r < p.sq;
      rs[r] = ok ? p.lse[row0 + r] : 0.f;
      rs[BQ + r] = ok ? p.delta[row0 + r] : 0.f;
    }
  };

  float dk[8][4], dv[8][4];  // 16 keys x 64 columns
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }
  const unsigned k_addr = shared_u32(ks), v_addr = shared_u32(vs);
  const int key_row = k0 + 16 * kg + lane / 4;

  int it = next_item(0);
  if (it < items) load_item(it, 0);
  cp_async_commit();
  for (int n = 0; it < items; ++n) {
    const int st = n & 1;
    const int nxt = next_item(it + 1);
    if (nxt < items) load_item(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this item's tiles have landed
    __syncthreads();
    const int i0 = (it % nqt) * BQ;
    const unsigned q_addr = shared_u32(q_tile(st));
    const unsigned g_addr = q_addr + 2 * Tile::QT;
    const float* rs = stats(st);

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by BQ rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, k_addr, 16 * kg, 16 * kk, lane);
      frag_a<LD>(va, v_addr, 16 * kg, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qb[4], gb[4];
        frag_b<LD>(qb, q_addr, 16 * np, 16 * kk, lane);
        frag_b<LD>(gb, g_addr, 16 * np, 16 * kk, lane);
        Mma<T>::run(s[2 * np], ka[0], ka[1], ka[2], ka[3], qb[0], qb[1]);
        Mma<T>::run(s[2 * np + 1], ka[0], ka[1], ka[2], ka[3], qb[2], qb[3]);
        Mma<T>::run(dp[2 * np], va[0], va[1], va[2], va[3], gb[0], gb[1]);
        Mma<T>::run(dp[2 * np + 1], va[0], va[1], va[2], va[3], gb[2], gb[3]);
      }
    }
    // P^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * tq + (e & 1);
        grad_pair(p, i0 + r < p.sq, i0 + r + off, key_row + 8 * (e >> 1),
                  rs[r], rs[BQ + r], inv_sk, s[j][e], dp[j][e]);
      }
    }
    // dV += P^T dO and dK += dS^T Q over this warp's 64 columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t gb[4], qb[4];
        frag_b_t<LD>(gb, g_addr, 64 * cs + 16 * np, 16 * kk, lane);
        frag_b_t<LD>(qb, q_addr, 64 * cs + 16 * np, 16 * kk, lane);
        Mma<T>::run(dv[2 * np], pa[0], pa[1], pa[2], pa[3], gb[0], gb[1]);
        Mma<T>::run(dv[2 * np + 1], pa[0], pa[1], pa[2], pa[3], gb[2], gb[3]);
        Mma<T>::run(dk[2 * np], da[0], da[1], da[2], da[3], qb[0], qb[1]);
        Mma<T>::run(dk[2 * np + 1], da[0], da[1], da[2], da[3], qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage may be refilled
    it = nxt;
  }
  cp_async_wait<0>();

  T* dkg = static_cast<T*>(p.dk) + b * p.dkb + kvh * p.dkh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dvb + kvh * p.dvh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key_row + 8 * (e >> 1);
      const int col = 64 * cs + 8 * j + 2 * tq + (e & 1);
      if (key < p.sk && col < p.d) {
        dkg[key * p.dks + col] = narrow<T>(dk[j][e] * p.scale);
        dvg[key * p.dvs + col] = narrow<T>(dv[j][e]);
      }
    }
  }
}

template <int DT>
struct DqTile {
  static constexpr int SPLIT = DT / 64;         // warps sharing 16 rows
  static constexpr int RG = DT == 256 ? 2 : 4;  // 16-row groups a block
  static constexpr int ROWS = 16 * RG;
  static constexpr int THREADS = 32 * RG * SPLIT;
  static constexpr int BK = 64;  // keys a tile
  static constexpr int LD = DT + 8;
  static constexpr int QT = ROWS * LD;
  static constexpr int KT = BK * LD;
  // Q and dO tiles, then 2 stages of (K, V) tiles
  static constexpr size_t SMEM = (2 * QT + 2 * 2 * KT) * 2;
};

// Block (x, y, z): query rows [ROWS (X - 1 - x), +ROWS) of query head y of
// batch z (X = gridDim.x, heaviest first).
template <typename T, int DT>
__global__ void __launch_bounds__(DqTile<DT>::THREADS)
flash_bwd_dq_kernel(const BwdParams p) {
  using Tile = DqTile<DT>;
  constexpr int BK = Tile::BK, LD = Tile::LD, THREADS = Tile::THREADS;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* qs = reinterpret_cast<T*>(bwd_smem);
  T* gs = qs + Tile::QT;
  T* ring = gs + Tile::QT;  // stage st: K tile, then V tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int rg = warp / Tile::SPLIT, cs = warp % Tile::SPLIT;
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / p.group;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * Tile::ROWS;
  const int off = p.sk - p.sq;
  const bool aligned = p.aligned != 0;
  const float inv_sk = 1.f / static_cast<float>(p.sk);
  const T* kg = static_cast<const T*>(p.k) + b * p.kb + kvh * p.kh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vb + kvh * p.vh;

  load_rows<T, Tile::ROWS, DT, LD, THREADS>(
      qs, static_cast<const T*>(p.q) + b * p.qb + h * p.qh, p.qs, i0, p.sq,
      p.d, aligned);
  load_rows<T, Tile::ROWS, DT, LD, THREADS>(
      gs, static_cast<const T*>(p.g) + b * p.gb + h * p.gh, p.gs, i0, p.sq,
      p.d, aligned);
  cp_async_commit();

  // this thread's rows: 16 rg + lane / 4 and 8 below it
  int row[2];
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = i0 + 16 * rg + lane / 4 + 8 * r;
    const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + row[r];
    lse[r] = row[r] < p.sq ? p.lse[at] : 0.f;
    dl[r] = row[r] < p.sq ? p.delta[at] : 0.f;
  }
  // key tiles that hold a key a row of the block sees
  const int p0 = i0 + off, p1 = min(i0 + Tile::ROWS, p.sq) - 1 + off;
  int kt0 = 0, kt1 = (p.sk + BK - 1) / BK;
  if (p.causal) kt1 = p1 < 0 ? 0 : min(kt1, p1 / BK + 1);
  if (p.has_window && p0 - p.window + 1 > 0) kt0 = (p0 - p.window + 1) / BK;
  const auto load_keys = [&](int kt, int st) {
    load_rows<T, BK, DT, LD, THREADS>(ring + st * 2 * Tile::KT, kg, p.ks,
                                      kt * BK, p.sk, p.d, aligned);
    load_rows<T, BK, DT, LD, THREADS>(ring + st * 2 * Tile::KT + Tile::KT, vg,
                                      p.vs, kt * BK, p.sk, p.d, aligned);
  };

  float dq[8][4];  // 16 rows x 64 columns
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  }
  const unsigned q_addr = shared_u32(qs), g_addr = shared_u32(gs);
  if (kt0 < kt1) load_keys(kt0, 0);
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) load_keys(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned k_addr = shared_u32(ring + st * 2 * Tile::KT);
    const unsigned v_addr = k_addr + 2 * Tile::KT;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows by BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t qa[4], ga[4];
      frag_a<LD>(qa, q_addr, 16 * rg, 16 * kk, lane);
      frag_a<LD>(ga, g_addr, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4], vb[4];
        frag_b<LD>(kb, k_addr, 16 * np, 16 * kk, lane);
        frag_b<LD>(vb, v_addr, 16 * np, 16 * kk, lane);
        Mma<T>::run(s[2 * np], qa[0], qa[1], qa[2], qa[3], kb[0], kb[1]);
        Mma<T>::run(s[2 * np + 1], qa[0], qa[1], qa[2], qa[3], kb[2], kb[3]);
        Mma<T>::run(dp[2 * np], ga[0], ga[1], ga[2], ga[3], vb[0], vb[1]);
        Mma<T>::run(dp[2 * np + 1], ga[0], ga[1], ga[2], ga[3], vb[2], vb[3]);
      }
    }
    // dS into dp
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        grad_pair(p, row[r] < p.sq, row[r] + off, kt * BK + 8 * j + 2 * tq + (e & 1),
                  lse[r], dl[r], inv_sk, s[j][e], dp[j][e]);
      }
    }
    // dQ += dS K over this warp's 64 columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      pack_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        frag_b_t<LD>(kb, k_addr, 64 * cs + 16 * np, 16 * kk, lane);
        Mma<T>::run(dq[2 * np], da[0], da[1], da[2], da[3], kb[0], kb[1]);
        Mma<T>::run(dq[2 * np + 1], da[0], da[1], da[2], da[3], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage may be refilled
  }
  cp_async_wait<0>();

  T* dqg = static_cast<T*>(p.dq) + b * p.dqb + h * p.dqh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row[e >> 1];
      const int col = 64 * cs + 8 * j + 2 * tq + (e & 1);
      if (i < p.sq && col < p.d) dqg[i * p.dqs + col] = narrow<T>(dq[j][e] * p.scale);
    }
  }
}

template <typename T, int DT>
int launch_half_bwd(const BwdParams& p, cudaStream_t stream) {
  using A = DkdvTile<DT>;
  using B = DqTile<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(A::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, DT>
      <<<dim3((p.sk + A::KEYS - 1) / A::KEYS, p.hkv, p.batch), A::THREADS,
         A::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(B::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, DT>
      <<<dim3((p.sq + B::ROWS - 1) / B::ROWS, p.hq, p.batch), B::THREADS,
         B::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: FMA pipes

constexpr int FB = 16;  // threads a block side
constexpr int FB_THREADS = FB * FB;

// Rows [row0, row0 + R) of an f32 operand into a tile of rows LD floats
// apart, DT columns, zeros past `rows` and past d.
template <int R, int DT, int LD>
__device__ __forceinline__ void load_rows_f32(float* tile, const float* g,
                                              long long rs, int row0, int rows,
                                              int d) {
#pragma unroll 4
  for (int e = threadIdx.x; e < R * DT; e += FB_THREADS) {
    const int r = e / DT, c = e % DT;
    tile[r * LD + c] = row0 + r < rows && c < d ? g[(row0 + r) * rs + c] : 0.f;
  }
}

template <int DT>
struct FmaDkdv {
  static constexpr int KEYS = DT == 256 ? 32 : 64;
  static constexpr int BQ = 32;      // query rows a tile
  static constexpr int LD = DT + 1;  // odd pitch: a column's reads spread
  static constexpr int PLD = BQ + 1;
  static constexpr int KA = KEYS / FB;  // keys a thread
  static constexpr int QA = BQ / FB;    // rows a thread (S, dP)
  static constexpr int CD = DT / FB;    // columns a thread (dK, dV)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * KEYS * LD + 2 * BQ * LD + 2 * KEYS * PLD + 2 * BQ);
};

// Block (x, y, z): keys [KEYS x, +KEYS) of kv head y of batch z. Thread
// (ty, tx) holds keys ty + 16 a of S^T and dP^T at rows tx + 16 c, and of
// dK and dV at columns tx + 16 c.
template <int DT>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkdv_fma_kernel(const BwdParams p) {
  using Tile = FmaDkdv<DT>;
  constexpr int KEYS = Tile::KEYS, BQ = Tile::BQ, LD = Tile::LD,
                PLD = Tile::PLD, KA = Tile::KA, QA = Tile::QA, CD = Tile::CD;
  extern __shared__ float fb_smem[];
  float* ks = fb_smem;
  float* vs = ks + KEYS * LD;
  float* qs = vs + KEYS * LD;
  float* gs = qs + BQ * LD;
  float* pt = gs + BQ * LD;     // P^T, keys x rows
  float* dst = pt + KEYS * PLD;  // dS^T
  float* rs = dst + KEYS * PLD;  // the rows' lse, then Delta

  const int tx = threadIdx.x % FB, ty = threadIdx.x / FB;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * KEYS;
  const int kend = min(k0 + KEYS, p.sk);
  const int off = p.sk - p.sq;
  const float inv_sk = 1.f / static_cast<float>(p.sk);
  const float* qg = static_cast<const float*>(p.q) + b * p.qb;
  const float* gg = static_cast<const float*>(p.g) + b * p.gb;
  load_rows_f32<KEYS, DT, LD>(
      ks, static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh, p.ks, k0,
      p.sk, p.d);
  load_rows_f32<KEYS, DT, LD>(
      vs, static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh, p.vs, k0,
      p.sk, p.d);

  float dk[KA][CD], dv[KA][CD];
#pragma unroll
  for (int a = 0; a < KA; ++a) {
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[a][c] = dv[a][c] = 0.f;
  }
  const int nqt = (p.sq + BQ - 1) / BQ;
  for (int it = 0; it < p.group * nqt; ++it) {
    const int qt = it % nqt, i0 = qt * BQ;
    const int p0 = i0 + off, p1 = min(i0 + BQ, p.sq) - 1 + off;
    if (!(p.causal && p0 < 0) &&
        ((p.causal && k0 > p1) ||
         (p.has_window && kend - 1 <= p0 - p.window))) {
      continue;  // every pair masked, every row sees a key
    }
    const int h = kvh * p.group + it / nqt;
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<BQ, DT, LD>(qs, qg + h * p.qh, p.qs, i0, p.sq, p.d);
    load_rows_f32<BQ, DT, LD>(gs, gg + h * p.gh, p.gs, i0, p.sq, p.d);
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x;
      const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + i0 + r;
      rs[r] = i0 + r < p.sq ? p.lse[at] : 0.f;
      rs[BQ + r] = i0 + r < p.sq ? p.delta[at] : 0.f;
    }
    __syncthreads();

    float s[KA][QA], dp[KA][QA];
#pragma unroll
    for (int a = 0; a < KA; ++a) {
#pragma unroll
      for (int c = 0; c < QA; ++c) s[a][c] = dp[a][c] = 0.f;
    }
#pragma unroll 4
    for (int x = 0; x < p.d; ++x) {
      float kv[KA], vv[KA], qv[QA], gv[QA];
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        kv[a] = ks[(ty + FB * a) * LD + x];
        vv[a] = vs[(ty + FB * a) * LD + x];
      }
#pragma unroll
      for (int c = 0; c < QA; ++c) {
        qv[c] = qs[(tx + FB * c) * LD + x];
        gv[c] = gs[(tx + FB * c) * LD + x];
      }
#pragma unroll
      for (int a = 0; a < KA; ++a) {
#pragma unroll
        for (int c = 0; c < QA; ++c) {
          s[a][c] = fmaf(kv[a], qv[c], s[a][c]);
          dp[a][c] = fmaf(vv[a], gv[c], dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < KA; ++a) {
#pragma unroll
      for (int c = 0; c < QA; ++c) {
        const int r = tx + FB * c;
        grad_pair(p, i0 + r < p.sq, i0 + r + off, k0 + ty + FB * a, rs[r],
                  rs[BQ + r], inv_sk, s[a][c], dp[a][c]);
        pt[(ty + FB * a) * PLD + r] = s[a][c];
        dst[(ty + FB * a) * PLD + r] = dp[a][c];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[KA], sv[KA];
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        pv[a] = pt[(ty + FB * a) * PLD + r];
        sv[a] = dst[(ty + FB * a) * PLD + r];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float gv = gs[r * LD + tx + FB * c];
        const float qv = qs[r * LD + tx + FB * c];
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          dv[a][c] = fmaf(pv[a], gv, dv[a][c]);
          dk[a][c] = fmaf(sv[a], qv, dk[a][c]);
        }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dkb + kvh * p.dkh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dvb + kvh * p.dvh;
#pragma unroll
  for (int a = 0; a < KA; ++a) {
    const int key = k0 + ty + FB * a;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + FB * c;
      if (key < p.sk && col < p.d) {
        dkg[key * p.dks + col] = dk[a][c] * p.scale;
        dvg[key * p.dvs + col] = dv[a][c];
      }
    }
  }
}

template <int DT>
struct FmaDq {
  static constexpr int ROWS = DT == 256 ? 32 : 64;
  static constexpr int BK = 32;  // keys a tile
  static constexpr int LD = DT + 1;
  static constexpr int SLD = BK + 1;
  static constexpr int RA = ROWS / FB;  // rows a thread
  static constexpr int KA = BK / FB;    // keys a thread (S, dP)
  static constexpr int CD = DT / FB;    // columns a thread (dQ)
  static constexpr size_t SMEM =
      sizeof(float) * (2 * ROWS * LD + 2 * BK * LD + ROWS * SLD);
};

// Block (x, y, z): query rows [ROWS (X - 1 - x), +ROWS) of query head y of
// batch z, heaviest first. Thread (ty, tx) holds rows ty + 16 a of S and
// dP at keys tx + 16 c, and of dQ at columns tx + 16 c.
template <int DT>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_fma_kernel(const BwdParams p) {
  using Tile = FmaDq<DT>;
  constexpr int ROWS = Tile::ROWS, BK = Tile::BK, LD = Tile::LD,
                SLD = Tile::SLD, RA = Tile::RA, KA = Tile::KA, CD = Tile::CD;
  extern __shared__ float fb_smem[];
  float* qs = fb_smem;
  float* gs = qs + ROWS * LD;
  float* ks = gs + ROWS * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;  // dS, rows x keys

  const int tx = threadIdx.x % FB, ty = threadIdx.x / FB;
  const int b = blockIdx.z, h = blockIdx.y, kvh = h / p.group;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int off = p.sk - p.sq;
  const float inv_sk = 1.f / static_cast<float>(p.sk);
  const float* kg = static_cast<const float*>(p.k) + b * p.kb + kvh * p.kh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vb + kvh * p.vh;
  load_rows_f32<ROWS, DT, LD>(
      qs, static_cast<const float*>(p.q) + b * p.qb + h * p.qh, p.qs, i0,
      p.sq, p.d);
  load_rows_f32<ROWS, DT, LD>(
      gs, static_cast<const float*>(p.g) + b * p.gb + h * p.gh, p.gs, i0,
      p.sq, p.d);
  float lse[RA], dl[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = i0 + ty + FB * a;
    const long long at = (static_cast<long long>(b) * p.hq + h) * p.sq + i;
    lse[a] = i < p.sq ? p.lse[at] : 0.f;
    dl[a] = i < p.sq ? p.delta[at] : 0.f;
  }
  const int p0 = i0 + off, p1 = min(i0 + ROWS, p.sq) - 1 + off;
  int kt0 = 0, kt1 = (p.sk + BK - 1) / BK;
  if (p.causal) kt1 = p1 < 0 ? 0 : min(kt1, p1 / BK + 1);
  if (p.has_window && p0 - p.window + 1 > 0) kt0 = (p0 - p.window + 1) / BK;

  float dq[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[a][c] = 0.f;
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<BK, DT, LD>(ks, kg, p.ks, kt * BK, p.sk, p.d);
    load_rows_f32<BK, DT, LD>(vs, vg, p.vs, kt * BK, p.sk, p.d);
    __syncthreads();
    float s[RA][KA], dp[RA][KA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < KA; ++c) s[a][c] = dp[a][c] = 0.f;
    }
#pragma unroll 4
    for (int x = 0; x < p.d; ++x) {
      float qv[RA], gv[RA], kv[KA], vv[KA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        qv[a] = qs[(ty + FB * a) * LD + x];
        gv[a] = gs[(ty + FB * a) * LD + x];
      }
#pragma unroll
      for (int c = 0; c < KA; ++c) {
        kv[c] = ks[(tx + FB * c) * LD + x];
        vv[c] = vs[(tx + FB * c) * LD + x];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int c = 0; c < KA; ++c) {
          s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
          dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = i0 + ty + FB * a;
#pragma unroll
      for (int c = 0; c < KA; ++c) {
        grad_pair(p, i < p.sq, i + off, kt * BK + tx + FB * c, lse[a], dl[a],
                  inv_sk, s[a][c], dp[a][c]);
        dss[(ty + FB * a) * SLD + tx + FB * c] = dp[a][c];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) sv[a] = dss[(ty + FB * a) * SLD + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = ks[j * LD + tx + FB * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) dq[a][c] = fmaf(sv[a], kv, dq[a][c]);
      }
    }
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dqb + h * p.dqh;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = i0 + ty + FB * a;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + FB * c;
      if (i < p.sq && col < p.d) dqg[i * p.dqs + col] = dq[a][c] * p.scale;
    }
  }
}

template <int DT>
int launch_fma_bwd(const BwdParams& p, cudaStream_t stream) {
  using A = FmaDkdv<DT>;
  using B = FmaDq<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_fma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(A::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_fma_kernel<DT>
      <<<dim3((p.sk + A::KEYS - 1) / A::KEYS, p.hkv, p.batch), FB_THREADS,
         A::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_fma_kernel<DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(B::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_fma_kernel<DT>
      <<<dim3((p.sq + B::ROWS - 1) / B::ROWS, p.hq, p.batch), FB_THREADS,
         B::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Delta, then dK and dV, then dQ: three launches on one stream.
template <typename T>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.batch) * p.hq * p.sq;
  flash_bwd_delta_kernel<T>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same<T, float>::value) {
    if (p.d <= 64) return launch_fma_bwd<64>(p, stream);
    if (p.d <= 128) return launch_fma_bwd<128>(p, stream);
    return launch_fma_bwd<256>(p, stream);
  } else {
    if (p.d <= 64) return launch_half_bwd<T, 64>(p, stream);
    if (p.d <= 128) return launch_half_bwd<T, 128>(p, stream);
    return launch_half_bwd<T, 256>(p, stream);
  }
}

}  // namespace

// dq, dk, dv of <g, O> for O = attention(q, k, v) (flash_attn.cu's NAME):
// q, o, g and dq (batch, hq, sq, d); k, v, dk and dv (batch, hkv, sk, d);
// each at its own (batch, head, seq) strides in elements with a unit
// stride along d; d <= 256 and a multiple of 8, sq >= 1, sk >= 1, batch
// >= 1. lse is the forward's (batch, hq, sq) f32 base-2 log-sum-exp,
// delta (batch, hq, sq) f32 scratch. aligned says every row of q, k, v and
// g starts on 16 bytes (the bf16/f16 kernels' cp.async copies; they copy
// 2 bytes at a time otherwise). Three launches; returns the first error
// of a launch that is not cudaSuccess, else 0.
#define BWD_ENTRY(NAME, T)                                                    \
  int NAME(const T* q, long long qb, long long qh, long long qs, const T* k,  \
           long long kb, long long kh, long long ks, const T* v,              \
           long long vb, long long vh, long long vs, const T* o,              \
           long long ob, long long oh, long long os, const T* g,              \
           long long gb, long long gh, long long gs, T* dq, long long dqb,    \
           long long dqh, long long dqs, T* dk, long long dkb, long long dkh, \
           long long dks, T* dv, long long dvb, long long dvh, long long dvs, \
           const float* lse, float* delta, int batch, int hq, int hkv,        \
           int sq, int sk, int d, float scale, int causal, int has_window,    \
           int window, int aligned, cudaStream_t stream) {                    \
    const BwdParams p{q,  qb,  qh,  qs,  k,  kb,    kh,    ks,     v,         \
                      vb, vh,  vs,  o,   ob, oh,    os,    g,      gb,        \
                      gh, gs,  dq,  dqb, dqh, dqs,  dk,    dkb,    dkh,       \
                      dks, dv, dvb, dvh, dvs, lse,  delta, batch,  hq,        \
                      hkv, hq / hkv, sq, sk, d, scale, scale * LOG2E, causal, \
                      has_window, window, aligned};                           \
    return launch_bwd<T>(p, stream);                                          \
  }

extern "C" {

BWD_ENTRY(flash_bwd_f32, float)
BWD_ENTRY(flash_bwd_bf16, __nv_bfloat16)
BWD_ENTRY(flash_bwd_f16, __half)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
