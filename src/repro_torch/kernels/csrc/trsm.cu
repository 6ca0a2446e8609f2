// Triangular-solve kernels: X = L^-1 B (L unit lower) and Z = B U^-1
// (U upper, non-unit diagonal), through one lower-triangular solver.
//
// Replaces: src/repro/kernels/trsm.py:trsm_lower (_trsm_lower_kernel)
// and src/repro/kernels/trsm.py:trsm_upper_right
// (_trsm_upper_right_kernel): the U and L strips of Algorithm 3 and the
// strips inside each blocked diagonal panel; also the pipeline's
// block-row solve and the four left solves of the secure linalg rounds.
//
// Z U = B is U^T Z^T = B^T, a lower solve with a non-unit diagonal. Every
// operand is passed with its batch, row and column strides, so the
// wrapper hands the transposes over as stride swaps and strided views
// (the panel loop's a[..., s0:s1, s1:]) need no copy. An upper-triangular
// left solve U X = B comes as (J U J)(J X) = J B, J the row reversal: J U
// J is lower, so the wrapper passes U's last element with both strides
// negated and B's and X's last rows with their row strides negated;
// offsets are signed 64-bit throughout.
//
// What bounds it on the H100: operations. An n x n triangle against
// n x m takes n^2 m operations (n^2 m / 2 multiply-adds) over
// (n^2 / 2 + 2 n m) elements moved. In f64 at 67 TFLOP/s and 3.35 TB/s:
// 1024^3, 1.07 GFLOP against 21 MB, 16 us (6.3 us of bytes); the
// pipeline's block-row solve, 1024^2 against 1024 x 4096, 4.3 GFLOP, 64
// us (24 us of bytes); the trisolve legs, 4096^2 against 4096 x 1024,
// 17.2 GFLOP, 256 us (87 us of bytes). Beneath the operations lies a
// dependent chain of n substitution steps.
//
// What the design does about it: a recursive blocked solve, launched from
// one host call as ceil(n / 128) leaves and a product between each two,
// 2 ceil(n / 128) - 1 kernels on the stream (the previous design, a
// right-looking sweep of 64-row leaves and K = 64 trailing updates on
// DMMA m8n8k4, launched 2 ceil(n / 64) - 1 and moved every trailing row
// n / 64 times). solve(rows) splits the rows at n1 = 128 ceil(leaves /
// 2), a multiple of 128 set by n alone: it solves the top n1 rows, takes
// T21 X1 from the rows below in one product of depth K = n1, then solves
// the bottom rows. Each trailing row is updated log2(n / 128) times, and
// the bulk of the work runs at large K: 512 at 1024^3, 2048 at the legs.
//  * Product (update_kernel): OUT = C - A B with A = T[rows, K], B = W[K,
//    cols], C = OUT = W[rows] (B's rows, at the storage type, where no
//    product has touched them yet). Where W's rows have unit stride (the
//    transposed problem of trsm_upper_right) the default routes run the
//    transposed product instead, so that every operand is staged along
//    its unit stride. On the f64 routes a block of ROWS / 32 x 2 warps
//    owns a ROWS x 64 tile (ROWS = 128 from 1024 rows up on the f64 route,
//    else 64, so that the smaller products still spread over the card),
//    summed by DMMA (mma.sync m16n8k4) from a 3-stage cp.async ring of
//    32-deep K slices: 16-byte copies where the staged axis has stride +1
//    and is aligned, element copies otherwise (the reversed legs, odd
//    offsets), zeros past the ragged edge. The ring, its copies and the
//    fragment are ring.cuh's, shared with schur.cu. C is loaded into
//    registers while the first slices land, each sum runs over k
//    ascending and is subtracted once. f32 and the bf16/f16 -> f32 routes
//    run the same product on the FMA pipes (64 x 64 a block of 256
//    threads, 4 x 4 a thread; no TF32), a 2-byte operand widened as it is
//    staged.
//  * Leaf (leaf_kernel): a 128-row (or 64- or 32-row, for a shorter last
//    or lone leaf) diagonal tile against 32 columns a block. The triangle
//    and the columns are staged together (one memory latency); lane c of
//    warp g then holds rows 16 g .. 16 g + 15 of column c in registers.
//    Group by group, warp kb runs its diagonal block's substitution (no
//    shuffle on the chain, T read from shared memory as a broadcast, a
//    column ahead, two rows a read) and publishes its rows; every later
//    warp takes its 16 x 16 tile of multiply-adds for them. The chain per
//    column is a true division (non-unit) and a multiply-add per row,
//    plus a barrier per 16 rows.
// Every output column (every row, for the transposed call) goes through
// the same sequence of operations whatever m, its offset, or the
// operands' strides: the split points depend on n alone, each product
// sums its K in one fixed order whatever the tile's position, shape or
// orientation (the products of a term commute exactly), and nothing uses
// atomics. So a call over m columns is bit-equal to calls over any split
// of its columns, which keeps lu_block_row's strips bit-equal to
// lu_nserver's and every transport's factors bit-equal to the fused
// sweep's. The leaf is a substitution, with a true division by the
// diagonal, not a multiply by an inverted tile.
// Mixed variant (the reference's acc_dtype, which solves a whole tile in
// the wide type and stores it narrow once): the solver takes a storage
// type TS and an arithmetic type TA, float with double or bfloat16 and
// half with float or double. The solve keeps its rows in a TA workspace W
// (n x m, allocated by the wrapper), never in the narrow output: each
// product writes its rows to W, each leaf solves rows of W (of B, widened,
// where untouched) and writes them wide to W, for the products after it,
// and narrow to X, once. The triangle is widened as it is read. The
// default routes pass X itself as W (TS = TA).
// Narrow variant (bfloat16 or half with no acc_dtype, as the reference's
// kernel computes them): TA = TS, every operation rounded to the half
// type (precision.cuh's quot; each x - a b by the type's own mul.rn and
// sub.rn, the same bits as precision.cuh's sub_prod), and a product
// subtracts its terms one at a time, k ascending, from the rows' values,
// two columns an instruction, instead of subtracting their sum. The
// recursion hands each row its terms in ascending k, product after
// product, so each element sees the plain version's forward
// substitution, operation for operation: the result is the plain
// version's bits.
// What still holds it back (PERF.md, the B3/B4 rows): the leaves, 0.10
// us a row of dependent chain in f64 (a multiply-add, a barrier every 16
// rows; 0.17 us with the division of a non-unit diagonal), no less a row
// than the parent's warp-per-column leaf took; and the products of the
// lower levels, which are latency-bound.
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "precision.cuh"
#include "ring.cuh"

namespace {

constexpr int LEAF = 128;          // rows of a leaf
constexpr int LEAF_COLS = 32;      // columns of a leaf block, one a lane
constexpr int BLK = 16;            // rows of a leaf's row group
constexpr int BIG_PRODUCT = 1024;  // rows from which f64 products tile by 128

// Two neighbouring elements of a column of the staged triangle, read in
// one shared-memory access.
template <typename T>
struct alignas(2 * sizeof(T)) Two {
  T lo, hi;
};

// The narrow routes' step x - a b in the half type H: the product rounded
// to H, then the difference, each by the type's own instruction with
// explicit round-to-nearest (mul.rn / sub.rn, which the compiler never
// contracts into an fma). These are IEEE operations, so their bits are
// precision.cuh's sub_prod's, which takes them through float; rsub2 does
// two lanes of a packed pair at once.
template <typename H>
__device__ __forceinline__ H rsub(H x, H a, H b) {
  const unsigned short xs = *reinterpret_cast<unsigned short*>(&x);
  const unsigned short as = *reinterpret_cast<unsigned short*>(&a);
  const unsigned short bs = *reinterpret_cast<unsigned short*>(&b);
  unsigned short pr, r;
  if constexpr (std::is_same<H, __nv_bfloat16>::value) {
    asm("mul.rn.bf16 %0, %1, %2;" : "=h"(pr) : "h"(as), "h"(bs));
    asm("sub.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(xs), "h"(pr));
  } else {
    asm("mul.rn.f16 %0, %1, %2;" : "=h"(pr) : "h"(as), "h"(bs));
    asm("sub.rn.f16 %0, %1, %2;" : "=h"(r) : "h"(xs), "h"(pr));
  }
  return *reinterpret_cast<H*>(&r);
}

template <typename H>
__device__ __forceinline__ unsigned rsub2(unsigned x, unsigned a,
                                          unsigned b) {
  unsigned pr, r;
  if constexpr (std::is_same<H, __nv_bfloat16>::value) {
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(pr) : "r"(a), "r"(b));
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(pr));
  } else {
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(pr) : "r"(a), "r"(b));
    asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(pr));
  }
  return r;
}

// A leaf's step x - a b: rsub on the narrow routes, else sub_prod.
template <typename T>
__device__ __forceinline__ T leaf_sub(T x, T a, T b) {
  if constexpr (is_half_type<T>::value) {
    return rsub(x, a, b);
  } else {
    return sub_prod(x, a, b);
  }
}

// BLK rows of a staged column of T, from an even row, in pairs.
template <typename TS>
__device__ __forceinline__ void load_column(Two<TS> (&v)[BLK / 2],
                                            const TS* col) {
#pragma unroll
  for (int p = 0; p < BLK / 2; ++p) {
    v[p] = *reinterpret_cast<const Two<TS>*>(col + 2 * p);
  }
}

template <typename TS>
__device__ __forceinline__ TS pick(const Two<TS> (&v)[BLK / 2], int i) {
  return i & 1 ? v[i / 2].hi : v[i / 2].lo;
}

// A leaf of ROWS rows (32, 64 or 128): ROWS / 16 warps, warp g the row
// group g of the block's LEAF_COLS columns. Its shared memory: the
// triangle column-major, ts[k * T_LD + i] = T[r0 + i][r0 + k] (T_LD even,
// so that pairs of rows stay aligned), then the columns, as[i * AS_LD +
// c] = row r0 + i of column c (AS_LD odd: the staging copies and each
// lane's column are free of bank conflicts in either orientation).
template <typename TS, typename TA, int ROWS>
struct Leaf {
  static constexpr int THREADS = 2 * ROWS;
  static constexpr int T_LD = ROWS + 2;
  static constexpr int AS_LD = LEAF_COLS + 1;
  static constexpr int T_BYTES =
      (ROWS * T_LD * static_cast<int>(sizeof(TS)) + 15) / 16 * 16;
  static constexpr size_t SMEM = T_BYTES + ROWS * AS_LD * sizeof(TA);
};

// Copy rows [0, nr) by columns [0, nc) of a source (element (i, c) at
// p[i * rs + c * cs]) into as[i * AS_LD + c], ROWS x LEAF_COLS, zeros
// elsewhere; consecutive threads along the source's unit-stride axis, so
// each thread's elements lie a fixed step apart. cp.async where the
// source is TA of 4 or 8 bytes; otherwise plain loads, widened, all
// issued before the first store.
template <typename TA, typename T, int ROWS>
__device__ __forceinline__ void stage_columns(TA* as, const T* p,
                                              long long rs, long long cs,
                                              int nr, int nc) {
  using L = Leaf<T, TA, ROWS>;
  constexpr int PER = ROWS * LEAF_COLS / L::THREADS;  // 16
  constexpr int ROW_STEP = L::THREADS / LEAF_COLS;   // ROWS / 16
  constexpr int COL_STEP = L::THREADS / ROWS;        // 2
  constexpr bool ASYNC = std::is_same<T, TA>::value && sizeof(TA) >= 4;
  const bool along = along_cols(rs, cs);
  const int tid = threadIdx.x;
  const int i0 = along ? tid / LEAF_COLS : tid % ROWS;
  const int c0 = along ? tid % LEAF_COLS : tid / ROWS;
  const int di = along ? ROW_STEP : 0, dc = along ? 0 : COL_STEP;
  const T* q = p + i0 * rs + static_cast<long long>(c0) * cs;
  const long long step = di * rs + dc * cs;
  TA v[ASYNC ? 1 : PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j * di, c = c0 + j * dc;
    const bool ok = i < nr && c < nc;
    if constexpr (ASYNC) {
      cp_async_elem<sizeof(TA)>(as + i * L::AS_LD + c, ok ? q : p, ok);
    } else {
      v[j] = ok ? widen<T, TA>(*q) : constant<TA>(0.f);
    }
    q += step;
  }
  if constexpr (!ASYNC) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      as[(i0 + j * di) * L::AS_LD + c0 + j * dc] = v[j];
    }
  }
}

// The reverse: rows [0, nr) by columns [0, nc) of as into p, rounded to T.
template <typename T, typename TA, int ROWS>
__device__ __forceinline__ void store_columns(T* p, long long rs,
                                              long long cs, const TA* as,
                                              int nr, int nc) {
  using L = Leaf<T, TA, ROWS>;
  constexpr int PER = ROWS * LEAF_COLS / L::THREADS;
  const bool along = along_cols(rs, cs);
  const int tid = threadIdx.x;
  const int i0 = along ? tid / LEAF_COLS : tid % ROWS;
  const int c0 = along ? tid % LEAF_COLS : tid / ROWS;
  const int di = along ? L::THREADS / LEAF_COLS : 0;
  const int dc = along ? 0 : L::THREADS / ROWS;
  T* q = p + i0 * rs + static_cast<long long>(c0) * cs;
  const long long step = di * rs + dc * cs;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = i0 + j * di, c = c0 + j * dc;
    if (i < nr && c < nc) *q = narrow<T, TA>(as[i * L::AS_LD + c]);
    q += step;
  }
}

// Solve the leaf rows [r0, r0 + nr) (nr <= ROWS) of matrix blockIdx.z for
// columns LEAF_COLS x ..: w = T_leaf^-1 w (the rows of w already hold b
// minus every earlier leaf's contribution; the first leaf's, b itself),
// and x = w rounded to TS where the route is mixed (w is x otherwise).
// Rows past nr are zero with a unit diagonal, so the substitution runs
// all ROWS rows; they are never written. The block stages the triangle
// (cp.async, or plain loads for 2-byte types) and its columns together.
// Then lane c of warp g holds rows 16 g .. 16 g + 15 of column c in
// registers, and for each group kb in turn: warp kb runs the diagonal
// block's substitution and publishes its rows; after a barrier every
// later warp takes T[its rows, group kb] times them from its rows, a
// 16 x 16 tile of multiply-adds, k ascending, while the next diagonal
// block waits only on its own warp's tile. The results leave through
// shared memory, consecutive threads along each output's unit-stride
// axis.
template <typename TS, typename TA, bool UNIT, int ROWS>
__global__ void __launch_bounds__(2 * ROWS)
leaf_kernel(const TS* __restrict__ t, long long tb, long long tr,
            long long tc, const TS* b, long long bb, long long br,
            long long bc, TA* w, long long wb, long long wr, long long wc,
            TS* x, long long xb, long long xr, long long xc, int r0, int nr,
            int m) {
  using L = Leaf<TS, TA, ROWS>;
  constexpr int T_LD = L::T_LD, AS_LD = L::AS_LD, THREADS = L::THREADS;
  extern __shared__ __align__(16) unsigned char leaf_smem[];
  TS* ts = reinterpret_cast<TS*>(leaf_smem);
  TA* as = reinterpret_cast<TA*>(leaf_smem + L::T_BYTES);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * LEAF_COLS;
  const int nc = min(LEAF_COLS, m - c0);
  t += blockIdx.z * tb + r0 * tr + r0 * tc;
  // the triangle, i >= k (i > k on a unit diagonal), a padded row's
  // diagonal (i == k >= nr, non-unit only) 1: each thread keeps one
  // coordinate and steps the other by 2 along the unit-stride axis
  {
    const bool along = along_cols(tr, tc);
    const int fix = tid % ROWS, s0 = tid / ROWS;
    const TS* q = t + (along ? s0 * tr + fix * tc : fix * tr + s0 * tc);
    const long long step = 2 * (along ? tr : tc);
    TS v[sizeof(TS) == 2 ? ROWS / 2 : 1];
#pragma unroll
    for (int j = 0; j < ROWS / 2; ++j) {
      const int i = along ? s0 + 2 * j : fix, k = along ? fix : s0 + 2 * j;
      const bool need = UNIT ? i > k : i >= k;
      const bool ok = need && i < nr;
      if constexpr (sizeof(TS) == 2) {
        v[j] = ok ? *q : constant<TS>(i == k ? 1.f : 0.f);
      } else if (need && (ok || i != k)) {
        cp_async_elem<sizeof(TS)>(ts + k * T_LD + i, ok ? q : t, ok);
      } else if (need) {
        ts[k * T_LD + i] = constant<TS>(1.f);
      }
      q += step;
    }
    if constexpr (sizeof(TS) == 2) {
#pragma unroll
      for (int j = 0; j < ROWS / 2; ++j) {
        const int i = along ? s0 + 2 * j : fix, k = along ? fix : s0 + 2 * j;
        if (UNIT ? i > k : i >= k) ts[k * T_LD + i] = v[j];
      }
    }
  }
  // the columns: rows that no product has touched (the first leaf's)
  // still hold B, at TS
  b += blockIdx.z * bb + r0 * br + c0 * bc;
  w += blockIdx.z * wb + r0 * wr + c0 * wc;
  if (r0 == 0) {
    stage_columns<TA, TS, ROWS>(as, b, br, bc, nr, nc);
  } else {
    stage_columns<TA, TA, ROWS>(as, w, wr, wc, nr, nc);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  static_assert(THREADS == 32 * (ROWS / BLK), "a warp a row group");
  const int g = tid / 32;
  TA* mine = as + (tid & 31);  // this lane's column: mine[i * AS_LD]
  TA y[BLK];
#pragma unroll
  for (int i = 0; i < BLK; ++i) y[i] = mine[(BLK * g + i) * AS_LD];
#pragma unroll 1
  for (int kb = 0; kb < ROWS / BLK; ++kb) {
    const int k0 = BLK * kb;
    if (g == kb) {
      // T's column j of the block, loaded a column ahead of its use
      Two<TS> cur[BLK / 2], nxt[BLK / 2];
      load_column(cur, ts + k0 * T_LD + k0);
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
        if (j + 1 < BLK) load_column(nxt, ts + (k0 + j + 1) * T_LD + k0);
        if (!UNIT) y[j] = quot(y[j], widen<TS, TA>(pick(cur, j)));
#pragma unroll
        for (int i = j + 1; i < BLK; ++i) {
          y[i] = leaf_sub(y[i], widen<TS, TA>(pick(cur, i)), y[j]);
        }
#pragma unroll
        for (int p = 0; p < BLK / 2; ++p) cur[p] = nxt[p];
      }
#pragma unroll
      for (int i = 0; i < BLK; ++i) mine[(k0 + i) * AS_LD] = y[i];
    }
    __syncthreads();
    if (g > kb) {
      TA xk[BLK];
#pragma unroll
      for (int j = 0; j < BLK; ++j) xk[j] = mine[(k0 + j) * AS_LD];
      Two<TS> cur[BLK / 2], nxt[BLK / 2];
      load_column(cur, ts + k0 * T_LD + BLK * g);
#pragma unroll
      for (int j = 0; j < BLK; ++j) {
        if (j + 1 < BLK) load_column(nxt, ts + (k0 + j + 1) * T_LD + BLK * g);
#pragma unroll
        for (int p = 0; p < BLK / 2; ++p) {
          y[2 * p] = leaf_sub(y[2 * p], widen<TS, TA>(cur[p].lo), xk[j]);
          y[2 * p + 1] =
              leaf_sub(y[2 * p + 1], widen<TS, TA>(cur[p].hi), xk[j]);
        }
#pragma unroll
        for (int p = 0; p < BLK / 2; ++p) cur[p] = nxt[p];
      }
    }
  }
  __syncthreads();
  store_columns<TA, TA, ROWS>(w, wr, wc, as, nr, nc);
  if constexpr (!std::is_same<TS, TA>::value) {
    x += blockIdx.z * xb + r0 * xr + c0 * xc;
    store_columns<TS, TA, ROWS>(x, xr, xc, as, nr, nc);
  }
}

// cudaFuncSetAttribute(KERNEL, max dynamic shared memory, bytes), once a
// device (the attribute is per device).
template <auto KERNEL>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<bool> ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(KERNEL,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) ready[dev].store(true);
  return err;
}

// Stage an O x I block of an operand as f32 tiles of the FMA ring: f32 by
// cp.async (ring.cuh's stage_f32); a 2-byte type widened, by plain loads,
// all issued before the first store.
template <typename T, int O, int I, int LD, int THREADS>
__device__ __forceinline__ void stage_wide(float* tile, const Feed<T>& f,
                                           int o0, int on, int i0, int in) {
  if constexpr (std::is_same<T, float>::value) {
    stage_f32<O, I, LD, THREADS>(tile, f.p, f.os, f.is, f.vec, o0, on, i0,
                                 in);
  } else {
    constexpr int PER = O * I / THREADS;
    float v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * THREADS;
      const int o = f.along ? e / I : e % O;
      const int i = f.along ? e % I : e / O;
      v[j] = (o0 + o < on && i0 + i < in)
                 ? widen<T, float>(f.p[(o0 + o) * f.os + (i0 + i) * f.is])
                 : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * THREADS;
      const int o = f.along ? e / I : e % O;
      const int i = f.along ? e % I : e / O;
      tile[o * LD + i] = v[j];
    }
  }
}

// OUT = C - A B for matrix blockIdx.z: A (rows x k) stored as TS, B (k x
// m) as TA, C and OUT (rows x m) as TA, C read from cb (at TS) instead
// where from_b; block (x, y) owns rows ROWS y .. and columns 64 x ... The
// solver passes A = T[rows, K], B = W[K, cols], C = OUT = W[rows] (B's
// rows where no product has touched them), or the transpose of all of
// it where W's rows have unit stride. f64 routes: DMMA; f32 and half ->
// f32: FMA; narrow: the rounded subtraction term by term, two columns an
// instruction (ROWS = 128).
// Threads of a product block: ROWS / 32 x 2 warps on DMMA, 256 (16 x 16)
// on the FMA pipes and the narrow routes.
template <typename TA, int ROWS>
constexpr int product_threads() {
  return std::is_same<TA, double>::value ? 2 * ROWS : FTHREADS;
}

template <typename TS, typename TA, int ROWS>
__global__ void __launch_bounds__(product_threads<TA, ROWS>())
update_kernel(const TS* __restrict__ a, long long ab, long long ar,
              long long ac, const TA* bm, long long bb, long long br,
              long long bc, const TS* cb, long long cbb, long long cbr,
              long long cbc, TA* out, long long ob, long long orr,
              long long oc, int rows, int m, int k, int from_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Feed<TS> fa = feed(a + blockIdx.z * ab, ar, ac);
  const Feed<TA> fb = feed<TA>(bm + blockIdx.z * bb, br, bc);
  cb += blockIdx.z * cbb;
  out += blockIdx.z * ob;
  const long long wr = orr, wc = oc;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * DN;
  // C, read before any write of OUT
  const auto c_at = [&](int r, int c) {
    const long long cs = c;
    return from_b ? widen<TS, TA>(cb[r * cbr + cs * cbc])
                  : out[r * wr + cs * wc];
  };
  if constexpr (std::is_same<TA, double>::value) {
    using R = Ring<TS, double, ROWS>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = m0 + 32 * (warp >> 1) + (lane >> 2);
    const int col0 = n0 + 32 * (warp & 1) + 2 * (lane & 3);
    double cv[4][4][2], acc[4][4][2];
    run_ring<STAGES>(
        (k + DK - 1) / DK,
        [&](int s) {
          load_slice<TS, double, ROWS>(smem + (s % STAGES) * R::STAGE, fa, fb,
                                       m0, n0, s * DK, rows, m, k);
        },
        [&] {  // this thread's elements of C
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int gr = row0 + 8 * r, gc = col0 + 8 * ni + e;
                cv[r][ni][e] = (gr < rows && gc < m) ? c_at(gr, gc) : 0.0;
                acc[r][ni][e] = 0.0;
              }
            }
          }
        },
        [&](int kt) {
          slice_product<TS, double, ROWS>(smem + (kt % STAGES) * R::STAGE,
                                          acc);
        });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + 8 * r;
      if (gr >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = col0 + 8 * ni + e;
          if (gc < m) {
            out[gr * wr + static_cast<long long>(gc) * wc] =
                cv[r][ni][e] - acc[r][ni][e];
          }
        }
      }
    }
  } else if constexpr (is_half_type<TA>::value) {
    // narrow (TS = TA): half tiles, A transposed so that a thread's rows
    // are neighbours; each thread's 8 x 4 of W as 8 x 2 packed pairs,
    // every term subtracted in turn, k ascending (rsub2)
    static_assert(ROWS == FM && std::is_same<TS, TA>::value, "narrow tile");
    constexpr int A_LD = FM + 8, B_LD = FN + 8;  // whole 16-byte vectors
    constexpr int A_BYTES = FK * A_LD * 2, STAGE = A_BYTES + FK * B_LD * 2;
    const Feed<TS> fat = feed(fa.p, fa.is, fa.os);  // A transposed: (k, row)
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int row0 = m0 + 4 * ty, col0 = n0 + 4 * tx;
    unsigned acc[8][2];
    run_ring<FSTAGES>(
        (k + FK - 1) / FK,
        [&](int s) {
          unsigned char* st = smem + (s % FSTAGES) * STAGE;
          stage_block<TS, FK, FM, A_LD, FTHREADS>(reinterpret_cast<TS*>(st),
                                                  fat, s * FK, k, m0, rows);
          stage_block<TA, FK, FN, B_LD, FTHREADS>(
              reinterpret_cast<TA*>(st + A_BYTES), fb, s * FK, k, n0, m);
        },
        [&] {  // C, packed, before any write
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int gr = row0 + f_row(i);
            unsigned short h[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const TA v = (gr < rows && col0 + j < m) ? c_at(gr, col0 + j)
                                                       : constant<TA>(0.f);
              h[j] = *reinterpret_cast<const unsigned short*>(&v);
            }
            acc[i][0] = h[0] | static_cast<unsigned>(h[1]) << 16;
            acc[i][1] = h[2] | static_cast<unsigned>(h[3]) << 16;
          }
        },
        [&](int kt) {
          const unsigned char* st = smem + (kt % FSTAGES) * STAGE;
          const TA* at = reinterpret_cast<const TA*>(st);
          const TA* bt = reinterpret_cast<const TA*>(st + A_BYTES);
#pragma unroll 8
          for (int kk = 0; kk < FK; ++kk) {
            const TA* ak = at + kk * A_LD + 4 * ty;
            const uint2 lo = *reinterpret_cast<const uint2*>(ak);
            const uint2 hi = *reinterpret_cast<const uint2*>(ak + 64);
            const uint2 bv =
                *reinterpret_cast<const uint2*>(bt + kk * B_LD + 4 * tx);
            const unsigned rows4[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const unsigned two = rows4[i / 2];
              const unsigned a2 = __byte_perm(two, 0, i & 1 ? 0x3232 : 0x1010);
              acc[i][0] = rsub2<TA>(acc[i][0], a2, bv.x);
              acc[i][1] = rsub2<TA>(acc[i][1], a2, bv.y);
            }
          }
        });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = row0 + f_row(i);
      if (gr >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + j < m) {
          const unsigned short h =
              static_cast<unsigned short>(acc[i][j / 2] >> (16 * (j & 1)));
          out[gr * wr + static_cast<long long>(col0 + j) * wc] =
              *reinterpret_cast<const TA*>(&h);
        }
      }
    }
  } else {
    constexpr int STAGE = ROWS * FA_LD + FK * FB_LD;  // floats
    constexpr int R = ROWS / 16;                      // rows a thread
    float* ring = reinterpret_cast<float*>(smem);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int row0 = m0 + 4 * ty, col0 = n0 + 4 * tx;
    float cv[R][4], acc[R][4];
    run_ring<FSTAGES>(
        (k + FK - 1) / FK,
        [&](int s) {
          float* sa = ring + (s % FSTAGES) * STAGE;
          stage_wide<TS, ROWS, FK, FA_LD, FTHREADS>(sa, fa, m0, rows, s * FK,
                                                    k);
          stage_wide<TA, FK, FN, FB_LD, FTHREADS>(sa + ROWS * FA_LD, fb,
                                                  s * FK, k, n0, m);
        },
        [&] {  // this thread's elements of C
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int gr = row0 + f_row<ROWS>(i);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              cv[i][j] = (gr < rows && col0 + j < m)
                             ? widen<TA, float>(c_at(gr, col0 + j))
                             : 0.0f;
              acc[i][j] = 0.0f;
            }
          }
        },
        [&](int kt) {
          const float* sa = ring + (kt % FSTAGES) * STAGE;
          fma_slice<ROWS>(sa, sa + ROWS * FA_LD, acc);
        });
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int gr = row0 + f_row<ROWS>(i);
      if (gr >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + j < m) {
          out[gr * wr + static_cast<long long>(col0 + j) * wc] =
              narrow<TA, float>(cv[i][j] - acc[i][j]);
        }
      }
    }
  }
}

template <typename TS, typename TA, int ROWS>
constexpr size_t product_smem() {
  if constexpr (std::is_same<TA, double>::value) {
    return Ring<TS, double, ROWS>::SMEM;
  } else if constexpr (is_half_type<TA>::value) {
    return FSTAGES * FK * (FM + 8 + FN + 8) * 2;
  } else {
    return FSTAGES * (ROWS * FA_LD + FK * FB_LD) * sizeof(float);
  }
}

// One call's solve: its operands, and the recursion that launches it.
template <typename TS, typename TA>
struct Solver {
  // the products' tiles: 64 rows, and 128 from BIG_PRODUCT rows up on the
  // f64 route (the route of the large solves); 128 on the narrow routes
  static constexpr bool BIG = std::is_same<TS, double>::value;
  static constexpr int SMALL = is_half_type<TA>::value ? FM : 64;
  const TS* t;
  long long tb, tr, tc;
  const TS* b;
  long long bb, br, bc;
  TS* x;
  long long xb, xr, xc;
  TA* w;
  long long wb, wr, wc;
  int batch, m;
  bool unit;
  cudaStream_t stream;

  // Rows [r0, r0 + n): leaves of LEAF rows, split at a multiple of LEAF
  // that depends on n alone.
  cudaError_t solve(int r0, int n) {
    if (n <= LEAF) return leaf(r0, n);
    const int leaves = (n + LEAF - 1) / LEAF;
    const int n1 = LEAF * ((leaves + 1) / 2);
    cudaError_t err = solve(r0, n1);
    if (err == cudaSuccess) err = product(r0, n1, n - n1);
    if (err == cudaSuccess) err = solve(r0 + n1, n - n1);
    return err;
  }

  // A leaf of 32, 64 or 128 rows, the fewest that hold nr.
  cudaError_t leaf(int r0, int nr) {
    const dim3 grid((m + LEAF_COLS - 1) / LEAF_COLS, 1, batch);
    if (nr <= LEAF / 4) return leaf_launch<LEAF / 4>(grid, r0, nr);
    if (nr <= LEAF / 2) return leaf_launch<LEAF / 2>(grid, r0, nr);
    return leaf_launch<LEAF>(grid, r0, nr);
  }

  template <int ROWS>
  cudaError_t leaf_launch(dim3 grid, int r0, int nr) {
    return unit ? leaf_as<true, ROWS>(grid, r0, nr)
                : leaf_as<false, ROWS>(grid, r0, nr);
  }

  template <bool UNIT, int ROWS>
  cudaError_t leaf_as(dim3 grid, int r0, int nr) {
    constexpr auto kernel = leaf_kernel<TS, TA, UNIT, ROWS>;
    constexpr size_t SMEM = Leaf<TS, TA, ROWS>::SMEM;
    const cudaError_t err = allow_smem<kernel>(SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<grid, Leaf<TS, TA, ROWS>::THREADS, SMEM, stream>>>(
        t, tb, tr, tc, b, bb, br, bc, w, wb, wr, wc, x, xb, xr, xc, r0, nr, m);
    return cudaGetLastError();
  }

  // Rows [r0 + k, r0 + k + rows) lose T[those rows, r0 : r0 + k] times
  // the solved rows [r0, r0 + k). Where W's rows have unit stride (the
  // transposed problem of trsm_upper_right), the product runs transposed,
  // W^T[:, rows] -= W^T[:, K] T^T[K, rows], so that every operand is
  // staged along its unit stride; each element sums the same products in
  // the same order either way. The tile depends on rows alone.
  cudaError_t product(int r0, int k, int rows) {
    if (BIG && rows >= BIG_PRODUCT) return product_launch<128>(r0, k, rows);
    return product_launch<SMALL>(r0, k, rows);
  }

  template <int ROWS>
  cudaError_t product_launch(int r0, int k, int rows) {
    constexpr auto kernel = update_kernel<TS, TA, ROWS>;
    constexpr size_t SMEM = product_smem<TS, TA, ROWS>();
    const cudaError_t err = allow_smem<kernel>(SMEM);
    if (err != cudaSuccess) return err;
    const int p0 = r0 + k, from_b = r0 == 0;
    const TS* tk = t + p0 * tr + r0 * tc;
    TA* wk = w + r0 * wr;
    TA* wp = w + p0 * wr;
    const TS* bp = b + p0 * br;
    const auto mag = [](long long v) { return v < 0 ? -v : v; };
    if constexpr (std::is_same<TS, TA>::value) {
      if (mag(wr) == 1 && mag(wc) != 1) {
        const dim3 grid((rows + DN - 1) / DN, (m + ROWS - 1) / ROWS, batch);
        kernel<<<grid, product_threads<TA, ROWS>(), SMEM, stream>>>(
            wk, wb, wc, wr, tk, tb, tc, tr, bp, bb, bc, br, wp, wb, wc, wr, m,
            rows, k, from_b);
        return cudaGetLastError();
      }
    }
    const dim3 grid((m + DN - 1) / DN, (rows + ROWS - 1) / ROWS, batch);
    kernel<<<grid, product_threads<TA, ROWS>(), SMEM, stream>>>(
        tk, tb, tr, tc, wk, wb, wr, wc,
                                            bp, bb, br, bc, wp, wb, wr, wc,
                                            rows, m, k, from_b);
    return cudaGetLastError();
  }
};

}  // namespace

// Solve T X = B for `batch` problems: T n x n lower triangular at strides
// (tb, tr, tc), B and X n x m at strides (bb, br, bc) and (xb, xr, xc);
// W, n x m at strides (wb, wr, wc), is the TA workspace of a mixed route
// and X itself on a default one. unit: 1 to take T's diagonal as ones.
// trsm_<route> names the storage type, then the arithmetic type where it
// is wider. Returns the first launch's cudaGetLastError() that is not
// cudaSuccess, else 0.
#define TRSM_ENTRY(ROUTE, TS, TA)                                            \
  int trsm_##ROUTE(const TS* t, long long tb, long long tr, long long tc,  \
                   const TS* b, long long bb, long long br, long long bc,  \
                   TS* x, long long xb, long long xr, long long xc, TA* w, \
                   long long wb, long long wr, long long wc, int batch,    \
                   int n, int m, int unit, cudaStream_t stream) {          \
    Solver<TS, TA> s{t,  tb, tr,    tc, b,  bb, br,       bc,    x,        \
                     xb, xr, xc,    w,  wb, wr, wc,       batch, m,        \
                     unit != 0, stream};                                   \
    return static_cast<int>(s.solve(0, n));                                \
  }

extern "C" {

TRSM_ENTRY(f64, double, double)
TRSM_ENTRY(f32, float, float)
TRSM_ENTRY(f32_f64, float, double)
TRSM_ENTRY(bf16_f32, __nv_bfloat16, float)
TRSM_ENTRY(f16_f32, __half, float)
TRSM_ENTRY(bf16, __nv_bfloat16, __nv_bfloat16)
TRSM_ENTRY(f16, __half, __half)
TRSM_ENTRY(bf16_f64, __nv_bfloat16, double)
TRSM_ENTRY(f16_f64, __half, double)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
