// Triangular-solve kernels: X = L^-1 B (L unit lower) and Z = B U^-1
// (U upper, non-unit diagonal), through one lower-triangular solver.
//
// Replaces: src/repro/kernels/trsm.py:trsm_lower (_trsm_lower_kernel)
// and src/repro/kernels/trsm.py:trsm_upper_right
// (_trsm_upper_right_kernel): the U and L strips of Algorithm 3 and the
// strips inside each blocked diagonal panel.
//
// Z U = B is U^T Z^T = B^T, a lower solve with a non-unit diagonal. Every
// operand is passed with its batch, row and column strides, so the
// wrapper hands the transposes over as stride swaps and strided views
// (the panel loop's a[..., s0:s1, s1:]) need no copy.
//
// What bounds it on the H100: operations at the strip shapes. An n x n
// triangle against n x m takes n^2 m operations over (n^2/2 + 2 n m)
// elements moved; at n = m = 1024 in f64 that is 1.07 GFLOP against
// 21 MB, about 16 us at the 67 TFLOP/s f64 tensor-core peak and 6 us at
// 3.35 TB/s. Underneath the operations lies a dependent chain of n
// substitution steps, which no number of SMs shortens.
//
// What the design does about it: a blocked right-looking solve, launched
// from one host call as 2 ceil(n / 64) - 1 kernels on the stream.
//  * Leaf (leaf_kernel): a 64-row (or shorter, last) diagonal tile of the
//    triangle against every column. One warp owns one column, two rows a
//    lane, and runs the 64 substitution steps warp-synchronously: x_k is
//    broadcast by a shuffle, divided by the diagonal (non-unit), and
//    every lane below subtracts T[i][k] x_k, T read from shared memory
//    that the block's four warps share. No block barrier per row, and
//    four columns a block, so a 1024-column strip gives 256 blocks and
//    the 32 x 992 panel strips (a single leaf, one launch) 248.
//  * Update (update_kernel): the rows below the leaf lose T[below, leaf]
//    times the leaf's solved rows, a K = 64 product over 64 x 64 output
//    tiles (240 blocks for the first update at n = m = 1024), on the f64
//    tensor cores (DMMA, mma.sync m8n8k4) for f64 and on the FMA pipes
//    for f32 (no TF32 anywhere). Tiles stage through shared memory with
//    consecutive threads on whichever axis has unit stride, every load of
//    a tile issued before its first store (one memory latency a tile).
// An upper-triangular left solve U X = B comes as (J U J)(J X) = J B, J
// the row reversal: J U J is lower, so the wrapper passes U's last
// element with both strides negated and B's and X's last rows with their
// row strides negated; offsets are signed 64-bit throughout.
// Every output column (every row, for the transposed call) goes through
// the same sequence of operations whatever m, its offset, or the
// operands' strides: the leaves depend on n alone, each product sums its
// K = 64 terms in one fixed order, and nothing uses atomics. So a call
// over m columns is bit-equal to calls over any split of its columns,
// which keeps lu_block_row's strips bit-equal to lu_nserver's and every
// transport's factors bit-equal to the fused sweep's. The leaf is a
// substitution, with a true division by the diagonal, not a multiply by
// an inverted tile.
// Mixed variant (the reference's acc_dtype, which solves a whole tile in
// the wide type and stores it narrow once): the solver takes a storage
// type TS and an arithmetic type TA, float with double or bfloat16 and
// half with float. Between launches the solve keeps its rows in a TA
// workspace W (n x m, allocated by the wrapper), never in the narrow
// output: each update writes the trailing rows to W, each leaf solves
// rows of W (of B, widened, for the first) and writes them wide to W,
// for the updates after it, and narrow to X, once. The triangle is
// widened as it is staged. The double updates stay on DMMA, the float
// ones on the FMA pipes. The default routes pass X itself as W (TS = TA),
// so their launches are unchanged. Every column still sees the same
// operations whatever m, so the split property above holds for both.
// bfloat16 and half storage take float or double arithmetic this way.
// Narrow variant (bfloat16 or half with no acc_dtype, as the reference's
// kernel computes them): TA = TS, every operation rounded to the half
// type (precision.cuh: quot, sub_prod), and the update subtracts its
// terms one at a time, k ascending, from the trailing rows' values
// instead of subtracting their sum: each element then sees the plain
// version's forward substitution, operation for operation, so the
// result is the plain version's bits.
#include <cuda_runtime.h>

#include <type_traits>

#include "precision.cuh"

namespace {

constexpr int LEAF = 64;          // rows per leaf (two per lane)
constexpr int LEAF_COLS = 4;      // columns (warps) per leaf block
constexpr int LEAF_LD = LEAF + 1; // odd row stride: column reads conflict-free
constexpr int TILE = 64;          // update tile: rows and columns
constexpr int TILE_LD = TILE + 4; // f64 fragment reads conflict-free
constexpr int UPD_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// s[r * LD + c] = g[(r0 + r) sr + (c0 + c) sc], widened to TA, for
// r < nr, c < nc of a ROWS x COLS tile, zero elsewhere; consecutive
// threads along the axis of g whose stride is 1 or -1 (a reversed view),
// told apart by the strides' magnitudes: four sign compares instead
// doubled the solver's registers (64 to 156) and slowed its default
// routes. Every thread issues all its loads before its first store, so a
// tile costs one memory latency, not one per element.
template <typename TA, typename TG, int ROWS, int COLS, int THREADS, int LD>
__device__ __forceinline__ void stage(TA* s, const TG* __restrict__ g,
                                      long long sr, long long sc, int r0,
                                      int c0, int nr, int nc) {
  constexpr int PER = ROWS * COLS / THREADS;
  static_assert(ROWS * COLS % THREADS == 0, "tile not split evenly");
  const bool along_cols =
      (sc < 0 ? -sc : sc) == 1 || (sr < 0 ? -sr : sr) != 1;
  TA v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int r = along_cols ? e / COLS : e % ROWS;
    const int c = along_cols ? e % COLS : e / ROWS;
    v[j] = (r < nr && c < nc)
               ? widen<TG, TA>(
                     g[(r0 + r) * sr + static_cast<long long>(c0 + c) * sc])
               : constant<TA>(0.f);
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int r = along_cols ? e / COLS : e % ROWS;
    const int c = along_cols ? e % COLS : e / ROWS;
    s[r * LD + c] = v[j];
  }
}

// Solve the leaf rows [r0, r0 + nr) of matrix blockIdx.z for the columns
// [LEAF_COLS x, LEAF_COLS x + LEAF_COLS): w = T_leaf^-1 src (rows of src
// already hold b minus every earlier leaf's contribution), and x = w
// rounded to TS where the route is mixed (w is x otherwise).
template <typename TS, typename TA, typename TSRC, bool UNIT>
__global__ void __launch_bounds__(32 * LEAF_COLS)
leaf_kernel(const TS* __restrict__ t, long long tb, long long tr,
            long long tc, const TSRC* src, long long sb, long long sr,
            long long sc, TA* w, long long wb, long long wr, long long wc,
            TS* x, long long xb, long long xr, long long xc, int r0, int nr,
            int m) {
  constexpr bool MIXED = !std::is_same<TS, TA>::value;
  __shared__ TA ts[LEAF * LEAF_LD];
  t += blockIdx.z * tb;
  src += blockIdx.z * sb;
  w += blockIdx.z * wb;
  x += blockIdx.z * xb;
  stage<TA, TS, LEAF, LEAF, 32 * LEAF_COLS, LEAF_LD>(ts, t, tr, tc, r0, r0,
                                                     nr, nr);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * LEAF_COLS + (threadIdx.x >> 5);
  if (col >= m) return;
  const long long cs = static_cast<long long>(col);
  const int i0 = lane, i1 = lane + 32;
  TA a0 = i0 < nr ? widen<TSRC, TA>(src[(r0 + i0) * sr + cs * sc])
                   : constant<TA>(0.f);
  TA a1 = i1 < nr ? widen<TSRC, TA>(src[(r0 + i1) * sr + cs * sc])
                   : constant<TA>(0.f);
  for (int k = 0; k < nr; ++k) {
    TA xk = __shfl_sync(FULL, k < 32 ? a0 : a1, k & 31);
    if (!UNIT) xk = quot(xk, ts[k * LEAF_LD + k]);
    if (i0 == k) a0 = xk;
    if (i1 == k) a1 = xk;
    if (i0 > k && i0 < nr) a0 = sub_prod(a0, ts[i0 * LEAF_LD + k], xk);
    if (i1 > k && i1 < nr) a1 = sub_prod(a1, ts[i1 * LEAF_LD + k], xk);
  }
  if (i0 < nr) {
    w[(r0 + i0) * wr + cs * wc] = a0;
    if (MIXED) x[(r0 + i0) * xr + cs * xc] = narrow<TS, TA>(a0);
  }
  if (i1 < nr) {
    w[(r0 + i1) * wr + cs * wc] = a1;
    if (MIXED) x[(r0 + i1) * xr + cs * xc] = narrow<TS, TA>(a1);
  }
}

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// Warp tile of the update: 32 rows x 16 columns of the 64 x 64 block
// tile, acc[mi][ni][e] = sum over k of A[row][k] X[k][col], k ascending
// in steps of 4, with row = 32 wy + 8 mi + g, col = 16 wx + 8 ni + 2 t + e
// (g = lane / 4, t = lane % 4, the DMMA fragment layout).
__device__ __forceinline__ void tile_product(const double* as,
                                             const double* bs, int k,
                                             double (&acc)[4][2][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wy = warp >> 2, wx = warp & 3;
  for (int k0 = 0; k0 < k; k0 += 4) {
    double a[4], b[2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      a[mi] = as[(32 * wy + 8 * mi + g) * TILE_LD + k0 + tq];
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      b[ni] = bs[(k0 + tq) * TILE_LD + 16 * wx + 8 * ni + g];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        dmma(acc[mi][ni][0], acc[mi][ni][1], a[mi], b[ni]);
      }
    }
  }
}

// The same product in f32 on the FMA pipes, one FMA per term, k
// ascending, in the same output layout.
__device__ __forceinline__ void tile_product(const float* as,
                                             const float* bs, int k,
                                             float (&acc)[4][2][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wy = warp >> 2, wx = warp & 3;
  for (int kk = 0; kk < k; ++kk) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float a = as[(32 * wy + 8 * mi + g) * TILE_LD + kk];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[mi][ni][e] = fmaf(
              a, bs[kk * TILE_LD + 16 * wx + 8 * ni + 2 * tq + e],
              acc[mi][ni][e]);
        }
      }
    }
  }
}

// The narrow routes' product: acc enters holding src and loses each
// term in turn, k ascending, every product and difference rounded to the
// half type, as the plain version's forward substitution updates a row
// (the f32 and f64 routes sum the terms first, then subtract the sum).
template <typename H>
__device__ __forceinline__ void tile_product(const H* as, const H* bs, int k,
                                             H (&acc)[4][2][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wy = warp >> 2, wx = warp & 3;
  for (int kk = 0; kk < k; ++kk) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const H a = as[(32 * wy + 8 * mi + g) * TILE_LD + kk];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[mi][ni][e] = sub_prod(
              acc[mi][ni][e], a,
              bs[kk * TILE_LD + 16 * wx + 8 * ni + 2 * tq + e]);
        }
      }
    }
  }
}

// w[rows r1 + 64 y ..., cols 64 x ...] = src - T[those rows, r0 : r0 + k]
// w[r0 : r0 + k, those cols], for the trailing rows [r1, n).
template <typename TS, typename TA, typename TSRC>
__global__ void __launch_bounds__(UPD_THREADS)
update_kernel(const TS* __restrict__ t, long long tb, long long tr,
              long long tc, const TSRC* src, long long sb, long long sr,
              long long sc, TA* w, long long wb, long long wr, long long wc,
              int r0, int k, int r1, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* as = reinterpret_cast<TA*>(smem_raw);
  TA* bs = as + TILE * TILE_LD;
  t += blockIdx.z * tb;
  src += blockIdx.z * sb;
  w += blockIdx.z * wb;
  const int row0 = r1 + blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int nr = min(TILE, n - row0);
  const int nc = min(TILE, m - col0);
  stage<TA, TS, TILE, TILE, UPD_THREADS, TILE_LD>(as, t, tr, tc, row0, r0,
                                                  nr, k);
  stage<TA, TA, TILE, TILE, UPD_THREADS, TILE_LD>(bs, w, wr, wc, r0, col0, k,
                                                  nc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wy = warp >> 2, wx = warp & 3;
  // this thread's elements of src, fetched while the product runs (src
  // may be w itself, so all reads come before any write)
  TA cv[4][2][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = 32 * wy + 8 * mi + g;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * wx + 8 * ni + 2 * tq + e;
        cv[mi][ni][e] =
            (r < nr && c < nc)
                ? widen<TSRC, TA>(src[(row0 + r) * sr +
                                      static_cast<long long>(col0 + c) * sc])
                : constant<TA>(0.f);
      }
    }
  }
  __syncthreads();
  constexpr bool HALF = is_half_type<TA>::value;
  TA acc[4][2][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[mi][ni][e] = HALF ? cv[mi][ni][e] : constant<TA>(0.f);
      }
    }
  }
  tile_product(as, bs, k, acc);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int r = 32 * wy + 8 * mi + g;
    if (r >= nr) continue;
    const long long gr = row0 + r;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * wx + 8 * ni + 2 * tq + e;
        if (c >= nc) continue;
        if constexpr (HALF) {
          w[gr * wr + (col0 + c) * wc] = acc[mi][ni][e];
        } else {
          w[gr * wr + (col0 + c) * wc] = cv[mi][ni][e] - acc[mi][ni][e];
        }
      }
    }
  }
}

template <typename TS, typename TA, typename TSRC>
cudaError_t leaf(dim3 grid, cudaStream_t stream, bool unit, const TS* t,
                 long long tb, long long tr, long long tc, const TSRC* src,
                 long long sb, long long sr, long long sc, TA* w,
                 long long wb, long long wr, long long wc, TS* x,
                 long long xb, long long xr, long long xc, int r0, int nr,
                 int m) {
  if (unit) {
    leaf_kernel<TS, TA, TSRC, true><<<grid, 32 * LEAF_COLS, 0, stream>>>(
        t, tb, tr, tc, src, sb, sr, sc, w, wb, wr, wc, x, xb, xr, xc, r0, nr,
        m);
  } else {
    leaf_kernel<TS, TA, TSRC, false><<<grid, 32 * LEAF_COLS, 0, stream>>>(
        t, tb, tr, tc, src, sb, sr, sc, w, wb, wr, wc, x, xb, xr, xc, r0, nr,
        m);
  }
  return cudaGetLastError();
}

template <typename TS, typename TA>
int launch(const TS* t, long long tb, long long tr, long long tc,
           const TS* b, long long bb, long long br, long long bc, TS* x,
           long long xb, long long xr, long long xc, TA* w, long long wb,
           long long wr, long long wc, int batch, int n, int m, int unit,
           cudaStream_t stream) {
  const int smem = static_cast<int>(2 * TILE * TILE_LD * sizeof(TA));
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel<TS, TA, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(update_kernel<TS, TA, TA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 leaf_grid((m + LEAF_COLS - 1) / LEAF_COLS, 1, batch);
  for (int r0 = 0; r0 < n; r0 += LEAF) {
    const int nr = min(LEAF, n - r0);
    const int r1 = r0 + nr;
    const dim3 grid((m + TILE - 1) / TILE, (n - r1 + TILE - 1) / TILE, batch);
    // the first leaf and the first update read b, at TS; everything after
    // reads the rows of w that the first update wrote, at TA
    if (r0 == 0) {
      err = leaf<TS, TA, TS>(leaf_grid, stream, unit, t, tb, tr, tc, b, bb,
                             br, bc, w, wb, wr, wc, x, xb, xr, xc, r0, nr, m);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (r1 >= n) break;
      update_kernel<TS, TA, TS><<<grid, UPD_THREADS, smem, stream>>>(
          t, tb, tr, tc, b, bb, br, bc, w, wb, wr, wc, r0, nr, r1, n, m);
    } else {
      err = leaf<TS, TA, TA>(leaf_grid, stream, unit, t, tb, tr, tc, w, wb,
                             wr, wc, w, wb, wr, wc, x, xb, xr, xc, r0, nr, m);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (r1 >= n) break;
      update_kernel<TS, TA, TA><<<grid, UPD_THREADS, smem, stream>>>(
          t, tb, tr, tc, w, wb, wr, wc, w, wb, wr, wc, r0, nr, r1, n, m);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

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
    return launch<TS, TA>(t, tb, tr, tc, b, bb, br, bc, x, xb, xr, xc, w,  \
                          wb, wr, wc, batch, n, m, unit, stream);          \
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
