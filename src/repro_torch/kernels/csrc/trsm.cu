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
// Every output column (every row, for the transposed call) goes through
// the same sequence of operations whatever m, its offset, or the
// operands' strides: the leaves depend on n alone, each product sums its
// K = 64 terms in one fixed order, and nothing uses atomics. So a call
// over m columns is bit-equal to calls over any split of its columns,
// which keeps lu_block_row's strips bit-equal to lu_nserver's and every
// transport's factors bit-equal to the fused sweep's. The leaf is a
// substitution, with a true division by the diagonal, not a multiply by
// an inverted tile.
#include <cuda_runtime.h>

namespace {

constexpr int LEAF = 64;          // rows per leaf (two per lane)
constexpr int LEAF_COLS = 4;      // columns (warps) per leaf block
constexpr int LEAF_LD = LEAF + 1; // odd row stride: column reads conflict-free
constexpr int TILE = 64;          // update tile: rows and columns
constexpr int TILE_LD = TILE + 4; // f64 fragment reads conflict-free
constexpr int UPD_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// s[r * LD + c] = g[(r0 + r) sr + (c0 + c) sc] for r < nr, c < nc of a
// ROWS x COLS tile, zero elsewhere; consecutive threads along the
// unit-stride axis of g. Every thread issues all its loads before its
// first store, so a tile costs one memory latency, not one per element.
template <typename T, int ROWS, int COLS, int THREADS, int LD>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g,
                                      long long sr, long long sc, int r0,
                                      int c0, int nr, int nc) {
  constexpr int PER = ROWS * COLS / THREADS;
  static_assert(ROWS * COLS % THREADS == 0, "tile not split evenly");
  const bool along_cols = sc == 1 || sr != 1;
  T v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = threadIdx.x + j * THREADS;
    const int r = along_cols ? e / COLS : e % ROWS;
    const int c = along_cols ? e % COLS : e / ROWS;
    v[j] = (r < nr && c < nc)
               ? g[(r0 + r) * sr + static_cast<long long>(c0 + c) * sc]
               : T(0);
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
// [LEAF_COLS x, LEAF_COLS x + LEAF_COLS): x = T_leaf^-1 src (rows of src
// already hold b minus every earlier leaf's contribution).
template <typename T, bool UNIT>
__global__ void __launch_bounds__(32 * LEAF_COLS)
leaf_kernel(const T* __restrict__ t, long long tb, long long tr,
            long long tc, const T* src, long long sb, long long sr,
            long long sc, T* x, long long xb, long long xr, long long xc,
            int r0, int nr, int m) {
  __shared__ T ts[LEAF * LEAF_LD];
  t += blockIdx.z * tb;
  src += blockIdx.z * sb;
  x += blockIdx.z * xb;
  stage<T, LEAF, LEAF, 32 * LEAF_COLS, LEAF_LD>(ts, t, tr, tc, r0, r0, nr,
                                                nr);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * LEAF_COLS + (threadIdx.x >> 5);
  if (col >= m) return;
  const long long cs = static_cast<long long>(col);
  const int i0 = lane, i1 = lane + 32;
  T a0 = i0 < nr ? src[(r0 + i0) * sr + cs * sc] : T(0);
  T a1 = i1 < nr ? src[(r0 + i1) * sr + cs * sc] : T(0);
  for (int k = 0; k < nr; ++k) {
    T xk = __shfl_sync(FULL, k < 32 ? a0 : a1, k & 31);
    if (!UNIT) xk = xk / ts[k * LEAF_LD + k];
    if (i0 == k) a0 = xk;
    if (i1 == k) a1 = xk;
    if (i0 > k && i0 < nr) a0 -= ts[i0 * LEAF_LD + k] * xk;
    if (i1 > k && i1 < nr) a1 -= ts[i1 * LEAF_LD + k] * xk;
  }
  if (i0 < nr) x[(r0 + i0) * xr + cs * xc] = a0;
  if (i1 < nr) x[(r0 + i1) * xr + cs * xc] = a1;
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

// x[rows r1 + 64 y ..., cols 64 x ...] = src - T[those rows, r0 : r0 + k]
// x[r0 : r0 + k, those cols], for the trailing rows [r1, n).
template <typename T>
__global__ void __launch_bounds__(UPD_THREADS)
update_kernel(const T* __restrict__ t, long long tb, long long tr,
              long long tc, const T* src, long long sb, long long sr,
              long long sc, T* x, long long xb, long long xr, long long xc,
              int r0, int k, int r1, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + TILE * TILE_LD;
  t += blockIdx.z * tb;
  src += blockIdx.z * sb;
  x += blockIdx.z * xb;
  const int row0 = r1 + blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int nr = min(TILE, n - row0);
  const int nc = min(TILE, m - col0);
  stage<T, TILE, TILE, UPD_THREADS, TILE_LD>(as, t, tr, tc, row0, r0, nr, k);
  stage<T, TILE, TILE, UPD_THREADS, TILE_LD>(bs, x, xr, xc, r0, col0, k, nc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wy = warp >> 2, wx = warp & 3;
  // this thread's elements of src, fetched while the product runs (src
  // may be x itself, so all reads come before any write)
  T cv[4][2][2];
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
                ? src[(row0 + r) * sr + static_cast<long long>(col0 + c) * sc]
                : T(0);
      }
    }
  }
  __syncthreads();
  T acc[4][2][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = T(0);
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
        x[gr * xr + (col0 + c) * xc] = cv[mi][ni][e] - acc[mi][ni][e];
      }
    }
  }
}

template <typename T>
int launch(const T* t, long long tb, long long tr, long long tc, const T* b,
           long long bb, long long br, long long bc, T* x, long long xb,
           long long xr, long long xc, int batch, int n, int m, int unit,
           cudaStream_t stream) {
  const int smem = static_cast<int>(2 * TILE * TILE_LD * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 leaf_grid((m + LEAF_COLS - 1) / LEAF_COLS, 1, batch);
  for (int r0 = 0; r0 < n; r0 += LEAF) {
    const int nr = min(LEAF, n - r0);
    // the first leaf and the first update read b; everything after reads
    // the rows of x that the first update wrote
    const T* src = r0 == 0 ? b : x;
    const long long sb = r0 == 0 ? bb : xb;
    const long long sr = r0 == 0 ? br : xr;
    const long long sc = r0 == 0 ? bc : xc;
    if (unit) {
      leaf_kernel<T, true><<<leaf_grid, 32 * LEAF_COLS, 0, stream>>>(
          t, tb, tr, tc, src, sb, sr, sc, x, xb, xr, xc, r0, nr, m);
    } else {
      leaf_kernel<T, false><<<leaf_grid, 32 * LEAF_COLS, 0, stream>>>(
          t, tb, tr, tc, src, sb, sr, sc, x, xb, xr, xc, r0, nr, m);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int r1 = r0 + nr;
    if (r1 >= n) break;
    const dim3 grid((m + TILE - 1) / TILE, (n - r1 + TILE - 1) / TILE, batch);
    update_kernel<T><<<grid, UPD_THREADS, smem, stream>>>(
        t, tb, tr, tc, src, sb, sr, sc, x, xb, xr, xc, r0, nr, r1, n, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Solve T X = B for `batch` problems: T n x n lower triangular at strides
// (tb, tr, tc), B and X n x m at strides (bb, br, bc) and (xb, xr, xc).
// unit: 1 to take T's diagonal as ones. Returns the first launch's
// cudaGetLastError() that is not cudaSuccess, else 0.
int trsm_f64(const double* t, long long tb, long long tr, long long tc,
             const double* b, long long bb, long long br, long long bc,
             double* x, long long xb, long long xr, long long xc, int batch,
             int n, int m, int unit, cudaStream_t stream) {
  return launch(t, tb, tr, tc, b, bb, br, bc, x, xb, xr, xc, batch, n, m,
                unit, stream);
}

int trsm_f32(const float* t, long long tb, long long tr, long long tc,
             const float* b, long long bb, long long br, long long bc,
             float* x, long long xb, long long xr, long long xc, int batch,
             int n, int m, int unit, cudaStream_t stream) {
  return launch(t, tb, tr, tc, b, bb, br, bc, x, xb, xr, xc, batch, n, m,
                unit, stream);
}

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
