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
// 21 MB, about 16 us at the 67 TFLOP/s f64 peak and 6 us at 3.35 TB/s.
//
// What the design does about it: columns of B are independent, so each
// thread block owns 32 of them (and one matrix of the batch) and walks
// the rows in chunks of 32, left-looking: a chunk first subtracts the
// product of its 32 rows of the triangle with every solved row above it,
// as 32 x 32 tiles staged in shared memory (an FMA per element pair,
// the triangle's entries broadcast across the warp), then solves its own
// 32 x 32 triangle in shared memory, one barrier per step, and writes
// its rows out. The subtraction order per element is the plain version's
// (k ascending), so the two differ only by FMA contraction. Tile loads
// put consecutive threads on whichever axis has unit stride, so both the
// direct and the transposed operands read coalesced. The grid is only
// m/32 x batch blocks: 32 blocks for a 1024-column strip, a quarter of
// the card's 132 SMs. That is the first thing to change for speed.
#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;        // chunk rows == columns per block
constexpr int TY = 8;         // thread rows; a block is TS x TY threads
constexpr int RPT = TS / TY;  // rows of a chunk per thread

// s[r][c] = g[(r0 + r) sr + (c0 + c) sc] inside nr x nc, zero outside.
template <typename T>
__device__ __forceinline__ void load_tile(T (*s)[TS + 1], const T* g,
                                          long long sr, long long sc, int r0,
                                          int c0, int nr, int nc) {
  const int tx = threadIdx.x;
  if (sc == 1) {
    for (int r = threadIdx.y; r < TS; r += TY) {
      s[r][tx] = (r < nr && tx < nc)
                     ? g[(r0 + r) * sr + (c0 + tx)]
                     : T(0);
    }
  } else {
    for (int c = threadIdx.y; c < TS; c += TY) {
      s[tx][c] = (tx < nr && c < nc)
                     ? g[(r0 + tx) * sr + static_cast<long long>(c0 + c) * sc]
                     : T(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T (*s)[TS + 1], T* g,
                                           long long sr, long long sc, int r0,
                                           int c0, int nr, int nc) {
  const int tx = threadIdx.x;
  if (sc == 1) {
    for (int r = threadIdx.y; r < nr; r += TY) {
      if (tx < nc) g[(r0 + r) * sr + (c0 + tx)] = s[r][tx];
    }
  } else {
    for (int c = threadIdx.y; c < nc; c += TY) {
      if (tx < nr) {
        g[(r0 + tx) * sr + static_cast<long long>(c0 + c) * sc] = s[tx][c];
      }
    }
  }
}

// Solve T X = B: T lower triangular n x n (unit diagonal if UNIT), B and
// X n x m. Block (x, -, z) owns columns [32 x, 32 x + 32) of matrix z.
template <typename T, bool UNIT>
__global__ void trsm_kernel(const T* __restrict__ t, long long tb,
                            long long tr, long long tc,
                            const T* __restrict__ bmat, long long bb,
                            long long br, long long bc, T* x, long long xb,
                            long long xr, long long xc, int n, int m) {
  __shared__ T ts[TS][TS + 1];  // a tile of the triangle
  __shared__ T xs[TS][TS + 1];  // solved rows above, then the chunk itself
  t += blockIdx.z * tb;
  bmat += blockIdx.z * bb;
  x += blockIdx.z * xb;
  const int c0 = blockIdx.x * TS;
  const int nc = min(TS, m - c0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int r0 = 0; r0 < n; r0 += TS) {
    const int nr = min(TS, n - r0);
    T acc[RPT];
    load_tile(xs, bmat, br, bc, r0, c0, nr, nc);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[q] = xs[ty + q * TY][tx];
    __syncthreads();
    // acc -= T[r0:r0+nr, 0:r0] X[0:r0, cols], 32 solved rows at a time
    for (int k0 = 0; k0 < r0; k0 += TS) {
      load_tile(ts, t, tr, tc, r0, k0, nr, TS);
      load_tile(xs, x, xr, xc, k0, c0, TS, nc);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TS; ++k) {
        const T xv = xs[k][tx];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] -= ts[ty + q * TY][k] * xv;
      }
      __syncthreads();
    }
    // this chunk's own triangle, one row of X per step
    load_tile(ts, t, tr, tc, r0, r0, nr, nr);
#pragma unroll
    for (int q = 0; q < RPT; ++q) xs[ty + q * TY][tx] = acc[q];
    __syncthreads();
    for (int k = 0; k < nr; ++k) {
      if (!UNIT) {
        if (ty == 0) xs[k][tx] = xs[k][tx] / ts[k][k];
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int i = ty + q * TY;
        if (i > k && i < nr) xs[i][tx] -= ts[i][k] * xs[k][tx];
      }
      __syncthreads();
    }
    store_tile(xs, x, xr, xc, r0, c0, nr, nc);
    __syncthreads();
  }
}

template <typename T>
int launch(const T* t, long long tb, long long tr, long long tc, const T* b,
           long long bb, long long br, long long bc, T* x, long long xb,
           long long xr, long long xc, int batch, int n, int m, int unit,
           cudaStream_t stream) {
  const dim3 block(TS, TY);
  const dim3 grid((m + TS - 1) / TS, 1, batch);
  if (unit) {
    trsm_kernel<T, true><<<grid, block, 0, stream>>>(
        t, tb, tr, tc, b, bb, br, bc, x, xb, xr, xc, n, m);
  } else {
    trsm_kernel<T, false><<<grid, block, 0, stream>>>(
        t, tb, tr, tc, b, bb, br, bc, x, xb, xr, xc, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Solve T X = B for `batch` problems: T n x n lower triangular at strides
// (tb, tr, tc), B and X n x m at strides (bb, br, bc) and (xb, xr, xc).
// unit: 1 to take T's diagonal as ones. Returns cudaGetLastError().
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
