// CED cipher kernel: out = rot90_cw^k(EWO(m, v)) in one pass over memory.
//
// Replaces: src/repro/kernels/ced.py:ced (_ced_kernel, _out_index_map),
// the Pallas kernel of the paper's Cipher stage (EWO row blinding and PRT
// rotation "run simultaneously", paper section IV.C).
//
// What bounds it on the H100: bytes. Each element is read once, divided
// (or multiplied) by its row's blinding entry and written once: one
// operation per 16 bytes moved in f64, far below the card's balance
// point, so its floor is 2 n^2 sizeof(T) over the memory rate.
//
// What the design does about it: a relayout that writes element (r, c)
// to its rotated place would read or write with a stride of n. Each
// block instead owns one 32x32 tile of the OUTPUT, reads the matching
// 32x32 tile of the input with consecutive threads on consecutive
// columns, scales it into shared memory, and writes the output tile
// again with consecutive threads on consecutive columns, picking each
// element from shared memory by the inverse relayout. Both the read and
// the write coalesce; the rotation costs only shared-memory addressing.
// The tile row is padded by one element against bank conflicts. Ragged
// edges (n not a multiple of 32) are masked. One k per launch; a batch
// runs on the grid's z axis.
//
// Exactness: the scale is one IEEE division or multiplication per
// element, and the relayout moves bits, so the output is bit-equal to the
// plain version. Built without --use_fast_math, which would make the
// division approximate.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;  // output tile edge
constexpr int ROWS = 8;   // thread rows per block; each thread does TILE/ROWS rows

// Relayout codes: 0..3 are k clockwise quarter-turns, 4 is the transpose
// (growth-safe relayout with an odd k). Gives the source element (r, c)
// of output element (i, j).
__device__ __forceinline__ void source_of(int rel, int n, int i, int j,
                                          int& r, int& c) {
  switch (rel) {
    case 0: r = i;         c = j;         break;
    case 1: r = n - 1 - j; c = i;         break;
    case 2: r = n - 1 - i; c = n - 1 - j; break;
    case 3: r = j;         c = n - 1 - i; break;
    default: r = j;        c = i;         break;
  }
}

template <typename T, bool EWM>
__global__ void ced_kernel(const T* __restrict__ m, const T* __restrict__ v,
                           T* __restrict__ out, int n, int rel) {
  __shared__ T tile[TILE][TILE + 1];
  const long long nn = static_cast<long long>(n) * n;
  m += blockIdx.z * nn;
  out += blockIdx.z * nn;
  v += static_cast<long long>(blockIdx.z) * n;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  // The relayout is affine with +-1 coefficients, so the source box of
  // this output tile is the TILE x TILE box spanned by two corners.
  int ra, ca, rb, cb;
  source_of(rel, n, i0, j0, ra, ca);
  source_of(rel, n, i0 + TILE - 1, j0 + TILE - 1, rb, cb);
  const int r0 = min(ra, rb);
  const int c0 = min(ca, cb);
  for (int y = threadIdx.y; y < TILE; y += ROWS) {
    const int r = r0 + y;
    const int c = c0 + threadIdx.x;
    if (r >= 0 && r < n && c >= 0 && c < n) {
      const T x = m[static_cast<long long>(r) * n + c];
      tile[y][threadIdx.x] = EWM ? x * v[r] : x / v[r];
    }
  }
  __syncthreads();
  for (int y = threadIdx.y; y < TILE; y += ROWS) {
    const int i = i0 + y;
    const int j = j0 + threadIdx.x;
    if (i < n && j < n) {
      int r, c;
      source_of(rel, n, i, j, r, c);
      out[static_cast<long long>(i) * n + j] = tile[r - r0][c - c0];
    }
  }
}

template <typename T>
int launch(const T* m, const T* v, T* out, int batch, int n, int rel,
           int ewm, cudaStream_t stream) {
  const dim3 block(TILE, ROWS);
  const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE, batch);
  if (ewm) {
    ced_kernel<T, true><<<grid, block, 0, stream>>>(m, v, out, n, rel);
  } else {
    ced_kernel<T, false><<<grid, block, 0, stream>>>(m, v, out, n, rel);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// m, out: `batch` contiguous n x n matrices; v: `batch` contiguous rows of
// n blinding entries. rel: 0..3 quarter-turns, 4 transpose. ewm: 1 to
// multiply, 0 to divide. Returns cudaGetLastError() after the launch.
int ced_f64(const double* m, const double* v, double* out, int batch, int n,
            int rel, int ewm, cudaStream_t stream) {
  return launch(m, v, out, batch, n, rel, ewm, stream);
}

int ced_f32(const float* m, const float* v, float* out, int batch, int n,
            int rel, int ewm, cudaStream_t stream) {
  return launch(m, v, out, batch, n, rel, ewm, stream);
}

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
