// Panel LU kernel: no-pivot Doolittle of one b x b tile, compact output
// (strict-lower multipliers plus U).
//
// Replaces: src/repro/kernels/lu_panel.py:lu_panel_compact
// (_lu_panel_kernel), every Doolittle tile of lu_diag_factor.
//
// What bounds it on the H100: latency. A tile is b dependent elimination
// steps; at the b = 32 of the inner panels it holds 8 KB (f64) and does
// about 2 b^3 / 3 = 22 thousand operations, which the card's bytes and
// operations rates would clear in nanoseconds. The time is the chain of
// b steps, each a barrier, plus the launch.
//
// What the design does about it: one thread block per tile (the grid is
// the batch), the whole tile in shared memory for all b steps, so the
// chain never touches device memory between steps: one read of the tile,
// one write of the result. Each step is two phases split by barriers:
// the multipliers of column k, then the rank-1 update of the trailing
// (b-k-1)^2 block spread over the block's threads. The input may be a
// strided view (batch, row and column strides); the output is
// contiguous. A tile must fit in shared memory (227 KB, so b <= 170 in
// f64); the wrapper raises on a larger one.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

template <typename T>
__global__ void lu_panel_kernel(const T* __restrict__ a, long long sb,
                                long long sr, long long sc,
                                T* __restrict__ out, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int bb = b * b;
  a += blockIdx.x * sb;
  out += static_cast<long long>(blockIdx.x) * bb;
  for (int idx = threadIdx.x; idx < bb; idx += blockDim.x) {
    s[idx] = a[(idx / b) * sr + (idx % b) * sc];
  }
  __syncthreads();
  for (int k = 0; k < b - 1; ++k) {
    const T pivot = s[k * b + k];
    for (int i = k + 1 + threadIdx.x; i < b; i += blockDim.x) {
      s[i * b + k] = s[i * b + k] / pivot;
    }
    __syncthreads();
    const int w = b - k - 1;
    for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
      const int i = k + 1 + idx / w;
      const int j = k + 1 + idx % w;
      s[i * b + j] -= s[i * b + k] * s[k * b + j];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < bb; idx += blockDim.x) {
    out[idx] = s[idx];
  }
}

template <typename T>
int launch(const T* a, long long sb, long long sr, long long sc, T* out,
           int batch, int b, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(b) * b;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lu_panel_kernel<T><<<batch, THREADS, smem, stream>>>(a, sb, sr, sc, out, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a: `batch` b x b tiles at element strides (sb, sr, sc); out: `batch`
// contiguous b x b compact factors. Returns cudaGetLastError().
int lu_panel_f64(const double* a, long long sb, long long sr, long long sc,
                 double* out, int batch, int b, cudaStream_t stream) {
  return launch(a, sb, sr, sc, out, batch, b, stream);
}

int lu_panel_f32(const float* a, long long sb, long long sr, long long sc,
                 float* out, int batch, int b, cudaStream_t stream) {
  return launch(a, sb, sr, sc, out, batch, b, stream);
}

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
