// Schur-complement update: OUT = C - A B, the trailing update of the
// right-looking block LU (lu_blocked), optionally over a leading batch.
//
// Replaces: src/repro/kernels/gemm.py:schur_update (body _schur_kernel,
// gemm.py:24; wrapper gemm.py:46).
//
// Every operand is passed with its batch, row and column strides, so the
// blocks of lu_blocked, which are views of the n x n matrix, need no
// copy; OUT is written fresh and C, A, B are left as they are. Any M, N
// and K: the ragged edge of each tile is masked, so the reference's
// "halve the tile until it divides" is not needed. f64 and f32
// accumulate in their own type; bf16 and f16 are widened to f32 on load,
// accumulate in f32 and are rounded once on store.
//
// What bounds it on the H100: operations. At 1024 x 1024 x 1024 in f64
// the product is 2.15 GFLOP against 33.5 MB moved: 32 us at the 67
// TFLOP/s f64 tensor-core peak, 10 us at 3.35 TB/s.
//
// What the design does about it, for now: a plain shared-memory tiling.
// A block of 16 x 16 threads owns a 64 x 64 tile of OUT and walks K in
// steps of 16, staging a 64 x 16 tile of A and a 16 x 64 tile of B in
// shared memory; each thread keeps a 4 x 4 register tile of sums (rows
// ty + 16 i, columns tx + 16 j, so the B reads of a warp are consecutive
// and the A reads are broadcasts). Each sum runs over k ascending with
// one FMA per term and is subtracted from C at the end, as the plain
// version computes C - (A B). Tile loads put consecutive threads on
// whichever axis has unit stride, so row-major and transposed operands
// both read coalesced. This runs on the FMA pipes, whose f64 peak is half
// the tensor-core rate the bound assumes, so it can reach at most half of
// its bound; the tensor cores (DMMA mma.sync m8n8k4, or wgmma) are the
// work of a later change.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // rows of OUT per block
constexpr int BN = 64;   // columns of OUT per block
constexpr int BK = 16;   // depth of one shared-memory step
constexpr int TD = 16;   // threads per block side
constexpr int RT = BM / TD;  // register tile side (4)
constexpr int NT = TD * TD;  // threads per block

template <typename T, typename Acc>
__device__ __forceinline__ Acc widen(T v) {
  return static_cast<Acc>(v);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16, float>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half, float>(__half v) {
  return __half2float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T narrow(Acc v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half, float>(float v) {
  return __float2half(v);
}

// Block (x, y, z) computes OUT[z][64 y : 64 y + 64, 64 x : 64 x + 64].
template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
schur_kernel(const T* __restrict__ c, long long cb, long long cr,
             long long cc, const T* __restrict__ a, long long ab,
             long long ar, long long ac, const T* __restrict__ b,
             long long bb, long long br, long long bc, T* __restrict__ out,
             long long ob, long long orr, long long oc, int m, int n,
             int k) {
  __shared__ Acc as[BK][BM + 1];  // A tile, stored k-major
  __shared__ Acc bs[BK][BN + 1];
  c += blockIdx.z * cb;
  a += blockIdx.z * ab;
  b += blockIdx.z * bb;
  out += blockIdx.z * ob;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TD + tx;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  Acc acc[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = Acc(0);
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: BM x BK; consecutive threads along k when A's rows are
    // contiguous, along m otherwise
#pragma unroll
    for (int e = tid; e < BM * BK; e += NT) {
      int r, q;
      if (ac == 1) {
        r = e / BK;
        q = e % BK;
      } else {
        r = e % BM;
        q = e / BM;
      }
      const int gr = m0 + r;
      const int gq = k0 + q;
      as[q][r] = (gr < m && gq < k)
                     ? widen<T, Acc>(a[gr * ar + gq * ac])
                     : Acc(0);
    }
    // B tile: BK x BN; consecutive threads along n when B's rows are
    // contiguous, along k otherwise
#pragma unroll
    for (int e = tid; e < BK * BN; e += NT) {
      int q, s;
      if (bc == 1) {
        q = e / BN;
        s = e % BN;
      } else {
        q = e % BK;
        s = e / BK;
      }
      const int gq = k0 + q;
      const int gs = n0 + s;
      bs[q][s] = (gq < k && gs < n)
                     ? widen<T, Acc>(b[gq * br + gs * bc])
                     : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      Acc av[RT], bv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = as[q][ty + i * TD];
#pragma unroll
      for (int j = 0; j < RT; ++j) bv[j] = bs[q][tx + j * TD];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int gr = m0 + ty + i * TD;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int gs = n0 + tx + j * TD;
      if (gs < n) {
        const Acc cv = widen<T, Acc>(c[gr * cr + gs * cc]);
        out[gr * orr + gs * oc] = narrow<T, Acc>(cv - acc[i][j]);
      }
    }
  }
}

template <typename T, typename Acc>
int launch(const T* c, long long cb, long long cr, long long cc, const T* a,
           long long ab, long long ar, long long ac, const T* b,
           long long bb, long long br, long long bc, T* out, long long ob,
           long long orr, long long oc, int batch, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 block(TD, TD);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  schur_kernel<T, Acc><<<grid, block, 0, stream>>>(
      c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out, ob, orr, oc, m, n,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// OUT = C - A B for `batch` problems: A m x k, B k x n, C and OUT m x n,
// each at (batch, row, column) strides in elements. Returns
// cudaGetLastError() right after the launch.
#define SCHUR_ENTRY(NAME, T, ACC)                                            \
  int NAME(const T* c, long long cb, long long cr, long long cc, const T* a, \
           long long ab, long long ar, long long ac, const T* b,             \
           long long bb, long long br, long long bc, T* out, long long ob,   \
           long long orr, long long oc, int batch, int m, int n, int k,      \
           cudaStream_t stream) {                                            \
    return launch<T, ACC>(c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out,  \
                          ob, orr, oc, batch, m, n, k, stream);              \
  }

extern "C" {

SCHUR_ENTRY(schur_f64, double, double)
SCHUR_ENTRY(schur_f32, float, float)
SCHUR_ENTRY(schur_bf16, __nv_bfloat16, float)
SCHUR_ENTRY(schur_f16, __half, float)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
