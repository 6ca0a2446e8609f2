// Panel LU kernels: no-pivot Doolittle of one b x b tile, compact output
// (strict-lower multipliers plus U).
//
// Replaces: src/repro/kernels/lu_panel.py:lu_panel_compact
// (_lu_panel_kernel), every Doolittle tile of lu_diag_factor.
//
// What bounds it on the H100: latency. A tile is b dependent elimination
// steps; at the b = 32 of the inner panels it holds 8 KB (f64) and does
// about 2 b^3 / 3 = 22 thousand operations, which the card's bytes and
// operations rates would clear in nanoseconds. The time is the chain of
// b steps, plus the launch.
//
// What the design does about it. Tiles of b <= 32, every tile of the SPDC
// paths (lu_warp_kernel): one warp factors one tile, with no block
// barrier. Lane i holds row i in registers. At step k the pivot row's
// entries come from lane k by shuffles, every lane below it divides its
// own a[i][k] by the pivot (a true division, as the plain version does;
// the divisions of a step run side by side across lanes) and updates its
// columns past k. The 31 steps are unrolled with no branch in them, so the
// shuffles of a step issue back to back and the compiler overlaps one
// step's updates with the next step's pivot and division, which are the
// chain that remains (a branch around each shuffle would make every one of
// them wait out its latency). A tile narrower than 32 is padded with the
// identity, so it takes the same code. Loads and stores put consecutive
// lanes on the unit-stride axis; a row-major tile comes in, and every
// tile goes out, through shared memory, rows padded to 33 against bank
// conflicts. Four tiles (warps) share a
// block; a tile's arithmetic depends on b and the type alone, so its bits
// are the same alone and in a stack.
// Tiles of 33 <= b <= 170 (lu_panel_kernel): one thread block per tile,
// the whole tile in shared memory (227 KB, so b <= 170 in f64), each step
// two phases split by barriers, the multipliers of column k, then the
// rank-1 update of the trailing (b-k-1)^2 block spread over the block's
// threads. The wrapper picks the kernel by b (lu_panel.py:route). The
// input may be a strided view (batch, row and column strides); the output
// is contiguous.
// Mixed variant (the reference's acc_dtype): both kernels take a storage
// type TS and an arithmetic type TA. The tile is widened as it loads,
// eliminated in registers or shared memory at TA and rounded to TS once,
// as it is stored: float tiles with double arithmetic, bfloat16 and half
// tiles with float or double arithmetic. The block kernel's tile is held
// at TA, so its widest tile is set by TA's size (170 for double
// arithmetic).
// Narrow variant (bfloat16 or half tiles with no acc_dtype, as the
// reference's kernel computes them): TA = TS, and every division and
// every product and difference of the update is rounded to the half type
// (precision.cuh: quot, sub_prod), in the plain version's order, so a
// tile's bits are the plain version's.
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr int WARP_ROWS = 32;           // widest tile of the warp kernel
constexpr int WARP_LD = WARP_ROWS + 1;  // padded row stride
constexpr int WARP_TILES = 4;           // tiles (warps) per block
constexpr unsigned FULL = 0xffffffffu;

// Warp w of block x factors tile WARP_TILES x + w of the batch.
template <typename TS, typename TA>
__global__ void __launch_bounds__(32 * WARP_TILES)
lu_warp_kernel(const TS* __restrict__ a, long long sb, long long sr,
               long long sc, TS* __restrict__ out, int batch, int b) {
  __shared__ TA stage[WARP_TILES][WARP_ROWS * WARP_LD];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(blockIdx.x) * WARP_TILES + w;
  if (tile >= batch) return;  // the whole warp
  TA* s = stage[w];
  a += tile * sb;
  out += tile * b * b;
  // x: this lane's row; past b the tile is the identity (below). Every
  // load is issued before the first use (one memory latency a tile),
  // consecutive lanes on the unit-stride axis: a row-major tile goes
  // through s to turn columns into rows, a column-major one is read by
  // rows directly.
  TA x[WARP_ROWS];
  if (sc == 1 || sr != 1) {
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) {
      x[r] = (r < b && lane < b) ? widen<TS, TA>(a[r * sr + lane * sc])
                                 : constant<TA>(r == lane ? 1.f : 0.f);
    }
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) s[r * WARP_LD + lane] = x[r];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < WARP_ROWS; ++j) x[j] = s[lane * WARP_LD + j];
  } else {
#pragma unroll
    for (int j = 0; j < WARP_ROWS; ++j) {
      x[j] = (j < b && lane < b) ? widen<TS, TA>(a[lane * sr + j * sc])
                                 : constant<TA>(j == lane ? 1.f : 0.f);
    }
  }
  // Step k: lane k's row is final; every lane divides its column k by the
  // pivot and the rows below keep the quotient, their multiplier, and
  // lose its multiple of the pivot row, whose entries come by shuffles.
  // Always 31 steps, unrolled, with no branch: padded to the identity, a
  // tile narrower than 32 has pivot 1 and multipliers 0 past b, so its
  // entries see exactly the operations of a b-step elimination.
#pragma unroll
  for (int k = 0; k < WARP_ROWS - 1; ++k) {
    const TA pivot = __shfl_sync(FULL, x[k], k);
    const bool below = lane > k;
    const TA mult = quot(x[k], pivot);
    x[k] = below ? mult : x[k];
#pragma unroll
    for (int j = k + 1; j < WARP_ROWS; ++j) {
      const TA u = __shfl_sync(FULL, x[j], k);
      if (below) x[j] = sub_prod(x[j], x[k], u);
    }
  }
#pragma unroll
  for (int j = 0; j < WARP_ROWS; ++j) s[lane * WARP_LD + j] = x[j];
  __syncwarp();
  if (lane < b) {
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r) {
      if (r < b) out[r * b + lane] = narrow<TS, TA>(s[r * WARP_LD + lane]);
    }
  }
}

template <typename TS, typename TA>
__global__ void lu_panel_kernel(const TS* __restrict__ a, long long sb,
                                long long sr, long long sc,
                                TS* __restrict__ out, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* s = reinterpret_cast<TA*>(smem_raw);
  const int bb = b * b;
  a += blockIdx.x * sb;
  out += static_cast<long long>(blockIdx.x) * bb;
  for (int idx = threadIdx.x; idx < bb; idx += blockDim.x) {
    s[idx] = widen<TS, TA>(a[(idx / b) * sr + (idx % b) * sc]);
  }
  __syncthreads();
  for (int k = 0; k < b - 1; ++k) {
    const TA pivot = s[k * b + k];
    for (int i = k + 1 + threadIdx.x; i < b; i += blockDim.x) {
      s[i * b + k] = quot(s[i * b + k], pivot);
    }
    __syncthreads();
    const int w = b - k - 1;
    for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
      const int i = k + 1 + idx / w;
      const int j = k + 1 + idx % w;
      s[i * b + j] = sub_prod(s[i * b + j], s[i * b + k], s[k * b + j]);
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < bb; idx += blockDim.x) {
    out[idx] = narrow<TS, TA>(s[idx]);
  }
}

template <typename TS, typename TA>
int launch(const TS* a, long long sb, long long sr, long long sc, TS* out,
           int batch, int b, cudaStream_t stream) {
  const size_t smem = sizeof(TA) * static_cast<size_t>(b) * b;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        lu_panel_kernel<TS, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lu_panel_kernel<TS, TA><<<batch, THREADS, smem, stream>>>(a, sb, sr, sc,
                                                            out, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename TS, typename TA>
int launch_warp(const TS* a, long long sb, long long sr, long long sc,
                TS* out, int batch, int b, cudaStream_t stream) {
  const int blocks = (batch - 1) / WARP_TILES + 1;  // batch >= 1
  lu_warp_kernel<TS, TA><<<blocks, 32 * WARP_TILES, 0, stream>>>(
      a, sb, sr, sc, out, batch, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: `batch` b x b tiles at element strides (sb, sr, sc); out: `batch`
// contiguous b x b compact factors. lu_panel_<route>: one block a tile,
// any b that fits; lu_panel_warp_<route>: one warp a tile, b <= 32. The
// route names the storage type, then the arithmetic type where it is
// wider. Each returns cudaGetLastError().
#define LU_PANEL_ENTRIES(ROUTE, TS, TA)                                      \
  int lu_panel_##ROUTE(const TS* a, long long sb, long long sr,            \
                       long long sc, TS* out, int batch, int b,            \
                       cudaStream_t stream) {                              \
    return launch<TS, TA>(a, sb, sr, sc, out, batch, b, stream);           \
  }                                                                        \
  int lu_panel_warp_##ROUTE(const TS* a, long long sb, long long sr,       \
                            long long sc, TS* out, int batch, int b,       \
                            cudaStream_t stream) {                         \
    return launch_warp<TS, TA>(a, sb, sr, sc, out, batch, b, stream);      \
  }

extern "C" {

LU_PANEL_ENTRIES(f64, double, double)
LU_PANEL_ENTRIES(f32, float, float)
LU_PANEL_ENTRIES(f32_f64, float, double)
LU_PANEL_ENTRIES(bf16_f32, __nv_bfloat16, float)
LU_PANEL_ENTRIES(f16_f32, __half, float)
LU_PANEL_ENTRIES(bf16, __nv_bfloat16, __nv_bfloat16)
LU_PANEL_ENTRIES(f16, __half, __half)
LU_PANEL_ENTRIES(bf16_f64, __nv_bfloat16, double)
LU_PANEL_ENTRIES(f16_f64, __half, double)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
