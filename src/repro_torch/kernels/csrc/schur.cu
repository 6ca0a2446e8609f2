// Schur-complement update: OUT = C - A B, the trailing update of the
// right-looking block LU (lu_blocked), optionally over a leading batch.
//
// Replaces: src/repro/kernels/gemm.py:schur_update (body _schur_kernel,
// gemm.py:24; wrapper gemm.py:46).
//
// Every operand is passed with its batch, row and column strides, so the
// blocks of lu_blocked, which are views of the n x n matrix, need no
// copy; OUT is written fresh and C, A, B are left as they are. Any M, N
// and K: the ragged edge of each tile is masked or zero-filled, so the
// reference's "halve the tile until it divides" is not needed.
//
// What bounds it on the H100: operations at the trailing updates, bytes
// at the inner ones. At 1024 x 1024 x 1024 in f64 the product is 2.15
// GFLOP against 33.5 MB moved: 32 us at the 67 TFLOP/s f64 tensor-core
// peak, 10 us at 3.35 TB/s. The inner updates of lu_blocked's diagonal
// tiles (K = 32, from 992 x 992 down) move C and OUT and do little else:
// 16.3 MB, 4.9 us at 992 x 32 x 992.
//
// What the design does about it. f64 (schur_dmma_kernel<double>), the
// route of the f64 paths:
//  * the f64 tensor cores: a block of 8 warps owns a 128 x 64 tile of
//    OUT, each warp a 32 x 32 tile of it, summed by the sm_90 mma.sync f64
//    shape m16n8k4 (DMMA) in registers. Timed once at 1024^3 on the H100,
//    m16n8k8 and m16n8k16 ran within the spread of repeated timings of it
//    and m8n8k4 1.5x slower (PERF.md);
//  * a 3-stage ring of 32-deep K slices in shared memory, filled by
//    cp.async, so the next slices load while the current one multiplies;
//    one barrier a slice. An operand whose rows are 16-byte aligned with
//    unit stride along the staged axis (every block of lu_blocked) goes
//    two elements a copy (16-byte cp.async.cg); any other, strided,
//    transposed or at an odd offset, one element a copy (8-byte
//    cp.async.ca, legal at any offset), consecutive threads along its
//    unit-stride axis. Both zero-fill past the ragged edge through their
//    src-size operand. Row strides of 36 and 68 doubles keep the fragment
//    reads free of bank conflicts;
//  * one wave at 1024 x 1024: 128 blocks on 132 SMs;
//  * each thread's elements of C are loaded into registers before the
//    first slice lands, so their load overlaps the product (it is most of
//    the bytes at the inner updates' K = 32). Each sum runs over k
//    ascending, by slices, in f64, and is subtracted from C at the end,
//    as the plain version computes C - (A B). No TF32, no split K, no
//    atomics: the same call gives the same bits every run.
// What still holds it at about half its bound is that feed: each block
// reads 48 KB of A and B from L2 per slice (PERF.md); TMA copies
// or clusters sharing tiles are the next step.
// bf16 and f16 (schur_wgmma_kernel<__nv_bfloat16>, <__half>), the
// default routes of the 2-byte types (plain bf16/f16 lu_blocked, and with
// acc_dtype=float32), and f32 below, replace the same Pallas kernel
// (gemm.py:24, wrapper :46) on their routes: OUT = C - A B summed in f32,
// rounded once to the storage type. Bound at 1024^3 by bytes, barely:
// 8.4 MB, 2.5 us at 3.35 TB/s, against 2.17 us for 2.15 GFLOP at the 989
// TFLOP/s of the bf16/f16 tensor cores; at the inner 992 x 32 x 992 by
// bytes, 1.2 us.
//  * the tensor cores through wgmma: a block of two warpgroups owns a
//    128 x 64 tile of OUT, each warpgroup 64 rows, summed by
//    wgmma.mma_async m64n64k16 .f32 with the accumulators in registers
//    (one wave of 128 blocks at 1024^2, as for DMMA);
//  * a 5-stage ring of 64-deep K slices in dynamic shared memory (A 128 x
//    64, B 64 x 64, 24 KB a stage), each tile a run of 128-byte rows under
//    the 128-byte swizzle that wgmma's descriptors read: A K-major, B as
//    stored (N-major, wgmma's transpose bit for B). Three slices load
//    while one multiplies and the previous one's wgmma group may still
//    run; one barrier a slice;
//  * an operand with a unit inner stride, a 16-byte aligned start and row
//    and batch strides of whole 16-byte vectors (every block of
//    lu_blocked and lu_panel_blocked) is loaded by TMA: the host encodes
//    a 3-D CUtensorMap per operand and call (cuTensorMapEncodeTiled,
//    reached through cudaGetDriverEntryPointByVersion, so the library
//    needs no -lcuda), passed as a __grid_constant__ parameter; thread 0
//    issues both copies of a slice against the stage's mbarrier and its
//    expected bytes, and TMA zero-fills past the edges. Any other operand
//    (transposed, strided, at an odd offset) is copied by all threads
//    into the same swizzled layout, a plain 2-byte load and store an
//    element, so the product and its bits do not depend on the route;
//  * C is loaded into registers in the accumulators' layout before the
//    first slice lands; OUT = round(C - acc) once (__float2bfloat16 /
//    __float2half, to nearest even), staged through shared memory and
//    stored 16 bytes a thread. No warp specialisation: the threads that
//    wait for a slice also issue the next one's copies, one loop for both
//    copy routes.
// What holds it at about a fifth of its bound (PERF.md) is the L2 feed,
// not the pipeline (4 to 6 stages time alike): 48 MB of A and B tiles a
// 1024^3 call; TMA multicast across a 2-block cluster would read a third
// less. The inner updates are latency-bound, level across the types.
// f32 (schur_fma_kernel<float>), plain f32 lu_blocked's route: no TF32 in
// any form, so the FMA pipes, 2.15 GFLOP at 67 TFLOP/s, 32 us at 1024^3;
// 2.4 us of bytes at the inner shape. A block of 256 threads owns a
// 128 x 64 tile of OUT (one wave), each thread 8 x 4 of it: 32 FMAs for
// three 16-byte shared reads (two of A, held row-major so that A's rows
// stage 16 bytes a copy, and one of B). A 3-stage cp.async ring of
// 32-deep slices, one barrier a slice: 16-byte cp.async.cg copies where a
// row is unit-strided and aligned, 4-byte cp.async.ca copies otherwise;
// row strides of 4 mod 32 banks keep both the copies and the fragment
// reads free of bank conflicts. C is preloaded into registers, each sum
// runs over k ascending in f32 and is subtracted from C at the end.
// Mixed f32 -> f64 (the reference's acc_dtype=float64): the DMMA kernel
// with f32 operands, schur_dmma_kernel<float>. cp.async copies bytes and
// cannot widen, so the ring holds f32 tiles (16-byte copies of four
// elements; row strides of 36 and 72 floats keep the fragment reads of
// all 32 lanes on distinct banks) and each fragment is widened to f64 as
// it is read from shared memory. Every product is summed over all of K in
// f64, subtracted from C in f64 and rounded to f32 once. The reference's
// Pallas kernel instead rounds each 128-deep chunk's product to f32
// before it subtracts it (gemm.py:33); the port sums all of K wide,
// accumulating "in a wider dtype" as DESIGN.md §6.4 states the variant's
// intent (ROADMAP §C).
// Mixed bfloat16 / half -> f64: the same DMMA kernel,
// schur_dmma_kernel<__nv_bfloat16> and <__half>, its ring holding 2-byte
// tiles (16-byte copies of eight elements where the operand pairs, a
// plain load and store an element otherwise, cp.async having no 2-byte
// copy), each fragment widened to f64 as it is read, every product summed
// over all of K in f64 and rounded to the storage type once, by
// __double2bfloat16 / __double2half (one rounding, not two through
// float).
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "precision.cuh"

namespace {

// ---------------------------------------------------------------- f64 DMMA
constexpr int DM = 128;            // rows of OUT per block
constexpr int DN = 64;             // columns of OUT per block
constexpr int DK = 32;             // depth of one pipeline stage
constexpr int STAGES = 3;          // K slices in flight
constexpr int DTHREADS = 256;      // 8 warps: 4 (rows) x 2 (columns)

// The ring's layout for operands stored as TS (double, or float, bfloat16
// or half on the mixed routes): row strides in elements chosen so the
// fragment reads below hit distinct banks (doubles: the 16 lanes of a
// half warp; floats: all 32 lanes, rows g apart by 4 banks in A and
// columns t apart by 8 in B; 2-byte types: rows g apart by 20 banks in A
// and columns t apart by 4 in B, lanes 2 t and 2 t + 1 sharing a word)
// and a whole number of 16-byte vectors, so every row of a stage starts
// 16-byte aligned; VEC elements make one 16-byte copy.
template <typename TS>
struct Ring {
  static constexpr int A_LD = DK + (sizeof(TS) == 2 ? 8 : 4);
  static constexpr int B_LD = DN + (sizeof(TS) == 8 ? 4 : 8);
  static constexpr int STAGE = DM * A_LD + DK * B_LD;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(TS));
  static constexpr size_t SMEM = STAGES * STAGE * sizeof(TS);
};

// A warp's 32 x 32 tile as four 8-row groups r by four 8-column groups
// ni: acc[r][ni][e] is row 8 r + g, column 8 ni + 2 t + e (g = lane / 4,
// t = lane % 4). Fragments of one k-step of 4: fa[r] = A[8 r + g][t],
// fb[ni] = B[t][8 ni + g] — the PTX layout of m16n8k4, whose rows are the
// groups 2 mi and 2 mi + 1.
__device__ __forceinline__ void dmma(double (&acc)[4][4][2],
                                     const double (&fa)[4],
                                     const double (&fb)[4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
          "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
          : "+d"(acc[2 * mi][ni][0]), "+d"(acc[2 * mi][ni][1]),
            "+d"(acc[2 * mi + 1][ni][0]), "+d"(acc[2 * mi + 1][ni][1])
          : "d"(fa[2 * mi]), "d"(fa[2 * mi + 1]), "d"(fb[ni]));
    }
  }
}

// One element of BYTES (4 or 8), read where pred holds and zero-filled
// otherwise; legal at any element offset.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* s, const void* g,
                                              bool pred) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sa),
               "l"(g), "n"(BYTES), "r"(pred ? BYTES : 0));
}

// 16 bytes, of which `bytes` (a multiple of the element size, at most 16)
// are read and the rest zero-filled; L2 only (.cg), and both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* s, const void* g,
                                           int bytes) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(bytes));
}

// One element of BYTES, zero-filled where pred fails: cp.async for 4 and
// 8 bytes; a 2-byte element, below cp.async's smallest copy, by a plain
// load and store (its stage is read only after the barrier that follows
// the wait on this slice, so the ring's order holds).
template <int BYTES>
__device__ __forceinline__ void copy_elem(void* s, const void* g, bool pred) {
  if constexpr (BYTES == 2) {
    *static_cast<unsigned short*>(s) =
        pred ? *static_cast<const unsigned short*>(g) : 0;
  } else {
    cp_async_elem<BYTES>(s, g, pred);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// True where an operand can be staged 16 bytes at a time: unit stride
// along the staged axis (A's k, B's n), a row stride a whole number of
// 16-byte vectors and a 16-byte aligned start, as every block of
// lu_blocked's 4096 x 4096 matrix has.
template <typename TS>
__device__ __forceinline__ bool pairs(const TS* p, long long rows,
                                      long long unit) {
  return unit == 1 && rows % Ring<TS>::VEC == 0 &&
         (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Issue the copies of K slice [k0, k0 + DK): A rows [m0, m0 + DM) into
// sa[r * A_LD + q], B columns [n0, n0 + DN) into sb[q * B_LD + s]; zeros
// past m, n and k (the masked copies read nothing, from a valid address).
// An operand that `pairs` goes VEC elements a copy; any other, strided,
// transposed or at an odd offset, one element a copy (cp.async.ca, legal
// at any element offset), consecutive threads along its unit-stride axis.
template <typename TS>
__device__ __forceinline__ void load_slice(
    TS* sa, TS* sb, const TS* a, long long ar, long long ac, bool a_pairs,
    const TS* b, long long br, long long bc, bool b_pairs, int m0, int n0,
    int k0, int m, int n, int k) {
  constexpr int A_LD = Ring<TS>::A_LD, B_LD = Ring<TS>::B_LD;
  constexpr int VEC = Ring<TS>::VEC, SIZE = static_cast<int>(sizeof(TS));
  const int tid = threadIdx.x;
  static_assert(SIZE == 2 || SIZE == 4 || SIZE == 8, "element size");
  if (a_pairs) {
#pragma unroll
    for (int j = 0; j < DM * DK / VEC / DTHREADS; ++j) {
      const int e = tid + j * DTHREADS;
      const int r = e / (DK / VEC), q = VEC * (e % (DK / VEC));
      const bool ok = m0 + r < m && k0 + q < k;
      cp_async16(sa + r * A_LD + q, ok ? a + (m0 + r) * ar + k0 + q : a,
                 ok ? min(VEC, k - k0 - q) * SIZE : 0);
    }
  } else {
    const bool along_k = ac == 1 || ar != 1;
#pragma unroll
    for (int j = 0; j < DM * DK / DTHREADS; ++j) {
      const int e = tid + j * DTHREADS;
      const int r = along_k ? e / DK : e % DM;
      const int q = along_k ? e % DK : e / DM;
      const bool ok = m0 + r < m && k0 + q < k;
      copy_elem<SIZE>(sa + r * A_LD + q,
                      ok ? a + (m0 + r) * ar + (k0 + q) * ac : a, ok);
    }
  }
  if (b_pairs) {
#pragma unroll
    for (int j = 0; j < DK * DN / VEC / DTHREADS; ++j) {
      const int e = tid + j * DTHREADS;
      const int q = e / (DN / VEC), c = VEC * (e % (DN / VEC));
      const bool ok = k0 + q < k && n0 + c < n;
      cp_async16(sb + q * B_LD + c, ok ? b + (k0 + q) * br + n0 + c : b,
                 ok ? min(VEC, n - n0 - c) * SIZE : 0);
    }
  } else {
    const bool along_n = bc == 1 || br != 1;
#pragma unroll
    for (int j = 0; j < DK * DN / DTHREADS; ++j) {
      const int e = tid + j * DTHREADS;
      const int q = along_n ? e / DN : e % DK;
      const int c = along_n ? e % DN : e / DK;
      const bool ok = k0 + q < k && n0 + c < n;
      copy_elem<SIZE>(sb + q * B_LD + c,
                      ok ? b + (k0 + q) * br + (n0 + c) * bc : b, ok);
    }
  }
}

// The warp's 32 x 32 tile gains the product of one K slice in shared
// memory, four k at a time, k ascending; fragments are widened to f64 as
// they are read.
template <typename TS>
__device__ __forceinline__ void slice_product(const TS* sa, const TS* sb,
                                              double (&acc)[4][4][2]) {
  constexpr int A_LD = Ring<TS>::A_LD, B_LD = Ring<TS>::B_LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const TS* arow = sa + (32 * (warp >> 1) + g) * A_LD + t;
  const TS* bcol = sb + t * B_LD + 32 * (warp & 1) + g;
#pragma unroll
  for (int kk = 0; kk < DK; kk += 4) {
    double fa[4], fb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fa[r] = widen<TS, double>(arow[8 * r * A_LD + kk]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      fb[ni] = widen<TS, double>(bcol[kk * B_LD + 8 * ni]);
    }
    dmma(acc, fa, fb);
  }
}

// Block (x, y, z) computes OUT[z][128 y : 128 y + 128, 64 x : 64 x + 64]
// from operands stored as TS, summed in f64 and stored as TS.
template <typename TS>
__global__ void __launch_bounds__(DTHREADS)
schur_dmma_kernel(const TS* __restrict__ c, long long cb, long long cr,
                  long long cc, const TS* __restrict__ a, long long ab,
                  long long ar, long long ac, const TS* __restrict__ b,
                  long long bb, long long br, long long bc,
                  TS* __restrict__ out, long long ob, long long orr,
                  long long oc, int m, int n, int k) {
  constexpr int A_LD = Ring<TS>::A_LD, STAGE = Ring<TS>::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TS* ring = reinterpret_cast<TS*>(smem_raw);
  c += blockIdx.z * cb;
  a += blockIdx.z * ab;
  b += blockIdx.z * bb;
  out += blockIdx.z * ob;
  const bool a_pairs = pairs(a, ar, ac), b_pairs = pairs(b, br, bc);
  const int m0 = blockIdx.y * DM;
  const int n0 = blockIdx.x * DN;
  const int slices = (k + DK - 1) / DK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) {
      TS* stage = ring + s * STAGE;
      load_slice(stage, stage + DM * A_LD, a, ar, ac, a_pairs, b, br, bc,
                 b_pairs, m0, n0, s * DK, m, n, k);
    }
    cp_async_commit();
  }
  // this thread's elements of C, fetched while the product runs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + 32 * (warp >> 1) + (lane >> 2);
  const int col0 = n0 + 32 * (warp & 1) + 2 * (lane & 3);
  double cv[4][4][2], acc[4][4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + 8 * r;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + 8 * ni + e;
        cv[r][ni][e] =
            (gr < m && gc < n) ? widen<TS, double>(c[gr * cr + gc * cc]) : 0.0;
        acc[r][ni][e] = 0.0;
      }
    }
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's have, and slice kt - 1 is read
    const int next = kt + STAGES - 1;
    if (next < slices) {
      TS* stage = ring + (next % STAGES) * STAGE;
      load_slice(stage, stage + DM * A_LD, a, ar, ac, a_pairs, b, br, bc,
                 b_pairs, m0, n0, next * DK, m, n, k);
    }
    cp_async_commit();
    const TS* stage = ring + (kt % STAGES) * STAGE;
    slice_product(stage, stage + DM * A_LD, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + 8 * r;
    if (gr >= m) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + 8 * ni + e;
        if (gc < n) {
          out[gr * orr + gc * oc] = narrow<TS, double>(cv[r][ni][e] -
                                                       acc[r][ni][e]);
        }
      }
    }
  }
}

template <typename TS>
int launch_dmma(const TS* c, long long cb, long long cr, long long cc,
                const TS* a, long long ab, long long ar, long long ac,
                const TS* b, long long bb, long long br, long long bc,
                TS* out, long long ob, long long orr, long long oc,
                int batch, int m, int n, int k, cudaStream_t stream) {
  constexpr size_t SMEM = Ring<TS>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      schur_dmma_kernel<TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + DN - 1) / DN, (m + DM - 1) / DM, batch);
  schur_dmma_kernel<TS><<<grid, DTHREADS, SMEM, stream>>>(
      c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out, ob, orr, oc, m, n,
      k);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- f32 on FMA
constexpr int FM = 128;        // rows of OUT per block
constexpr int FN = 64;         // columns of OUT per block
constexpr int FK = 32;         // depth of one pipeline stage
constexpr int FSTAGES = 3;     // K slices in flight
constexpr int FTHREADS = 256;  // 16 x 16, each thread 8 rows x 4 columns
// A slice as A[r][q], 36 floats a row, and B as B[q][s], 68 a row: whole
// 16-byte vectors, and 4 mod 32 banks apart, so that neither the copies'
// writes nor the fragment reads below collide on a bank
constexpr int FA_LD = FK + 4;
constexpr int FB_LD = FN + 4;
constexpr int F_STAGE = FM * FA_LD + FK * FB_LD;  // floats
constexpr size_t F_SMEM = FSTAGES * F_STAGE * sizeof(float);

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Issue the copies of an O x I block of an f32 operand into
// tile[o * LD + i]: element (o, i) at p[(o0 + o) * os + (i0 + i) * is],
// zeros where o0 + o >= on or i0 + i >= in. `vec` (unit stride along i, a
// row stride of whole 16-byte vectors, a 16-byte aligned start): four
// elements a 16-byte copy. Otherwise one element a 4-byte copy, legal at
// any offset: consecutive threads along i where its stride is 1, else a
// warp takes 8 consecutive o by 4 i, so that a unit stride along o (a
// transposed operand) reads 32-byte runs, and with LD = 4 mod 32 the
// warp's 32 writes land on 32 banks.
template <int O, int I, int LD>
__device__ __forceinline__ void stage_f32(float* tile, const float* p,
                                          long long os, long long is,
                                          bool vec, int o0, int on, int i0,
                                          int in) {
  static_assert(LD % 32 == 4 && O % 8 == 0 && I % 4 == 0, "f32 tile shape");
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < O * I / 4 / FTHREADS; ++j) {
      const int e = tid + j * FTHREADS;
      const int o = e / (I / 4), i = 4 * (e % (I / 4));
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async16(tile + o * LD + i, ok ? p + (o0 + o) * os + i0 + i : p,
                 ok ? min(4, in - i0 - i) * 4 : 0);
    }
  } else if (is == 1) {
#pragma unroll
    for (int j = 0; j < O * I / FTHREADS; ++j) {
      const int e = tid + j * FTHREADS;
      const int o = e / I, i = e % I;
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async_elem<4>(tile + o * LD + i, ok ? p + (o0 + o) * os + i0 + i : p,
                       ok);
    }
  } else {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < O * I / FTHREADS; ++j) {
      const int blk = warp + FTHREADS / 32 * j;
      const int o = 8 * (blk % (O / 8)) + (lane & 7);
      const int i = 4 * (blk / (O / 8)) + (lane >> 3);
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async_elem<4>(tile + o * LD + i,
                       ok ? p + (o0 + o) * os + (i0 + i) * is : p, ok);
    }
  }
}

// Row i (of 8) of a thread's tile: 4 ty + i for i < 4, 64 + 4 ty + i - 4
// after, so that the two float4 reads of a k group stay 16 banks apart.
__device__ __forceinline__ int f_row(int i) { return i < 4 ? i : 60 + i; }

// The thread's 8 x 4 tile gains one K slice in shared memory, k ascending:
// per four k, eight float4s of A (its rows, four k each) and four of B
// (a k each, its four columns).
__device__ __forceinline__ void fma_slice(const float* sa, const float* sb,
                                          float (&acc)[8][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* arow = sa + 4 * ty * FA_LD;
  const float* bcol = sb + 4 * tx;
#pragma unroll
  for (int kk = 0; kk < FK; kk += 4) {
    float av[8][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(arow + f_row(i) * FA_LD + kk);
      av[i][0] = v.x;
      av[i][1] = v.y;
      av[i][2] = v.z;
      av[i][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v =
          *reinterpret_cast<const float4*>(bcol + (kk + u) * FB_LD);
      bv[u][0] = v.x;
      bv[u][1] = v.y;
      bv[u][2] = v.z;
      bv[u][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i][u], bv[u][j], acc[i][j]);
        }
      }
    }
  }
}

// Four neighbours (gr, gc .. gc + 3) of a row, zeros outside m x n: one
// 16-byte load where unit-strided, aligned and whole.
__device__ __forceinline__ void load_row4(const float* p, long long rs,
                                          long long cs, int gr, int gc,
                                          int m, int n, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = 0.0f;
  if (gr >= m) return;
  const float* q = p + gr * rs + gc * cs;
  if (cs == 1 && gc + 4 <= n && aligned16(q)) {
    const float4 w = *reinterpret_cast<const float4*>(q);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (gc + e < n) v[e] = q[e * cs];
  }
}

__device__ __forceinline__ void store_row4(float* p, long long rs,
                                           long long cs, int gr, int gc,
                                           int m, int n, const float (&v)[4]) {
  if (gr >= m) return;
  float* q = p + gr * rs + gc * cs;
  if (cs == 1 && gc + 4 <= n && aligned16(q)) {
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (gc + e < n) q[e * cs] = v[e];
  }
}

// Block (x, y, z) computes OUT[z][128 y : 128 y + 128, 64 x : 64 x + 64]
// in f32 on the FMA pipes; thread (ty, tx) = (tid / 16, tid % 16) owns
// rows 4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3, columns 4 tx ..
// 4 tx + 3. A template of the one type f32, so that the profiler names
// its route as it names the others'.
template <typename T>
__global__ void __launch_bounds__(FTHREADS, 1)
schur_fma_kernel(const T* __restrict__ c, long long cb, long long cr,
                 long long cc, const T* __restrict__ a, long long ab,
                 long long ar, long long ac, const T* __restrict__ b,
                 long long bb, long long br, long long bc,
                 T* __restrict__ out, long long ob, long long orr,
                 long long oc, int m, int n, int k) {
  static_assert(std::is_same<T, float>::value, "the FMA kernel is f32's");
  extern __shared__ __align__(16) unsigned char f_smem[];
  float* ring = reinterpret_cast<float*>(f_smem);
  c += blockIdx.z * cb;
  a += blockIdx.z * ab;
  b += blockIdx.z * bb;
  out += blockIdx.z * ob;
  const bool a_vec = ac == 1 && ar % 4 == 0 && aligned16(a);
  const bool b_vec = bc == 1 && br % 4 == 0 && aligned16(b);
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const int slices = (k + FK - 1) / FK;
  const auto load = [&](int s) {
    float* sa = ring + (s % FSTAGES) * F_STAGE;
    stage_f32<FM, FK, FA_LD>(sa, a, ar, ac, a_vec, m0, m, s * FK, k);
    stage_f32<FK, FN, FB_LD>(sa + FM * FA_LD, b, br, bc, b_vec, s * FK, k,
                             n0, n);
  };
#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  // this thread's elements of C, fetched while the product runs
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = m0 + 4 * ty, col0 = n0 + 4 * tx;
  float cv[8][4], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    load_row4(c, cr, cc, row0 + f_row(i), col0, m, n, cv[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<FSTAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's have, and slice kt - 1 is read
    if (kt + FSTAGES - 1 < slices) load(kt + FSTAGES - 1);
    cp_async_commit();
    const float* sa = ring + (kt % FSTAGES) * F_STAGE;
    fma_slice(sa, sa + FM * FA_LD, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cv[i][j] - acc[i][j];
    store_row4(out, orr, oc, row0 + f_row(i), col0, m, n, v);
  }
}

template <typename T>
int launch_fma(const T* c, long long cb, long long cr, long long cc,
               const T* a, long long ab, long long ar, long long ac,
               const T* b, long long bb, long long br, long long bc, T* out,
               long long ob, long long orr, long long oc, int batch, int m,
               int n, int k, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      schur_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(F_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM, batch);
  schur_fma_kernel<T><<<grid, FTHREADS, F_SMEM, stream>>>(
      c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out, ob, orr, oc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- bf16 and f16 on wgmma
constexpr int WM = 128;               // rows of OUT per block, 64 a warpgroup
constexpr int WN = 64;                // columns of OUT per block
constexpr int WK = 64;                // depth of a stage: 128 bytes of a row
constexpr int WSTAGES = 5;            // stages of the ring
constexpr int WAHEAD = WSTAGES - 2;   // slices loading ahead of the product
constexpr int WTHREADS = 256;         // two warpgroups
constexpr int W_A_BYTES = WM * WK * 2;
constexpr int W_B_BYTES = WK * WN * 2;
constexpr int W_STAGE = W_A_BYTES + W_B_BYTES;  // 24 KB
// the ring, slack to align it to the swizzle's 1024 bytes, an mbarrier a stage
constexpr size_t W_SMEM = WSTAGES * W_STAGE + SWIZZLE_ATOM + WSTAGES * 8;

#define WGMMA_D                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_D_OPERANDS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d += A B for the warpgroup's 64 x 16 of A (K-major) and 16 x 64 of B
// (N-major: transpose bit 1), both from shared memory. d[4 j + 2 h + e]
// is row 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e, for warp w
// of the warpgroup.
template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                unsigned long long da,
                                                unsigned long long db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D
        ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : WGMMA_D_OPERANDS(d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WGMMA_D
        ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : WGMMA_D_OPERANDS(d)
        : "l"(da), "l"(db), "r"(1));
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned short u);
template <>
__device__ __forceinline__ __nv_bfloat16 from_bits(unsigned short u) {
  return __ushort_as_bfloat16(u);
}
template <>
__device__ __forceinline__ __half from_bits(unsigned short u) {
  return __ushort_as_half(u);
}
__device__ __forceinline__ unsigned short to_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ unsigned short to_bits(__half v) {
  return __half_as_ushort(v);
}

// Copy rows [r0, r0 + R) by columns [q0, q0 + 64) of a 2-byte operand,
// element (r, q) at p[r * rs + q * qs], into a swizzled tile, zeros where
// r >= rows or q >= cols: a plain load and store an element (cp.async has
// no 2-byte copy), consecutive threads along the unit-stride axis.
template <int R>
__device__ __forceinline__ void copy_tile(unsigned char* tile,
                                          const unsigned short* p,
                                          long long rs, long long qs, int r0,
                                          int rows, int q0, int cols) {
  const bool along_q = qs == 1 || rs != 1;
#pragma unroll 8
  for (int j = 0; j < R * WK / WTHREADS; ++j) {
    const int e = threadIdx.x + j * WTHREADS;
    const int r = along_q ? e / WK : e % R;
    const int q = along_q ? e % WK : e / R;
    const bool ok = r0 + r < rows && q0 + q < cols;
    *reinterpret_cast<unsigned short*>(tile + swizzled(r, q)) =
        ok ? p[(r0 + r) * rs + (q0 + q) * qs] : 0;
  }
}

// What a block needs to load a K slice into its ring.
struct WgmmaFeed {
  const CUtensorMap* a_map;
  const CUtensorMap* b_map;
  int tma;  // bit 0: A by TMA, bit 1: B by TMA
  unsigned tx_bytes;
  const unsigned short* a;
  long long ar, ac;
  const unsigned short* b;
  long long br, bc;
  int m0, n0, z, m, n, k;
};

// Issue slice s into stage s % WSTAGES: TMA copies from thread 0 against
// the stage's mbarrier, the other operand copied by every thread (then
// fenced for wgmma, which reads shared memory through the async proxy).
__device__ __forceinline__ void wgmma_load(const WgmmaFeed& f, int s,
                                           unsigned char* ring,
                                           unsigned ring_addr,
                                           unsigned bars) {
  const int st = s % WSTAGES, k0 = s * WK;
  unsigned char* sa = ring + st * W_STAGE;
  const unsigned sa_addr = ring_addr + st * W_STAGE;
  if (f.tx_bytes != 0 && threadIdx.x == 0) {
    const unsigned bar = bars + 8 * st;
    mbar_expect_tx(bar, f.tx_bytes);
    if (f.tma & 1) tma_load(sa_addr, f.a_map, bar, k0, f.m0, f.z);
    if (f.tma & 2) tma_load(sa_addr + W_A_BYTES, f.b_map, bar, f.n0, k0, f.z);
  }
  if (!(f.tma & 1)) copy_tile<WM>(sa, f.a, f.ar, f.ac, f.m0, f.m, k0, f.k);
  if (!(f.tma & 2)) {
    copy_tile<WK>(sa + W_A_BYTES, f.b, f.br, f.bc, k0, f.k, f.n0, f.n);
  }
  if (f.tma != 3) fence_proxy_async();
}

// The pair (gr, gc), (gr, gc + 1) of a 2-byte operand widened to f32,
// zeros outside m x n: one 4-byte load where unit-strided and aligned.
template <typename T>
__device__ __forceinline__ void load_pair(const T* p, long long rs,
                                          long long cs, int gr, int gc,
                                          int m, int n, float& x, float& y) {
  x = y = 0.0f;
  if (gr >= m || gc >= n) return;
  const T* q = p + gr * rs + gc * cs;
  if (cs == 1 && gc + 2 <= n &&
      (reinterpret_cast<unsigned long long>(q) & 3) == 0) {
    const unsigned w = *reinterpret_cast<const unsigned*>(q);
    x = widen<T, float>(from_bits<T>(w & 0xffff));
    y = widen<T, float>(from_bits<T>(w >> 16));
    return;
  }
  x = widen<T, float>(q[0]);
  if (gc + 1 < n) y = widen<T, float>(q[cs]);
}

// Block (x, y, z) computes OUT[z][128 y : 128 y + 128, 64 x : 64 x + 64]
// from 2-byte operands T, summed in f32 by wgmma; warpgroup g owns rows
// 64 g .. 64 g + 63. `tma`: bit 0 where a_map holds A, bit 1 where b_map
// holds B (maps over the whole batch, the block's matrix by coordinate).
template <typename T>
__global__ void __launch_bounds__(WTHREADS, 1)
schur_wgmma_kernel(__grid_constant__ const CUtensorMap a_map,
                   __grid_constant__ const CUtensorMap b_map, int tma,
                   const T* __restrict__ c, long long cb, long long cr,
                   long long cc, const T* __restrict__ a, long long ab,
                   long long ar, long long ac, const T* __restrict__ b,
                   long long bb, long long br, long long bc,
                   T* __restrict__ out, long long ob, long long orr,
                   long long oc, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char w_smem[];
  const unsigned raw = smem_addr(w_smem);
  unsigned char* ring =
      w_smem + (SWIZZLE_ATOM - raw % SWIZZLE_ATOM) % SWIZZLE_ATOM;
  const unsigned ring_addr = smem_addr(ring);
  const unsigned bars = ring_addr + WSTAGES * W_STAGE;
  const int z = blockIdx.z;
  c += z * cb;
  out += z * ob;
  const WgmmaFeed feed{
      &a_map, &b_map, tma,
      static_cast<unsigned>((tma & 1 ? W_A_BYTES : 0) +
                            (tma & 2 ? W_B_BYTES : 0)),
      reinterpret_cast<const unsigned short*>(a + z * ab), ar, ac,
      reinterpret_cast<const unsigned short*>(b + z * bb), br, bc,
      static_cast<int>(blockIdx.y) * WM, static_cast<int>(blockIdx.x) * WN,
      z, m, n, k};
  const int slices = (k + WK - 1) / WK;
  if (threadIdx.x == 0 && feed.tx_bytes != 0) {
    for (int s = 0; s < WSTAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  for (int s = 0; s < WAHEAD && s < slices; ++s) {
    wgmma_load(feed, s, ring, ring_addr, bars);
  }
  // this thread's elements of C in the accumulators' layout, fetched
  // while the first slices land
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int rloc = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int cloc = 2 * (lane & 3);
  float cv[32], acc[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      load_pair(c, cr, cc, feed.m0 + rloc + 8 * h, feed.n0 + 8 * j + cloc, m,
                n, cv[i], cv[i + 1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < slices; ++kt) {
    const int st = kt % WSTAGES;
    if (feed.tx_bytes != 0) mbar_wait(bars + 8 * st, (kt / WSTAGES) & 1);
    __syncthreads();  // every copy of slice kt is in; slice kt - 2 is read
    const unsigned a_tile = ring_addr + st * W_STAGE + wg * (64 * 128);
    const unsigned b_tile = ring_addr + st * W_STAGE + W_A_BYTES;
    wgmma_fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      wgmma_m64n64k16<T>(
          acc, wgmma_desc(a_tile + 32 * kk, SWIZZLE_ATOM, SWIZZLE_ATOM),
          wgmma_desc(b_tile + 16 * 128 * kk, SWIZZLE_ATOM, SWIZZLE_ATOM));
    }
    wgmma_commit();
    wgmma_fence_operands(acc);
    // into the stage of slice kt - 2, whose product the last wait ended
    if (kt + WAHEAD < slices) {
      wgmma_load(feed, kt + WAHEAD, ring, ring_addr, bars);
    }
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);
  // OUT = round(C - acc), through the ring's first 16 KB (swizzled, so
  // that the pair writes and the 16-byte reads are free of bank
  // conflicts), stored 16 bytes a thread
  __syncthreads();  // both warpgroups' products are done with the ring
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const unsigned lo = to_bits(narrow<T, float>(cv[i] - acc[i]));
      const unsigned hi = to_bits(narrow<T, float>(cv[i + 1] - acc[i + 1]));
      const int at = swizzled(rloc + 8 * h, 8 * j + cloc);
      *reinterpret_cast<unsigned*>(ring + at) = lo | hi << 16;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < WM * WN / 8 / WTHREADS; ++j) {
    const int e = threadIdx.x + j * WTHREADS;
    const int r = e >> 3, q = 8 * (e & 7);
    const int gr = feed.m0 + r, gc = feed.n0 + q;
    if (gr >= m || gc >= n) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ring + swizzled(r, q));
    T* dst = out + gr * orr + gc * oc;
    if (oc == 1 && gc + 8 <= n && aligned16(dst)) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
      for (int e2 = 0; e2 < 8 && gc + e2 < n; ++e2) {
        dst[e2 * oc] = from_bits<T>(h[e2]);
      }
    }
  }
}

// A TMA map of a 2-byte operand for the wgmma ring: `batch` matrices at
// bs elements, `rows` rows at rs, `cols` elements a row at unit stride
// us; a box of box_rows x 64, 128-byte swizzle, zeros past the edges.
// False where the operand does not qualify (a unit inner stride, a
// 16-byte aligned start, row and batch strides of whole 16-byte vectors
// under 2^40 bytes) or the driver refuses the map.
template <typename T>
bool tile_map(EncodeTiled encode, CUtensorMap* map, const T* p, long long bs,
              long long rs, long long us, int batch, int rows, int cols,
              int box_rows) {
  const long long row_bytes = rs * static_cast<long long>(sizeof(T));
  const long long batch_bytes =
      batch > 1 ? bs * static_cast<long long>(sizeof(T)) : row_bytes * rows;
  const auto fits = [](long long v) {
    return v > 0 && v % 16 == 0 && v < (1ll << 40);
  };
  if (us != 1 || (reinterpret_cast<unsigned long long>(p) & 15) != 0 ||
      !fits(row_bytes) || !fits(batch_bytes) || rows <= 0 || cols <= 0) {
    return false;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(batch_bytes)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(WK),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 3, const_cast<T*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The operands a call loads by TMA (bit 0 A, bit 1 B), their maps filled.
template <typename T>
int tma_operands(EncodeTiled encode, const T* a, long long ab, long long ar,
                 long long ac, const T* b, long long bb, long long br,
                 long long bc, int batch, int m, int n, int k,
                 CUtensorMap* a_map, CUtensorMap* b_map) {
  return (tile_map(encode, a_map, a, ab, ar, ac, batch, m, k, WM) ? 1 : 0) |
         (tile_map(encode, b_map, b, bb, br, bc, batch, k, n, WK) ? 2 : 0);
}

template <typename T>
int launch_wgmma(const T* c, long long cb, long long cr, long long cc,
                 const T* a, long long ab, long long ar, long long ac,
                 const T* b, long long bb, long long br, long long bc, T* out,
                 long long ob, long long orr, long long oc, int batch, int m,
                 int n, int k, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap a_map{}, b_map{};
  const int tma = tma_operands(encode, a, ab, ar, ac, b, bb, br, bc, batch, m,
                               n, k, &a_map, &b_map);
  const cudaError_t err = cudaFuncSetAttribute(
      schur_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + WN - 1) / WN, (m + WM - 1) / WM, batch);
  schur_wgmma_kernel<T><<<grid, WTHREADS, W_SMEM, stream>>>(
      a_map, b_map, tma, c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out, ob,
      orr, oc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// OUT = C - A B for `batch` problems: A m x k, B k x n, C and OUT m x n,
// each at (batch, row, column) strides in elements. Returns
// cudaGetLastError() right after the launch.
#define SCHUR_ENTRY(NAME, T, LAUNCH)                                         \
  int NAME(const T* c, long long cb, long long cr, long long cc, const T* a, \
           long long ab, long long ar, long long ac, const T* b,             \
           long long bb, long long br, long long bc, T* out, long long ob,   \
           long long orr, long long oc, int batch, int m, int n, int k,      \
           cudaStream_t stream) {                                            \
    return LAUNCH(c, cb, cr, cc, a, ab, ar, ac, b, bb, br, bc, out, ob, orr, \
                  oc, batch, m, n, k, stream);                               \
  }

extern "C" {

SCHUR_ENTRY(schur_f64, double, launch_dmma<double>)
SCHUR_ENTRY(schur_f32, float, launch_fma<float>)
SCHUR_ENTRY(schur_f32_f64, float, launch_dmma<float>)
SCHUR_ENTRY(schur_bf16, __nv_bfloat16, launch_wgmma<__nv_bfloat16>)
SCHUR_ENTRY(schur_f16, __half, launch_wgmma<__half>)
SCHUR_ENTRY(schur_bf16_f64, __nv_bfloat16, launch_dmma<__nv_bfloat16>)
SCHUR_ENTRY(schur_f16_f64, __half, launch_dmma<__half>)

// Which operands a bf16 or f16 call with these arguments loads by TMA: bit
// 0 A, bit 1 B; the block's threads copy the others. 0 for all where the
// driver has no cuTensorMapEncodeTiled.
int schur_half_tma_operands(const __nv_bfloat16* a, long long ab,
                            long long ar, long long ac,
                            const __nv_bfloat16* b, long long bb,
                            long long br, long long bc, int batch, int m,
                            int n, int k) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 0;
  CUtensorMap a_map{}, b_map{};
  return tma_operands(encode, a, ab, ar, ac, b, bb, br, bc, batch, m, n, k,
                      &a_map, &b_map);
}

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
