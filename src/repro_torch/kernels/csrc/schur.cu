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
// f32, bf16 and f16 (schur_kernel) take the FMA kernel of the first
// port, a route by type: plain f32 lu_blocked calls the f32 route.
// A block of 16 x 16 threads owns a 64 x 64 tile of OUT and walks K in
// steps of 16 through shared memory, each thread a 4 x 4 register tile of
// FMA sums (f32 accumulates in f32, bf16 and f16 are widened to f32 and
// rounded once on store), subtracted from C at the end.
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

#include "precision.cuh"

namespace {

constexpr int BM = 64;   // rows of OUT per block
constexpr int BN = 64;   // columns of OUT per block
constexpr int BK = 16;   // depth of one shared-memory step
constexpr int TD = 16;   // threads per block side
constexpr int RT = BM / TD;  // register tile side (4)
constexpr int NT = TD * TD;  // threads per block

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
SCHUR_ENTRY(schur_f32, float, (launch<float, float>))
SCHUR_ENTRY(schur_f32_f64, float, launch_dmma<float>)
SCHUR_ENTRY(schur_bf16, __nv_bfloat16, (launch<__nv_bfloat16, float>))
SCHUR_ENTRY(schur_f16, __half, (launch<__half, float>))
SCHUR_ENTRY(schur_bf16_f64, __nv_bfloat16, launch_dmma<__nv_bfloat16>)
SCHUR_ENTRY(schur_f16_f64, __half, launch_dmma<__half>)

const char* spdc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
