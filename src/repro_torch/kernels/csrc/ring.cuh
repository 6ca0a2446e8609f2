// The pipelined products that schur.cu (OUT = C - A B) and trsm.cu (the
// recursive solve's T21 X1 products) share: cp.async copies and their
// groups, the 3-stage ring of 32-deep K slices that they fill, and the two
// ways a block sums a slice:
//  * f64 tensor cores (DMMA, the sm_90 mma.sync shape m16n8k4), a block of
//    ROWS / 32 x 2 warps, each warp a 32 x 32 tile of the output. A and B
//    may be stored in different types (the solver's triangle at its
//    storage type against its f64 workspace); each fragment is widened to
//    f64 as it is read from shared memory;
//  * the FMA pipes in f32 (no TF32), a block of 256 threads over a
//    ROWS x 64 tile (128 or 64), each thread ROWS / 16 x 4 of it.
// Each sum runs over k ascending, slice by slice, whatever the tile's
// position: the same element gets the same bits in any grid.
#pragma once

#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

// ---------------------------------------------------------------- copies
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// The ring's schedule over `slices` K slices in N stages: load(s) issues
// slice s's copies into stage s % N, mul(s) multiplies it. The first N - 1
// slices are issued, then before() runs (a block loads its C tile into
// registers there, while they land); then for each slice: wait for this
// thread's copies of it, a barrier (everyone's have landed, and slice
// s - 1 is read, so its stage may be refilled), issue slice s + N - 1,
// multiply slice s. One barrier a slice.
template <int N, typename Load, typename Before, typename Mul>
__device__ __forceinline__ void run_ring(int slices, Load&& load,
                                         Before&& before, Mul&& mul) {
#pragma unroll
  for (int s = 0; s < N - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  before();
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<N - 2>();
    __syncthreads();
    if (kt + N - 1 < slices) load(kt + N - 1);
    cp_async_commit();
    mul(kt);
  }
}

// An operand as a block stages it: element (o, i) at p[o * os + i * is],
// i the axis a stage row runs along (A's k, B's n). `vec`: unit stride
// along i, an outer stride of whole 16-byte vectors and a 16-byte aligned
// start, so 16 bytes go in one copy. Otherwise one element a copy,
// consecutive threads along i where `along` (its stride is 1 or -1, or
// o's is not), else along o. Strides are told apart by magnitude, so that
// reversed views (negated strides) copy as their unreversed ones do.
template <typename T>
struct Feed {
  const T* p;
  long long os, is;
  bool vec, along;
};

// True where consecutive threads should run along an operand's columns:
// their stride is 1 or -1, or the rows' is not.
__device__ __forceinline__ bool along_cols(long long rs, long long cs) {
  return (cs < 0 ? -cs : cs) == 1 || (rs < 0 ? -rs : rs) != 1;
}

template <typename T>
__device__ __forceinline__ Feed<T> feed(const T* p, long long os,
                                        long long is) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  return {p, os, is, is == 1 && os % VEC == 0 && aligned16(p),
          along_cols(os, is)};
}

// ----------------------------------------------------------------- DMMA
constexpr int DN = 64;             // columns of OUT per block
constexpr int DK = 32;             // depth of one pipeline stage
constexpr int STAGES = 3;          // K slices in flight

// The ring's layout for A stored as TA and B as TB (double, or float,
// bfloat16 or half): row strides in elements chosen so the fragment reads
// hit distinct banks (doubles: the 16 lanes of a half warp; floats: all 32
// lanes, rows g apart by 4 banks in A and columns t apart by 8 in B;
// 2-byte types: rows g apart by 20 banks in A and columns t apart by 4 in
// B, lanes 2 t and 2 t + 1 sharing a word) and a whole number of 16-byte
// vectors, so every row of a stage starts 16-byte aligned. A block of
// ROWS rows; a stage is A then B, in bytes.
template <typename TA, typename TB, int ROWS>
struct Ring {
  static constexpr int A_LD = DK + (sizeof(TA) == 2 ? 8 : 4);
  static constexpr int B_LD = DN + (sizeof(TB) == 8 ? 4 : 8);
  static constexpr int A_BYTES = ROWS * A_LD * static_cast<int>(sizeof(TA));
  static constexpr int STAGE =
      A_BYTES + DK * B_LD * static_cast<int>(sizeof(TB));
  static constexpr size_t SMEM = STAGES * STAGE;
  static constexpr int THREADS = 2 * ROWS;  // ROWS / 32 x 2 warps
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

// Issue the copies of an O x I block of an operand into tile[o * LD + i]:
// element (o0 + o, i0 + i) of f, zeros where o0 + o >= on or
// i0 + i >= in (the masked copies read nothing, from a valid address).
template <typename T, int O, int I, int LD, int THREADS>
__device__ __forceinline__ void stage_block(T* tile, const Feed<T>& f,
                                            int o0, int on, int i0, int in) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int SIZE = static_cast<int>(sizeof(T));
  static_assert(SIZE == 2 || SIZE == 4 || SIZE == 8, "element size");
  const int tid = threadIdx.x;
  if (f.vec) {
#pragma unroll
    for (int j = 0; j < O * I / VEC / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int o = e / (I / VEC), i = VEC * (e % (I / VEC));
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async16(tile + o * LD + i, ok ? f.p + (o0 + o) * f.os + i0 + i : f.p,
                 ok ? min(VEC, in - i0 - i) * SIZE : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < O * I / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int o = f.along ? e / I : e % O;
      const int i = f.along ? e % I : e / O;
      const bool ok = o0 + o < on && i0 + i < in;
      copy_elem<SIZE>(tile + o * LD + i,
                      ok ? f.p + (o0 + o) * f.os + (i0 + i) * f.is : f.p, ok);
    }
  }
}

// Issue the copies of K slice [k0, k0 + DK) into a stage: A rows
// [m0, m0 + ROWS) as sa[r * A_LD + q], B columns [n0, n0 + DN) as
// sb[q * B_LD + s]; zeros past m, n and k.
template <typename TA, typename TB, int ROWS>
__device__ __forceinline__ void load_slice(unsigned char* stage,
                                           const Feed<TA>& a,
                                           const Feed<TB>& b, int m0, int n0,
                                           int k0, int m, int n, int k) {
  using R = Ring<TA, TB, ROWS>;
  stage_block<TA, ROWS, DK, R::A_LD, R::THREADS>(
      reinterpret_cast<TA*>(stage), a, m0, m, k0, k);
  stage_block<TB, DK, DN, R::B_LD, R::THREADS>(
      reinterpret_cast<TB*>(stage + R::A_BYTES), b, k0, k, n0, n);
}

// The warp's 32 x 32 tile gains the product of one K slice in shared
// memory, four k at a time, k ascending; fragments are widened to f64 as
// they are read. Warp w owns rows 32 (w / 2), columns 32 (w % 2).
template <typename TA, typename TB, int ROWS>
__device__ __forceinline__ void slice_product(const unsigned char* stage,
                                              double (&acc)[4][4][2]) {
  using R = Ring<TA, TB, ROWS>;
  constexpr int A_LD = R::A_LD, B_LD = R::B_LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const TA* arow = reinterpret_cast<const TA*>(stage) +
                   (32 * (warp >> 1) + g) * A_LD + t;
  const TB* bcol = reinterpret_cast<const TB*>(stage + R::A_BYTES) +
                   t * B_LD + 32 * (warp & 1) + g;
#pragma unroll
  for (int kk = 0; kk < DK; kk += 4) {
    double fa[4], fb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fa[r] = widen<TA, double>(arow[8 * r * A_LD + kk]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      fb[ni] = widen<TB, double>(bcol[kk * B_LD + 8 * ni]);
    }
    dmma(acc, fa, fb);
  }
}

// ------------------------------------------------------------ f32 on FMA
constexpr int FM = 128;        // rows of OUT per block
constexpr int FN = 64;         // columns of OUT per block
constexpr int FK = 32;         // depth of one pipeline stage
constexpr int FSTAGES = 3;     // K slices in flight
constexpr int FTHREADS = 256;  // 16 x 16, each thread FM / 16 rows x 4 columns
// A slice as A[r][q], 36 floats a row, and B as B[q][s], 68 a row: whole
// 16-byte vectors, and 4 mod 32 banks apart, so that neither the copies'
// writes nor the fragment reads below collide on a bank
constexpr int FA_LD = FK + 4;
constexpr int FB_LD = FN + 4;
constexpr int F_STAGE = FM * FA_LD + FK * FB_LD;  // floats
constexpr size_t F_SMEM = FSTAGES * F_STAGE * sizeof(float);

// Issue the copies of an O x I block of an f32 operand into
// tile[o * LD + i]: element (o, i) at p[(o0 + o) * os + (i0 + i) * is],
// zeros where o0 + o >= on or i0 + i >= in. `vec` (unit stride along i, a
// row stride of whole 16-byte vectors, a 16-byte aligned start): four
// elements a 16-byte copy. Otherwise one element a 4-byte copy, legal at
// any offset: consecutive threads along i where its stride is 1, else a
// warp takes 8 consecutive o by 4 i, so that a unit stride along o (a
// transposed operand) reads 32-byte runs, and with LD = 4 mod 32 the
// warp's 32 writes land on 32 banks.
template <int O, int I, int LD, int THREADS = FTHREADS>
__device__ __forceinline__ void stage_f32(float* tile, const float* p,
                                          long long os, long long is,
                                          bool vec, int o0, int on, int i0,
                                          int in) {
  static_assert(LD % 32 == 4 && O % 8 == 0 && I % 4 == 0, "f32 tile shape");
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < O * I / 4 / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int o = e / (I / 4), i = 4 * (e % (I / 4));
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async16(tile + o * LD + i, ok ? p + (o0 + o) * os + i0 + i : p,
                 ok ? min(4, in - i0 - i) * 4 : 0);
    }
  } else if (is == 1) {
#pragma unroll
    for (int j = 0; j < O * I / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int o = e / I, i = e % I;
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async_elem<4>(tile + o * LD + i, ok ? p + (o0 + o) * os + i0 + i : p,
                       ok);
    }
  } else {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < O * I / THREADS; ++j) {
      const int blk = warp + THREADS / 32 * j;
      const int o = 8 * (blk % (O / 8)) + (lane & 7);
      const int i = 4 * (blk / (O / 8)) + (lane >> 3);
      const bool ok = o0 + o < on && i0 + i < in;
      cp_async_elem<4>(tile + o * LD + i,
                       ok ? p + (o0 + o) * os + (i0 + i) * is : p, ok);
    }
  }
}

// Row i of a thread's tile in a block of ROWS rows (256 threads, 16 x
// 16, each thread ROWS / 16 rows by 4 columns): 4 ty + i for i < 4,
// ROWS / 2 + 4 ty + i - 4 after, so that at 128 rows the two float4 reads
// of a k group stay 16 banks apart.
template <int ROWS = FM>
__device__ __forceinline__ int f_row(int i) {
  return i < 4 ? i : ROWS / 2 - 4 + i;
}

// The thread's ROWS / 16 x 4 tile gains one K slice in shared memory, k
// ascending: per four k, a float4 of A for each of its rows (four k
// each) and four of B (a k each, its four columns).
template <int ROWS = FM>
__device__ __forceinline__ void fma_slice(const float* sa, const float* sb,
                                          float (&acc)[ROWS / 16][4]) {
  constexpr int R = ROWS / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* arow = sa + 4 * ty * FA_LD;
  const float* bcol = sb + 4 * tx;
#pragma unroll
  for (int kk = 0; kk < FK; kk += 4) {
    float av[R][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(arow + f_row<ROWS>(i) * FA_LD + kk);
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
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i][u], bv[u][j], acc[i][j]);
        }
      }
    }
  }
}

}  // namespace
