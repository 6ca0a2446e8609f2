// Hopper's building blocks for the kernels that run on wgmma and TMA
// (schur.cu's schur_wgmma_kernel, flash_attn.cu's flash_wgmma_kernel):
// the 128-byte swizzled tile layout and the wgmma shared-memory
// descriptor that reads it, wgmma's fence, commit and wait, the mbarrier
// operations a TMA ring runs on, TMA loads of 3-D and 4-D tensor maps,
// and the driver's cuTensorMapEncodeTiled, reached through the runtime
// so that no library links -lcuda. sm_90a only.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_runtime.h>

namespace {

constexpr int SWIZZLE_ATOM = 1024;  // 8 rows of 128 bytes

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, q) in a tile of 64-element (128-byte) rows
// under the 128-byte swizzle: 16-byte chunk q / 8 of row r sits at chunk
// (q / 8) ^ (r % 8). TMA's CU_TENSOR_MAP_SWIZZLE_128B writes this layout,
// and a wgmma descriptor of the 128-byte swizzle reads it, in a tile
// whose start is SWIZZLE_ATOM-aligned.
__device__ __forceinline__ int swizzled(int r, int q) {
  return r * 128 + ((((q >> 3) ^ r) & 7) << 4) + (q & 7) * 2;
}

// A wgmma shared-memory matrix descriptor for the 128-byte swizzle (layout
// type 1 in bits 62-63): the start address, then the leading and stride
// byte offsets (bits 16-29 and 32-45, each in 16-byte units). The stride
// offset is the step from one group of 8 rows (K-major operand) or of 8 k
// (MN-major operand) to the next. The leading offset is read only for an
// MN-major operand wider than one 64-element swizzle row, where it is the
// step from one 64-column panel to the next; a K-major operand's k-step
// of 16 elements lies inside one 128-byte row and never reads it.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr,
                                                         unsigned lbo,
                                                         unsigned sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<unsigned long long>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators: the compiler may neither read one before the
// wgmma that writes it has been waited for nor move one between
// registers while a wgmma group is in flight.
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// This thread's arrival, expecting `bytes` more of TMA copies in the phase.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A tile lands in
// microseconds; one that has not after 2^26 polls (seconds) never will,
// and the block traps, so the launch fails instead of hanging the card.
// ptxas reports a warpgroup wait injected before the trap (C7517): it is
// on the trap's path alone.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// Orders this thread's plain shared-memory stores before later reads of
// the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a 3-D tensor map at (c0 innermost, c1, c2) into shared memory,
// completing on the mbarrier `bar` with its bytes.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
// The same for a 4-D tensor map at (c0 innermost, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the runtime loaded; null where the
// driver has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace
