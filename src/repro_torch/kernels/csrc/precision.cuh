// Conversions between a kernel's storage type TS and the type TA it
// computes in: widen<TS, TA> on load, narrow<TS, TA> on store. The
// default routes compute in their storage type (TS = TA, a plain copy);
// the mixed routes store narrow and compute wide: float stored with
// double arithmetic, bfloat16 or half stored with float arithmetic.
// Half types go through their intrinsics; every narrowing rounds to
// nearest.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename TS, typename TA>
__device__ __forceinline__ TA widen(TS v) {
  return static_cast<TA>(v);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16, float>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float widen<__half, float>(__half v) {
  return __half2float(v);
}

template <typename TS, typename TA>
__device__ __forceinline__ TS narrow(TA v) {
  return static_cast<TS>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half, float>(float v) {
  return __float2half(v);
}
