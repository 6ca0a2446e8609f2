// Conversions between a kernel's storage type TS and the type TA it
// computes in: widen<TS, TA> on load, narrow<TS, TA> on store. The
// default routes compute in their storage type (TS = TA, a plain copy);
// the mixed routes store narrow and compute wide: float stored with
// double arithmetic, bfloat16 or half stored with float or double
// arithmetic. Half types go through their intrinsics; every narrowing
// rounds to nearest even, once: a double narrows to bfloat16 or half by
// __double2bfloat16 / __double2half, never through float, which would
// round twice.
//
// The narrow routes (bfloat16 or half storage and arithmetic) compute
// every operation in the storage type: quot(a, b), and sub_prod(x, a, b)
// = x - a b as a product rounded to the type, then a difference rounded
// to it, with no fused multiply-add. Each is taken in float with
// explicit IEEE operations (__fmul_rn, __fsub_rn, __fdiv_rn: never
// contracted, never approximate) and rounded to the half type once.
// Products of two half values are exact in float; a float sum or
// quotient of them, rounded to nearest and then to the half type, is the
// half type's correctly rounded result, since float carries at least
// 2p + 2 bits for the half types' p (8, 11). So these are the half
// type's own IEEE operations, bit for bit, and also what PyTorch's
// elementwise bfloat16 and half operators compute on either device. For
// float and double, quot and sub_prod are the plain expressions, which
// the compiler treats as before (it may contract x - a b into an FMA).
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
template <>
__device__ __forceinline__ double widen<__nv_bfloat16, double>(
    __nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));  // exact
}
template <>
__device__ __forceinline__ double widen<__half, double>(__half v) {
  return static_cast<double>(__half2float(v));  // exact
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
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, double>(
    double v) {
  return __double2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half, double>(double v) {
  return __double2half(v);
}

// The constant v (0 or 1 where the kernels use it) in type T.
template <typename T>
__device__ __forceinline__ T constant(float v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 constant<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half constant<__half>(float v) {
  return __float2half_rn(v);
}

// a / b and x - a b in T (see the head of this file).
template <typename T>
__device__ __forceinline__ T quot(T a, T b) {
  return a / b;
}
template <typename T>
__device__ __forceinline__ T sub_prod(T x, T a, T b) {
  return x - a * b;
}

template <typename H>
__device__ __forceinline__ H half_quot(H a, H b) {
  return narrow<H, float>(
      __fdiv_rn(widen<H, float>(a), widen<H, float>(b)));
}
template <typename H>
__device__ __forceinline__ H half_sub_prod(H x, H a, H b) {
  const H p = narrow<H, float>(
      __fmul_rn(widen<H, float>(a), widen<H, float>(b)));
  return narrow<H, float>(
      __fsub_rn(widen<H, float>(x), widen<H, float>(p)));
}
template <>
__device__ __forceinline__ __nv_bfloat16 quot<__nv_bfloat16>(__nv_bfloat16 a,
                                                             __nv_bfloat16 b) {
  return half_quot(a, b);
}
template <>
__device__ __forceinline__ __half quot<__half>(__half a, __half b) {
  return half_quot(a, b);
}
template <>
__device__ __forceinline__ __nv_bfloat16 sub_prod<__nv_bfloat16>(
    __nv_bfloat16 x, __nv_bfloat16 a, __nv_bfloat16 b) {
  return half_sub_prod(x, a, b);
}
template <>
__device__ __forceinline__ __half sub_prod<__half>(__half x, __half a,
                                                    __half b) {
  return half_sub_prod(x, a, b);
}

// True for the half types, whose routes round every operation.
template <typename T>
struct is_half_type {
  static constexpr bool value = false;
};
template <>
struct is_half_type<__nv_bfloat16> {
  static constexpr bool value = true;
};
template <>
struct is_half_type<__half> {
  static constexpr bool value = true;
};
