"""The (storage, arithmetic) routes of the panel, triangular-solve and
Schur kernels: one table, read by the dispatcher (ops) to accept or
refuse an `acc_dtype` and by the wrappers to pick a CUDA entry point.

A default route computes in its kernel's default arithmetic type: the
storage type itself, except that the Schur update sums bfloat16 and
float16 in float32. A mixed route (the reference's acc_dtype) stores
narrow and computes wide. The ported mixed pairs are float32 storage
with float64 arithmetic and bfloat16/float16 storage with float32
arithmetic; the other pairs wait in ROADMAP B7.
"""
from __future__ import annotations

import torch

_F64, _F32, _BF16, _F16 = torch.float64, torch.float32, torch.bfloat16, torch.float16
_SOLVE = {
    (_F64, _F64): "f64", (_F32, _F32): "f32", (_F32, _F64): "f32_f64",
    (_BF16, _F32): "bf16_f32", (_F16, _F32): "f16_f32",
}
#: kernel -> {(storage, arithmetic): suffix of its CUDA entry points}
ROUTES = {
    "lu_panel": _SOLVE, "trsm_lower": _SOLVE, "trsm_upper_right": _SOLVE,
    "trsm_left": {(_F64, _F64): "f64", (_F32, _F32): "f32"},
    "schur_update": {
        (_F64, _F64): "f64", (_F32, _F32): "f32", (_F32, _F64): "f32_f64",
        (_BF16, _F32): "bf16", (_F16, _F32): "f16",
    },
}
#: the default arithmetic of a storage type where it is not the type itself
_WIDENED = {"schur_update": {_BF16: _F32, _F16: _F32}}


def default_arithmetic(kernel: str, dtype: torch.dtype) -> torch.dtype:
    return _WIDENED.get(kernel, {}).get(dtype, dtype)


def accumulator(kernel: str, dtype: torch.dtype, acc_dtype) -> torch.dtype | None:
    """The arithmetic dtype of a call: None for the default route
    (acc_dtype None, the storage dtype or its default arithmetic), else
    acc_dtype for a mixed pair in ROUTES. Any other pair raises
    TypeError."""
    if acc_dtype is None or acc_dtype in (dtype, default_arithmetic(kernel, dtype)):
        return None
    if (dtype, acc_dtype) not in ROUTES[kernel]:
        raise TypeError(
            f"{kernel}: {dtype} storage with {acc_dtype} arithmetic is not "
            "ported (ROADMAP B7)")
    return acc_dtype


def suffix(kernel: str, dtype: torch.dtype,
           acc_dtype: torch.dtype | None) -> str:
    """The CUDA entry-point suffix of a call's route (acc_dtype None: the
    default route); TypeError for a route with no CUDA entry point."""
    arith = acc_dtype or default_arithmetic(kernel, dtype)
    found = ROUTES[kernel].get((dtype, arith))
    if found is None:
        raise TypeError(
            f"{kernel} has no CUDA route for {dtype} storage with "
            f"{arith} arithmetic")
    return found
