"""Wrappers of the triangular-solve kernels (csrc/trsm.cu).

Ports of src/repro/kernels/trsm.py:trsm_lower and :trsm_upper_right. One
CUDA solver handles both: Z = B·U⁻¹ is handed over as Uᵀ Zᵀ = Bᵀ by
swapping strides, and every operand goes with its strides, so strided
views need no copy.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    f"trsm_{suffix}": (
        _INT,
        (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
         _INT, _INT, _INT, _INT, _PTR),
    )
    for suffix in ("f32", "f64")
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_GRID_Z = 65535


def _check(kernel: str, tri: torch.Tensor, rhs: torch.Tensor) -> int:
    """Validate a (…, n, n) triangle against its right-hand side; returns
    the batch size."""
    if tri.device.type != "cuda" or rhs.device != tri.device:
        raise ValueError(f"{kernel} needs CUDA operands, got {tri.device}/{rhs.device}")
    if tri.dtype not in _SUFFIX or rhs.dtype != tri.dtype:
        raise TypeError(f"{kernel} takes float32/float64, got {tri.dtype}/{rhs.dtype}")
    if tri.ndim not in (2, 3) or rhs.ndim != tri.ndim:
        raise ValueError(f"{kernel} needs two 2-D or two 3-D operands")
    if tri.shape[-1] != tri.shape[-2]:
        raise ValueError(f"{kernel}: triangle {tuple(tri.shape)} is not square")
    if tri.ndim == 3 and tri.shape[0] != rhs.shape[0]:
        raise ValueError(f"{kernel}: batch {tri.shape[0]} != {rhs.shape[0]}")
    batch = tri.shape[0] if tri.ndim == 3 else 1
    if batch > _MAX_GRID_Z:
        raise ValueError(f"batch {batch} exceeds the grid's {_MAX_GRID_Z}")
    return batch


def _strides(t: torch.Tensor, transpose: bool) -> tuple[int, int, int]:
    """(batch, row, column) element strides, rows and columns swapped
    for a transposed view."""
    sb = t.stride(0) if t.ndim == 3 else 0
    sr, sc = t.stride(-2), t.stride(-1)
    return (sb, sc, sr) if transpose else (sb, sr, sc)


def _launch(kernel, tri, rhs, out, *, transpose: bool, n: int, m: int,
            unit: bool, batch: int) -> None:
    lib = build.library("trsm", _SIGNATURES)
    with torch.cuda.device(tri.device):
        code = getattr(lib, f"trsm_{_SUFFIX[tri.dtype]}")(
            tri.data_ptr(), *_strides(tri, transpose),
            rhs.data_ptr(), *_strides(rhs, transpose),
            out.data_ptr(), *_strides(out, transpose),
            batch, n, m, int(unit), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, kernel, code)


def trsm_lower_cuda(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = L⁻¹B for L (…, n, n) unit lower — only its strict lower
    triangle is read — and B (…, n, m), at any strides."""
    batch = _check("trsm_lower", l, b)
    n, m = b.shape[-2], b.shape[-1]
    if n != l.shape[-1]:
        raise ValueError(f"trsm_lower: L {tuple(l.shape)} vs B {tuple(b.shape)}")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if batch and n and m:
        _launch("trsm_lower", l, b, out, transpose=False, n=n, m=m,
                unit=True, batch=batch)
    return out


def trsm_upper_right_cuda(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Z = B·U⁻¹ for U (…, n, n) upper with a non-unit diagonal — only
    its upper triangle is read — and B (…, m, n), at any strides."""
    batch = _check("trsm_upper_right", u, b)
    m, n = b.shape[-2], b.shape[-1]
    if n != u.shape[-1]:
        raise ValueError(f"trsm_upper_right: U {tuple(u.shape)} vs B {tuple(b.shape)}")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if batch and n and m:
        _launch("trsm_upper_right", u, b, out, transpose=True, n=n, m=m,
                unit=False, batch=batch)
    return out
