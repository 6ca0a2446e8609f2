"""Wrappers of the triangular-solve kernels (csrc/trsm.cu).

Ports of src/repro/kernels/trsm.py:trsm_lower and :trsm_upper_right, and
the left solves of the secure linalg rounds (`trsm_left_cuda`). One CUDA
solver, a lower-triangular T X = B, handles them all: Z = B·U⁻¹ is handed
over as Uᵀ Zᵀ = Bᵀ by swapping strides, and an upper-triangular left
solve U X = B as (J U J)(J X) = J B, J the row reversal: J U J is lower,
so U goes over with a pointer to its last element and both strides
negated, B and X with pointers to their last rows and negated row
strides. Every operand goes with its strides, so strided and reversed
views need no copy. One wrapper call puts `cuda_launches(n)` kernels on
the stream: a 64-row leaf solve per leaf and a trailing update between
consecutive leaves. `acc_dtype` (trsm_lower_cuda, trsm_upper_right_cuda)
selects the mixed variant (the reference's acc_dtype, routes.ROUTES):
the solve runs in the wider type, its intermediate rows kept in a
workspace of that type, and the result is stored at B's type. Without
it, bfloat16 and float16 solve in their own type, every operation
rounded to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, routes

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    f"trsm_{suffix}": (
        _INT,
        (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
         _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _PTR),
    )
    for suffix in set(routes.ROUTES["trsm_lower"].values())
}
_MAX_GRID_Z = 65535
#: rows of one leaf of csrc/trsm.cu's blocked solve
LEAF = 64


def cuda_launches(n: int) -> int:
    """CUDA launches of one wrapper call on an n-row triangle: a leaf
    solve per LEAF rows and an update between each two."""
    return 2 * -(-n // LEAF) - 1 if n > 0 else 0


def _check(kernel: str, tri: torch.Tensor, rhs: torch.Tensor,
           acc_dtype: torch.dtype | None) -> int:
    """Validate a (…, n, n) triangle against its right-hand side and the
    route; returns the batch size."""
    if tri.device.type != "cuda" or rhs.device != tri.device:
        raise ValueError(f"{kernel} needs CUDA operands, got {tri.device}/{rhs.device}")
    if rhs.dtype != tri.dtype:
        raise TypeError(f"{kernel}: operands of one dtype, got {tri.dtype}/{rhs.dtype}")
    routes.suffix(kernel, tri.dtype, acc_dtype)
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


def _operand(t: torch.Tensor, transpose: bool = False, flip_rows: bool = False,
             flip_cols: bool = False) -> tuple[int, int, int, int]:
    """(address, batch, row, column element strides) of t as the solver
    reads it: rows and columns swapped for a transposed view; a flipped
    axis starts at its last index and runs at the negated stride."""
    sb = t.stride(0) if t.ndim == 3 else 0
    sr, sc = t.stride(-2), t.stride(-1)
    rows, cols = t.shape[-2], t.shape[-1]
    if transpose:
        sr, sc, rows, cols = sc, sr, cols, rows
    offset = 0
    if flip_rows:
        offset, sr = offset + (rows - 1) * sr, -sr
    if flip_cols:
        offset, sc = offset + (cols - 1) * sc, -sc
    return t.data_ptr() + offset * t.element_size(), sb, sr, sc


def _launch(kernel, tri, rhs, out, *, transpose: bool, n: int, m: int,
            unit: bool, batch: int, acc_dtype, transpose_tri: bool | None = None,
            reverse: bool = False) -> None:
    """Solve on the stream: `transpose` swaps rows and columns of every
    operand (the right solve), `transpose_tri` of the triangle alone
    (default: `transpose`), and `reverse` hands the problem over as
    J T J, J B, J X (an upper left solve)."""
    suffix = routes.suffix(kernel, tri.dtype, acc_dtype)
    t_op = _operand(tri, transpose if transpose_tri is None else transpose_tri,
                    reverse, reverse)
    b_op = _operand(rhs, transpose, reverse)
    x_op = _operand(out, transpose, reverse)
    if acc_dtype is None:
        w_op = x_op
    else:
        # the solver's n x m orientation, contiguous
        work = torch.empty((batch, n, m), dtype=acc_dtype, device=out.device)
        w_op = (work.data_ptr(), n * m, m, 1)
    lib = build.library("trsm", _SIGNATURES)
    with torch.cuda.device(tri.device):
        code = getattr(lib, f"trsm_{suffix}")(
            *t_op, *b_op, *x_op, *w_op,
            batch, n, m, int(unit), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, kernel, code)


def _left(kernel: str, t: torch.Tensor, b: torch.Tensor, *, upper: bool,
          unit: bool, transpose_t: bool, acc_dtype) -> torch.Tensor:
    """The left solve X = op(T)⁻¹B of trsm_lower_cuda and trsm_left_cuda:
    an op(T) that is upper triangular goes to the lower solver reversed
    (module docstring)."""
    batch = _check(kernel, t, b, acc_dtype)
    n, m = b.shape[-2], b.shape[-1]
    if n != t.shape[-1]:
        raise ValueError(f"{kernel}: T {tuple(t.shape)} vs B {tuple(b.shape)}")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if batch and n and m:
        _launch(kernel, t, b, out, transpose=False, n=n, m=m,
                unit=unit, batch=batch, acc_dtype=acc_dtype,
                transpose_tri=transpose_t, reverse=upper != transpose_t)
    return out


def trsm_lower_cuda(l: torch.Tensor, b: torch.Tensor,
                    acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """X = L⁻¹B for L (…, n, n) unit lower — only its strict lower
    triangle is read — and B (…, n, m), at any strides; solved in
    `acc_dtype` where given, stored at B's dtype."""
    return _left("trsm_lower", l, b, upper=False, unit=True,
                 transpose_t=False, acc_dtype=acc_dtype)


def trsm_upper_right_cuda(u: torch.Tensor, b: torch.Tensor,
                          acc_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """Z = B·U⁻¹ for U (…, n, n) upper with a non-unit diagonal — only
    its upper triangle is read — and B (…, m, n), at any strides; solved
    in `acc_dtype` where given, stored at B's dtype."""
    batch = _check("trsm_upper_right", u, b, acc_dtype)
    m, n = b.shape[-2], b.shape[-1]
    if n != u.shape[-1]:
        raise ValueError(f"trsm_upper_right: U {tuple(u.shape)} vs B {tuple(b.shape)}")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    if batch and n and m:
        _launch("trsm_upper_right", u, b, out, transpose=True, n=n, m=m,
                unit=False, batch=batch, acc_dtype=acc_dtype)
    return out


def trsm_left_cuda(t: torch.Tensor, b: torch.Tensor, *, upper: bool,
                   transpose_t: bool = False) -> torch.Tensor:
    """X = op(T)⁻¹B, op(T) = Tᵀ where `transpose_t`, else T, for T
    (…, n, n) with its triangle in the upper (`upper`) or lower half —
    only that triangle is read, its stored diagonal included — and B
    (…, n, m), at any strides; float64 or float32."""
    return _left("trsm_left", t, b, upper=upper, unit=False,
                 transpose_t=transpose_t, acc_dtype=None)
