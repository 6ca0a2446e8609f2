"""Wrapper of the Schur-complement kernel (csrc/schur.cu).

Port of src/repro/kernels/gemm.py:schur_update: C − A·B for (M, K)·(K, N)
operands or a (B, M, K)·(B, K, N) stack, at any strides, into a fresh
output. float64 runs on the tensor cores (DMMA) and accumulates in
float64; float32 accumulates in its own type, bfloat16 and float16 in
float32, on the FMA pipes. `acc_dtype=torch.float64` on float32,
bfloat16 or float16 operands selects the mixed variant (the reference's
acc_dtype): the DMMA kernel on tiles of the storage type, widened as
they are read, summed in float64 and rounded to the storage type once.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, routes

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    f"schur_{suffix}": (
        _INT,
        (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
         _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _PTR),
    )
    for suffix in set(routes.ROUTES["schur_update"].values())
}
#: the card's limit on the grid's y axis (row tiles) and z axis (batch)
_MAX_GRID_YZ = 65535


def rows_per_block(dtype: torch.dtype,
                   acc_dtype: torch.dtype | None = None) -> int:
    """Rows of OUT one block computes: csrc/schur.cu's DM for the DMMA
    kernel (float64, and the mixed routes to float64), BM for the
    FMA kernel of the other types."""
    return 128 if torch.float64 in (dtype, acc_dtype) else 64


def check_grid(dtype: torch.dtype, batch: int, m: int,
               acc_dtype: torch.dtype | None = None) -> None:
    """Raise where the launch grid (row tiles on y, the batch on z) would
    exceed what the card accepts; its x axis (column tiles) cannot."""
    rows = rows_per_block(dtype, acc_dtype)
    if -(-m // rows) > _MAX_GRID_YZ or batch > _MAX_GRID_YZ:
        raise ValueError(
            f"schur_update: batch {batch}, M {m} exceed the launch grid")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, row, column) element strides; batch 0 for a 2-D operand."""
    return (t.stride(0) if t.ndim == 3 else 0, t.stride(-2), t.stride(-1))


def schur_update_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C − A·B on CUDA tensors: c (…, M, N), a (…, M, K), b (…, K, N),
    all 2-D or all 3-D with one batch size, one dtype, summed in
    `acc_dtype` where given (a mixed route of routes.ROUTES). Returns a new
    contiguous tensor; the operands are left as they are."""
    for t in (c, a, b):
        if t.device.type != "cuda" or t.device != c.device:
            raise ValueError(
                f"schur_update needs CUDA operands on one device, got "
                f"{c.device}/{a.device}/{b.device}")
    if a.dtype != c.dtype or b.dtype != c.dtype:
        raise TypeError(
            "schur_update takes operands of one dtype, got "
            f"{c.dtype}/{a.dtype}/{b.dtype}")
    suffix = routes.suffix("schur_update", c.dtype, acc_dtype)
    if c.ndim not in (2, 3) or a.ndim != c.ndim or b.ndim != c.ndim:
        raise ValueError("schur_update needs three 2-D or three 3-D operands")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k or tuple(c.shape[-2:]) != (m, n):
        raise ValueError(
            f"schur_update: C {tuple(c.shape)}, A {tuple(a.shape)}, "
            f"B {tuple(b.shape)} do not chain")
    batch = c.shape[0] if c.ndim == 3 else 1
    if c.ndim == 3 and not a.shape[0] == b.shape[0] == batch:
        raise ValueError(
            f"schur_update: batches {batch}, {a.shape[0]}, {b.shape[0]}")
    check_grid(c.dtype, batch, m, acc_dtype)
    out = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    if batch == 0 or m == 0 or n == 0:
        return out
    lib = build.library("schur", _SIGNATURES)
    with torch.cuda.device(c.device):
        code = getattr(lib, f"schur_{suffix}")(
            c.data_ptr(), *_strides(c), a.data_ptr(), *_strides(a),
            b.data_ptr(), *_strides(b), out.data_ptr(), *_strides(out),
            batch, m, n, k, torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, "schur_update", code)
    return out
