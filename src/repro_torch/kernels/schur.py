"""Wrapper of the Schur-complement kernel (csrc/schur.cu).

Port of src/repro/kernels/gemm.py:schur_update: C − A·B for (M, K)·(K, N)
operands or a (B, M, K)·(B, K, N) stack, at any strides, into a fresh
output. float64 runs on the f64 tensor cores (DMMA) and accumulates in
float64; bfloat16 and float16 on the 16-bit tensor cores (wgmma, the
operands loaded by TMA where their layout allows), accumulated in
float32 and rounded once; float32 in float32 on the FMA pipes (no TF32).
`acc_dtype=torch.float64` on float32, bfloat16 or float16 operands
selects the mixed variant (the reference's acc_dtype): the DMMA kernel
on tiles of the storage type, widened as they are read, summed in
float64 and rounded to the storage type once.
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
_SIGNATURES["schur_half_tma_operands"] = (
    _INT, (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _INT))
#: each route's device kernel (by entry-point suffix) as the profiler
#: names it, template arguments and all
KERNELS = {
    "f64": "schur_dmma_kernel<double>",
    "f32": "schur_fma_kernel<float>",
    "f32_f64": "schur_dmma_kernel<float>",
    "bf16": "schur_wgmma_kernel<__nv_bfloat16>",
    "f16": "schur_wgmma_kernel<__half>",
    "bf16_f64": "schur_dmma_kernel<__nv_bfloat16>",
    "f16_f64": "schur_dmma_kernel<__half>",
}
#: rows of OUT one block of each device kernel computes: csrc/schur.cu's
#: DM, FM and WM
TILE_ROWS = {"schur_dmma_kernel": 128, "schur_fma_kernel": 128,
             "schur_wgmma_kernel": 128}
#: the card's limit on the grid's y axis (row tiles) and z axis (batch)
_MAX_GRID_YZ = 65535


def device_kernel(dtype: torch.dtype,
                  acc_dtype: torch.dtype | None = None) -> str:
    """The device kernel (KERNELS) of a call's route."""
    return KERNELS[routes.suffix("schur_update", dtype, acc_dtype)]


def rows_per_block(dtype: torch.dtype,
                   acc_dtype: torch.dtype | None = None) -> int:
    """Rows of OUT one block of the route's device kernel computes."""
    return TILE_ROWS[device_kernel(dtype, acc_dtype).split("<")[0]]


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


def tma_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, bool]:
    """Whether a bfloat16/float16 call on these A and B loads each by TMA
    (a unit inner stride, a 16-byte aligned start, row and batch strides
    of whole 16-byte vectors) or has the block's threads copy it into the
    same tiles. Both give the same bits, so results cannot tell which
    ran; the card tests ask this of lu_blocked's operands. CUDA tensors
    of a 2-byte dtype, as schur_update_cuda takes them."""
    if a.device.type != "cuda" or a.element_size() != 2 or b.dtype != a.dtype:
        raise ValueError("tma_operands takes 2-byte CUDA operands of one dtype")
    m, k = a.shape[-2:]
    batch = a.shape[0] if a.ndim == 3 else 1
    lib = build.library("schur", _SIGNATURES)
    with torch.cuda.device(a.device):
        mask = lib.schur_half_tma_operands(
            a.data_ptr(), *_strides(a), b.data_ptr(), *_strides(b), batch, m,
            b.shape[-1], k)
    return bool(mask & 1), bool(mask & 2)
