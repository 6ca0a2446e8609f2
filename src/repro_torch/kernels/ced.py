"""Wrapper of the CED cipher kernel (csrc/ced.cu).

Port of src/repro/kernels/ced.py:ced. Computes rot90_cw^k(EWO(m, v)) —
or the transpose, for the growth-safe relayout with an odd k — for an
(n, n) matrix or a (B, n, n) stack sharing one k, in one pass.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    f"ced_{suffix}": (_INT, (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR))
    for suffix in ("f32", "f64")
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: relayout code of the transpose (codes 0..3 are quarter-turns)
_TRANSPOSE = 4
_MAX_GRID_Z = 65535


def ced_cuda(m: torch.Tensor, v: torch.Tensor, k: int, *, mode: str = "ewd",
             growth_safe: bool = False) -> torch.Tensor:
    """Launch the CED kernel: m is a contiguous (n, n) or (B, n, n) CUDA
    tensor, v the contiguous (n,) or (B, n) blinding rows in m's dtype.
    Raises on anything else."""
    if m.device.type != "cuda" or v.device != m.device:
        raise ValueError(f"ced_cuda needs CUDA operands, got {m.device}/{v.device}")
    if m.dtype not in _SUFFIX or v.dtype != m.dtype:
        raise TypeError(f"ced_cuda takes float32/float64, got {m.dtype}/{v.dtype}")
    if m.ndim not in (2, 3) or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"ced_cuda needs (n, n) or (B, n, n), got {tuple(m.shape)}")
    if tuple(v.shape) != tuple(m.shape[:-1]):
        raise ValueError(f"blinding rows {tuple(v.shape)} do not match {tuple(m.shape)}")
    if not (m.is_contiguous() and v.is_contiguous()):
        raise ValueError("ced_cuda needs contiguous operands")
    if mode not in ("ewd", "ewm"):
        raise ValueError(f"unknown EWO mode: {mode!r}")
    batch = m.shape[0] if m.ndim == 3 else 1
    if batch > _MAX_GRID_Z:
        raise ValueError(f"batch {batch} exceeds the grid's {_MAX_GRID_Z}")
    n = m.shape[-1]
    out = torch.empty_like(m)
    if batch == 0 or n == 0:
        return out
    rel = _TRANSPOSE if growth_safe and k % 2 == 1 else k % 4
    lib = build.library("ced", _SIGNATURES)
    with torch.cuda.device(m.device):
        code = getattr(lib, f"ced_{_SUFFIX[m.dtype]}")(
            m.data_ptr(), v.data_ptr(), out.data_ptr(), batch, n, rel,
            int(mode == "ewm"), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, "ced", code)
    return out
