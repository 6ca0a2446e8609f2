"""Wrapper of the panel LU kernel (csrc/lu_panel.cu).

Port of src/repro/kernels/lu_panel.py:lu_panel_compact: no-pivot
Doolittle of one (b, b) tile or a (B, b, b) stack, compact output. Two
kernels, chosen by `route`: one warp a tile up to WARP_MAX wide, one
thread block a tile up to `max_tile`. `acc_dtype` selects the mixed
variant (the reference's acc_dtype): float32 tiles eliminated in float64,
bfloat16 and float16 tiles in float32, stored at their own type.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, routes

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    f"lu_panel_{kind}{suffix}": (
        _INT, (_PTR, _LL, _LL, _LL, _PTR, _INT, _INT, _PTR))
    for kind in ("", "warp_")
    for suffix in set(routes.ROUTES["lu_panel"].values())
}
#: shared memory one thread block may hold on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
_MAX_GRID_X = 2**31 - 1
#: widest tile the warp kernel takes: one row a lane
WARP_MAX = 32


def max_tile(dtype: torch.dtype) -> int:
    """Largest b whose b x b tile held at `dtype`, the type the kernel
    computes in, fits in one block's shared memory (170 for float64)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    b = int((MAX_SMEM_BYTES // itemsize) ** 0.5)
    while b * b * itemsize > MAX_SMEM_BYTES:
        b -= 1
    return b


def route(b: int, dtype: torch.dtype) -> str:
    """The kernel for a b x b tile computed in `dtype` (the accumulator
    of a mixed route, else the storage type): "warp" (one warp a tile)
    up to WARP_MAX, "block" (one thread block a tile) up to max_tile;
    raises above it. A tile's route, and with it its arithmetic, never
    depends on the batch."""
    if b > max_tile(dtype):
        raise ValueError(
            f"a {b}x{b} tile computed in {dtype} exceeds one block's shared "
            f"memory (largest {max_tile(dtype)}); factor it blocked"
        )
    return "warp" if b <= WARP_MAX else "block"


def lu_panel_cuda(a: torch.Tensor, acc_dtype: torch.dtype | None = None
                  ) -> torch.Tensor:
    """Launch the panel kernel on a (b, b) or (B, b, b) CUDA tensor at any
    strides; returns the contiguous compact factor at a's dtype, computed
    in `acc_dtype` where given (a mixed route of routes.ROUTES). A tile that
    does not fit in shared memory at the arithmetic type raises."""
    if a.device.type != "cuda":
        raise ValueError(f"lu_panel_cuda needs a CUDA tensor, got {a.device}")
    suffix = routes.suffix("lu_panel", a.dtype, acc_dtype)
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"lu_panel_cuda needs (b, b) or (B, b, b), got {tuple(a.shape)}")
    b = a.shape[-1]
    kind = route(b, acc_dtype or a.dtype)
    batch = a.shape[0] if a.ndim == 3 else 1
    if batch > _MAX_GRID_X:
        raise ValueError(f"batch {batch} exceeds the grid")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if batch == 0 or b == 0:
        return out
    sb = a.stride(0) if a.ndim == 3 else 0
    lib = build.library("lu_panel", _SIGNATURES)
    with torch.cuda.device(a.device):
        prefix = "lu_panel_warp_" if kind == "warp" else "lu_panel_"
        code = getattr(lib, prefix + suffix)(
            a.data_ptr(), sb, a.stride(-2), a.stride(-1), out.data_ptr(),
            batch, b, torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, "lu_panel", code)
    return out
