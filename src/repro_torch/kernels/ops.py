"""Dispatch between the hand-written kernels and their plain versions.

A tensor on a CUDA device goes to the kernel — or the call raises; there
is no fallback. A tensor on the CPU goes to the plain PyTorch version in
ref.py. Any other device raises.

`LAUNCHES[name]` counts the kernel launches each wrapper made (plain
versions never count), so a run can show that its path went through the
kernels; `reset_launches()` zeroes every count. A mixed route counts
under its kernel's name. `trsm_left` also counts each launch under its
leg in `TRSM_LEFT_LEGS` (the four solves of a trisolve chunk).

`acc_dtype` (lu_panel, trsm_lower, trsm_upper_right, schur_update) selects
the reference's mixed variant, on both devices: narrow storage, wide
arithmetic, one rounding on store. None, or the storage dtype itself,
is the default route. The pairs ported are those of routes.ROUTES:
float32 storage with float64 arithmetic and bfloat16/float16 storage
with float32 arithmetic (for schur_update the latter is its default
route); any other pair raises TypeError.
"""
from __future__ import annotations

import torch

from . import ref
from .ced import ced_cuda
from .flash_attn import check_operands, flash_attention_cuda
from .lu_panel import lu_panel_cuda
from .routes import accumulator
from .schur import schur_update_cuda
from .trsm import trsm_left_cuda, trsm_lower_cuda, trsm_upper_right_cuda

LAUNCHES: dict[str, int] = {
    "ced": 0, "lu_panel": 0, "trsm_lower": 0, "trsm_upper_right": 0,
    "trsm_left": 0, "schur_update": 0, "flash_attention": 0,
}
#: trsm_left's launches by leg: "l" solves L a = b, "u" U y = a, "ut"
#: Uᵀ a = b and "lt" Lᵀ y = a (T's stored triangle, then "t" where the
#: solve is through its transpose)
TRSM_LEFT_LEGS: dict[str, int] = {"l": 0, "u": 0, "ut": 0, "lt": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, TRSM_LEFT_LEGS):
        for name in counts:
            counts[name] = 0



def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix or on
    any other device."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"operands on {device} and {t.device}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel and no plain path for device {device}")
    return device.type == "cuda"


def ced(m: torch.Tensor, v: torch.Tensor, k: int, *, mode: str = "ewd",
        growth_safe: bool = False) -> torch.Tensor:
    """Fused CED cipher: rot90_cw^k(EWO(m, v)); growth_safe composes odd
    rotations with the exchange flip (DESIGN.md §6.1). v is cast to m's
    dtype first, as the reference's EWO does."""
    v = v.to(m.dtype)
    if _on_cuda(m, v):
        out = ced_cuda(m, v, k, mode=mode, growth_safe=growth_safe)
        LAUNCHES["ced"] += 1
        return out
    return ref.ced_ref(m, v, k, mode=mode, growth_safe=growth_safe)


def lu_panel(a: torch.Tensor, *, acc_dtype=None) -> torch.Tensor:
    """Compact no-pivot LU of a (..., b, b) tile: strict-lower
    multipliers plus U, eliminated in acc_dtype where given. Leaves `a`
    untouched."""
    acc = accumulator("lu_panel", a.dtype, acc_dtype)
    if _on_cuda(a):
        out = lu_panel_cuda(a, acc)
        LAUNCHES["lu_panel"] += 1
        return out
    return ref.lu_panel_ref(a, acc)


def trsm_lower(l: torch.Tensor, b: torch.Tensor, *,
               acc_dtype=None) -> torch.Tensor:
    """X = L⁻¹B, L unit lower; only l's strict lower triangle is read.
    Solved in acc_dtype where given."""
    acc = accumulator("trsm_lower", b.dtype, acc_dtype)
    if _on_cuda(l, b):
        out = trsm_lower_cuda(l, b, acc)
        LAUNCHES["trsm_lower"] += 1
        return out
    return ref.trsm_lower_ref(l, b, acc)


def trsm_upper_right(u: torch.Tensor, b: torch.Tensor, *,
                     acc_dtype=None) -> torch.Tensor:
    """Z = B·U⁻¹, U upper with a non-unit diagonal; only u's upper
    triangle is read. Solved in acc_dtype where given."""
    acc = accumulator("trsm_upper_right", b.dtype, acc_dtype)
    if _on_cuda(u, b):
        out = trsm_upper_right_cuda(u, b, acc)
        LAUNCHES["trsm_upper_right"] += 1
        return out
    return ref.trsm_upper_right_ref(u, b, acc)


def trsm_left(t: torch.Tensor, b: torch.Tensor, *, upper: bool,
              transpose_t: bool = False) -> torch.Tensor:
    """X = op(T)⁻¹B, op(T) = Tᵀ where transpose_t, else T; only T's
    upper (upper=True) or lower triangle is read, its stored diagonal
    included. float64 or float32 (routes.ROUTES)."""
    if _on_cuda(t, b):
        out = trsm_left_cuda(t, b, upper=upper, transpose_t=transpose_t)
        LAUNCHES["trsm_left"] += 1
        TRSM_LEFT_LEGS[("u" if upper else "l") + ("t" if transpose_t else "")] += 1
        return out
    return ref.trsm_left_ref(t, b, upper=upper, transpose_t=transpose_t)


def schur_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                 acc_dtype=None) -> torch.Tensor:
    """C − A·B into a fresh tensor; (…, M, K)·(…, K, N), batch-aware.
    float64/float32 accumulate in their own type, bfloat16/float16 in
    float32, float32 in float64 with acc_dtype=torch.float64."""
    acc = accumulator("schur_update", c.dtype, acc_dtype)
    if _on_cuda(c, a, b):
        out = schur_update_cuda(c, a, b, acc)
        LAUNCHES["schur_update"] += 1
        return out
    return ref.schur_update_ref(c, a, b, acc)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Blockwise online-softmax attention (GQA-aware): q (B, Hq, Sq, D),
    k and v (B, Hkv, Sk, D) at any (batch, head, seq) strides; query rows
    right-aligned to the keys; scale defaults to D^-½."""
    if _on_cuda(q, k, v):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   scale=scale)
        LAUNCHES["flash_attention"] += 1
        return out
    check_operands(q, k, v, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
