"""Dispatch between the hand-written kernels and their plain versions.

A tensor on a CUDA device goes to the kernel — or the call raises; there
is no fallback. A tensor on the CPU goes to the plain PyTorch version in
ref.py. Any other device raises.

`LAUNCHES[name]` counts the kernel launches each wrapper made (plain
versions never count), so a run can show that its path went through the
kernels; `reset_launches()` zeroes every count. `flash_attention` counts
one a call (a split decode's two CUDA launches included), and
`flash_attention_backward` one a backward of a call made under autograd
(its three CUDA launches: Δ, dK and dV, dQ);
`flash_decode_partial` and `flash_combine`, the split decode's halves
for keys spread over ranks, count their own. A mixed route counts
under its kernel's name. `trsm_left` also counts each launch under its
leg in `TRSM_LEFT_LEGS` (the four solves of a trisolve chunk).

`acc_dtype` (lu_panel, trsm_lower, trsm_upper_right, schur_update) selects
the reference's mixed variant, on both devices: narrow storage, wide
arithmetic, one rounding on store. None, or the storage dtype itself,
is the default route: for bfloat16 and float16 the panel and the solves
then compute in the half type itself, the Schur update in float32. The
pairs are those of routes.ROUTES: float32 storage with float64
arithmetic and bfloat16/float16 storage with float32 or float64
arithmetic (for schur_update bf16/f16 -> f32 is its default route); any
other pair raises TypeError.
"""
from __future__ import annotations

import torch

from . import ref
from .ced import ced_cuda
from .flash_attn import (check_operands, check_partials, flash_attention_cuda,
                         flash_combine_cuda, flash_decode_partial_cuda,
                         partial_chunks)
from .flash_grad import FlashAttention
from .lu_panel import lu_panel_cuda
from .routes import accumulator
from .schur import schur_update_cuda
from .trsm import trsm_left_cuda, trsm_lower_cuda, trsm_upper_right_cuda

LAUNCHES: dict[str, int] = {
    "ced": 0, "lu_panel": 0, "trsm_lower": 0, "trsm_upper_right": 0,
    "trsm_left": 0, "schur_update": 0, "flash_attention": 0,
    "flash_attention_backward": 0, "flash_decode_partial": 0,
    "flash_combine": 0,
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
    float32, and float32, bfloat16 and float16 in float64 with
    acc_dtype=torch.float64."""
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
    right-aligned to the keys; scale defaults to D^-½.

    On CUDA, where grad is enabled and an operand requires it, the
    kernel runs under autograd (flash_grad.FlashAttention: the forward
    kernel, writing each row's log-sum-exp, and in the backward the
    gradient kernels of csrc/flash_bwd.cu, counted apart as
    "flash_attention_backward"); otherwise, as in serving under no_grad,
    the kernel is called directly. Either way the forward counts one
    launch. On the CPU the plain version runs, under autograd as any
    tensor code does."""
    if _on_cuda(q, k, v):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            out = FlashAttention.apply(q, k, v, causal, window, scale)
        else:
            out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       scale=scale)
        LAUNCHES["flash_attention"] += 1
        return out
    check_operands(q, k, v, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float | None = None,
                         chunks: int | None = None) -> torch.Tensor:
    """The split decode's first half over one range of keys: q (B, Hq, 1,
    D), one query row, which sees every key of k and v (B, Hkv, Sk, D),
    Sk >= 0. Returns (chunks, B, Hq, 1, D + 2) f32 partials: each chunk's
    unnormalised accumulator, m (base 2) and l, in
    flash_attn.decode_split's chunks, `chunks` at least enough for the
    keys (the rest empty: acc = l = 0, m = −1e30). A range with no key
    launches nothing."""
    chunks = partial_chunks(q, k, chunks)
    if _on_cuda(q, k, v):
        out = flash_decode_partial_cuda(q, k, v, scale=scale, chunks=chunks)
        if k.shape[2] and q.shape[0]:
            LAUNCHES["flash_decode_partial"] += 1
        return out
    check_operands(q, k, v, None, keys_may_be_empty=True)
    return ref.flash_decode_partial_ref(q, k, v, scale=scale, chunks=chunks)


def flash_combine(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The split decode's second half: (chunks, B, Hq, Sq, D + 2) f32
    partials (flash_decode_partial's, or several ranges' laid end to end
    along chunks) merged in chunk order into a (B, Hq, Sq, D) tensor of
    `dtype`."""
    if _on_cuda(part):
        out = flash_combine_cuda(part, dtype)
        if out.numel():
            LAUNCHES["flash_combine"] += 1
        return out
    check_partials(part, dtype)
    return ref.flash_combine_ref(part, dtype)
