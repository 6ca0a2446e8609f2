"""The flash-attention kernel's forward under autograd.

The reference trains through its jnp attention (`_blockwise`, `_sdpa`,
`_local` in src/repro/models/attention.py) and has no backward kernel for
its Pallas flash kernel; so the port owes none either. On CUDA tensors,
though, the port's attention IS the kernel (csrc/flash_attn.cu, a ctypes
call whose output carries no `grad_fn`), so training needs it under
autograd: `FlashAttention.apply` launches the kernel in its forward and,
in its backward, returns the gradient of the plain version
(`ref.flash_attention_ref`), recomputed from the saved q, k and v. That
is the gradient of what the reference's training differentiates (its
`_sdpa`; above `attn_block` keys see ROADMAP §C, "P's dtype").

The backward materialises the (B, Hq, Sq, Sk) f32 scores and their
softmax: about 2.1 GB at tinyllama's batch 4 × 2048 keys and 32 heads,
and a few times that transiently while autograd runs through them.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from . import ref
from .flash_attn import flash_attention_cuda

#: the profiler range around the plain backward, which a trace reads to
#: split a training step's device time
BACKWARD_RANGE = "flash_attention.plain_backward"


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, grad_out: torch.Tensor,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ⟨grad_out, flash_attention_ref(q, k, v)⟩: autograd
    through the plain version, recomputed here. Any strides, GQA, window,
    non-causal and any scale, on either device."""
    with record_function(BACKWARD_RANGE), torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                      scale=scale)
        return torch.autograd.grad(out, leaves, grad_out)


class FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: `flash_attention_backward` on
    the saved operands. No gradient for causal, window or scale."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, grad_out, *ctx.mask)
        return dq, dk, dv, None, None, None
