"""The flash-attention kernel under autograd, with its gradient as kernels.

The reference trains through its jnp attention (`_blockwise`, `_sdpa`,
`_local` in src/repro/models/attention.py) and its Pallas flash kernel
has no backward. On CUDA tensors the port's attention IS the kernel
(csrc/flash_attn.cu, a ctypes call whose output carries no `grad_fn`),
so `FlashAttention.apply` runs it under autograd: the forward launches
it with each row's base-2 log-sum-exp written beside the output
(flash_attn.flash_attention_lse_cuda; the prefill kernels at any Sq),
and the backward launches the gradient kernels (csrc/flash_bwd.cu,
flash_bwd.flash_attention_backward_cuda: Δ, then dK and dV, then dQ)
on the saved q, k, v, O and lse. Nothing of it falls back to a plain
version on the card; a kernel that does not build or launch raises.

`flash_attention_backward` is the oracle: autograd through the plain
forward (ref.flash_attention_ref), which materialises the (B, Hq, Sq, Sk)
f32 scores. The tests and chip_smoke.py hold the kernels' gradient, and
its plain version ref.flash_attention_backward_ref, against it.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from . import ref
from .flash_attn import flash_attention_lse_cuda
from .flash_bwd import flash_attention_backward_cuda

#: the profiler range around the backward kernels' call, which a trace
#: reads to split a training step's device time
BACKWARD_RANGE = "flash_attention.backward"
#: the range around the oracle (autograd through the plain version); no
#: training step on the card runs it
PLAIN_BACKWARD_RANGE = "flash_attention.plain_backward"


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, grad_out: torch.Tensor,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ⟨grad_out, flash_attention_ref(q, k, v)⟩: autograd
    through the plain version, recomputed here. Any strides, GQA, window,
    non-causal and any scale, on either device."""
    with record_function(PLAIN_BACKWARD_RANGE), torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                      scale=scale)
        return torch.autograd.grad(out, leaves, grad_out)


class FlashAttention(torch.autograd.Function):
    """Forward: the CUDA kernel, writing lse. Backward: the gradient
    kernels on the saved q, k, v, output and lse, counted under
    ops.LAUNCHES["flash_attention_backward"]. No gradient for causal,
    window or scale."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_lse_cuda(q, k, v, causal=causal,
                                            window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from .ops import LAUNCHES

        causal, window, scale = ctx.mask
        with record_function(BACKWARD_RANGE):
            dq, dk, dv = flash_attention_backward_cuda(
                *ctx.saved_tensors, grad_out, causal=causal, window=window,
                scale=scale)
        LAUNCHES["flash_attention_backward"] += 1
        return dq, dk, dv, None, None, None
