"""Wrapper of B6's gradient kernels (csrc/flash_bwd.cu).

The port's own gradient of the flash kernel: the reference's Pallas
kernel has no backward (it trains through its jnp attention), so this
replaces no TPU kernel. Given the forward's output O and each row's
base-2 log-sum-exp (flash_attn.flash_attention_lse_cuda), it
returns (dq, dk, dv) of ⟨dO, O⟩ in three launches: Δ = Σ_d dO·O a row
(`flash_bwd_delta_kernel`), dK and dV by blocks of keys that walk every
query head of their kv head's group (`flash_bwd_dkdv_kernel`), and dQ by
blocks of query rows (`flash_bwd_dq_kernel`); f32 runs the same walks on
the FMA pipes (`*_fma_kernel`). ref.flash_attention_backward_ref is the
same arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .flash_attn import (_SUFFIX, _WIDE_WINDOW, _aligned, _check_cuda,
                         empty_rows_like, head_tile)

_PTR, _INT, _LL, _FLT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_SIGNATURES = {
    f"flash_bwd_{suffix}": (
        _INT, (*(_PTR, _LL, _LL, _LL) * 8, _PTR, _PTR,
               _INT, _INT, _INT, _INT, _INT, _INT, _FLT,
               _INT, _INT, _INT, _INT, _PTR))
    for suffix in _SUFFIX.values()
}
#: CUDA launches a call: Δ, then dK and dV, then dQ
CUDA_LAUNCHES = 3
#: the kernels' tiles by route ("half": bf16 and f16, "f32") and padded
#: head dimension DT: (keys a dK/dV block owns, query rows of each tile it
#: walks) and (query rows a dQ block owns, keys of each tile it walks);
#: csrc/flash_bwd.cu's DkdvTile and DqTile, FmaDkdv and FmaDq
DKDV_TILES = {"half": {64: (64, 64), 128: (64, 64), 256: (32, 64)},
              "f32": {64: (64, 32), 128: (64, 32), 256: (32, 32)}}
DQ_TILES = {"half": {64: (64, 64), 128: (64, 64), 256: (32, 64)},
            "f32": {64: (64, 32), 128: (64, 32), 256: (32, 32)}}


def device_kernels(q: torch.Tensor) -> tuple[str, ...]:
    """The device kernels a call on q runs, as the profiler names them."""
    dt = head_tile(q.shape[3])
    if q.dtype == torch.float32:
        return ("flash_bwd_delta_kernel<float>",
                f"flash_bwd_dkdv_fma_kernel<{dt}>",
                f"flash_bwd_dq_fma_kernel<{dt}>")
    ctype = "__nv_bfloat16" if q.dtype == torch.bfloat16 else "__half"
    return (f"flash_bwd_delta_kernel<{ctype}>",
            f"flash_bwd_dkdv_kernel<{ctype}, {dt}>",
            f"flash_bwd_dq_kernel<{ctype}, {dt}>")


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, grad_out: torch.Tensor, *,
                                  causal: bool = True,
                                  window: int | None = None,
                                  scale: float | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(dq, dk, dv) of ⟨grad_out, O⟩ for O = flash_attention_cuda(q, k, v)
    on CUDA tensors: o that output and lse its (B, Hq, Sq) f32 base-2
    log-sum-exp. Each operand at its own (batch, head, seq) strides with a
    unit stride along D; grad_out at any strides (made contiguous once
    where its D stride is not 1, as an expanded gradient's is). The
    gradients come in the operands' dtypes and layouts."""
    _check_cuda(q, k, v, window)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("grad_out", grad_out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash backward: {name} {tuple(t.shape)} "
                             f"{t.dtype} does not match q {tuple(q.shape)} "
                             f"{q.dtype}")
    if o.stride(3) != 1:
        raise ValueError(f"flash backward: o needs a unit stride along D, "
                         f"got {o.stride()}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash backward: lse must be a contiguous ({b}, "
                         f"{hq}, {sq}) f32 tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if grad_out.stride(3) != 1:
        grad_out = grad_out.contiguous()
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    dq, dk, dv = (empty_rows_like(t) for t in (q, k, v))
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = build.library("flash_bwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, f"flash_bwd_{_SUFFIX[q.dtype]}")(
            *(x for t in (q, k, v, o, grad_out, dq, dk, dv)
              for x in (t.data_ptr(), *t.stride()[:3])),
            lse.data_ptr(), delta.data_ptr(), b, hq, hkv, sq, sk, d,
            float(scale), int(bool(causal)), int(window is not None),
            min(int(window or 0), _WIDE_WINDOW),
            int(_aligned(q, k, v, grad_out)),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, "flash_attention backward", code)
    return dq, dk, dv
