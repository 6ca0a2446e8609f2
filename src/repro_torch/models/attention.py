"""Attention: GQA/MQA full attention, for prefill and for decode over the
KV cache.

Port of src/repro/models/attention.py for kind="full". The reference runs
this function in jnp (`_blockwise`/`_sdpa` for prefill, a two-block
softmax over the cache plus the new token for decode) and calls its
Pallas kernel the TPU-target twin of that path. Here the kernel is the
path: on CUDA tensors both phases run the flash kernel
(kernels/csrc/flash_attn.cu, through `ops.flash_attention`), on CPU
tensors its plain version. GQA is the kernel's head map, so K/V are never
repeated across the query heads.

Local attention ("sliding", "chunked") and its ring-buffer decode come
with the gemma3/llama4 slice, M-RoPE with qwen2-vl (ROADMAP A14); both
raise here.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import ops
from ..serve.kvcache import merge_cache_updates
from .common import Initializer, apply_rope


class Attention(nn.Module):
    """wq (d, h, dh), wk and wv (d, hk, dh), wo (h, dh, d)."""

    def __init__(self, ini: Initializer, cfg):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.wq = ini.normal((d, h, dh))
        self.wk = ini.normal((d, hk, dh))
        self.wv = ini.normal((d, hk, dh))
        self.wo = ini.normal((h, dh, d), std=std_o)


def init_attention(ini: Initializer, cfg) -> Attention:
    return Attention(ini, cfg)


def _mask(qpos, kpos, *, causal: bool, window: int | None, chunk: int | None):
    """qpos: (..., S) or (S,); kpos: (T,) — broadcast to (..., S, T). The
    position-based mask of the reference's jnp path; the flash kernel
    computes the same set from right-aligned row indices."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = k >= 0  # ring-buffer slots not yet written carry pos = -1
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    if chunk is not None:
        m = m & ((k // chunk) == (q // chunk))
    return m


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) · (d, H, D) → (B, S, H, D) as one matrix product."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


def attention(
    p: Attention,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    *,
    kind: str = "full",
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, d_model). Returns (out, cache).

    Prefill (cache None): causal attention over the S projected tokens.
    Decode (cache given, S == 1): the token's k, v and position are
    written into slot `step` of the cache IN PLACE (merge_cache_updates),
    then the kernel attends from q (B, 1, H, D) over the written prefix
    cache[:, :step + 1], a strided view with no copy. That is the
    reference's two-block softmax over the cache plus the new token; the
    caller's position must equal the step (the tokens already cached), as
    the reference's decode step requires.
    """
    if kind != "full":
        raise NotImplementedError(
            f"{kind} attention (local windows, ring-buffer decode) comes with "
            "the gemma3/llama4 slice (ROADMAP A14)")
    if cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE comes with the qwen2-vl slice (ROADMAP A14)")
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    scale = dh**-0.5

    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=cfg.causal,
                                  scale=scale)
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        written = merge_cache_updates(cache, k, v, positions[0, :1])
        out = ops.flash_attention(
            q.transpose(1, 2), cache["k"][:, :written].transpose(1, 2),
            cache["v"][:, :written].transpose(1, 2), causal=cfg.causal,
            scale=scale)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    y = out @ p.wo.reshape(h * dh, -1)
    return y, cache
