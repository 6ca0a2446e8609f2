"""Attention: GQA/MQA, full or local (sliding-window, chunked), for
prefill and for decode over the (possibly ring-buffered) KV cache.

Port of src/repro/models/attention.py. The reference runs this function
in jnp (`_blockwise`/`_sdpa` and `_local` for prefill, a two-block softmax
over the cache plus the new token for decode) and calls its Pallas kernel
the TPU-target twin of that path. Here the kernel is the path: on CUDA
tensors every phase and kind runs the flash kernel
(kernels/csrc/flash_attn.cu, through `ops.flash_attention`), on CPU
tensors its plain version. GQA is the kernel's head map, so K/V are never
repeated across the query heads.

Local layers (1 < window < S in prefill, as the reference's rule):

  * sliding: the kernel's window route, keys (q − W, q];
  * chunked (llama4): a token sees its own W-token chunk up to itself.
    The kernel has no chunk mask, so the chunks are folded into the
    batch (S padded to a multiple of W, as `_local` pads it) and run
    causal: exact, because a chunk sees only itself.

Decode over a local layer's ring of L = W slots, token t in slot t % L:
a sliding layer's keys are the written prefix before the ring wraps and
all L slots after (each then holds one of the last W positions); a
chunked layer's are slots [0, t mod W], the tokens of t's chunk. Either
way the keys are a prefix of the cache, which the decode route reads as
it reads a full layer's. No query row is ever fully masked on these
paths (each sees itself), so the flash kernel's mean-of-V rows
(ROADMAP §C) cannot arise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..serve.kvcache import merge_cache_updates
from .common import Initializer, apply_mrope, apply_rope


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


def _local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
           window: int, scale: float) -> torch.Tensor:
    """Local prefill attention of (B, S, H, D) projections → (B, H, S, D).
    sliding: the kernel's window route; chunked: the W-token chunks
    folded into the batch and run causal."""
    if kind == "sliding":
        return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True,
                                   window=window, scale=scale)
    b, s = q.shape[:2]
    pad = (-s) % window
    nc = (s + pad) // window

    def fold(t):
        t = F.pad(t, (0, 0, 0, 0, 0, pad))  # (B, nc·W, H, D)
        return t.reshape(b * nc, window, *t.shape[2:]).transpose(1, 2)

    out = ops.flash_attention(fold(q), fold(k), fold(v), causal=True,
                              scale=scale)  # (B·nc, H, W, D)
    h, d = out.shape[1], out.shape[3]
    out = out.reshape(b, nc, h, window, d).transpose(1, 2)
    return out.reshape(b, h, nc * window, d)[:, :, :s]


def _decode_keys(kind: str, step: int, length: int, window: int | None) -> int:
    """How many leading cache slots a decode token at `step` attends:
    full layers the written prefix; sliding rings the prefix until they
    wrap, then every slot; chunked rings the slots of the token's own
    chunk, [0, step mod W]."""
    if kind == "chunked" and window:
        return step % window + 1
    return min(step + 1, length)


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

    kind: "full", "sliding" or "chunked" (cfg.window wide). positions:
    (B, S), or (B, S, 3) under M-RoPE.

    Prefill (cache None): causal (or, for an encoder, full) attention
    over the S projected tokens; local kinds as the module docstring
    says. Decode (cache given, S == 1): the token's k, v and position
    are written into its slot of the cache IN PLACE
    (merge_cache_updates), then the kernel attends from q (B, 1, H, D)
    over the leading slots that hold the token's keys, a strided view
    with no copy. That is the reference's two-block softmax over the
    cache plus the new token; the caller's position must equal the step
    (the tokens already cached), as the reference's decode step requires.
    """
    if kind not in ("full", "sliding", "chunked"):
        raise ValueError(f"unknown attention kind {kind!r}")
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    scale = dh**-0.5

    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
        pos1d = positions[..., 0]
    elif cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        pos1d = positions
    else:
        pos1d = positions if positions.ndim == 2 else positions[..., 0]

    window = cfg.window if kind != "full" else None
    if cache is None:
        if window and 1 < window < s:
            out = _local(q, k, v, kind=kind, window=window, scale=scale)
        else:
            out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=cfg.causal,
                                      scale=scale)
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        step = merge_cache_updates(cache, k, v, pos1d[0, :1],
                                   ring=kind != "full")
        keys = _decode_keys(kind, step, cache["k"].shape[1], window)
        out = ops.flash_attention(
            q.transpose(1, 2), cache["k"][:, :keys].transpose(1, 2),
            cache["v"][:, :keys].transpose(1, 2), causal=cfg.causal,
            scale=scale)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    y = out @ p.wo.reshape(h * dh, -1)
    return y, cache
