"""Full model assembly: embeddings or a stub frontend → layer stack →
norm → last-position logits. Decoder-only LMs and the encoder-only audio
arch share this file (cfg.causal distinguishes them).

Port of src/repro/models/lm.py. The vocab table is padded to a multiple
of 2048 and padded logit slots are masked to −1e30, as in the reference.
A stub frontend (qwen2-vl's vision, hubert's audio) takes precomputed
embeddings through one linear adapter in place of the token table.

The loss (`lm_loss`) is cross-entropy over sequence chunks (`_chunk_ce`)
so that the (B, S, Vp) f32 logits never live whole: at gemma3's 262k
vocabulary that is the difference between gigabytes and a chunk's
hundreds of megabytes. The reference gets this from its lax.scan; here
each chunk runs under `torch.utils.checkpoint`, so its logits are freed
after the forward and recomputed in the backward (ROADMAP §C).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .blocks import apply_stack, init_stack
from .common import Initializer, apply_norm, init_norm, positions_for

F32 = torch.float32


def padded_vocab(cfg, multiple: int = 2048) -> int:
    v = cfg.vocab_size
    return -(-v // multiple) * multiple


class Frontend(nn.Module):
    """The stub frontend's adapter (d, d): it stands in for the
    patch/frame projection of the embeddings the inputs carry."""

    def __init__(self, ini: Initializer, d: int):
        super().__init__()
        self.adapter = ini.normal((d, d))


class LM(nn.Module):
    """embed (Vp, d) or, with a stub frontend, frontend.adapter (d, d);
    stack (one Layer per layer), final_norm, lm_head (d, Vp)."""

    def __init__(self, cfg, ini: Initializer):
        super().__init__()
        vp = padded_vocab(cfg)
        self.cfg = cfg
        if cfg.frontend is None:
            self.embed = ini.normal((vp, cfg.d_model))
        else:
            self.frontend = Frontend(ini, cfg.d_model)
        self.stack = init_stack(ini, cfg)
        self.final_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
        self.lm_head = ini.normal((cfg.d_model, vp))


def init_lm(cfg, seed: int = 0, *, device=None) -> LM:
    """The model with weights drawn from `seed` on `device` (None = the
    CUDA device, RuntimeError without one), in cfg.param_dtype."""
    ini = Initializer(seed, cfg.param_dtype, resolve_device(device))
    return LM(cfg, ini)


def with_parameters(model: LM, tensors: dict, *,
                    requires_grad: bool = False) -> LM:
    """A new LM of model's config whose parameters are `tensors`, by
    name (those of `model.named_parameters()`), shared and not copied.
    The training step builds its gradient leaves and its updated model
    with it, so the caller's model is never changed in place."""
    new = LM(model.cfg, Initializer(0, model.cfg.param_dtype, "meta"))
    names = [name for name, _ in new.named_parameters()]
    if set(names) != set(tensors):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(names) - set(tensors))}, unknown "
                         f"{sorted(set(tensors) - set(names))}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        setattr(new.get_submodule(owner), leaf,
                nn.Parameter(tensors[name].detach(), requires_grad=requires_grad))
    return new


def embed_inputs(params: LM, batch: dict, cfg) -> torch.Tensor:
    """batch["tokens"] (B, S) through the table, or with a stub frontend
    batch["embeds"] (B, S, d) through the adapter."""
    if cfg.frontend is None:
        return params.embed[batch["tokens"]].to(cfg.dtype)
    return (batch["embeds"].to(cfg.dtype) @ params.frontend.adapter).to(cfg.dtype)


def forward_hidden(
    params: LM,
    batch: dict,
    cfg,
    positions: torch.Tensor | None = None,
    caches: list | None = None,
    *,
    remat_policy: str = "nothing",
) -> tuple[torch.Tensor, list | None]:
    """Normed hidden states (B, S, d). With caches (decode) each layer
    writes its token into its cache in place, and the same list comes
    back. remat_policy: blocks.apply_stack's ("nothing", "dots", "none"),
    which matters only where grad is enabled."""
    x = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    if positions is None:
        positions = positions_for(cfg, b, s, device=x.device)
    x, caches = apply_stack(params.stack, x, cfg, positions, caches,
                            remat_policy=remat_policy)
    return apply_norm(params.final_norm, x, cfg.norm_type), caches


def _chunk_loss(h: torch.Tensor, lab: torch.Tensor, head: torch.Tensor,
                vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ CE, count) over one chunk: h (B, C, d), lab (B, C) with −1 for
    a position that counts nothing. Padded vocab slots get −1e30, never
    −inf, so a masked row's (lse − gold)·0 stays 0. torch.gather raises
    on −1 where the reference's take_along_axis wraps, so the index is
    clamped to 0; the mask drops the row either way."""
    logits = (h @ head).to(F32)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
    logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab.clamp(min=0)[..., None].long())[..., 0]
    mask = (lab >= 0).to(F32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def _chunk_ce(hidden: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
              cfg, chunk: int) -> torch.Tensor:
    """Mean cross-entropy over seq chunks. hidden: (B, S, d), labels:
    (B, S). The chunk is halved until it divides S. With grad enabled
    each chunk is checkpointed: its (B, C, Vp) f32 logits are recomputed
    in the backward rather than kept."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    while s % chunk != 0:
        chunk //= 2
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    for c in range(0, s, chunk):
        args = (hidden[:, c:c + chunk], labels[:, c:c + chunk], head,
                cfg.vocab_size)
        if torch.is_grad_enabled():
            loss, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            loss, n = _chunk_loss(*args)
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params: LM, batch: dict, cfg, *, remat_policy: str = "nothing",
            ce_chunk: int = 512) -> torch.Tensor:
    """Mean next-token (decoder) or per-position (encoder) CE loss, a 0-d
    f32 tensor. A decoder's labels shift left by one and its last
    position gets −1 (masked), which keeps S intact so the chunks divide
    it."""
    hidden, _ = forward_hidden(params, batch, cfg, remat_policy=remat_policy)
    labels = batch["labels"]
    if cfg.causal:
        labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                           dim=1)
    return _chunk_ce(hidden, labels, params.lm_head, cfg, ce_chunk)


def lm_logits_last(params: LM, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits (B, Vp) of the last position; padded slots −1e30."""
    logits = (hidden[:, -1] @ params.lm_head).to(F32)
    vp = params.lm_head.shape[1]
    pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)
