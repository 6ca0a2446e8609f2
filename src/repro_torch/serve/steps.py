"""LM-serving steps: prefill (a parallel forward over the prompt) and
decode (one token against the caches), and greedy generation.

Port of src/repro/serve/steps.py. The steps run eagerly and without
autograd; decode updates the caches in place and hands the same list
back. On CUDA every full-attention layer of both steps runs the flash
kernel.
"""
from __future__ import annotations

import torch

from ..models.lm import forward_hidden, lm_logits_last
from .kvcache import init_caches


def build_prefill_step(cfg):
    """prefill_step(params, batch) -> last-position logits (B, Vp), f32.
    batch carries tokens (B, S) (or a stub frontend's embeds (B, S, d))
    for the full prompt."""

    @torch.no_grad()
    def prefill_step(params, batch):
        hidden, _ = forward_hidden(params, batch, cfg)
        return lm_logits_last(params, hidden, cfg)

    return prefill_step


def build_decode_step(cfg):
    """decode_step(params, caches, inputs, pos) -> (logits, caches).

    inputs: {"tokens": (B, 1)} or {"embeds": (B, 1, d)}; pos: (B,)
    absolute position of this token (== number of tokens already in the
    cache), three equal streams of it under M-RoPE."""

    @torch.no_grad()
    def decode_step(params, caches, inputs, pos):
        positions = pos[:, None]
        if cfg.rope_type == "mrope":
            positions = positions[..., None].expand(-1, -1, 3)
        hidden, caches = forward_hidden(params, inputs, cfg,
                                        positions=positions, caches=caches)
        return lm_logits_last(params, hidden, cfg), caches

    return decode_step


def greedy_generate(cfg, params, prompt: torch.Tensor, steps: int,
                    max_seq: int | None = None) -> torch.Tensor:
    """The reference's example-grade generation: the prompt goes through
    the decode step one token at a time (teacher-forced), then `steps`
    greedy tokens follow. prompt: (B, S0) on the model's device; returns
    (B, S0 + steps)."""
    b, s0 = prompt.shape
    max_seq = max_seq or (s0 + steps)
    caches = init_caches(cfg, b, max_seq, device=prompt.device)
    decode = build_decode_step(cfg)

    tok = prompt[:, :1]
    out = [tok]
    for t in range(s0 + steps - 1):
        pos = torch.full((b,), t, dtype=torch.int32, device=prompt.device)
        logits, caches = decode(params, caches, {"tokens": tok}, pos)
        if t + 1 < s0:
            tok = prompt[:, t + 1: t + 2]  # teacher-forced prompt
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
