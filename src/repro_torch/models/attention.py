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

Under sharding rules (distrib/sharding.py; `launch/train.py --mesh
smoke`, the dry run) q, k, v and the output are constrained at the
reference's sites, and the kernel runs through DTensor's `local_map` on
each rank's own shard (`_sharded`): with the heads sharded, on the
rank's heads, all keys local (K/V repeated to the query heads first
where their heads do not divide over the model axis, as the reference
repeats them); in the sequence-parallel fallback, on the rank's block of
query rows against the keys up to its block's end (gathered over the
model axis inside), which the kernel's right-aligned rows then place at
their true positions.

Decode under sharding rules (`_sharded_decode`) takes the caches where
serve.kvcache.place_caches put them, once, where they were made:
CACHE_SPECS, batch over the data axes and slots over the model axis, as
the reference does (its scores constrained to the cache's
layout, so that GSPMD splits the softmax over the ranks' keys). Every
model rank gets q with all heads and the token's k and v; it writes them
into the token's slot where that slot is its own, runs B6's decode
partial (`ops.flash_decode_partial`) over its own slots among the
token's keys, and all-gathers the ranks' f32 partials over the model
axis; B6's merge (`ops.flash_combine`) then takes the chunks in rank
order, so every rank holds the whole (B, H, 1, D) output. K and V keep
their kv heads (the kernel's head map is GQA). A rank with no key among
its slots contributes empty chunks (l = 0), which weigh nothing. With
one model rank the partial's chunks are the unsharded decode's own, so
the two agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distrib.sharding import (constrain, current_rules, gather,
                                is_sharded, matmul)
from ..kernels import ops
from ..kernels.flash_attn import decode_split
from ..serve.kvcache import merge_cache_updates
from .common import Initializer, apply_mrope, apply_rope


class Attention(nn.Module):
    """wq (d, h, dh), wk and wv (d, hk, dh), wo (h, dh, d)."""

    def __init__(self, ini: Initializer, cfg):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.wq = ini.normal((d, h, dh), ("fsdp", "heads", None))
        self.wk = ini.normal((d, hk, dh), ("fsdp", "kv_heads", None))
        self.wv = ini.normal((d, hk, dh), ("fsdp", "kv_heads", None))
        self.wo = ini.normal((h, dh, d), ("heads", None, "fsdp"), std=std_o)


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


def _project(x: torch.Tensor, w: torch.Tensor, heads: str) -> torch.Tensor:
    """(B, S, d) · (d, H, D) → (B, S, H, D) as one matrix product. Under
    sharding rules the weight is first gathered over its fsdp axes and
    kept split by `heads` ("heads" or "kv_heads") alone, so the product's
    H·D columns split evenly into heads."""
    d, h, dh = w.shape
    w = constrain(w, None, heads, None)
    return matmul(x, w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


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


def _prefill(q, k, v, cfg, *, kind: str, window, scale: float) -> torch.Tensor:
    """Prefill attention of (B, S, H, D) projections → (B, H, S, D) on
    one device: a local layer (`window` given where the reference's rule
    1 < window < S holds for the whole sequence) as `_local`, else the
    kernel's causal (or full) route."""
    if window:
        return _local(q, k, v, kind=kind, window=window, scale=scale)
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=cfg.causal,
                               scale=scale)


def _sharded(q, k, v, cfg, rules, *, kind: str, window, scale: float
             ) -> torch.Tensor:
    """`_prefill` on DTensor projections, each rank's shard through the
    kernel (module docstring): q (B, S, H, D) placed by ("batch", "qseq",
    "heads"), k and v by ("batch", "qseq", "kv_heads"); the output
    (B, H, S, D) by ("batch", "heads", "qseq"). Every input enters the
    local function at its own placements, so each rank's gradients are
    its shard's; the sequence-parallel fallback gathers the keys inside,
    by a differentiable all-gather over the model axis."""
    from torch.distributed.tensor.experimental import local_map

    g = cfg.num_heads // cfg.num_kv_heads
    if not rules.shard_kv and rules.model_size > 1:
        k = constrain(k.repeat_interleave(g, dim=2), "batch", "qseq", "heads",
                      None)
        v = constrain(v.repeat_interleave(g, dim=2), "batch", "qseq", "heads",
                      None)
    kv_heads = "kv_heads" if rules.shard_kv else "heads"
    seq_split = not rules.shard_heads and rules.model_size > 1
    mesh, axis = rules.mesh, rules.model_axis
    if seq_split and kind == "chunked":
        # a chunked layer folds whole chunks: every rank runs all of them
        q, k, v = (constrain(t, "batch", None, "heads", None)
                   for t in (q, k, v))
        seq_split = False
    q_seq = "qseq" if seq_split else None

    def local(ql, kl, vl):
        if seq_split:
            from torch.distributed._functional_collectives import (
                all_gather_tensor_autograd)

            group = mesh.get_group(axis)
            kl = all_gather_tensor_autograd(kl.contiguous(), 1, group)
            vl = all_gather_tensor_autograd(vl.contiguous(), 1, group)
            if cfg.causal:
                # this rank's query block ends at key (r + 1)·S/M
                end = (mesh.get_local_rank(axis) + 1) * ql.shape[1]
                kl, vl = kl[:, :end], vl[:, :end]
        return _prefill(ql, kl, vl, cfg, kind=kind, window=window,
                        scale=scale)

    q_pl = rules.placements("batch", q_seq, "heads", None)
    kv_pl = rules.placements("batch", q_seq, kv_heads, None)
    out = local_map(
        local, out_placements=(rules.placements("batch", "heads", q_seq,
                                                None),),
        in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh,
        redistribute_inputs=True,
    )(q, k, v)
    return constrain(out, "batch", "heads", "qseq", None)


def _decode_keys(kind: str, step: int, length: int, window: int | None) -> int:
    """How many leading cache slots a decode token at `step` attends:
    full layers the written prefix; sliding rings the prefix until they
    wrap, then every slot; chunked rings the slots of the token's own
    chunk, [0, step mod W]."""
    if kind == "chunked" and window:
        return step % window + 1
    return min(step + 1, length)


def _sharded_decode(q, k, v, pos1d, cache: dict, cfg, rules, *, kind: str,
                    window, scale: float) -> torch.Tensor:
    """One decode token under sharding rules (module docstring): q (B, 1,
    H, D), k and v (B, 1, Hkv, D), pos1d (B, 1) as `attention` has them;
    the cache's k, v and pos DTensors placed by CACHE_SPECS
    (serve.kvcache.place_caches, where the caches are made). Writes the
    token into its slot on the rank that holds it and advances the host's
    step; returns (B, H, 1, D) placed by ("batch", None, None, None), whole
    on every model rank."""
    from torch.distributed._functional_collectives import wait_tensor
    from torch.distributed.tensor.experimental import local_map

    for name in ("k", "v", "pos"):
        if not is_sharded(cache[name]):
            raise ValueError(
                f"decode under sharding rules needs the cache's {name!r} "
                "placed by CACHE_SPECS (serve.kvcache.place_caches)")
    step = int(cache["step"])
    length = cache["k"].shape[1]
    if step >= length and kind == "full":
        raise ValueError(
            f"the cache holds {length} tokens and is full; size it to the "
            "prompt plus the generated tokens")
    slot = step % length
    keys = _decode_keys(kind, step, length, window)
    mesh, axis, ranks = rules.mesh, rules.model_axis, rules.model_size
    # each rank's slots: torch.chunk's split of the L slots, as Shard's
    per_rank = -(-length // ranks)
    # as many chunks as a rank's slots need, so every rank's partial has
    # one shape for the all-gather
    chunks = decode_split(per_rank)[1]

    def local(ql, kl, vl, pl, ck, cv, cpos):
        lo = mesh.get_local_rank(axis) * per_rank if axis else 0
        if lo <= slot < lo + ck.shape[1]:
            ck[:, slot - lo] = kl[:, 0]
            cv[:, slot - lo] = vl[:, 0]
            cpos[slot - lo:slot - lo + 1] = pl[0, :1]
        n = max(0, min(keys - lo, ck.shape[1]))
        part = ops.flash_decode_partial(
            ql.transpose(1, 2), ck[:, :n].transpose(1, 2),
            cv[:, :n].transpose(1, 2), scale=scale, chunks=chunks)
        if ranks > 1:
            part = wait_tensor(gather(part, 0, (axis,), mesh))
        return ops.flash_combine(part, ql.dtype)

    whole = rules.placements("batch", None, None, None)
    out = local_map(
        local, out_placements=(whole,),
        in_placements=(whole, whole, whole, rules.placements("batch", None),
                       rules.placements("batch", "model", None, None),
                       rules.placements("batch", "model", None, None),
                       rules.placements("model")),
        device_mesh=mesh, redistribute_inputs=True,
    )(q, k.to(cache["k"].dtype), v.to(cache["v"].dtype), pos1d,
      cache["k"], cache["v"], cache["pos"])
    cache["step"] += 1
    return out


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
    Under sharding rules the decode splits its keys over the model axis
    (`_sharded_decode`).
    """
    if kind not in ("full", "sliding", "chunked"):
        raise ValueError(f"unknown attention kind {kind!r}")
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    scale = dh**-0.5

    q = constrain(_project(x, p.wq, "heads"), "batch", "qseq", "heads", None)
    k = constrain(_project(x, p.wk, "kv_heads"), "batch", "qseq", "kv_heads",
                  None)
    v = constrain(_project(x, p.wv, "kv_heads"), "batch", "qseq", "kv_heads",
                  None)
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
    local = window if window and 1 < window < s else None
    rules = current_rules()
    sharded = rules is not None and rules.mesh is not None
    if cache is None and sharded:
        out = _sharded(q, k, v, cfg, rules, kind=kind, window=local,
                       scale=scale)
    elif cache is None:
        out = _prefill(q, k, v, cfg, kind=kind, window=local, scale=scale)
    elif s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    elif sharded:
        out = _sharded_decode(q, k, v, pos1d, cache, cfg, rules, kind=kind,
                              window=window, scale=scale)
    else:
        step = merge_cache_updates(cache, k, v, pos1d[0, :1],
                                   ring=kind != "full")
        keys = _decode_keys(kind, step, cache["k"].shape[1], window)
        out = ops.flash_attention(
            q.transpose(1, 2), cache["k"][:, :keys].transpose(1, 2),
            cache["v"][:, :keys].transpose(1, 2), causal=cfg.causal,
            scale=scale)
    out = constrain(out.transpose(1, 2), "batch", "qseq", "heads", None)
    wo = constrain(p.wo, "heads", None, None)
    y = matmul(out.reshape(b, s, h * dh), wo.reshape(h * dh, -1))
    return constrain(y, "batch", "seq", None), cache
