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
from ..distrib.sharding import (
    constrain, current_rules, is_sharded, matmul, with_rules)
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
        self.adapter = ini.normal((d, d), ("fsdp", None))


class LM(nn.Module):
    """embed (Vp, d) or, with a stub frontend, frontend.adapter (d, d);
    stack (one Layer per layer), final_norm, lm_head (d, Vp)."""

    def __init__(self, cfg, ini: Initializer):
        super().__init__()
        vp = padded_vocab(cfg)
        self.cfg = cfg
        if cfg.frontend is None:
            self.embed = ini.normal((vp, cfg.d_model), ("model", "fsdp"))
        else:
            self.frontend = Frontend(ini, cfg.d_model)
        self.stack = init_stack(ini, cfg)
        self.final_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
        self.lm_head = ini.normal((cfg.d_model, vp), ("fsdp", "model"))


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
        module = new.get_submodule(owner)
        param = nn.Parameter(tensors[name].detach(), requires_grad=requires_grad)
        param.spec = getattr(module, leaf).spec
        setattr(module, leaf, param)
    return new


def reference_tree(cfg, named: dict, stack) -> dict:
    """The reference's LM tree (`split_tree(init_lm(...))` layout) of one
    leaf per port parameter name: named maps every name of
    `model.named_parameters()` to its leaf, and `stack` combines the
    leaves of one pattern position over the periods."""
    from .blocks import reference_layers

    tree: dict = {"lm_head": named["lm_head"],
                  "final_norm": {"gamma": named["final_norm.gamma"]}}
    if "final_norm.beta" in named:
        tree["final_norm"]["beta"] = named["final_norm.beta"]
    if "embed" in named:
        tree["embed"] = named["embed"]
    if "frontend.adapter" in named:
        tree["frontend"] = {"adapter": named["frontend.adapter"]}
    layers: list[dict] = [{} for _ in range(cfg.num_layers)]
    for name, leaf in named.items():
        if name.startswith("stack."):
            _, i, part, key = name.split(".")
            layers[int(i)].setdefault(part, {})[key] = leaf
    tree["stack"] = reference_layers(cfg, layers, stack)
    return tree


def _stacked_spec(specs: list) -> tuple:
    """A pattern position's spec stacked over the periods: a leading
    replicated axis, as the reference's init_stack stacks its Px leaves."""
    if any(s != specs[0] for s in specs):
        raise ValueError(f"periods disagree on a spec: {specs}")
    return (None, *specs[0])


def param_specs(model: LM) -> dict:
    """Every parameter's logical spec, by the reference's tree path: the
    reference's `split_tree(init_lm(cfg, key))[1]` for the same config."""
    return reference_tree(model.cfg, {n: p.spec for n, p in
                                      model.named_parameters()},
                          _stacked_spec)


def _partial_over_model(names: tuple) -> tuple:
    """The placements of `names` under the active rules with the model
    axis Partial (a sum pending over it)."""
    from torch.distributed.tensor import Partial

    rules = current_rules()
    out = list(rules.placements(*names))
    if rules.model_axis is not None:
        out[rules.mesh.mesh_dim_names.index(rules.model_axis)] = Partial()
    return tuple(out)


def _vocab_rows(ids: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids as indices into this rank's `rows` vocabulary rows, clamped
    into range, and whether each id is one of them)."""
    rules = current_rules()
    if rules.model_axis is None:
        return ids, torch.ones_like(ids, dtype=torch.bool)
    local = ids - rules.mesh.get_local_rank(rules.model_axis) * rows
    return local.clamp(0, rows - 1), (local >= 0) & (local < rows)


def _vocab_parallel_gold(logits: torch.Tensor, lab: torch.Tensor
                         ) -> torch.Tensor:
    """logits[..., lab] for logits (B, C, Vp) sharded by ("batch", None,
    "model"): each rank reads the labels in its vocabulary slice (zeros
    for the rest), the sum over the model axis left pending."""
    from torch.distributed.tensor.experimental import local_map

    def pick(part, ids):
        idx, mine = _vocab_rows(ids.clamp(min=0).long(), part.shape[-1])
        return part.gather(-1, idx[..., None])[..., 0] * mine

    rules = current_rules()
    return local_map(pick, out_placements=(_partial_over_model(("batch", None)),),
                     in_placements=(rules.placements("batch", None, "model"),
                                    rules.placements("batch", None)),
                     device_mesh=rules.mesh, redistribute_inputs=True,
                     )(logits, lab)


def _vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor
                           ) -> torch.Tensor:
    """table[tokens] for a table sharded by ("model", "fsdp") under the
    active rules: every rank looks the whole batch's tokens up in its own
    block of the table (its vocabulary rows, zeros for the rest; its fsdp
    columns), so the result is sharded over the fsdp axes on d, and the
    sum over the model axis is left pending (Partial) for the constraint
    that follows. The table enters at its own placements, which keeps
    each rank's gradient its block's."""
    from torch.distributed.tensor.experimental import local_map

    def lookup(rows, ids):
        idx, mine = _vocab_rows(ids, rows.shape[0])
        return rows[idx] * mine[..., None]

    rules = current_rules()
    return local_map(lookup,
                     out_placements=(_partial_over_model((None, None, "fsdp")),),
                     in_placements=(rules.placements("model", "fsdp"),
                                    rules.placements(None, None)),
                     device_mesh=rules.mesh, redistribute_inputs=True,
                     )(table, tokens)


def embed_inputs(params: LM, batch: dict, cfg) -> torch.Tensor:
    """batch["tokens"] (B, S) through the table, or with a stub frontend
    batch["embeds"] (B, S, d) through the adapter."""
    if cfg.frontend is None:
        if is_sharded(params.embed):
            x = _vocab_parallel_lookup(params.embed, batch["tokens"])
        else:
            x = params.embed[batch["tokens"]]
    else:
        x = matmul(batch["embeds"].to(cfg.dtype), params.frontend.adapter)
    return constrain(x.to(cfg.dtype), "batch", "seq", None)


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
    logits = constrain(matmul(h, head).to(F32), "batch", None, "model")
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
    logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    if is_sharded(logits):
        gold = _vocab_parallel_gold(logits, lab)
    else:
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
            loss, n = checkpoint(with_rules(_chunk_loss), *args,
                                 use_reentrant=False)
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
    return constrain(logits.masked_fill(pad, -1e30), "batch", "model")
