"""Carry state into the port from plain values.

The SPDC protocol has no weights; its state is the client's key material
(the seed, the blinding vector, the cipher record) and the servers' LU
factors. The first functions build the port's objects from numpy arrays
and Python values — for instance those another SPDC implementation
produced — so the port's `keygen`, `authenticate` and `decipher` can
consume them.

The LM serving path has weights and decode caches. `lm_params_from_numpy`
and `caches_from_numpy` take them in the reference's tree layout (nested
dicts of arrays, each layer-pattern position stacked over a leading
"periods" axis, the rest under "remainder") and return the port's model
and per-layer cache list, so both packages can compute on identical
weights: token tables or stub-frontend adapters, attention, MLP, MoE and
SSM layers, full and ring KV caches and SSM state caches. They import
the LM stack when called, so the SPDC side of this
module does not load it.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from .core.cipher import CipherMeta
from .core.keygen import Key
from .core.seed import Seed
from .device import resolve_device

if TYPE_CHECKING:
    from .models.lm import LM


def seed_from_numpy(psi: float, mu: float, m_max: float, digest: bytes) -> Seed:
    """A Seed from its four fields (digest: the 32-byte SeedGen hash)."""
    digest = bytes(digest)
    if len(digest) != 32:
        raise ValueError(f"a seed digest is 32 bytes, got {len(digest)}")
    return Seed(psi=float(psi), mu=float(mu), m_max=float(m_max), digest=digest)


def key_from_numpy(v) -> Key:
    """A Key from a blinding vector (copied as float64)."""
    v = np.array(v, dtype=np.float64)
    if v.ndim != 1 or v.shape[0] < 2:
        raise ValueError(f"a blinding vector is (n,) with n >= 2, got {v.shape}")
    return Key(v=v)


def meta_from_fields(mode: str, rotate_k: int, n: int,
                     flipped: bool = False) -> CipherMeta:
    """A CipherMeta from its fields."""
    if mode not in ("ewd", "ewm"):
        raise ValueError(f"unknown EWO mode: {mode!r}")
    return CipherMeta(mode=mode, rotate_k=int(rotate_k), n=int(n),
                      flipped=bool(flipped))


def factors_from_numpy(l, u, *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, U) tensors on `device` (None = the CUDA device, RuntimeError
    without one) copied from array-likes, in their own dtype."""
    device = resolve_device(device)
    l_t = torch.tensor(np.asarray(l), device=device)
    u_t = torch.tensor(np.asarray(u), device=device)
    if l_t.shape != u_t.shape or l_t.ndim not in (2, 3) \
            or l_t.shape[-1] != l_t.shape[-2]:
        raise ValueError(f"factors {tuple(l_t.shape)} and {tuple(u_t.shape)} "
                         "are not matching (…, n, n) arrays")
    return l_t, u_t


def _layer_trees(cfg, stack: dict) -> list[dict]:
    """The reference's stacked layer tree, one tree per layer in order:
    layer i is period i // P of pattern position i % P, or after the last
    full period, the remainder's position i % P."""
    from .models.blocks import split_layers

    n_periods, rem = split_layers(cfg)
    plen = len(cfg.pattern)

    def pick(tree, period):
        if isinstance(tree, dict):
            return {k: pick(v, period) for k, v in tree.items()}
        return tree if period is None else tree[period]

    layers = [pick(stack["periods"][f"l{i % plen}"], i // plen)
              for i in range(n_periods * plen)]
    layers += [pick(stack["remainder"][f"l{r}"], None) for r in range(rem)]
    return layers


def _copy_into(target: torch.Tensor, value, path: str) -> torch.Tensor:
    value = np.array(value)
    if value.dtype.name == "bfloat16":  # ml_dtypes' type: widen exactly
        value = value.astype(np.float32)
    value = torch.from_numpy(value)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"{path}: shape {tuple(value.shape)}, the port's "
                         f"model has {tuple(target.shape)}")
    return value.to(device=target.device, dtype=target.dtype)


def lm_params_from_numpy(cfg, tree: dict, *, device=None) -> LM:
    """The port's model with the reference's weights: `tree` is
    `split_tree(init_lm(cfg, key))[0]` of the reference as numpy arrays.
    Every leaf is checked against the shape of the port's own parameter;
    values keep the port's dtype for them (cfg.param_dtype)."""
    from .models.common import Initializer
    from .models.lm import LM

    device = resolve_device(device)
    model = LM(cfg, Initializer(0, cfg.param_dtype, "meta"))
    flat = {"lm_head": tree["lm_head"],
            "final_norm.gamma": tree["final_norm"]["gamma"]}
    if "embed" in tree:
        flat["embed"] = tree["embed"]
    if "frontend" in tree:
        flat["frontend.adapter"] = tree["frontend"]["adapter"]
    if "beta" in tree["final_norm"]:
        flat["final_norm.beta"] = tree["final_norm"]["beta"]
    for i, layer in enumerate(_layer_trees(cfg, tree["stack"])):
        for part, leaves in layer.items():
            for leaf, value in leaves.items():
                flat[f"stack.{i}.{part}.{leaf}"] = value
    names = dict(model.named_parameters())
    if set(names) != set(flat):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(names) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(names))}")
    model.to_empty(device=device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(_copy_into(param, flat[name], name))
    return model


def caches_from_numpy(cfg, tree: dict, *, device=None) -> list[dict]:
    """The port's per-layer cache list from the reference's
    `init_caches(cfg, batch, max_seq)` tree as numpy arrays (k, v, pos and
    step of every attention layer, full or ring; state and conv of every
    SSM layer), each leaf checked against the port's own."""
    from .serve.kvcache import init_caches

    device = resolve_device(device)
    layers = _layer_trees(cfg, tree)
    kinds = [mixer for mixer, _ in cfg.layer_list()]
    batch = np.shape(next(iter(layers[0].values())))[0]
    # max_seq is a full layer's length; a model with only ring layers
    # needs just their length, and one with only SSM layers none
    attn = ([i for i, mixer in enumerate(kinds) if mixer == "attn_full"]
            or [i for i, mixer in enumerate(kinds) if mixer != "ssm"])
    max_seq = np.shape(layers[attn[0]]["k"])[1] if attn else 1
    caches = init_caches(cfg, batch, max_seq, device=device)
    for i, (cache, layer) in enumerate(zip(caches, layers)):
        if set(cache) != set(layer):
            raise ValueError(f"layer {i}: leaves {sorted(layer)}, the port's "
                             f"cache has {sorted(cache)}")
        for leaf, target in cache.items():
            target.copy_(_copy_into(target, layer[leaf], f"layer {i} {leaf}"))
    return caches
