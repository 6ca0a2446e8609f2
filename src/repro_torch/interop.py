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

Training goes the other way too: `lm_tree_from_port` turns the port's
named tensors (its parameters, or their gradients) back into the
reference's stacked tree as numpy, and `opt_state_from_numpy` carries the
reference's AdamW state (moments in that tree layout, and the step) into
the port's per-parameter dicts.
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


def _tensor(value) -> torch.Tensor:
    """A CPU tensor of an array-like; ml_dtypes' bfloat16 keeps its bits."""
    value = np.array(value)
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(value)


def _copy_into(target: torch.Tensor, value, path: str) -> torch.Tensor:
    value = _tensor(value)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"{path}: shape {tuple(value.shape)}, the port's "
                         f"model has {tuple(target.shape)}")
    return value.to(device=target.device, dtype=target.dtype)


def _skeleton(cfg) -> LM:
    """The port's model on the meta device: every parameter's name and
    shape, nothing allocated."""
    from .models.common import Initializer
    from .models.lm import LM

    return LM(cfg, Initializer(0, cfg.param_dtype, "meta"))


def _flat_lm_tree(cfg, tree: dict, names) -> dict:
    """The reference's LM tree as {port parameter name: leaf}, checked
    to hold exactly `names`."""
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
    if set(names) != set(flat):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(names) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(names))}")
    return flat


def lm_params_from_numpy(cfg, tree: dict, *, device=None) -> LM:
    """The port's model with the reference's weights: `tree` is
    `split_tree(init_lm(cfg, key))[0]` of the reference as numpy arrays.
    Every leaf is checked against the shape of the port's own parameter;
    values keep the port's dtype for them (cfg.param_dtype)."""
    device = resolve_device(device)
    model = _skeleton(cfg)
    flat = _flat_lm_tree(cfg, tree, dict(model.named_parameters()))
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


def lm_tree_from_port(cfg, tensors) -> dict:
    """The reference's LM tree, as float32 or the tensors' own numpy
    dtypes (bfloat16 widened exactly to float32), from the port's named
    tensors: a model's parameters, their gradients, or a moment of the
    optimizer state ({name: tensor}, or the model itself). Layer i goes
    to pattern position i % P of period i // P, stacked over the periods,
    or after the last full period to the remainder: the inverse of
    lm_params_from_numpy."""
    from torch import nn

    from .models.lm import reference_tree

    if isinstance(tensors, nn.Module):
        tensors = dict(tensors.named_parameters())
    names = {name for name, _ in _skeleton(cfg).named_parameters()}
    if set(tensors) != names:
        raise ValueError(f"names differ from the model's: missing "
                         f"{sorted(names - set(tensors))}, unknown "
                         f"{sorted(set(tensors) - names)}")

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return reference_tree(cfg, {n: host(t) for n, t in tensors.items()},
                          np.stack)


def opt_state_from_numpy(cfg, state: dict, model: LM) -> dict:
    """The port's AdamW state from the reference's: `state` is
    `init_opt_state`'s {"mu", "nu", "step"} (or a later one) as numpy,
    mu and nu in the reference's LM tree. The moments keep their dtype
    (bfloat16 bit for bit) and land on the model's device; the step is a
    0-d int32 tensor."""
    names = dict(model.named_parameters())
    device = next(iter(names.values())).device
    out = {}
    for moment in ("mu", "nu"):
        flat = _flat_lm_tree(cfg, state[moment], names)
        out[moment] = {}
        for name, param in names.items():
            value = _tensor(flat[name])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{moment} {name}: shape {tuple(value.shape)}, "
                                 f"the parameter's {tuple(param.shape)}")
            out[moment][name] = value.to(device)
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                               device=device)
    return out
