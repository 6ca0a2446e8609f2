"""Decode caches: ring-buffered KV for attention, recurrent state for SSM.

Port of src/repro/serve/kvcache.py. The cache is a list with one dict per
layer, in layer order (the reference stacks them per period). An
attention layer's dict holds the reference's leaves:

  * "k", "v": (B, L, Hkv, D) in cfg.dtype, on the model's device;
  * "pos": (L,) int32, the absolute position in each slot, −1 where
    nothing was written yet;
  * "step": () int32, the tokens written so far. It lives on the host:
    it is the write index, read by Python in every layer, and reading it
    from device memory would synchronise the card once per layer. (A
    Python int serves as well: the dry run sets one, since a fake tensor
    holds no value.)

Under sharding rules (`place_caches`) "k", "v" and "pos" are DTensors
placed by CACHE_SPECS, batch over the data axes and slots over the model
axis, and models/attention.py's decode writes and reads each rank's own
slots.

L is pattern-aware as in the reference: max_seq slots for full layers;
for sliding and chunked layers a ring of `window` slots, token t in slot
t % L, so a stale slot is overwritten, never shifted. An SSM layer's
dict holds its recurrent state (models.ssm.init_ssm_cache): "state"
(B, H, N, P) in f32 and "conv" (B, 3, C), the last three conv inputs.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.ssm import init_ssm_cache

_ITEMSIZE_F32 = 4
_ITEMSIZE_I32 = 4


def layer_cache_len(cfg, mixer: str, max_seq: int) -> int:
    if mixer == "attn_full":
        return max_seq
    return min(cfg.window or max_seq, max_seq)


def init_layer_cache(cfg, mixer: str, batch: int, max_seq: int, device=None):
    """One layer's cache on `device` (None: the CUDA device, or raise)."""
    device = resolve_device(device)
    if mixer == "ssm":
        return init_ssm_cache(cfg, batch, cfg.dtype, device=device)
    length = layer_cache_len(cfg, mixer, max_seq)
    hk, dh = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, hk, dh), dtype=cfg.dtype, device=device),
        "v": torch.zeros((batch, length, hk, dh), dtype=cfg.dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
        "step": torch.zeros((), dtype=torch.int32),
    }


def init_caches(cfg, batch: int, max_seq: int, device=None) -> list[dict]:
    """One layer cache per entry of cfg.layer_list(), in order, on
    `device` (None: the CUDA device, or raise)."""
    return [init_layer_cache(cfg, mixer, batch, max_seq, device)
            for mixer, _ in cfg.layer_list()]


def merge_cache_updates(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                        pos_new: torch.Tensor, *, ring: bool = False) -> int:
    """Write one decode token into one attention layer's cache, in place:
    k_new and v_new (B, 1, Hkv, D) into slot step % L, pos_new (1,) into
    pos there, then step + 1. Returns the token's step (its index in the
    sequence; the slots before it hold the tokens before it).

    The reference defers this write out of its period scan and merges all
    layers' deltas at once, so XLA cannot materialise f32 copies of the
    stacked cache (its kvcache.py and models/attention.py:200-207);
    eagerly the write happens where the token is computed. A ring
    (`ring=True`, a local layer's window-sized cache) wraps and
    overwrites the token L steps back, which its window no longer sees.
    A full layer's cache does not wrap: writing past its length raises."""
    step = int(cache["step"])
    length = cache["k"].shape[1]
    if step >= length and not ring:
        raise ValueError(
            f"the cache holds {length} tokens and is full; size it to the "
            "prompt plus the generated tokens")
    slot = step % length
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][slot:slot + 1] = pos_new
    cache["step"] += 1
    return step


#: each cache leaf's logical spec, unstacked (the reference's
#: cache_logical_specs by leaf name)
CACHE_SPECS = {"k": ("batch", "model", None, None),
               "v": ("batch", "model", None, None), "pos": ("model",),
               "step": (), "state": ("batch", "model", None, None),
               "conv": ("batch", None, None)}


def place_caches(caches: list[dict]) -> list[dict]:
    """Every layer cache's tensor leaves placed by CACHE_SPECS under the
    active sharding rules (the reference's cache_logical_specs, each leaf
    unstacked), in the dicts themselves; the host's "step" is never
    placed, and without active rules nothing changes. Returns the same
    list. Call it once, where the caches are made."""
    from ..distrib.sharding import distribute

    for cache in caches:
        for name, leaf in cache.items():
            if name != "step" and isinstance(leaf, torch.Tensor):
                cache[name] = distribute(leaf, *CACHE_SPECS.get(
                    name, (None,) * leaf.ndim))
    return caches


def cache_logical_specs(cfg, caches: list[dict]) -> dict:
    """Logical spec names per cache leaf in the reference's tree layout
    (its init_caches tree: "periods" stacked, leading axis replicated,
    then "remainder"), from the port's per-layer cache list: equal to the
    reference's cache_logical_specs(cfg, init_caches(...)) for the same
    config."""
    from ..models.blocks import reference_layers

    layers = [{name: CACHE_SPECS.get(name, (None,) * leaf.ndim)
               for name, leaf in cache.items()} for cache in caches]
    return reference_layers(cfg, layers, lambda specs: (None, *specs[0]))


def cache_bytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of the decode caches of every layer, from their shapes alone
    (no allocation), SSM state caches included — the reference's count."""
    item = torch.empty((), dtype=cfg.dtype).element_size()
    total = 0
    for mixer, _ in cfg.layer_list():
        if mixer == "ssm":
            h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            total += batch * h * n * pd * _ITEMSIZE_F32
            total += batch * 3 * (h * pd + 2 * n) * item
            continue
        length = layer_cache_len(cfg, mixer, max_seq)
        total += 2 * batch * length * cfg.num_kv_heads * cfg.head_dim * item
        total += (length + 1) * _ITEMSIZE_I32
    return total
