"""The port's mixers and frontends against the JAX package, on the CPU:
local attention (sliding and chunked) with its ring-buffer decode, MoE,
the Mamba2 SSD mixer, M-RoPE and the stub frontends.

Both packages get the same seeded numpy inputs; whole models run on the
reference's weights (`init_lm` on a smoke config, float32), carried into
the port by `interop.lm_params_from_numpy`. Tolerances: attention and
layer outputs within 2e-5 (f32 values of order one, summed in another
order; the reference's own local-attention test holds `_local` to its
masked `_blockwise` at 2e-5), SSD within 1e-4 of the f64 recurrence (the
reference's bound), logits within 1e-4 (of order 0.5, through the layers
and the lm_head), caches within 1e-5 and their positions and steps
exactly. Counts, shapes and slot sets are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attention
from repro.models import common as r_common
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro.models.lm import init_lm as r_init_lm
from repro.serve import kvcache as r_kvcache
from repro.serve import steps as r_steps
from repro_torch import configs, interop
from repro_torch.models import attention, common, moe, ssm
from repro_torch.models.lm import init_lm
from repro_torch.serve import kvcache, steps

CPU = "cpu"
B, S = 2, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_module(module, tree):
    """Load a reference parameter dict into a port module."""
    with torch.no_grad():
        for name, param in module.named_parameters():
            param.copy_(_t(np.array(tree[name])))
    return module


def _smoke(arch, **kw):
    return (dataclasses.replace(r_configs.smoke_config(arch), **kw),
            dataclasses.replace(configs.smoke_config(arch), **kw))


def _models(arch, **kw):
    """(cfg_r, cfg, reference params, port model) on identical weights."""
    cfg_r, cfg = _smoke(arch, **kw)
    params, _ = r_common.split_tree(r_init_lm(cfg_r, jax.random.key(1)))
    return cfg_r, cfg, params, interop.lm_params_from_numpy(cfg, _np(params),
                                                           device=CPU)


def _inputs(cfg, seed=3, s=S):
    """(reference batch, port batch): tokens, or embeds for a stub
    frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        a = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
        return {"tokens": jnp.asarray(a)}, {"tokens": _t(a)}
    a = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": _t(a)}


# ------------------------------------------------------ local attention
LOCAL_CASES = [(64, 16, "sliding"), (48, 16, "sliding"),
               (64, 16, "chunked"), (40, 16, "chunked")]


@pytest.mark.parametrize("s,w,kind", LOCAL_CASES)
def test_local_attention_exactness(s, w, kind):
    """The port's local prefill (B6's window route, or the chunks folded
    into the batch and run causal) == the reference's `_local` and its
    masked `_blockwise`, with 4 query heads over 2 kv heads."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32) for _ in "kv")
    kr, vr = (jnp.repeat(jnp.asarray(a), 2, axis=2) for a in (k, v))
    pos = jnp.broadcast_to(jnp.arange(s)[None], (2, s))
    got = attention._local(_t(q), _t(k), _t(v), kind=kind, window=w,
                           scale=0.35).transpose(1, 2).numpy()
    want = r_attention._local(jnp.asarray(q), kr, vr, pos, kind=kind, window=w,
                              scale=0.35)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    masked = r_attention._blockwise(
        jnp.asarray(q), kr, vr, pos, jnp.arange(s), causal=True,
        window=w if kind == "sliding" else None,
        chunk=w if kind == "chunked" else None, scale=0.35, block=10**9)
    np.testing.assert_allclose(got, np.asarray(masked), atol=2e-5)


@pytest.mark.parametrize("kind", ["sliding", "chunked"])
@pytest.mark.parametrize("length", [16, 5])
def test_decode_keys_are_the_reference_mask(kind, length):
    """The slots a decode token attends (a prefix of the ring, token t in
    slot t % L) are exactly those the reference's position mask keeps
    over the ring's stored positions, before and after it wraps, at a
    ring of the window (L = W = 16) and one cut by max_seq (L = 5)."""
    w = 16
    pos = np.full(length, -1)
    for t in range(3 * length + 7):
        pos[t % length] = t
        keep = np.asarray(r_attention._mask(
            jnp.asarray([t]), jnp.asarray(pos), causal=True,
            window=w if kind == "sliding" else None,
            chunk=w if kind == "chunked" else None))[0]
        keys = attention._decode_keys(kind, t, length, w)
        if length < w and t >= length:
            break  # a cut ring is sized to max_seq and never wraps
        np.testing.assert_array_equal(
            keep, np.arange(length) < keys, err_msg=f"{kind} t={t}")


@pytest.mark.parametrize("kind", ["sliding", "chunked"])
def test_ring_decode_matches_reference_layer(kind):
    """One local attention layer: prefill past the window, then 40 decode
    steps through a ring of 16 slots (it wraps twice) against the
    reference's decode and merge_cache_updates step by step, the whole
    history's masked attention, and the reference's ring at the end."""
    layer_kind = {"sliding": "attn_sliding", "chunked": "attn_chunked"}[kind]
    cfg_r, cfg = _smoke("gemma3-1b")
    params, _ = r_common.split_tree(r_attention.init_attention(
        r_common.Initializer(jax.random.key(4), jnp.float32), cfg_r))
    port = _port_module(
        attention.init_attention(common.Initializer(0, torch.float32), cfg), params)
    n = 40
    x = np.random.default_rng(4).standard_normal((B, n, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (B, n)).astype(np.int32)
    want, _ = r_attention.attention(params, jnp.asarray(x), cfg_r,
                                    jnp.asarray(pos), kind=kind)
    prefill, _ = attention.attention(port, _t(x), cfg, _t(pos), kind=kind)
    np.testing.assert_allclose(prefill.numpy(), np.asarray(want), atol=2e-5)

    cache_r = r_kvcache.init_layer_cache(cfg_r, layer_kind, B, n)
    cache = kvcache.init_layer_cache(cfg, layer_kind, B, n, device=CPU)
    assert cache["k"].shape[1] == cfg.window == 16
    for t in range(n):
        xt, pt = x[:, t:t + 1], pos[:, t:t + 1]
        want, delta = r_attention.attention(params, jnp.asarray(xt), cfg_r,
                                            jnp.asarray(pt), kind=kind,
                                            cache=cache_r)
        cache_r = r_kvcache.merge_cache_updates(
            {"s": {"l": cache_r}}, {"s": {"l": delta}})["s"]["l"]
        got, cache = attention.attention(port, _t(xt), cfg, _t(pt), kind=kind,
                                         cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"step {t}")
        # the whole history's local attention at position t
        np.testing.assert_allclose(got.numpy(), prefill.numpy()[:, t:t + 1],
                                   atol=2e-5, err_msg=f"step {t}")
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy(), np.asarray(cache_r[leaf]),
                                   atol=1e-5)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(cache_r["pos"]))
    assert int(cache["step"]) == int(cache_r["step"]) == n


# ------------------------------------------------------------------ MoE
def _moe_pair(**kw):
    cfg_r, cfg = _smoke("granite-moe-1b-a400m", **kw)
    params, _ = r_common.split_tree(r_moe.init_moe(
        r_common.Initializer(jax.random.key(0), jnp.float32), cfg_r))
    port = _port_module(moe.init_moe(common.Initializer(0, torch.float32), cfg),
                        params)
    x = np.random.default_rng(0).standard_normal((2, 32, cfg.d_model)
                                                 ).astype(np.float32)
    return cfg_r, cfg, params, port, x


def test_moe_dispatch_vs_dense_high_capacity():
    """With capacity high enough to never drop, dispatch == dense, in the
    port as in the reference, and each equals the reference's."""
    cfg_r, cfg, params, port, x = _moe_pair(moe_capacity_factor=8.0,
                                            moe_group=64)
    got = {impl: moe.apply_moe(port, _t(x), dataclasses.replace(cfg, moe_impl=impl))
           for impl in ("dispatch", "dense")}
    np.testing.assert_allclose(got["dispatch"].numpy(), got["dense"].numpy(),
                               atol=1e-6)
    for impl, y in got.items():
        want = r_moe.apply_moe(params, jnp.asarray(x),
                               dataclasses.replace(cfg_r, moe_impl=impl))
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("group", [32, 16])
def test_moe_capacity_drops_match_reference(group):
    """At the default capacity factor (1.25) some (token, choice) pairs
    overflow their expert; the port drops the same ones, first come first
    served within each group, and its output equals the reference's."""
    cfg_r, cfg, params, port, x = _moe_pair(moe_group=group)
    w, idx = moe._routing(port, _t(x).reshape(-1, cfg.d_model), cfg)
    w_r, idx_r = r_moe._routing(params, jnp.asarray(x).reshape(-1, cfg.d_model),
                                cfg_r)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-6)
    cap = moe._capacity(cfg, group)
    per_expert = np.stack([np.bincount(g.ravel(), minlength=cfg.num_experts)
                           for g in idx.numpy().reshape(-1, group, 2)])
    assert (per_expert > cap).any(), "the case must drop"
    y = moe.apply_moe(port, _t(x), cfg)
    want = r_moe.apply_moe(params, jnp.asarray(x), cfg_r)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-6)


def test_moe_active_params_accounting():
    """moe_active_params counts only the per-token ACTIVE expert weights,
    as the reference's, which it equals on every MoE config."""
    cfg = configs.smoke_config("granite-moe-1b-a400m")
    base = moe.moe_active_params(cfg)
    assert base > 0
    doubled = moe.moe_active_params(
        dataclasses.replace(cfg, experts_per_token=2 * cfg.experts_per_token))
    assert doubled == base + 3 * cfg.d_model * cfg.d_ff * cfg.experts_per_token
    pool = moe.moe_active_params(
        dataclasses.replace(cfg, num_experts=2 * cfg.num_experts))
    assert pool - base == cfg.d_model * cfg.num_experts
    for arch in ("granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                 "jamba-1.5-large-398b"):
        for get in ("get_config", "smoke_config"):
            assert moe.moe_active_params(getattr(configs, get)(arch)) == \
                r_moe.moe_active_params(getattr(r_configs, get)(arch))


# ------------------------------------------------------------------ SSD
@pytest.mark.parametrize("s", [24, 21])
def test_ssd_chunked_matches_sequential(s):
    """Chunked SSD == the naive sequential recurrence in f64 (final state
    too), and == the reference's chunked SSD, at a length that fills its
    chunks and one that pads the last."""
    rng = np.random.default_rng(2)
    b, h, p_, n = 2, 3, 4, 8
    xd = rng.standard_normal((b, s, h, p_)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in "BC")
    got, state = ssm._ssd_chunked(_t(xd), _t(la), _t(Bm), _t(Cm), chunk=8)
    want = np.zeros((b, s, h, p_))
    st = np.zeros((b, h, n, p_))
    for t in range(s):
        st = st * np.exp(la[:, t].astype(np.float64))[:, :, None, None] \
            + np.einsum("bn,bhp->bhnp", Bm[:, t], xd[:, t])
        want[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], st)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), st, atol=1e-4)
    ref, ref_state = r_ssm._ssd_chunked(*map(jnp.asarray, (xd, la, Bm, Cm)), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), atol=1e-5)


def test_ssm_layer_prefill_and_decode_match_reference():
    """One SSM layer: the chunked prefill, then 12 decode steps from an
    empty state cache, against the reference's, with the causal conv and
    the caches' state and conv tail."""
    cfg_r, cfg = _smoke("mamba2-370m")
    params, _ = r_common.split_tree(r_ssm.init_ssm(
        r_common.Initializer(jax.random.key(5), jnp.float32), cfg_r))
    port = _port_module(ssm.init_ssm(common.Initializer(0, torch.float32), cfg),
                        params)
    n = 12
    x = np.random.default_rng(5).standard_normal((B, n, 64)).astype(np.float32)
    conv = np.random.default_rng(6).standard_normal((B, n, 24)).astype(np.float32)
    w = np.random.default_rng(7).standard_normal((4, 24)).astype(np.float32)
    np.testing.assert_allclose(
        ssm._causal_conv(_t(conv), _t(w)).numpy(),
        np.asarray(r_ssm._causal_conv(jnp.asarray(conv), jnp.asarray(w))),
        atol=1e-5)
    want, _ = r_ssm.apply_ssm(params, jnp.asarray(x), cfg_r)
    got, none = ssm.apply_ssm(port, _t(x), cfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    cache_r = r_ssm.init_ssm_cache(cfg_r, B, cfg_r.dtype)
    cache = kvcache.init_layer_cache(cfg, "ssm", B, n, device=CPU)
    for t in range(n):
        want, cache_r = r_ssm.apply_ssm(params, jnp.asarray(x[:, t:t + 1]), cfg_r,
                                        cache=cache_r)
        got, cache = ssm.apply_ssm(port, _t(x[:, t:t + 1]), cfg, cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    for leaf in ("state", "conv"):
        assert cache[leaf].dtype == torch.float32
        np.testing.assert_allclose(cache[leaf].numpy(), np.asarray(cache_r[leaf]),
                                   atol=1e-5)


# -------------------------------------------------------------- M-RoPE
def test_mrope_sections_and_equivalence():
    """Qwen2-VL's exact split; text-only M-RoPE (equal streams) == plain
    RoPE; and with three different streams the port == the reference."""
    assert common.mrope_sections(128) == (16, 24, 24)
    for d in (16, 32, 80, 256):
        assert common.mrope_sections(d) == r_common.mrope_sections(d)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8))
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    np.testing.assert_allclose(common.apply_mrope(_t(x), _t(pos3)).numpy(),
                               common.apply_rope(_t(x), _t(pos)).numpy(),
                               atol=1e-6)
    streams = np.stack([pos, pos // 2 + 3, 7 - pos], axis=-1)
    np.testing.assert_allclose(
        common.apply_mrope(_t(x), _t(streams), 1e6).numpy(),
        np.asarray(r_common.apply_mrope(jnp.asarray(x), jnp.asarray(streams), 1e6)),
        atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(_t(x), _t(pos3), sections=(4, 4, 4))


def test_positions_for_matches_reference():
    for arch in ("qwen2-vl-72b", "tinyllama-1.1b"):
        cfg_r, cfg = _smoke(arch)
        for offset in (0, np.array([0, 5])):
            got = common.positions_for(cfg, 2, 6, offset=torch.as_tensor(offset))
            want = r_common.positions_for(cfg_r, 2, 6, offset=offset)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- whole models, decode
DECODE_ARCHS = ["gemma3-1b", "granite-moe-1b-a400m", "mamba2-370m",
                "llama4-scout-17b-a16e", "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_parallel_forward(arch):
    """Sequential decode over the caches == the parallel forward (dense
    MoE, so capacity drops cannot differ), in the port, and both equal the
    reference's logits. At S = 24 over smoke windows of 16 the local
    layers' prefill runs local and their rings wrap."""
    cfg_r, cfg, params, model = _models(arch, moe_impl="dense")
    inp_r, inp = _inputs(cfg)
    prefill = steps.build_prefill_step(cfg)(model, inp)
    want = jax.jit(r_steps.build_prefill_step(cfg_r))(params, inp_r)
    vocab = cfg.vocab_size
    np.testing.assert_allclose(prefill.numpy()[:, :vocab],
                               np.asarray(want)[:, :vocab], atol=1e-4)
    decode = steps.build_decode_step(cfg)
    caches = kvcache.init_caches(cfg, B, S, device=CPU)
    for t in range(S):
        logits, caches = decode(model, caches,
                                {k: a[:, t:t + 1] for k, a in inp.items()},
                                torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy()[:, :vocab],
                               prefill.numpy()[:, :vocab], atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-1.5-large-398b",
                                  "mamba2-370m"])
def test_caches_after_decode_equal_reference(arch):
    """Every layer's cache after 20 decode steps — ring k/v/pos/step of
    local layers, full ones, SSM state and conv tails — equals the
    reference's, carried over by interop.caches_from_numpy."""
    cfg_r, cfg, params, model = _models(arch, moe_impl="dense")
    inp_r, inp = _inputs(cfg, seed=8)
    n = 20
    dec_r = jax.jit(r_steps.build_decode_step(cfg_r))
    dec = steps.build_decode_step(cfg)
    caches_r = r_kvcache.init_caches(cfg_r, B, n)
    caches = kvcache.init_caches(cfg, B, n, device=CPU)
    for t in range(n):
        _, caches_r = dec_r(params, caches_r,
                            {k: a[:, t:t + 1] for k, a in inp_r.items()},
                            jnp.full((B,), t, jnp.int32))
        _, caches = dec(model, caches, {k: a[:, t:t + 1] for k, a in inp.items()},
                        torch.full((B,), t, dtype=torch.int32))
    want = interop.caches_from_numpy(cfg, _np(caches_r), device=CPU)
    assert len(caches) == len(want) == cfg.num_layers
    for got, ref in zip(caches, want):
        assert set(got) == set(ref)
        for leaf in got:
            if leaf in ("pos", "step"):
                assert torch.equal(got[leaf], ref[leaf].to(got[leaf].dtype))
            else:
                np.testing.assert_allclose(got[leaf].numpy(), ref[leaf].numpy(),
                                           atol=1e-5)


# ----------------------------------------------------------- frontends
def test_encoder_frontend_prefill_matches_reference():
    """hubert: frame embeddings through the audio stub's adapter, a
    non-causal LayerNorm/GELU stack without RoPE; the port's hidden
    states and last logits equal the reference's."""
    from repro.models.lm import forward_hidden as r_forward_hidden
    from repro_torch.models.lm import forward_hidden

    cfg_r, cfg, params, model = _models("hubert-xlarge")
    assert not cfg.causal and cfg.frontend == "audio"
    inp_r, inp = _inputs(cfg)
    want, _ = r_forward_hidden(params, inp_r, cfg_r)
    got, _ = forward_hidden(model, inp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    logits = steps.build_prefill_step(cfg)(model, inp)
    want = jax.jit(r_steps.build_prefill_step(cfg_r))(params, inp_r)
    np.testing.assert_allclose(logits.numpy()[:, :cfg.vocab_size],
                               np.asarray(want)[:, :cfg.vocab_size], atol=1e-4)


def test_interop_carries_frontend_moe_and_ssm_parameters():
    """Every reference leaf lands in the port's model, by name and shape:
    the adapter in place of the table, MoE experts with their f32 router,
    SSM projections with their f32 A_log/D/dt_bias."""
    for arch in ("qwen2-vl-72b", "jamba-1.5-large-398b"):
        cfg_r, cfg, params, model = _models(arch)
        names = dict(model.named_parameters())
        assert ("embed" in names) == (cfg.frontend is None)
        flat = jax.tree_util.tree_leaves(params)
        assert sum(a.size for a in flat) == sum(p.numel() for p in names.values())
    _, _, params, model = _models("jamba-1.5-large-398b")
    layer = model.stack[1]
    assert layer.ffn.router.dtype == layer.mixer.A_log.dtype == torch.float32
    np.testing.assert_array_equal(
        layer.mixer.w_x.detach().numpy(),
        np.asarray(params["stack"]["periods"]["l1"]["mixer"]["w_x"][0]))
    tree = _np(params)
    tree["frontend"] = {"adapter": np.zeros((64, 64), np.float32)}
    with pytest.raises(ValueError, match="differ"):
        interop.lm_params_from_numpy(cfg, tree, device=CPU)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-1b", "mamba2-370m",
                                  "jamba-1.5-large-398b", "llama4-scout-17b-a16e"])
def test_cache_bytes_matches_materialized_caches(arch):
    """cache_bytes (shapes alone, no allocation) equals the bytes of the
    materialized caches — full and ring KV, SSM state and conv — and the
    reference's count; the port's steps live on the host and are left
    out of neither count."""
    cfg_r, cfg = _smoke(arch)
    est = kvcache.cache_bytes(cfg, B, 16)
    real = sum(t.numel() * t.element_size()
               for c in kvcache.init_caches(cfg, B, 16, device=CPU)
               for t in c.values())
    assert est == real == r_kvcache.cache_bytes(cfg_r, B, 16) > 0


def test_new_model_families_build_on_cpu_and_raise_without_cuda():
    """init_lm builds every family on request; without a device and
    without CUDA it raises, as for the dense models."""
    for arch in ("granite-moe-1b-a400m", "mamba2-370m", "hubert-xlarge"):
        model = init_lm(configs.smoke_config(arch), device=CPU)
        assert all(p.device.type == "cpu" for p in model.parameters())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                init_lm(configs.smoke_config(arch))
            with pytest.raises(RuntimeError, match="CUDA"):
                kvcache.init_caches(configs.smoke_config(arch), 1, 4)
