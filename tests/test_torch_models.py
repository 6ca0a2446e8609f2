"""The port's LM serving path against the JAX package, on the CPU.

The reference's weights (`init_lm` on `smoke_config("tinyllama-1.1b")`,
float32) are carried into the port with `interop.lm_params_from_numpy`,
so both packages compute on identical weights and inputs.

Tolerances: layer-level functions within 1e-5 (f32 on values of order
one, summed in another order), prefill and decode logits within 1e-4
(the same through two layers and the lm_head; the logits are of order
0.5), caches k/v within 1e-5 and pos/step exactly. Configs, counts and
the Markov table are compared exactly.
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
from repro.models import mlp as r_mlp
from repro.models.lm import forward_hidden as r_forward_hidden
from repro.models.lm import init_lm as r_init_lm
from repro.models.lm import padded_vocab as r_padded_vocab
from repro.serve import kvcache as r_kvcache
from repro.serve import steps as r_steps
from repro.train import data as r_data
from repro_torch import configs, interop
from repro_torch.kernels import ops
from repro_torch.models import attention, common, mlp
from repro_torch.models.lm import forward_hidden, init_lm, padded_vocab
from repro_torch.serve import kvcache, steps
from repro_torch.train import data

ARCH = "tinyllama-1.1b"
B, S = 2, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    return r_configs.smoke_config(ARCH), configs.smoke_config(ARCH)


@pytest.fixture(scope="module")
def weights(cfgs):
    """(reference params, the port's model) on identical weights."""
    cfg_r, cfg = cfgs
    params, _ = r_common.split_tree(r_init_lm(cfg_r, jax.random.key(1)))
    return params, interop.lm_params_from_numpy(cfg, _np(params), device="cpu")


@pytest.fixture(scope="module")
def tokens(cfgs):
    rng = np.random.default_rng(3)
    return rng.integers(0, cfgs[1].vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def decoded(cfgs, weights, tokens):
    """Both packages' decode loops over the same S tokens: (reference
    logits, reference caches, port logits, port caches)."""
    cfg_r, cfg = cfgs
    params, model = weights
    dec_r = jax.jit(r_steps.build_decode_step(cfg_r))
    dec = steps.build_decode_step(cfg)
    caches_r = r_kvcache.init_caches(cfg_r, B, S)
    caches = kvcache.init_caches(cfg, B, S, device="cpu")
    for t in range(S):
        logits_r, caches_r = dec_r(params, caches_r,
                                   {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                                   jnp.full((B,), t, jnp.int32))
        logits, caches = dec(model, caches,
                             {"tokens": torch.from_numpy(tokens[:, t:t + 1])},
                             torch.full((B,), t, dtype=torch.int32))
    return np.asarray(logits_r), caches_r, logits.numpy(), caches


def _vocab(cfg, logits):
    return np.asarray(logits)[..., :cfg.vocab_size]


# ------------------------------------------------------------- layers
def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(r_common.rms_norm(jnp.asarray(x), jnp.asarray(g))), atol=1e-5)
    np.testing.assert_allclose(
        common.layer_norm(*map(torch.from_numpy, (x, g, b))).numpy(),
        np.asarray(r_common.layer_norm(*map(jnp.asarray, (x, g, b)))), atol=1e-5)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = np.arange(8)[None] + np.array([[0], [100]])
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=1e-5)


def _port_module(module, tree):
    """Load a reference parameter dict into a port module."""
    with torch.no_grad():
        for name, param in module.named_parameters():
            param.copy_(torch.from_numpy(np.array(tree[name])))
    return module


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_reference(cfgs, mlp_type):
    cfg_r = dataclasses.replace(cfgs[0], mlp_type=mlp_type)
    cfg = dataclasses.replace(cfgs[1], mlp_type=mlp_type)
    params, _ = r_common.split_tree(
        r_mlp.init_mlp(r_common.Initializer(jax.random.key(2), jnp.float32), cfg_r))
    port = _port_module(mlp.init_mlp(common.Initializer(0, torch.float32), cfg),
                        params)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(
        mlp.apply_mlp(port, torch.from_numpy(x), cfg).numpy(),
        np.asarray(r_mlp.apply_mlp(params, jnp.asarray(x), cfg_r)), atol=1e-5)


def test_attention_layer_prefill_and_decode_match_reference(cfgs):
    """Prefill over 12 tokens, then 12 decode steps from an empty cache
    (the reference merges each step's delta with merge_cache_updates, the
    port writes in place)."""
    cfg_r, cfg = cfgs
    params, _ = r_common.split_tree(r_attention.init_attention(
        r_common.Initializer(jax.random.key(4), jnp.float32), cfg_r))
    port = _port_module(
        attention.init_attention(common.Initializer(0, torch.float32), cfg), params)
    n = 12
    x = np.random.default_rng(4).standard_normal((B, n, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (B, n)).astype(np.int32)
    want, _ = r_attention.attention(params, jnp.asarray(x), cfg_r, jnp.asarray(pos))
    got, none = attention.attention(port, torch.from_numpy(x), cfg,
                                    torch.from_numpy(pos))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    cache_r = r_kvcache.init_layer_cache(cfg_r, "attn_full", B, n)
    cache = kvcache.init_layer_cache(cfg, "attn_full", B, n, device="cpu")
    for t in range(n):
        xt, pt = x[:, t:t + 1], pos[:, t:t + 1]
        want, delta = r_attention.attention(params, jnp.asarray(xt), cfg_r,
                                            jnp.asarray(pt), cache=cache_r)
        cache_r = r_kvcache.merge_cache_updates(
            {"s": {"l": cache_r}}, {"s": {"l": delta}})["s"]["l"]
        got, cache = attention.attention(port, torch.from_numpy(xt), cfg,
                                         torch.from_numpy(pt), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache[leaf].numpy(), np.asarray(cache_r[leaf]),
                                   atol=1e-5)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(cache_r["pos"]))
    assert int(cache["step"]) == int(cache_r["step"]) == n


def test_mask_matches_reference():
    qpos, kpos = np.arange(6)[None] + 3, np.array([-1, 0, 2, 4, 5, 8, 9])
    for kw in ({"causal": True, "window": None, "chunk": None},
               {"causal": True, "window": 3, "chunk": None},
               {"causal": False, "window": None, "chunk": 4}):
        np.testing.assert_array_equal(
            attention._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), **kw).numpy(),
            np.asarray(r_attention._mask(jnp.asarray(qpos), jnp.asarray(kpos), **kw)))


# -------------------------------------------------------- whole model
def test_forward_hidden_matches_reference(cfgs, weights, tokens):
    cfg_r, cfg = cfgs
    params, model = weights
    want, _ = r_forward_hidden(params, {"tokens": jnp.asarray(tokens)}, cfg_r)
    got, _ = forward_hidden(model, {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_prefill_logits_match_reference(cfgs, weights, tokens):
    cfg_r, cfg = cfgs
    params, model = weights
    want = jax.jit(r_steps.build_prefill_step(cfg_r))(
        params, {"tokens": jnp.asarray(tokens)})
    got = steps.build_prefill_step(cfg)(model, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_vocab(cfg, got), _vocab(cfg, want), atol=1e-4)
    assert (got[:, cfg.vocab_size:] == -1e30).all()


def test_decode_loop_logits_match_reference_and_prefill(cfgs, weights, tokens,
                                                       decoded):
    cfg_r, cfg = cfgs
    logits_r, _, logits, _ = decoded
    np.testing.assert_allclose(_vocab(cfg, logits), _vocab(cfg, logits_r),
                               atol=1e-4)
    prefill = steps.build_prefill_step(cfg)(
        weights[1], {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_vocab(cfg, logits), _vocab(cfg, prefill),
                               atol=1e-4)


def test_caches_after_decode_equal_reference(cfgs, decoded):
    """k/v within 1e-5, pos and step exactly, in every layer; the
    reference's stacked tree is unstacked by interop.caches_from_numpy."""
    _, cfg = cfgs
    _, caches_r, _, caches = decoded
    want = interop.caches_from_numpy(cfg, _np(caches_r), device="cpu")
    assert len(caches) == len(want) == cfg.num_layers
    for got, ref in zip(caches, want):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(got[leaf].numpy(), ref[leaf].numpy(),
                                       atol=1e-5)
        assert torch.equal(got["pos"], ref["pos"])
        assert int(got["step"]) == int(ref["step"]) == S


def test_greedy_generate_matches_reference(cfgs, weights, tokens):
    """Tokens equal wherever the reference's top-2 logit margin exceeds
    the logits' agreement (1e-4): at a first differing column, the
    reference's own margin there must be below it."""
    cfg_r, cfg = cfgs
    params, model = weights
    prompt, gen = tokens[:, :6], 10
    want = np.asarray(r_steps.greedy_generate(cfg_r, params, jnp.asarray(prompt), gen))
    got = steps.greedy_generate(cfg, model, torch.from_numpy(prompt), gen).numpy()
    assert got.shape == want.shape == (B, 6 + gen)
    np.testing.assert_array_equal(got[:, :6], prompt)
    differ = np.nonzero((got != want).any(axis=0))[0]
    if differ.size:
        j = int(differ[0])
        logits = _vocab(cfg, jax.jit(r_steps.build_prefill_step(cfg_r))(
            params, {"tokens": jnp.asarray(want[:, :j])}))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        rows = (got[:, j] != want[:, j])
        assert (top2[rows, 1] - top2[rows, 0] < 1e-4).all(), (j, top2)


def test_decode_past_the_cache_raises(cfgs, weights):
    cfg = cfgs[1]
    caches = kvcache.init_caches(cfg, 1, 2, device="cpu")
    dec = steps.build_decode_step(cfg)
    for t in range(2):
        dec(weights[1], caches, {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
            torch.full((1,), t, dtype=torch.int32))
    with pytest.raises(ValueError, match="full"):
        dec(weights[1], caches, {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
            torch.full((1,), 2, dtype=torch.int32))


def test_cpu_path_launches_no_kernel(cfgs, weights, tokens):
    ops.reset_launches()
    steps.build_prefill_step(cfgs[1])(weights[1],
                                      {"tokens": torch.from_numpy(tokens)})
    assert ops.LAUNCHES["flash_attention"] == 0


# ------------------------------------------------------ configs, data
def _dtype_names(cfg):
    return [str(d).replace("torch.", "").replace("dtype(", "").strip("')")
            for d in (cfg.dtype, cfg.param_dtype, cfg.opt_dtype)]


@pytest.mark.parametrize("arch", list(r_configs.CONFIGS))
def test_configs_and_counts_equal_reference(arch):
    assert list(configs.CONFIGS) == list(r_configs.CONFIGS)
    for get in ("get_config", "smoke_config"):
        want = getattr(r_configs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert _dtype_names(got) == [np.dtype(d).name for d in
                                     (want.dtype, want.param_dtype, want.opt_dtype)]
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.layer_list() == want.layer_list()
        assert padded_vocab(got) == r_padded_vocab(want)
        assert configs.runnable_cells(got) == r_configs.runnable_cells(want)
        for shape in configs.SHAPES:
            assert configs.cell_status(got, shape) == r_configs.cell_status(want, shape)
        assert kvcache.cache_bytes(got, 2, 64) == r_kvcache.cache_bytes(want, 2, 64)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in r_configs.SHAPES.items()}


def test_init_caches_match_reference_layout(cfgs):
    """Same leaves and per-layer shapes as the reference's tree, unstacked."""
    cfg_r, cfg = cfgs
    want = interop.caches_from_numpy(cfg, _np(r_kvcache.init_caches(cfg_r, B, 16)),
                                     device="cpu")
    got = kvcache.init_caches(cfg, B, 16, device="cpu")
    for g, w in zip(got, want):
        assert set(g) == {"k", "v", "pos", "step"}
        for leaf in g:
            assert g[leaf].shape == w[leaf].shape and g[leaf].dtype == w[leaf].dtype
            assert torch.equal(g[leaf], w[leaf])


def test_init_caches_without_device_use_cuda_or_raise(cfgs):
    """Like init_lm, the caches go to the CUDA device when no device is
    given, and without one they raise rather than land on the CPU."""
    cfg = cfgs[1]
    if torch.cuda.is_available():
        caches = kvcache.init_caches(cfg, B, 8)
        assert all(c["k"].is_cuda and c["pos"].is_cuda for c in caches)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.init_caches(cfg, B, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.init_layer_cache(cfg, "attn_full", B, 8)


def test_synthetic_markov_table_bit_equal_to_reference(cfgs):
    cfg_r, cfg = cfgs
    np.testing.assert_array_equal(data._markov_logits(32000, 5),
                                  r_data._markov_logits(32000, 5))
    src = data.SyntheticLM(cfg, seed=5)
    np.testing.assert_array_equal(src.nexts, np.asarray(r_data.SyntheticLM(cfg_r, seed=5).nexts))
    toks = src.batch(3, 4, 40)["tokens"].numpy()
    assert toks.dtype == np.int32 and toks.shape == (4, 40)
    for t in range(1, 40):  # every step follows the table
        assert all(toks[b, t] in src.nexts[toks[b, t - 1]] for b in range(4))
    np.testing.assert_array_equal(toks, src.batch(3, 4, 40)["tokens"].numpy())
    assert not np.array_equal(toks, src.batch(4, 4, 40)["tokens"].numpy())


def test_interop_checks_shapes(cfgs, weights):
    tree = _np(weights[0])
    tree["lm_head"] = tree["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        interop.lm_params_from_numpy(cfgs[1], tree, device="cpu")


def test_launcher_runs_on_cpu_on_request(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] tinyllama-1.1b-smoke: batch=2 prompt=4 generated=4" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke"])
