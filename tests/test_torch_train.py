"""The port's training math against the JAX package, on the CPU: the
chunked loss and its gradients, local attention's gradients, the remat
policies, the flash kernel's backward function, AdamW and one train step.

Both packages run on the reference's weights (`init_lm` on a smoke
config, float32), carried into the port by `interop.lm_params_from_numpy`;
the port's gradients go back to the reference's tree through
`interop.lm_tree_from_port`. Inputs come from numpy seeds; labels carry
−1 (masked) positions, and the CE chunk (8) is below S (32), so chunking
and the mask both run.

Tolerances (f32 throughout, sums in another order): the loss rtol 1e-5;
each gradient leaf within 1e-4 of its own max|g| (and none is zero);
remat policies 1e-6 of max|g| (the same arithmetic, recomputed); the
oracle flash_grad.flash_attention_backward bit-equal to autograd through
the plain version (it is that autograd), and FlashAttention's wiring
bit-equal to the plain versions of its forward and gradient kernels
(tests/test_torch_flash_grad.py holds those to the oracle and the
reference). AdamW: parameters 1e-6, moments 1e-6 relative
(one bf16 ulp, 2^-7, for a bf16 state). A whole train step: parameters
within 1e-5, where Adam moves each by about ±lr per step for any
gradient above eps, so an element whose gradient is rounding noise may
move the other way: lr is 1e-4 with 100 warmup steps, so that costs at
most 2·lr₂ = 4e-6.
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
from repro.models.lm import init_lm as r_init_lm
from repro.models.lm import lm_loss as r_lm_loss
from repro.train import optimizer as r_opt
from repro.train.steps import build_train_step as r_build_train_step
from repro_torch import configs, interop
from repro_torch.kernels import flash_grad, ops, ref
from repro_torch.models import attention, blocks, common
from repro_torch.models.lm import lm_loss
from repro_torch.train import optimizer, steps

CPU = "cpu"
B, S, CHUNK = 2, 32, 8
ARCHS = ["tinyllama-1.1b", "mamba2-370m", "granite-moe-1b-a400m", "hubert-xlarge"]
#: whole-model gradients of the heavy smoke configs (gemma3's local
#: layers, llama4's chunked ones): slow tier, as tests/test_models.py
#: keeps their train steps
GRAD_ARCHS = ARCHS + [pytest.param(a, marks=pytest.mark.slow)
                      for a in ("gemma3-1b", "llama4-scout-17b-a16e")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager CPU training is thousands of small ops: one intra-op thread
    runs them faster than a pool contended by the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=3, b=B, s=S):
    """(reference batch, port batch): tokens (or a stub frontend's
    embeds) and labels with two masked positions."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = tokens.copy()
    labels[0, 5] = labels[-1, s // 2 + 1] = -1
    if cfg.frontend is None:
        inputs = {"tokens": tokens}
    else:
        inputs = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    inputs["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            {k: _t(v) for k, v in inputs.items()})


def _leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


def _assert_tree_close(got: dict, want: dict, tol: float, nonzero=True,
                       exact_zero=lambda path: False):
    """Each leaf of got within tol of the max|.| of want's leaf. A leaf
    whose gradient is zero in exact arithmetic (`exact_zero(path)`) holds
    rounding noise in both packages: both must stay within tol of the
    largest leaf's max instead."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        if exact_zero(path):
            assert max(float(np.abs(w).max()),
                       float(np.abs(got[path]).max())) <= tol * top, path
            continue
        scale = float(np.abs(w).max())
        if nonzero:
            assert scale > 0, f"{path}: zero gradient"
            assert float(np.abs(got[path]).max()) > 0, f"{path}: zero in the port"
        err = float(np.abs(got[path].astype(np.float64) - w).max())
        assert err <= tol * max(scale, 1e-30), f"{path}: {err} of {scale}"


@pytest.fixture(scope="module")
def carried():
    """arch -> (cfg_r, cfg, reference params, port model, reference batch,
    port batch, reference loss, reference gradient tree), computed once
    per arch (the reference's value_and_grad jitted)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r, cfg = r_configs.smoke_config(arch), configs.smoke_config(arch)
            params, _ = r_common.split_tree(r_init_lm(cfg_r, jax.random.key(1)))
            model = interop.lm_params_from_numpy(cfg, _np(params), device=CPU)
            bj, bt = _batch(cfg)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: r_lm_loss(p, b, cfg_r, ce_chunk=CHUNK)))(params, bj)
            cache[arch] = (cfg_r, cfg, params, model, bj, bt, float(loss),
                           _np(grads))
        return cache[arch]

    return get


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(carried, arch):
    """Chunked CE with the causal shift (or per position for hubert),
    masked labels and the padded vocabulary."""
    _, cfg, _, model, _, bt, want, _ = carried(arch)
    with torch.no_grad():
        got = lm_loss(model, bt, cfg, ce_chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_lm_loss_chunk_halves_until_it_divides(carried):
    """A chunk of 12 over S = 32 halves to 3, then 1: the same loss."""
    _, cfg, _, model, _, bt, want, _ = carried("tinyllama-1.1b")
    with torch.no_grad():
        got = lm_loss(model, bt, cfg, ce_chunk=12)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_chunk_ce_masks_minus_one_without_nan():
    """Every label −1: (lse − gold)·0 stays 0 (the −1e30 sentinel, not
    −inf) and the count clamps to 1, so the loss and its gradient are 0."""
    from repro_torch.models.lm import _chunk_ce

    cfg = configs.smoke_config("tinyllama-1.1b")
    h = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    head = torch.randn(cfg.d_model, 2048, requires_grad=True)
    loss = _chunk_ce(h, torch.full((2, 8), -1), head, cfg, 4)
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert torch.isfinite(head.grad).all() and float(head.grad.abs().max()) == 0


# -------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(carried, arch):
    """The port's gradient of every parameter, mapped back into the
    reference's tree, against jax.grad(lm_loss). With top-1 routing
    (llama4) the renormalised expert weight is 1 whatever the router
    says, so the router's gradient is zero in exact arithmetic."""
    _, cfg, _, model, _, bt, want_loss, want = carried(arch)
    loss, grads = steps.loss_and_grads(model, bt, cfg, ce_chunk=CHUNK)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_tree_close(
        interop.lm_tree_from_port(cfg, grads), want, 1e-4,
        exact_zero=lambda path: cfg.experts_per_token == 1 and "router" in path)
    # the model's own parameters stay frozen
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("s,kind", [(64, "sliding"), (40, "sliding"),
                                    (64, "chunked"), (40, "chunked")])
def test_local_attention_layer_gradients_match_reference(s, kind):
    """gemma3's sliding and llama4's chunked layer (window 16 < S): the
    gradients of ⟨out, w⟩ with respect to x and every weight against the
    reference's attention layer."""
    cfg_r, cfg = r_configs.smoke_config("gemma3-1b"), configs.smoke_config("gemma3-1b")
    params, _ = r_common.split_tree(r_attention.init_attention(
        r_common.Initializer(jax.random.key(4), jnp.float32), cfg_r))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (B, s)).astype(np.int32)

    def objective(p, xx):
        out, _ = r_attention.attention(p, xx, cfg_r, jnp.asarray(pos), kind=kind)
        return jnp.sum(out * jnp.asarray(w))

    want_p, want_x = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        params, jnp.asarray(x))
    port = attention.init_attention(common.Initializer(0, torch.float32), cfg)
    with torch.no_grad():
        for name, param in port.named_parameters():
            param.copy_(_t(params[name]))
            param.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    out, _ = attention.attention(port, xt, cfg, _t(pos), kind=kind)
    torch.sum(out * _t(w)).backward()
    got = {name: p.grad.numpy() for name, p in port.named_parameters()}
    _assert_tree_close({"p": got, "x": xt.grad.numpy()},
                       {"p": _np(want_p), "x": np.asarray(want_x)}, 1e-4)


# ------------------------------------------------------------------- remat
def _count_layers(monkeypatch):
    calls = {"n": 0}
    real = blocks.apply_layer

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(blocks, "apply_layer", counting)
    return calls


def test_remat_policies_give_the_same_gradients(monkeypatch):
    """gemma3's smoke stack (2 periods of 6 layers and 1 remainder layer):
    "nothing", "dots" and "none" give the same gradients; with a
    checkpoint each period's 6 layers run again in the backward, the
    remainder layer does not (13 + 12 layer calls against 13)."""
    cfg = configs.smoke_config("gemma3-1b")
    params, _ = r_common.split_tree(
        r_init_lm(r_configs.smoke_config("gemma3-1b"), jax.random.key(2)))
    model = interop.lm_params_from_numpy(cfg, _np(params), device=CPU)
    _, bt = _batch(cfg, seed=5)
    calls = _count_layers(monkeypatch)
    grads, counts = {}, {}
    for policy in ("none", "nothing", "dots"):
        calls["n"] = 0
        _, grads[policy] = steps.loss_and_grads(
            model, bt, dataclasses.replace(cfg, remat=policy), ce_chunk=CHUNK)
        counts[policy] = calls["n"]
    assert counts == {"none": 13, "nothing": 25, "dots": 25}
    base = interop.lm_tree_from_port(cfg, grads["none"])
    for policy in ("nothing", "dots"):
        _assert_tree_close(interop.lm_tree_from_port(cfg, grads[policy]), base, 1e-6)


def test_remat_is_off_without_grad_and_for_decode(monkeypatch):
    """Under no_grad (serving) every layer runs once whatever the policy;
    an unknown policy raises."""
    cfg = configs.smoke_config("tinyllama-1.1b")
    from repro_torch.models.lm import forward_hidden, init_lm

    model = init_lm(cfg, 0, device=CPU)
    calls = _count_layers(monkeypatch)
    with torch.no_grad():
        forward_hidden(model, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                       cfg, remat_policy="nothing")
    assert calls["n"] == cfg.num_layers
    with pytest.raises(ValueError, match="remat"):
        forward_hidden(model, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                       cfg, remat_policy="everything")


# ------------------------------------------------------ the B6 backward
FLASH_CASES = {
    "gqa causal": ((2, 4, 2, 24, 24, 16), {"causal": True}),
    "window": ((1, 4, 1, 30, 30, 16), {"causal": True, "window": 5}),
    "non-causal": ((2, 2, 2, 20, 20, 8), {"causal": False}),
    "scale": ((1, 4, 2, 16, 16, 16), {"causal": True, "scale": 0.3}),
    "right-aligned rows": ((1, 4, 2, 6, 20, 16), {"causal": True}),
}


def _qkv(b, hq, hkv, sq, sk, d, seed=0):
    """q, k, v as the model passes them: (B, H, S, D) views of (B, S, H, D)
    tensors (strided), and a grad_out of the same layout."""
    rng = np.random.default_rng(seed)

    def draw(h, s):
        return _t(rng.standard_normal((b, s, h, d)).astype(np.float32)).transpose(1, 2)

    return draw(hq, sq), draw(hkv, sk), draw(hkv, sk), draw(hq, sq)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_is_autograd_of_the_plain_version(case):
    shape, kw = FLASH_CASES[case]
    q, k, v, g = _qkv(*shape)
    got = flash_grad.flash_attention_backward(q, k, v, g, kw.get("causal", True),
                                              kw.get("window"), kw.get("scale"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw), leaves, g)
    for a, b_, t in zip(got, want, (q, k, v)):
        assert a.shape == t.shape
        assert torch.equal(a, b_)


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_autograd_function_wiring(monkeypatch, case):
    """FlashAttention with its CUDA forward and backward replaced by their
    plain versions (the wiring is all that runs here): the forward's
    value, the gradients for q, k and v that the plain version of the
    gradient kernels gives on the saved operands, output and lse, none
    for the mask arguments, and one backward call counted."""
    monkeypatch.setattr(flash_grad, "flash_attention_lse_cuda",
                        ref.flash_attention_lse_ref)
    monkeypatch.setattr(flash_grad, "flash_attention_backward_cuda",
                        ref.flash_attention_backward_ref)
    shape, kw = FLASH_CASES[case]
    q, k, v, g = _qkv(*shape, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_grad.FlashAttention.apply(*leaves, kw.get("causal", True),
                                          kw.get("window"), kw.get("scale"))
    assert out.grad_fn is not None
    ops.reset_launches()
    got = torch.autograd.grad(out, leaves, g)
    assert ops.LAUNCHES["flash_attention_backward"] == 1
    ops.reset_launches()
    want_out, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    want = ref.flash_attention_backward_ref(q, k, v, want_out, lse, g, **kw)
    assert torch.equal(out.detach(), want_out)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def test_cpu_train_step_launches_no_kernel(carried):
    """On the CPU the loss, its gradients and the update run the plain
    versions: no kernel launch is counted."""
    _, cfg, _, model, _, bt, _, _ = carried("tinyllama-1.1b")
    ops.reset_launches()
    step = steps.build_train_step(cfg, optimizer.AdamWConfig())
    step(model, optimizer.init_opt_state(model, optimizer.AdamWConfig()), bt)
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES


# ------------------------------------------------------------------ AdamW
def _toy(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(dtype),
            "b": rng.standard_normal(5).astype(dtype)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    """Three updates with clipping active (grad norm above clip_norm) and
    weight decay, from the same parameters and gradients."""
    kw = dict(lr=0.05, clip_norm=0.5, warmup_steps=2, total_steps=10)
    cfg_r = r_opt.AdamWConfig(**kw, state_dtype=getattr(jnp, state_dtype))
    cfg = optimizer.AdamWConfig(**kw, state_dtype=getattr(torch, state_dtype))
    p_np = _toy(0)
    p_r = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = {k: _t(v) for k, v in p_np.items()}
    st_r, st = r_opt.init_opt_state(p_r, cfg_r), optimizer.init_opt_state(p, cfg)
    for i in range(3):
        g_np = {k: 3 * v for k, v in _toy(10 + i).items()}
        p_r, st_r, m_r = r_opt.adamw_update(
            p_r, {k: jnp.asarray(v) for k, v in g_np.items()}, st_r, cfg_r)
        p, st, m = optimizer.adamw_update(p, {k: _t(v) for k, v in g_np.items()},
                                          st, cfg)
        assert float(m_r["grad_norm"]) > cfg.clip_norm
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_r["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(m_r["lr"]), rtol=1e-6)
        rtol = 2.0 ** -7 if state_dtype == "bfloat16" else 1e-6
        for k in p_np:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(p_r[k]), atol=1e-6)
            for moment in ("mu", "nu"):
                assert st[moment][k].dtype == getattr(torch, state_dtype)
                np.testing.assert_allclose(
                    st[moment][k].float().numpy(),
                    np.asarray(st_r[moment][k], dtype=np.float32), rtol=rtol,
                    atol=1e-12)
        assert int(st["step"]) == int(st_r["step"]) == i + 1


def test_adamw_matches_numpy_reference_impl():
    """Mirror of the reference's numpy AdamW check: one step, no decay,
    no clipping, no warmup."""
    cfg = optimizer.AdamWConfig(lr=0.1, beta1=0.9, beta2=0.999, eps=1e-8,
                                weight_decay=0.0, clip_norm=1e9, warmup_steps=0,
                                total_steps=10**9)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    p1, _, _ = optimizer.adamw_update(p, g, optimizer.init_opt_state(p, cfg), cfg)
    gn = g["w"].numpy()
    mhat, vhat = 0.1 * gn / (1 - 0.9), 0.001 * gn ** 2 / (1 - 0.999)
    lr = float(optimizer.schedule(cfg, 1.0))
    want = p["w"].numpy() - lr * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(p1["w"].numpy(), want, rtol=1e-5)
    # out of place: the inputs are as they were
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0, 3.0]))


def test_grad_clipping_and_norm():
    cfg = optimizer.AdamWConfig(clip_norm=0.5)
    g = {"w": torch.tensor([30.0, 40.0])}
    assert float(optimizer.global_norm(g)) == pytest.approx(50.0)
    p = {"w": torch.zeros(2)}
    _, _, metrics = optimizer.adamw_update(p, g, optimizer.init_opt_state(p, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(50.0)


@pytest.mark.parametrize("step", [0.0, 1.0, 5.0, 10.0, 37.0, 110.0, 500.0])
def test_schedule_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=110)
    got = float(optimizer.schedule(optimizer.AdamWConfig(**kw), step))
    want = float(r_opt.schedule(r_opt.AdamWConfig(**kw), jnp.asarray(step, jnp.float32)))
    assert got == pytest.approx(want, rel=1e-6)


def test_schedule_warmup_and_decay():
    cfg = optimizer.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(optimizer.schedule(cfg, 5.0)) == pytest.approx(0.5)
    assert float(optimizer.schedule(cfg, 10.0)) == pytest.approx(1.0)
    assert float(optimizer.schedule(cfg, 110.0)) == pytest.approx(0.1, rel=1e-3)


def test_bf16_state_dtype():
    cfg = optimizer.AdamWConfig(state_dtype=torch.bfloat16)
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = optimizer.init_opt_state(p, cfg)
    assert st["mu"]["w"].dtype == torch.bfloat16
    p2, st2, _ = optimizer.adamw_update(p, {"w": torch.ones(4, dtype=torch.bfloat16)},
                                        st, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert st2["nu"]["w"].dtype == torch.bfloat16


# ------------------------------------------------------------- train step
def test_train_step_matches_reference(carried):
    """tinyllama smoke: one reference step gives both packages the same
    non-trivial state (the reference's moments and step carried across by
    interop.opt_state_from_numpy); the next step's loss, grad norm, lr,
    parameters and moments agree."""
    cfg_r, cfg, params, _, bj, bt, _, _ = carried("tinyllama-1.1b")
    kw = dict(lr=1e-4, warmup_steps=100)
    opt_r = r_opt.AdamWConfig(**kw)
    step_r = jax.jit(r_build_train_step(cfg_r, opt_r, ce_chunk=CHUNK))
    p1, o1, _ = step_r(params, r_opt.init_opt_state(params, opt_r), bj,
                       jax.random.key(0))
    p2, o2, m2 = step_r(p1, o1, bj, jax.random.key(1))
    model = interop.lm_params_from_numpy(cfg, _np(p1), device=CPU)
    opt = interop.opt_state_from_numpy(cfg, _np(o1), model)
    step = steps.build_train_step(cfg, optimizer.AdamWConfig(**kw), ce_chunk=CHUNK)
    new, new_opt, m = step(model, opt, bt, 1)
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[name]), float(m2[name]), rtol=1e-5,
                                   err_msg=name)
    got = _leaves(interop.lm_tree_from_port(cfg, new))
    for path, want in _leaves(_np(p2)).items():
        np.testing.assert_allclose(got[path], want, atol=1e-5, err_msg=path)
    for moment in ("mu", "nu"):
        _assert_tree_close(interop.lm_tree_from_port(cfg, new_opt[moment]),
                           _np(o2[moment]), 1e-4, nonzero=False)
    assert int(new_opt["step"]) == int(o2["step"]) == 2
    # the step is out of place: the model it was given is unchanged
    np.testing.assert_array_equal(model.lm_head.numpy(), np.asarray(p1["lm_head"]))


def test_sdc_check_in_train_step():
    """Mirror of the reference's SDC-in-step test: an honest head passes."""
    from repro_torch.models.lm import init_lm
    from repro_torch.train.data import SyntheticLM

    cfg = configs.smoke_config("tinyllama-1.1b")
    model = init_lm(cfg, 0, device=CPU)
    opt_cfg = optimizer.AdamWConfig()
    step = steps.build_train_step(cfg, opt_cfg, sdc_check=True)
    batch = SyntheticLM(cfg).batch(0, 4, 128)
    _, _, metrics = step(model, optimizer.init_opt_state(model, opt_cfg), batch,
                         torch.Generator().manual_seed(1))
    assert float(metrics["sdc_residual"]) < 1e-3


# ---------------------------------------------------- accumulation, learning
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_equivalence(arch):
    """Mirror of the reference's test: grad_accum=2 matches accum=1 on the
    same global batch (MoE capacity 8.0, so that no token drops in either)."""
    cfg1 = configs.smoke_config(arch)
    if cfg1.num_experts:
        cfg1 = dataclasses.replace(cfg1, moe_capacity_factor=8.0)
    cfg2 = dataclasses.replace(cfg1, grad_accum=2)
    from repro_torch.models.lm import init_lm

    model = init_lm(cfg1, 0, device=CPU)
    opt_cfg = optimizer.AdamWConfig(lr=1e-3)
    opt = optimizer.init_opt_state(model, opt_cfg)
    _, batch = _batch(cfg1, seed=3, b=4, s=16)
    p1, _, m1 = steps.build_train_step(cfg1, opt_cfg)(model, opt, batch)
    p2, _, m2 = steps.build_train_step(cfg2, opt_cfg)(model, opt, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-5)
    for (name, a), (_, b_) in zip(p1.named_parameters(), p2.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_learns(arch):
    """Mirror of the reference's smoke train step: a finite loss, changed
    parameters, and a loss that falls over 5 steps on a repeated batch."""
    from repro_torch.models.lm import init_lm

    cfg = configs.smoke_config(arch)
    model = init_lm(cfg, 0, device=CPU)
    opt_cfg = optimizer.AdamWConfig(lr=1e-3)
    opt = optimizer.init_opt_state(model, opt_cfg)
    step = steps.build_train_step(cfg, opt_cfg)
    _, batch = _batch(cfg, seed=2)
    p, o, losses = model, opt, []
    for i in range(5):
        p, o, m = step(p, o, batch, i)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    first = next(iter(model.parameters()))
    assert not torch.allclose(first, next(iter(p.parameters())))
