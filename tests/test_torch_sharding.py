"""The port's sharding rules, parameter and cache specs, meshes and the
sharded train step, against the reference.

Mirrors the sharding cases of tests/test_distributed.py (the head
fallback, constrain without rules, the sharded train step). Meshes here
are DeviceMeshes over a process group: a fake one (torch.testing's
FakeStore) where only the layout matters, four gloo ranks on the CPU
(spawned, over a FileStore in tmp_path) where values do. Every fixture
that starts a process group destroys it, so other files in the same
worker see none.

The sharded decode (models/attention.py's `_sharded_decode`) runs in
one spawn of four gloo ranks for four cases; its logits are held to the
unsharded port's within 1e-5 of max|logits| (the same arithmetic, the
keys' softmax merged over two ranks' partials) and to the reference's
decode step on the same weights within 1e-4, the bar of
tests/test_torch_models.py.

Tolerances: the sharded step's losses and grad norms against the
unsharded port's within 1e-5 relative, its parameters after two AdamW
steps within 1e-5 absolute (the same arithmetic, its sums split over
ranks and reduced in another order; AdamWConfig()'s first steps move a
parameter by about lr·(step / warmup) = 3e-6 a step whatever its
gradient's size, so an element whose gradient is rounding noise may move
the other way on the other layout: 1.2e-5 over two steps at most, 6e-6
at the first); the first loss against the reference's step on the same
weights (carried by interop) within 1e-5 relative, the bar of
tests/test_torch_train.py; the launcher's losses, --mesh smoke against
--mesh none, within 1e-6 relative on one rank and 1e-5 on four, and
each of their checkpoints' leaves within 1e-5 of its norm (normwise: at
lr 3e-3 a noise-level gradient's sign flip moves its element by up to
2·lr a step, which one element in 10^5 shows).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import CONFIGS as R_CONFIGS
from repro.configs import smoke_config as r_smoke
from repro.distrib.sharding import make_rules as r_make_rules
from repro.models.common import split_tree
from repro.models.lm import init_lm as r_init_lm
from repro.serve.kvcache import init_caches as r_init_caches_for_decode
from repro.serve.steps import build_decode_step as r_build_decode_step
from repro.serve.kvcache import cache_logical_specs as r_cache_specs
from repro.serve.kvcache import init_caches as r_init_caches
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import init_opt_state as r_init_opt
from repro.train.steps import build_train_step as r_build_train_step
from repro_torch import interop
from repro_torch.configs import smoke_config
from repro_torch.distrib import sharding
from repro_torch.distrib.sharding import constrain, make_rules, use_rules
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.dryrun import fake_group
from repro_torch.models.lm import init_lm, param_specs
from repro_torch.serve.kvcache import cache_logical_specs, init_caches
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import build_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
BATCH, SEQ = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fake_mesh():
    """A (2, 4) ("data", "model") mesh over a fake 8-rank group."""
    with fake_group(8):
        yield t_mesh.make_smoke_mesh((2, 4), device_type="cpu")
    assert not dist.is_initialized()


def _spec_tuples(tree):
    return jax.tree.map(lambda s: tuple(s), tree,
                        is_leaf=lambda x: isinstance(x, tuple))


# ----------------------------------------------------------- sharding rules
@pytest.mark.parametrize("heads,kv", [(8, 4), (6, 1), (16, 2), (40, 8)])
def test_rules_head_fallback(fake_mesh, heads, kv):
    """shard_heads when heads divide over the model axis, else the
    sequence-parallel fallback; each logical name resolves to the
    reference's PartitionSpec entries on the same (2, 4) mesh."""
    from repro.compat import make_mesh

    r_mesh = make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
    got = make_rules(fake_mesh, num_heads=heads, num_kv_heads=kv)
    want = r_make_rules(r_mesh, num_heads=heads, num_kv_heads=kv)
    for field in ("batch_axes", "model_axis", "fsdp_axes", "shard_heads",
                  "shard_kv", "shard_seq"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.model_size == 4
    for names in [("batch", "qseq", "heads", None), ("batch", "seq", None),
                  ("fsdp", "kv_heads", None), ("model", "fsdp"), (None,)]:
        assert got.resolve(*names) == tuple(want.resolve(*names)), names
    if heads == 6:
        assert not got.shard_heads and not got.shard_kv
        assert got.resolve("batch", "qseq", "heads", None) == (
            "data", "model", None, None)


def test_placements_follow_the_spec(fake_mesh):
    """One placement per mesh axis: Shard(d) where the axis names tensor
    dimension d, Replicate() elsewhere; an axis on two dimensions is
    refused."""
    from torch.distributed.tensor import Replicate, Shard

    rules = make_rules(fake_mesh, num_heads=8, num_kv_heads=4)
    assert rules.placements("batch", "seq", None) == (Shard(0), Shard(1))
    assert rules.placements("fsdp", "heads", None) == (Shard(0), Shard(1))
    assert rules.placements(None, None) == (Replicate(), Replicate())
    assert rules.placements("model", "fsdp") == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="shards dimensions"):
        rules.placements("seq", "model")


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x
    with use_rules(make_rules(None)):
        assert constrain(x, "batch", None) is x
    assert sharding.ShardingRules().resolve("batch", "model") == (None, None)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_rules_reach_other_threads(fake_mesh, policy):
    """The autograd engine runs a CUDA backward, and the recomputation of
    a checkpointed layer with it, on a thread of its own: a remat body
    sees there the rules active at its forward, while a plain call on
    another thread sees none."""
    import threading

    from repro_torch.models.blocks import _remat

    rules = make_rules(fake_mesh, num_heads=8, num_kv_heads=4)
    seen, stray = [], []

    def body(x):
        seen.append(sharding.current_rules())
        return torch.sin(x) @ x.T

    def on_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    x = torch.ones(4, 4, requires_grad=True)
    with use_rules(rules):
        y = _remat(body, policy)(x).sum()
        on_thread(lambda: stray.append(sharding.current_rules()))
    on_thread(y.backward)
    assert seen == [rules, rules]  # the forward and its recomputation
    assert stray == [None] and sharding.current_rules() is None
    assert x.grad is not None


def test_constrain_redistributes_under_rules(fake_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with use_rules(make_rules(fake_mesh, num_heads=8, num_kv_heads=4)):
        x = constrain(torch.ones(8, 16), "batch", "model")
        assert isinstance(x, DTensor)
        assert tuple(x.placements) == (Shard(0), Shard(1))
        y = constrain(x, "batch", None)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert constrain(y, "batch", None) is y


# ------------------------------------------------ parameter and cache specs
@pytest.mark.parametrize("arch", sorted(R_CONFIGS))
def test_param_specs_equal_reference(arch):
    """Every parameter carries the reference's logical spec from birth:
    param_specs gives the reference's split_tree specs, by its tree path,
    for every config's smoke reduction."""
    px = jax.eval_shape(lambda: r_init_lm(r_smoke(arch), jax.random.key(0)))
    want = _spec_tuples(split_tree(px)[1])
    got = param_specs(init_lm(smoke_config(arch), 0, device="meta"))
    assert got == want


@pytest.mark.parametrize("arch", sorted(a for a in R_CONFIGS
                                        if R_CONFIGS[a].causal))
def test_cache_logical_specs_equal_reference(arch):
    caches_r = jax.eval_shape(lambda: r_init_caches(r_smoke(arch), 2, 32))
    want = _spec_tuples(r_cache_specs(r_smoke(arch), caches_r))
    got = cache_logical_specs(smoke_config(arch),
                              init_caches(smoke_config(arch), 2, 32, device="meta"))
    assert got == want


# -------------------------------------------------------------------- meshes
def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        t_mesh.make_production_mesh()
    with fake_group(16):
        with pytest.raises(RuntimeError, match="needs 256 ranks, the process "
                                               "group has 16"):
            t_mesh.make_production_mesh(device_type="cpu")
    with fake_group(512):
        single = t_mesh.make_production_mesh(device_type="cpu")
        multi = t_mesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert single.mesh_dim_names == ("data", "model")
        assert tuple(single.shape) == (16, 16)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        assert tuple(multi.shape) == (2, 16, 16)


def test_smoke_mesh_rule():
    assert launch_train.smoke_mesh_shape(1) == (1, 1)
    assert launch_train.smoke_mesh_shape(2) == (1, 2)
    assert launch_train.smoke_mesh_shape(4) == (2, 2)
    assert launch_train.smoke_mesh_shape(8) == (2, 4)


# --------------------------------------------------------- sharded step
def _config(arch, heads, smoke):
    from dataclasses import replace

    cfg = smoke(arch)
    if heads is not None:
        cfg = replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
    return cfg


def _unsharded_steps(cfg):
    model = init_lm(cfg, 0, device="cpu")
    opt_cfg = AdamWConfig()
    opt = init_opt_state(model, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    data = SyntheticLM(cfg).batch(0, BATCH, SEQ)
    metrics = []
    for _ in range(2):
        model, opt, m = step(model, opt, data, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, dict(model.named_parameters())


def _reference_loss(cfg, cfg_r):
    """The reference's step loss on the port's seed-0 weights and batch."""
    tree = interop.lm_tree_from_port(cfg, init_lm(cfg, 0, device="cpu"))
    params = jax.tree.map(jnp.asarray, tree)
    opt_r = RAdamWConfig()
    data = SyntheticLM(cfg).batch(0, BATCH, SEQ)
    batch = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    _, _, m = jax.jit(r_build_train_step(cfg_r, opt_r))(
        params, r_init_opt(params, opt_r), batch, jax.random.key(0))
    return float(m["loss"])


@pytest.mark.parametrize("arch,heads", [
    (ARCH, None), (ARCH, (3, 1)), ("granite-moe-1b-a400m", None),
    ("mamba2-370m", None)], ids=["heads", "seq-fallback", "moe", "ssd"])
def test_sharded_train_step_matches_unsharded_and_reference(
        tmp_path, monkeypatch, arch, heads):
    """Four gloo ranks as a (2, 2) mesh: parameters and AdamW moments are
    DTensors; two steps give the unsharded port's losses, grad norms and
    parameters, and the first loss is the reference's on the same
    weights. The cases: heads over the model axis; 3 heads, which do not
    divide over it (sequence-parallel attention, K/V repeated and
    gathered); expert-parallel MoE; the SSD scan on each rank's heads."""
    import torch.multiprocessing as mp

    monkeypatch.syspath_prepend(str(Path(__file__).parent))
    import _torch_mesh_worker

    out = tmp_path / "rank0"
    mp.spawn(_torch_mesh_worker.run,
             args=(4, str(tmp_path / "store"), str(out), arch, BATCH, SEQ,
                   heads),
             nprocs=4)
    got = json.loads(Path(f"{out}.json").read_text())
    assert got["sharded"] and got["mesh"] == [2, 2]
    cfg = _config(arch, heads, smoke_config)
    want, params = _unsharded_steps(cfg)
    for g, w in zip(got["metrics"], want):
        for name in ("loss", "grad_norm", "lr"):
            assert g[name] == pytest.approx(w[name], rel=1e-5), name
    with np.load(f"{out}.npz") as arrays:
        for name, p in params.items():
            np.testing.assert_allclose(arrays[name], p.numpy(), atol=1.2e-5,
                                       err_msg=name)
    assert got["metrics"][0]["loss"] == pytest.approx(
        _reference_loss(cfg, _config(arch, heads, r_smoke)), rel=1e-5)


# ----------------------------------------------------------- sharded decode
#: the decode cases, one spawn for all: a full cache; 3 heads, which do
#: not divide over the model axis (the sequence-parallel fallback);
#: gemma3's sliding rings of 16 slots, driven past their window so that
#: they wrap; llama4's chunked rings (and its expert-parallel MoE)
DECODE_CASES = {"full": (ARCH, None), "seq-fallback": (ARCH, (3, 1)),
                "sliding": ("gemma3-1b", None),
                "chunked": ("llama4-scout-17b-a16e", None)}
#: batch, tokens decoded (each cache holds that many slots, so each model
#: rank of a full cache holds half: the second rank has no key for the
#: first half of the steps), the prefill's prompt
DECODE_BATCH, DECODE_STEPS, DECODE_PROMPT = 4, 20, 8


@pytest.fixture(scope="module")
def sharded_decode(tmp_path_factory):
    """Every decode case on four gloo ranks as a (2, 2) mesh, one thread
    a rank: (the logits by case and phase, rank 0's summary)."""
    import torch.multiprocessing as mp

    sys.path.insert(0, str(Path(__file__).parent))
    try:
        import _torch_mesh_worker
    finally:
        sys.path.pop(0)
    tmp = tmp_path_factory.mktemp("decode")
    out = tmp / "rank0"
    mp.spawn(_torch_mesh_worker.decode,
             args=(4, str(tmp / "store"), str(out), DECODE_CASES, DECODE_BATCH,
                   DECODE_STEPS, DECODE_PROMPT),
             nprocs=4)
    with np.load(f"{out}.npz") as arrays:
        logits = dict(arrays)
    return logits, json.loads(Path(f"{out}.json").read_text())


def _reference_decode(cfg, tokens: torch.Tensor) -> np.ndarray:
    """The reference's decode loop on the port's seed-0 weights (carried
    by interop): (steps, B, Vp) logits."""
    arch, heads = cfg
    cfg_t, cfg_r = _config(arch, heads, smoke_config), _config(arch, heads,
                                                               r_smoke)
    tree = interop.lm_tree_from_port(cfg_t, init_lm(cfg_t, 0, device="cpu"))
    params = jax.tree.map(jnp.asarray, tree)
    b, s = tokens.shape
    caches = r_init_caches_for_decode(cfg_r, b, s)
    step = jax.jit(r_build_decode_step(cfg_r))
    out = []
    for t in range(s):
        logits, caches = step(params, caches,
                              {"tokens": jnp.asarray(tokens[:, t:t + 1].numpy())},
                              jnp.full((b,), t, jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_sharded_decode_matches_unsharded_and_reference(sharded_decode, case):
    """Four gloo ranks as a (2, 2) mesh: the caches end as DTensors placed
    by CACHE_SPECS; the prefill of the prompt and every decode step's
    logits are the unsharded port's within 1e-5 of max|logits|, and the
    decode steps the reference's within 1e-4."""
    import _torch_mesh_worker as worker

    logits, summary = sharded_decode
    assert summary["mesh"] == [2, 2] and summary["placed"][case]
    arch, heads = DECODE_CASES[case]
    cfg = _config(arch, heads, smoke_config)
    v = cfg.vocab_size
    tokens = worker.decode_tokens(cfg, DECODE_BATCH, DECODE_STEPS)
    model = init_lm(cfg, 0, device="cpu")
    from repro_torch.serve.steps import build_prefill_step

    want = {"prefill": build_prefill_step(cfg)(
                model, {"tokens": tokens[:, :DECODE_PROMPT]}).numpy(),
            "decode": worker.decode_logits(cfg, model, tokens)}
    for phase, w in want.items():
        got = logits[f"{case}/{phase}"]
        assert got.shape == w.shape, phase
        scale = np.abs(w[..., :v]).max()
        np.testing.assert_allclose(got[..., :v], w[..., :v], rtol=0,
                                   atol=1e-5 * scale, err_msg=phase)
    np.testing.assert_allclose(
        logits[f"{case}/decode"][..., :v],
        _reference_decode(DECODE_CASES[case], tokens)[..., :v], atol=1e-4)


def test_sharded_decode_takes_placed_caches_only():
    """On one gloo rank as a (1, 1) mesh: the decode step under rules
    refuses caches that place_caches did not place, and with placed ones
    gives the unsharded port's logits within 1e-5 of max|logits|."""
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        import _torch_mesh_worker as worker
    finally:
        sys.path.pop(0)
    from repro_torch.distrib.sharding import make_rules, use_rules
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.serve.kvcache import init_caches, place_caches

    cfg = smoke_config(ARCH)
    tokens = worker.decode_tokens(cfg, DECODE_BATCH, 6)
    model = init_lm(cfg, 0, device="cpu")
    want = worker.decode_logits(cfg, model, tokens)
    with launch_train.process_group(torch.device("cpu")):
        mesh = make_smoke_mesh((1, 1), ("data", "model"), device_type="cpu")
        rules = make_rules(mesh, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads)
        with use_rules(rules):
            placed = launch_train.place_params(model, rules)
            with pytest.raises(ValueError, match="place_caches"):
                worker.decode_logits(cfg, placed, tokens)
            got = worker.decode_logits(cfg, placed, tokens, place_caches(
                init_caches(cfg, DECODE_BATCH, 6, device="cpu")))
    assert not dist.is_initialized()
    v = cfg.vocab_size
    np.testing.assert_allclose(got[..., :v], want[..., :v], rtol=0,
                               atol=1e-5 * np.abs(want[..., :v]).max())


# ------------------------------------------------------------- the launcher
def _losses(out: str) -> list[float]:
    line = next(x for x in out.splitlines() if x.startswith("[train] losses:"))
    return json.loads(line.split(":", 1)[1])


LAUNCH = ["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "6",
          "--batch", str(BATCH), "--seq", str(SEQ), "--lr", "3e-3"]


def test_launcher_mesh_smoke_single_rank_equals_none(tmp_path, capsys):
    """Started without torchrun, --mesh smoke runs as one rank on a (1, 1)
    mesh and trains as --mesh none does, loss for loss; the checkpoints
    both write hold the same tensors."""
    assert launch_train.main([*LAUNCH, "--mesh", "none",
                              "--ckpt", str(tmp_path / "none")]) == 0
    plain = capsys.readouterr().out
    assert launch_train.main([*LAUNCH, "--mesh", "smoke",
                              "--ckpt", str(tmp_path / "smoke")]) == 0
    sharded = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in sharded
    np.testing.assert_allclose(_losses(sharded), _losses(plain), rtol=1e-6)
    assert not dist.is_initialized()
    a = sorted((tmp_path / "none").glob("step_*/leaf_*.npy"))
    b = sorted((tmp_path / "smoke").glob("step_*/leaf_*.npy"))
    assert [p.name for p in a] == [p.name for p in b] and a
    manifest = [json.loads(p.read_text())["leaves"] for p in
                (sorted((tmp_path / d).glob("step_*/manifest.json"))[-1]
                 for d in ("none", "smoke"))]
    assert [(m["path"], m["shape"], m["dtype"]) for m in manifest[0]] == \
        [(m["path"], m["shape"], m["dtype"]) for m in manifest[1]]
    for pa, pb in zip(a, b):
        want, got = np.load(pa).astype(np.float64), np.load(pb).astype(np.float64)
        assert np.linalg.norm(got - want) <= 1e-5 * max(np.linalg.norm(want),
                                                        1e-30), pa.name


def test_launcher_mesh_smoke_on_four_gloo_ranks(tmp_path, capsys):
    """torchrun --standalone --nproc-per-node 4: a (2, 2) mesh of gloo
    ranks trains to --mesh none's losses within 1e-5 relative."""
    assert launch_train.main([*LAUNCH, "--mesh", "none",
                              "--ckpt", str(tmp_path / "none")]) == 0
    plain = _losses(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *LAUNCH,
         "--mesh", "smoke", "--ckpt", str(tmp_path / "smoke")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    assert "mesh={'data': 2, 'model': 2}" in run.stdout
    np.testing.assert_allclose(_losses(run.stdout), plain, rtol=1e-5)
