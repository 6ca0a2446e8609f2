"""The port's training infrastructure on the CPU: checkpoints (atomic,
verified, garbage-collected, restorable onto a device, bf16 leaves as
their bits with the reference's hashes), the data pipeline, the
fault-tolerant loop (resume, fresh against resumed, straggler and SDC
gates), Freivalds SDC checks, the eval step and the launcher.

Mirrors tests/test_train_infra.py and the SDC cases of
tests/test_distributed.py. The straggler case runs on a fake clock put
into repro_torch.train.loop, so its verdict does not depend on the
host's load. Equality is exact where the port replays the same
arithmetic (restores, fresh against resumed runs, rejected steps).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch import configs
from repro_torch.core import sdc
from repro_torch.launch import train as launch_train
from repro_torch.models.lm import init_lm
from repro_torch.train import loop as loop_mod
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.steps import build_eval_step, build_train_step

CPU = "cpu"
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager CPU training is thousands of small ops: one intra-op thread
    runs them faster than a pool contended by the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_state():
    return {"params": {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, torch.nn.Module):
        for (n, x), (m, y) in zip(a.named_parameters(), b.named_parameters()):
            assert n == m and x.dtype == y.dtype and torch.equal(x, y), n
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    st = _tiny_state()
    for step in (10, 20, 30):
        mgr.save(step, st, blocking=True)
    assert mgr.all_steps() == [20, 30]  # oldest pruned
    restored, at = mgr.restore(st)
    assert at == 30
    _equal_trees(restored, st)
    assert len(mgr.write_seconds) == 3


def test_checkpoint_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, _tiny_state())
    mgr.wait()
    assert mgr.latest_step() == 3
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert [m["path"] for m in manifest["leaves"]] == ["opt/step", "params/a",
                                                       "params/b"]


def test_checkpoint_integrity_detection(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = _tiny_state()
    mgr.save(5, st, blocking=True)
    leaf = next(Path(tmp_path).glob("step_*/leaf_000001.npy"))
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(st)


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    """A tmp dir left by a 'crashed' writer is never listed."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tiny_state(), blocking=True)
    (Path(tmp_path) / "step_000000099.tmp-1234").mkdir()
    assert mgr.all_steps() == [1]


def test_restore_onto_a_device(tmp_path):
    """The port's counterpart of the reference's restore_sharded: leaves
    land on the device asked for, whatever the template's device, in the
    template's dtype."""
    mgr = CheckpointManager(tmp_path)
    st = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, st, blocking=True)
    template = {"w": torch.empty((4, 4), dtype=torch.float64, device="meta")}
    placed, _ = mgr.restore(template, device=CPU)
    assert placed["w"].device.type == CPU and placed["w"].dtype == torch.float64
    np.testing.assert_array_equal(placed["w"].numpy(), st["w"].numpy())
    with pytest.raises(ValueError, match="stored"):
        mgr.restore({"w": torch.empty((2, 8), device="meta")}, device=CPU)


def test_bf16_leaf_bit_equal_with_the_reference_hash(tmp_path):
    """A bf16 leaf round-trips bit for bit, and its manifest names
    bfloat16 with the hash the reference writes for the same values."""
    vals = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(1, {"w": t}, blocking=True)
    RefCheckpointManager(tmp_path / "ref").save(
        1, {"w": jnp.asarray(vals, jnp.bfloat16)}, blocking=True)
    ours, theirs = (json.loads((tmp_path / d / "step_000000001" / "manifest.json")
                               .read_text())["leaves"][0] for d in ("port", "ref"))
    assert ours["dtype"] == theirs["dtype"] == "bfloat16"
    assert ours["sha"] == theirs["sha"]
    restored, _ = mgr.restore({"w": torch.empty((3, 5), dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), t.view(torch.int16))


def test_model_and_optimizer_state_roundtrip(tmp_path):
    """A model (its named parameters) and its AdamW state, bf16 params
    and state included, come back equal and as a model."""
    import dataclasses

    cfg = dataclasses.replace(configs.smoke_config(ARCH), params_dtype="bfloat16")
    model = init_lm(cfg, 0, device=CPU)
    opt = init_opt_state(model, AdamWConfig(state_dtype=torch.bfloat16))
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, {"params": model, "opt": opt}, blocking=True)
    restored, at = mgr.restore({"params": init_lm(cfg, 1, device=CPU), "opt": opt})
    assert at == 4 and type(restored["params"]) is type(model)
    _equal_trees(restored, {"params": model, "opt": opt})


# ----------------------------------------------------------------------- data
def test_data_determinism_and_sharding():
    cfg = configs.smoke_config(ARCH)
    d1, d2 = SyntheticLM(cfg, seed=1), SyntheticLM(cfg, seed=1)
    b1 = d1.batch(5, 8, 16)
    assert torch.equal(b1["tokens"], d2.batch(5, 8, 16)["tokens"])
    assert not torch.equal(d1.batch(6, 8, 16)["tokens"], b1["tokens"])
    shards = [d1.shard_batch(5, 8, 16, i, 4)["tokens"] for i in range(4)]
    assert torch.equal(torch.cat(shards), b1["tokens"])
    toks = b1["tokens"].numpy()
    for row in toks:
        for t in range(len(row) - 1):
            assert row[t + 1] in d1.nexts[row[t]]


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-72b"])
def test_frontend_embeds(arch):
    """A stub frontend's batch: f32 unit normals (B, S, d) in place of
    tokens, the tokens as labels, a function of (seed, step); shards cut
    both."""
    cfg = configs.smoke_config(arch)
    data = SyntheticLM(cfg, seed=2)
    b = data.batch(3, 4, 16)
    assert set(b) == {"embeds", "labels"}
    assert b["embeds"].shape == (4, 16, cfg.d_model)
    assert b["embeds"].dtype == torch.float32 and b["labels"].dtype == torch.int32
    assert abs(float(b["embeds"].std()) - 1.0) < 0.1
    assert torch.equal(b["embeds"], data.batch(3, 4, 16)["embeds"])
    assert not torch.equal(b["embeds"], data.batch(4, 4, 16)["embeds"])
    half = data.shard_batch(3, 4, 16, 1, 2)
    assert torch.equal(half["embeds"], b["embeds"][2:])
    assert torch.equal(half["labels"], b["labels"][2:])


# ----------------------------------------------------------------------- loop
def _loop_fixture(tmp, total=30, **kw):
    cfg = configs.smoke_config(ARCH)
    model = init_lm(cfg, 0, device=CPU)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = build_train_step(cfg, opt_cfg)
    data = SyntheticLM(cfg, seed=0)
    mgr = CheckpointManager(tmp, keep_last=3)
    lc = LoopConfig(total_steps=total, checkpoint_every=10, **kw)
    return (step, model, init_opt_state(model, opt_cfg),
            lambda s: data.batch(s, 4, 32), mgr, lc)


def test_loop_resumes_after_crash(tmp_path):
    step, p, o, data_fn, mgr, lc = _loop_fixture(tmp_path)
    calls = {"n": 0}

    def bomb(s):
        if s == 15 and calls["n"] == 0:
            calls["n"] = 1
            raise RuntimeError("node failure")

    _, _, rep = run_training(step, p, o, data_fn, mgr, lc, fault_injector=bomb)
    assert rep.restarts == 1
    # replayed steps 10..15 after resume => more steps run than total
    assert rep.steps_run > lc.total_steps - 1
    assert mgr.latest_step() == lc.total_steps


def test_loop_fresh_vs_resumed_equivalence(tmp_path):
    """A crash and resume lands on the same parameters and optimizer
    state as an uninterrupted run, bit for bit."""
    step, p, o, data_fn, mgr1, lc = _loop_fixture(tmp_path / "a", total=20)
    pa, oa, _ = run_training(step, p, o, data_fn, mgr1, lc)
    step2, p2, o2, data_fn2, mgr2, lc2 = _loop_fixture(tmp_path / "b", total=20)
    fired = {"n": 0}

    def bomb(s):
        if s == 13 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("boom")

    pb, ob, rep = run_training(step2, p2, o2, data_fn2, mgr2, lc2,
                               fault_injector=bomb)
    assert rep.restarts == 1
    _equal_trees({"params": pa, "opt": oa}, {"params": pb, "opt": ob})


def test_loop_resumes_from_an_existing_checkpoint(tmp_path):
    """A second run with the same manager picks up at its latest step and
    falls back to the one before when the latest is corrupt."""
    step, p, o, data_fn, mgr, lc = _loop_fixture(tmp_path, total=20)
    run_training(step, p, o, data_fn, mgr, lc)
    leaf = next((Path(tmp_path) / "step_000000020").glob("leaf_000001.npy"))
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    _, _, rep = run_training(step, p, o, data_fn, mgr,
                             LoopConfig(total_steps=22, checkpoint_every=10))
    assert rep.steps_run == 12  # from step 10, the checkpoint before 20


def test_loop_straggler_detection(tmp_path, monkeypatch):
    """Step 9's data fetch takes 1 s of a fake clock that advances 10 ms
    a step otherwise: a straggler past 5 x the median, reported to the
    hook, whatever the host's load."""
    step, p, o, data_fn, mgr, lc = _loop_fixture(tmp_path, total=12,
                                                 straggler_factor=5.0)
    now = {"t": 0.0}

    def clock():
        now["t"] += 0.005  # each read: two a step
        return now["t"]

    def slow_data(s):
        if s == 9:
            now["t"] += 1.0  # slow data fetch, inside the timed region
        return data_fn(s)

    monkeypatch.setattr(loop_mod, "clock", clock)
    seen = []
    _, _, rep = run_training(step, p, o, slow_data, mgr, lc,
                             on_straggler=lambda *e: seen.append(e))
    assert [s for s, _, _ in rep.straggler_events] == [9]
    assert seen == rep.straggler_events


def test_sdc_gate_rejecting_every_step_keeps_the_start(tmp_path):
    """An sdc_threshold no residual can pass rejects every step: the
    parameters and optimizer state at the end are bit-equal to those at
    the start (the update is out of place), and each step counts."""
    cfg = configs.smoke_config(ARCH)
    model = init_lm(cfg, 0, device=CPU)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = init_opt_state(model, opt_cfg)
    before = {"params": {n: p.clone() for n, p in model.named_parameters()},
              "opt": {"mu": {n: t.clone() for n, t in opt["mu"].items()},
                      "nu": {n: t.clone() for n, t in opt["nu"].items()},
                      "step": opt["step"].clone()}}
    step = build_train_step(cfg, opt_cfg, sdc_check=True)
    data = SyntheticLM(cfg, seed=0)
    p, o, rep = run_training(step, model, opt, lambda s: data.batch(s, 2, 16),
                             CheckpointManager(tmp_path),
                             LoopConfig(total_steps=4, checkpoint_every=2,
                                        sdc_threshold=-1.0))
    assert rep.sdc_rejects == 4 and rep.steps_run == 4
    _equal_trees({"params": dict(p.named_parameters()), "opt": o}, before)


def test_step_seed_depends_on_seed_and_step_only():
    assert loop_mod.step_seed(1, 5) == loop_mod.step_seed(1, 5)
    assert len({loop_mod.step_seed(s, t) for s in range(3) for t in range(3)}) == 9
    assert 0 <= loop_mod.step_seed(7, 2**40) < 2**63


# ------------------------------------------------------------------------ SDC
def test_freivalds_accepts_correct_and_rejects_corrupt():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))
    c = a @ b
    assert not bool(sdc.sdc_flag(sdc.freivalds_residual(a, b, c, 0)))
    c_bad = c.clone()
    c_bad[5, 7] += 1.0  # one corrupted element
    assert bool(sdc.sdc_flag(sdc.freivalds_residual(a, b, c_bad, 0)))


def test_checked_matmul_and_step_outputs():
    """The probe is a function of its key (an int or a generator), signs
    ±1; the largest residual of many claims flags the corrupt one."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((16, 8)))
    b = torch.from_numpy(rng.standard_normal((8, 12)))
    c, resid = sdc.checked_matmul(a, b, 3)
    assert torch.equal(c, a @ b) and float(resid) < 1e-12
    r = sdc.rademacher(1000, 3, dtype=torch.float64, device=CPU)
    assert set(r.tolist()) == {-1.0, 1.0}
    assert torch.equal(r, sdc.rademacher(1000, torch.Generator().manual_seed(3),
                                         dtype=torch.float64, device=CPU))
    bad = c.clone()
    bad[0, 0] += 1.0
    assert float(sdc.check_step_outputs([(a, b, c), (a, b, c)], 0)) < 1e-12
    assert bool(sdc.sdc_flag(sdc.check_step_outputs([(a, b, c), (a, b, bad)], 0)))
    assert float(sdc.check_step_outputs([], 0)) == 0.0


# ----------------------------------------------------------------------- eval
def test_eval_step_deterministic_finite_loss():
    cfg = configs.smoke_config(ARCH)
    model = init_lm(cfg, 0, device=CPU)
    batch = SyntheticLM(cfg, seed=0).batch(0, 4, 32)
    ev = build_eval_step(cfg, ce_chunk=16)
    l1, l2 = float(ev(model, batch)), float(ev(model, batch))
    assert np.isfinite(l1) and l1 == l2
    assert 0.0 < l1 < 2.0 * np.log(cfg.vocab_size)
    assert not ev(model, batch).requires_grad


# ------------------------------------------------------------------- launcher
def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", ARCH, "--smoke", "--batch", "4",
            "--seq", "32", "--lr", "3e-3", "--ckpt", str(tmp_path),
            "--ckpt-every", "6"]
    assert launch_train.main([*argv, "--steps", "12"]) == 0  # asserts the loss fell
    first = capsys.readouterr().out
    assert "resume_from=None" in first and "restarts=0" in first
    assert launch_train.main([*argv, "--steps", "24"]) == 0
    second = capsys.readouterr().out
    assert "resume_from=12" in second and "done: 12 steps" in second
    assert CheckpointManager(tmp_path).latest_step() == 24


def test_launcher_refuses_mesh_and_cpu_fallback(tmp_path):
    """A mesh the launcher does not know is refused, and so is the CPU
    where no --device asks for it, with or without --mesh smoke (whose
    runs tests/test_torch_sharding.py holds)."""
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--mesh", "production",
                           "--ckpt", str(tmp_path)])
    if not torch.cuda.is_available():
        for mesh in ("none", "smoke"):
            with pytest.raises(RuntimeError, match="CUDA"):
                launch_train.main(["--mesh", mesh, "--ckpt", str(tmp_path)])
