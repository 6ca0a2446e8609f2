"""The port's launch tools: the per-op cost count (launch/op_cost.py, the
counterpart of hlo_cost.py), the roofline terms on H100 constants, the
dry-run rules (pure data parallelism, the grad-accumulation clamp), the
relay programs, a dry-run cell at smoke size and the perf variants.

Mirrors tests/test_launch.py. Where the reference shows that its HLO
count multiplies loop bodies by their trip counts, the port's eager count
sees every iteration. Meshes are DeviceMeshes over a fake process group
(every fixture destroys its group). The full-size dry-run cell (256 fake
ranks, a fresh process) is marked slow, as the reference's is.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.lu import lu_nserver as r_lu_nserver
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.core.lu import lu_nserver
from repro_torch.distrib.spdc_pipeline import lu_nserver_shardmap
from repro_torch.launch import dryrun, mesh, op_cost, perf, roofline

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fake_mesh():
    """A (2, 4) ("data", "model") mesh over a fake 8-rank group."""
    with dryrun.fake_group(8):
        yield mesh.make_smoke_mesh((2, 4), device_type="cpu")
    assert not dist.is_initialized()


def test_op_cost_counts_every_loop_iteration():
    """The reason hlo_cost.py exists is XLA counting a while body once;
    an eager count sees all ten products (and the tanh elements)."""
    x = torch.zeros(64, 128)
    w = torch.zeros(128, 128)
    with op_cost.counting() as cost:
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
    dot = 2 * 64 * 128 * 128
    assert 9 * dot < cost.flops < 12 * dot


def test_op_cost_collectives_in_loops(fake_mesh):
    """x sharded on data, w on model; a loop of 5 products each
    constrained back to data-only sharding all-gathers 5 times, and the
    flops are the local shards' (one eighth of the global product's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        xs = distribute_tensor(torch.zeros(16, 64), fake_mesh,
                               [Shard(0), Replicate()])
        ws = distribute_tensor(torch.zeros(64, 64), fake_mesh,
                               [Replicate(), Shard(1)])
        with op_cost.counting() as cost:
            h = xs
            for _ in range(5):
                h = torch.tanh(h @ ws).redistribute(fake_mesh,
                                                    [Shard(0), Replicate()])
    assert cost.coll_counts == {"all-gather": 5}
    # each gathers the (8, 64) f32 row block: 2 KiB a gather, within a node
    assert cost.coll_wire == {"all-gather": 5 * 8 * 64 * 4}
    assert cost.coll_wire_link == {"nvlink": 5 * 8 * 64 * 4}
    local_dot = 2 * 8 * 64 * 16
    assert 5 * local_dot <= cost.flops < 5 * local_dot * 1.1


def test_op_cost_links_and_bytes():
    assert op_cost.link_of(range(8)) == "nvlink"
    assert op_cost.link_of(range(0, 256, 16)) == "network"
    assert op_cost.link_of(range(8, 24)) == "network"
    # an expanded dimension counts its elements once
    assert op_cost.tensor_bytes(torch.zeros(4, 8).expand(3, 4, 8)) == 4 * 8 * 4
    # the fused flash op: causal right-aligned pairs, windows
    assert op_cost._flash_pairs(4, 4, True, None) == 10
    assert op_cost._flash_pairs(1, 6, True, None) == 6
    assert op_cost._flash_pairs(4, 4, False, None) == 16
    assert op_cost._flash_pairs(4, 4, True, 2) == 7


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": True, "window": 5},
                                {"causal": False}])
def test_flash_backward_is_one_fused_op(kw):
    """B6 under autograd in the count: the forward 4·B·Hq·D·pairs flops
    and q, k, v and the output; the backward the gradient kernels' seven
    products, 14·B·Hq·D·pairs, and q, k, v, the output, lse, dO and the
    three gradients once each; no op of the plain gradient that gives the
    values (the oracle's, bit for bit)."""
    from repro_torch.kernels import flash_grad, ops

    b, hq, hkv, s, d = 2, 4, 2, 16, 8
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d),
                                                    dtype=np.float32))
               .requires_grad_() for h in (hq, hkv, hkv))
    g = torch.from_numpy(rng.standard_normal((b, hq, s, d), dtype=np.float32))
    pairs = op_cost._flash_pairs(s, s, kw["causal"], kw.get("window"))
    with op_cost.counting() as cost:
        out = ops.flash_attention(q, k, v, **kw)
        fwd_flops, fwd_bytes = cost.flops, cost.hbm_bytes
        grads = torch.autograd.grad(out, (q, k, v), g)
    assert fwd_flops == 4 * b * hq * d * pairs
    assert fwd_bytes == 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    assert cost.flops - fwd_flops == 14 * b * hq * d * pairs
    assert cost.hbm_bytes - fwd_bytes == 4 * (
        4 * b * hq * s * d + 4 * b * hkv * s * d + b * hq * s)
    want = flash_grad.flash_attention_backward(q, k, v, g, kw["causal"],
                                               kw.get("window"))
    assert all(torch.equal(a, c) for a, c in zip(grads, want))


def test_roofline_analyze_terms():
    """The reference's case, scaled by the H100 constants: a step of
    PEAK_FLOPS flops and half HBM_BW bytes takes 1 s and 0.5 s; 100 GB of
    all-reduce wire across nodes 2 s at 50 GB/s, over NVLink 0.22 s."""
    cost = op_cost.Cost(flops=roofline.PEAK_FLOPS, hbm_bytes=roofline.HBM_BW / 2)
    cost.coll_counts = {"all-reduce": 1}
    cost.coll_bytes = {"all-reduce": 50e9}
    cost.coll_wire = {"all-reduce": 100e9}
    cost.coll_wire_link = {"network": 100e9}
    rl = roofline.analyze(arch="x", shape="y", mesh_name="single", chips=256,
                          op_cost=cost, memory_stats={}, active_params=1e9,
                          tokens=1e6, training=True)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(2.0)  # 100e9 / 50e9
    assert rl.dominant == "collective"
    assert rl.model_flops == pytest.approx(6e15)
    cost.coll_wire_link = {"nvlink": 100e9}
    assert roofline.collective_seconds(cost) == pytest.approx(100e9 / 450e9)
    cost.coll_wire_link = {}  # an unplaced collective pays the network
    assert roofline.collective_seconds(cost) == pytest.approx(2.0)


def test_relay_programs_equivalent():
    """baseline / exact / stream relay programs produce the N-server LU
    (the reference's lu_nserver on the same matrix)."""
    rng = np.random.default_rng(11)
    n, servers = 32, 8
    x = rng.standard_normal((n, n)) + n * np.eye(n)
    ref_l, ref_u, _ = r_lu_nserver(x, servers)
    l0, u0, _ = lu_nserver(torch.from_numpy(x), servers)
    for program in ("baseline", "exact", "stream"):
        l, u = lu_nserver_shardmap(torch.from_numpy(x), servers,
                                   program=program, device="cpu")
        for got, want in ((l, ref_l), (u, ref_u), (l, l0), (u, u0)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-9, err_msg=program)


def test_dp_over_model_rules(fake_mesh):
    """The pure-DP strategy folds every axis into batch and fsdp."""
    cfg = replace(get_config("mamba2-370m"), dp_over_model=True)
    rules = dryrun.rules_for(cfg, SHAPES["train_4k"], fake_mesh)
    assert rules.model_axis is None
    assert rules.batch_axes == ("data", "model")
    assert rules.fsdp_axes == ("data", "model")


def test_effective_grad_accum_clamp():
    with dryrun.fake_group(8):
        m = mesh.make_smoke_mesh((8, 1), ("data", "model"), device_type="cpu")
        cfg = get_config("nemotron-4-340b")  # grad_accum=32
        rules = dryrun.rules_for(cfg, SHAPES["train_4k"], m)
        eff = dryrun.effective_cfg(cfg, SHAPES["train_4k"], m, rules)
    # 256 batch / 8 data shards => accum can stay 32 (256/32=8 divisible by 8)
    assert eff.grad_accum == 32
    assert (256 // eff.grad_accum) % 8 == 0


@pytest.fixture
def smoke_configs(monkeypatch):
    """The dry run on each arch's smoke reduction."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)


def test_dryrun_cell_at_smoke_size(smoke_configs, fake_mesh):
    """tinyllama's smoke reduction, train_4k on the fake (2, 4) mesh:
    every term of the count is positive, the collectives are DTensor's
    (gathers of fsdp weights and sequence shards, reductions of partial
    sums), and the analysis gives all three roofline terms."""
    cost, rules, meta = dryrun.lower_cell("tinyllama-1.1b", "train_4k",
                                          fake_mesh, "smoke")
    assert rules.shard_heads and rules.batch_axes == ("data",)
    assert cost.flops > 0 and cost.hbm_bytes > 0
    assert cost.coll_counts["all-gather"] > 0
    assert cost.coll_counts["reduce-scatter"] > 0
    assert cost.total_coll_wire > 0
    assert cost.peak_live_bytes >= meta["argument_bytes"] > 0
    rl = roofline.analyze(arch="tinyllama-1.1b-smoke", shape="train_4k",
                          mesh_name="smoke", chips=8, op_cost=cost,
                          memory_stats={}, active_params=meta["cfg"]
                          .active_param_count(), tokens=256 * 4096,
                          training=True)
    assert rl.compute_s > 0 and rl.memory_s > 0 and rl.collective_s > 0


def test_dryrun_prefill_cell_at_smoke_size(smoke_configs, fake_mesh):
    """A prefill cell: the fused flash op's flops are counted per device
    (each rank's own heads), and nothing trains."""
    cost, _, meta = dryrun.lower_cell("tinyllama-1.1b", "prefill_32k",
                                      fake_mesh, "smoke")
    cfg = meta["cfg"]
    # 4 heads over 4 model ranks, 32 rows over 2 data ranks: one head of
    # 16 rows a rank, causal over 32768 keys, per layer
    flash = 4 * 16 * 1 * cfg.head_dim * (32768 * 32769 // 2) * cfg.num_layers
    assert cost.flops > flash
    assert "opt_total_bytes" not in meta and cost.total_coll_wire > 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-1b"])
def test_dryrun_decode_cell_at_smoke_size(smoke_configs, fake_mesh,
                                          monkeypatch, arch):
    """A decode_32k cell on the fake (2, 4) mesh: the token sits at the
    end of a full cache (step L − 1 from the host), so each attention
    layer's decode partial is counted over this rank's own slots, a
    quarter of them (32768 / 4 for a full cache, 16 / 4 for gemma3's
    sliding rings), and the partials' all-gather over the model axis is
    counted as a collective: (4 ranks x chunks, 64 rows of the batch, 4
    heads, 1, D + 2) f32 gathered."""
    pairs, gathers = [], []
    flash_pairs, collective = op_cost._flash_pairs, op_cost.Cost.collective

    def spy_pairs(sq, sk, causal, window):
        pairs.append(sk)
        return flash_pairs(sq, sk, causal, window)

    def spy_collective(self, kind, nbytes, link, count=True):
        gathers.append((kind, nbytes))
        return collective(self, kind, nbytes, link, count)

    monkeypatch.setattr(op_cost, "_flash_pairs", spy_pairs)
    monkeypatch.setattr(op_cost.Cost, "collective", spy_collective)
    cost, rules, meta = dryrun.lower_cell(arch, "decode_32k", fake_mesh,
                                          "smoke")
    cfg = meta["cfg"]
    assert rules.model_size == 4 and meta["caches_total_bytes"] > 0
    lengths = [32768 if mixer == "attn_full" else cfg.window
               for mixer, _ in cfg.layer_list()]
    assert pairs == [n // 4 for n in lengths]
    for n in sorted(set(lengths)):
        chunks = -(-(n // 4) // 128)
        part = 4 * chunks * 64 * cfg.num_heads * (cfg.head_dim + 2) * 4
        assert gathers.count(("all-gather", part)) == lengths.count(n)
    assert cost.coll_counts["all-gather"] >= len(lengths)
    assert cost.flops > 4.0 * 64 * cfg.num_heads * cfg.head_dim * sum(pairs)
    assert "opt_total_bytes" not in meta


def test_spdc_cell_counts_the_relay():
    """The N-server pipeline under fake tensors: one collective-permute a
    hop of the port's hop log, its bytes the relay buffer's; the baseline
    relays the whole (n, n) buffer from every slot every round."""
    n, servers = 64, 4
    cost, hops = dryrun.spdc_cost(n, servers, "baseline")
    assert len(hops) == servers * servers
    assert cost.coll_counts["collective-permute"] == len(hops)
    assert cost.coll_wire["collective-permute"] == sum(h.nbytes for h in hops)
    assert all(h.nbytes == n * n * 4 for h in hops)
    assert cost.flops > 2 * n**3 / 3
    exact, _ = dryrun.spdc_cost(n, servers, "exact")
    assert exact.total_coll_wire < cost.total_coll_wire


def test_perf_spdc_relay_variants(tmp_path):
    """--spdc --relay: each program's record, the exact relay's wire
    below the baseline's."""
    recs = {relay: perf.run_spdc_variant("single", relay, 64, f"spdc_{relay}",
                                         out_dir=tmp_path)
            for relay in ("baseline", "exact", "stream")}
    for relay, rec in recs.items():
        assert json.loads((tmp_path / f"spdc_{relay}.json").read_text())[
            "program"] == relay
        assert rec["chips"] == 256 and rec["collective_s"] > 0
    assert (recs["exact"]["collective_wire_bytes"]
            < recs["baseline"]["collective_wire_bytes"])


def test_perf_set_variant_against_baseline(tmp_path, monkeypatch, capsys):
    """--set overrides reach the cell, and each term prints against the
    baseline record: remat=none keeps the activations (more peak memory,
    fewer flops than remat=nothing's recompute)."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    small = {"train_4k": replace(SHAPES["train_4k"], seq_len=256,
                                 global_batch=32)}
    monkeypatch.setattr(dryrun, "SHAPES", small)

    def cell(arch, shape_name, mesh_name, out_dir):
        # the production mesh's layout at 8 fake ranks
        with dryrun.fake_group(8):
            m = mesh.make_smoke_mesh((2, 4), device_type="cpu")
            cost, rules, meta = dryrun.lower_cell(arch, shape_name, m, mesh_name)
        rl = roofline.analyze(arch=arch, shape=shape_name, mesh_name=mesh_name,
                              chips=8, op_cost=cost,
                              memory_stats={"peak_est_bytes": cost.peak_live_bytes},
                              active_params=1.0, tokens=1.0, training=True)
        rec = rl.to_dict()
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
            json.dumps(rec))
        return rec

    monkeypatch.setattr(dryrun, "run_cell", cell)
    base = cell("tinyllama-1.1b", "train_4k", "single", tmp_path / "base")
    var = perf.run_variant("tinyllama-1.1b", "train_4k", "single",
                           {"remat": "none"}, "noremat",
                           base_dir=tmp_path / "base", out_dir=tmp_path)
    out = capsys.readouterr().out
    assert "[perf:noremat] vs baseline:" in out and "collective_s" in out
    assert var["flops_per_device"] < base["flops_per_device"]
    assert (var["memory_stats"]["peak_est_bytes"]
            > base["memory_stats"]["peak_est_bytes"])


@pytest.mark.slow
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_one_cell_subprocess(tmp_path, shape):
    """End-to-end dry run of a model-sharded cell on the 16×16 mesh (a
    fresh process: 256 fake ranks); decode_32k is the reference's own
    case (tests/test_launch.py)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", shape, "--mesh", "single", "--out",
         str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.load(open(tmp_path / f"gemma3-1b__{shape}__single.json"))
    assert rec["chips"] == 256
    assert rec["compute_s"] > 0 and rec["memory_s"] > 0 and rec["collective_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["compile_s"] is None and "compile_s" in rec["null_keys"]
