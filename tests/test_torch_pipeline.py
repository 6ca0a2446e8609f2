"""The port's multi-device pipeline (distrib.spdc_pipeline: the baseline,
exact and stream relay programs on a mesh of server slots, the shardmap
transport, distributed=) against the JAX reference's shard_map pipeline,
on the CPU.

Mirrors tests/test_distributed.py's pipeline cases and the distributed
cases of tests/test_faults.py, tests/test_batched.py and
tests/test_precision.py; the recovery case is in
tests/test_torch_recovery.py. The reference runs on the host devices
tests/conftest.py forces; the port on CPU slots (device="cpu"), where
its kernels' plain versions run. Inputs are numpy arrays from seeds.
Bars: factors within 1e-10 of max|F| of the reference's (the same
block operations, other summation orders) and within the reference
test's atol 1e-9 of the port's own lu_nserver; determinants by
Determinant.allclose, the same verdicts; the hop log one hop a slot a
round to (i + 1) % N with the reference's collective-permute shapes.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as r_api
import repro_torch
from repro.core import protocol as r_protocol
from repro.core.faults import ServerFault as RServerFault
from repro.distrib import spdc_pipeline as r_pipeline
from repro_torch.api import ShardMapTransport, TransportConfig
from repro_torch.core.decipher import Determinant
from repro_torch.core.faults import ServerFault
from repro_torch.core.lu import lu_nserver
from repro_torch.distrib import spdc_pipeline as t_pipeline
from repro_torch.distrib.spdc_pipeline import (
    ServerMesh, lu_nserver_shardmap, pipeline_collective_bytes,
)

CPU = "cpu"
PROGRAMS = ("baseline", "exact", "stream")
RTOL = 1e-10


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.standard_normal(shape) + n * np.eye(n)


def _port(x, servers, **kw):
    l, u = lu_nserver_shardmap(torch.from_numpy(x), servers, device=CPU, **kw)
    return l.numpy(), u.numpy()


def _ref(x, servers, faults=(), **kw):
    plan = tuple(RServerFault(**dataclasses.asdict(f)) for f in faults)
    l, u = r_pipeline.lu_nserver_shardmap(jnp.asarray(x), servers,
                                          faults=plan, **kw)
    return np.asarray(l), np.asarray(u)


def _close(got, want, rtol=RTOL):
    """Each factor within rtol · max|F| of the reference's."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * np.abs(w).max()


def _same_det(got, want):
    """A port Determinant against a reference one (other class)."""
    return Determinant(**dataclasses.asdict(want)).allclose(got) \
        and got.dtype == want.dtype


def _reference_permutes(program, n, servers, batch=None):
    """(source-target pairs, operand shape) of each collective-permute
    in the reference's lowered program, in program order."""
    fn = r_pipeline._compiled_pipeline(program, n, batch, servers, "servers")
    shape = (n, n) if batch is None else (batch, n, n)
    text = fn.lower(jax.ShapeDtypeStruct(shape, jnp.float64)).as_text()
    found = re.findall(
        r'collective_permute".*?source_target_pairs = dense<(.*?)>'
        r".*?\(tensor<([0-9x]+)xf64>\)", text)
    return [([tuple(p) for p in eval(pairs)],
             tuple(int(d) for d in dims.split("x")))
            for pairs, dims in found]


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("n,servers", [(16, 4), (24, 8), (32, 2), (40, 5)])
def test_shardmap_matches_reference(n, servers, program):
    """Each program at each size: the reference's factors at rtol 1e-10
    of max|F|, and the port's lu_nserver at the reference test's atol
    1e-9."""
    x = _wellcond(n, seed=servers)
    got = _port(x, servers, program=program)
    _close(got, _ref(x, servers, program=program))
    l2, u2, _ = lu_nserver(torch.from_numpy(x), servers)
    np.testing.assert_allclose(got[0], l2.numpy(), atol=1e-9)
    np.testing.assert_allclose(got[1], u2.numpy(), atol=1e-9)


@pytest.mark.parametrize("program", PROGRAMS)
def test_batched_shardmap_matches_reference(program):
    """A (B, n, n) stack in one sweep: the reference's factors, and L·U
    reconstructs every matrix."""
    x = _wellcond(32, seed=4, batch=4)
    l, u = _port(x, 4, program=program)
    assert l.shape == u.shape == x.shape
    _close((l, u), _ref(x, 4, program=program))
    np.testing.assert_allclose(l @ u, x, atol=1e-9)


FAULT_CASES = {
    "sign_flip_u": ((ServerFault(server=2, mode="sign_flip", target="u"),),
                    None),
    "single_lu_and_dropout": ((ServerFault(server=1, target="lu"),
                               ServerFault(server=3, kind="dropout")), None),
    "block_matrices": ((ServerFault(server=1, mode="block", target="lu",
                                    matrices=(0, 2)),), 3),
}


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_shardmap_fault_injection_matches_reference(program, case):
    """Faults injected at the slot outputs — a tamper, a dropout, a
    stack's chosen matrices — give the reference's corrupted factors;
    the slots the plan names are the only ones changed."""
    faults, batch = FAULT_CASES[case]
    x = _wellcond(16, seed=5, batch=batch)
    got = _port(x, 4, program=program, faults=faults)
    _close(got, _ref(x, 4, program=program, faults=faults))
    honest = _port(x, 4, program=program)
    hit = {f.server for f in faults}
    for s in range(4):
        rows = slice(4 * s, 4 * s + 4)
        same = all(np.array_equal(g[..., rows, :], h[..., rows, :])
                   for g, h in zip(got, honest))
        assert same == (s not in hit)


def test_pivots_come_from_the_factorization_under_growth():
    """A divergence by design (ROADMAP §C): each server's diagonal U
    block is the factorization's U_ii, as lu_nserver keeps it, where the
    reference keeps the row solve's L_ii⁻¹ S_ii. On a quarter-turned
    dominant matrix (the growth an odd-k ciphertext gives the no-pivot
    LU) every program's log|det| stays within 1e-11 of slogdet, as
    lu_nserver's does; the reference's solved pivots drift 1e-10 on the
    same input."""
    rng = np.random.default_rng(1)
    m = rng.standard_normal((256, 256)) + 256 * np.eye(256)
    x = np.rot90(m, -1).copy() / rng.uniform(0.5, 2.0, (256, 1))
    want = np.linalg.slogdet(x)[1]

    def drift(u):
        return abs(np.log(np.abs(np.diagonal(u))).sum() - want)

    _, u_inline, _ = lu_nserver(torch.from_numpy(x), 4)
    assert drift(u_inline.numpy()) <= 1e-11
    for program in PROGRAMS:
        assert drift(_port(x, 4, program=program)[1]) <= 1e-11, program
    assert drift(_ref(x, 4)[1]) > 1e-11


# ------------------------------------------------------------------ errors
def test_shardmap_rejects_what_the_reference_rejects():
    """The reference's errors, with its messages."""
    x = torch.from_numpy(_wellcond(16, seed=1))
    with pytest.raises(ValueError, match="unknown program"):
        lu_nserver_shardmap(x, 4, program="telepathy", device=CPU)
    with pytest.raises(TypeError, match="exact_relay"):
        lu_nserver_shardmap(x, 4, exact_relay=True, device=CPU)
    with pytest.raises(ValueError, match="in_band"):
        lu_nserver_shardmap(x, 4, device=CPU,
                            faults=(ServerFault(server=0, in_band=True),))
    with pytest.raises(ValueError, match="delay"):
        lu_nserver_shardmap(x, 4, device=CPU, faults=(
            ServerFault(server=0, kind="delay", delay_rounds=1),))
    with pytest.raises(ValueError, match="must be"):
        lu_nserver_shardmap(x[0], 4, device=CPU)
    with pytest.raises(ValueError, match="not partitionable"):
        lu_nserver_shardmap(x, 3, device=CPU)
    with pytest.raises(ValueError, match="not partitionable"):
        lu_nserver_shardmap(x[:8, :8], 8, device=CPU)
    with pytest.raises(ValueError, match="slots"):
        lu_nserver_shardmap(x, 4, mesh=ServerMesh(2, CPU))
    # the reference raises the same on the same inputs
    with pytest.raises(TypeError, match="exact_relay"):
        r_pipeline.lu_nserver_shardmap(jnp.asarray(x.numpy()), 4,
                                       exact_relay=True)
    with pytest.raises(ValueError, match="not partitionable"):
        r_pipeline.lu_nserver_shardmap(jnp.asarray(x.numpy()), 3)


# -------------------------------------------------------- one-way schedule
@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("n,servers,batch", [(16, 4, None), (24, 3, 2)])
def test_hop_log_is_the_reference_ring(program, n, servers, batch):
    """The hop log, read like the reference's HLO: per relay round one
    hop from every slot to (i + 1) % N, the wrap hop included, and no
    other copy between slots; the rounds and each hop's bytes are the
    reference's collective-permutes (the baseline's one permute runs in
    each of its N loop rounds, the others' are unrolled over rounds
    0..N−2)."""
    mesh = ServerMesh(servers, CPU)
    lu_nserver_shardmap(torch.from_numpy(_wellcond(n, 2, batch)), servers,
                        mesh=mesh, program=program)
    permutes = _reference_permutes(program, n, servers, batch)
    if program == "baseline":
        assert len(permutes) == 1
        permutes = permutes * servers
    assert len(permutes) == (servers if program == "baseline" else servers - 1)
    ring = [(i, (i + 1) % servers) for i in range(servers)]
    rounds = sorted({h.round for h in mesh.hops})
    assert rounds == list(range(len(permutes)))
    for t, (pairs, shape) in zip(rounds, permutes):
        hops = [h for h in mesh.hops if h.round == t]
        assert pairs == ring
        assert sorted((h.src, h.dst) for h in hops) == ring
        # the reference's operand is (1, rows, n) for one matrix
        assert all(h.nbytes == 8 * int(np.prod(shape)) for h in hops)
    assert len(mesh.hops) == len(permutes) * servers


def test_live_edge_bytes_and_collective_model_match_reference():
    """The live edge t → t+1 carries the reference's message sizes, and
    pipeline_collective_bytes is the reference's model."""
    n, servers = 32, 4
    b = n // servers
    for program in PROGRAMS:
        mesh = ServerMesh(servers, CPU)
        lu_nserver_shardmap(torch.from_numpy(_wellcond(n, 3)), servers,
                            mesh=mesh, program=program)
        live = [h.nbytes for h in mesh.hops if h.dst == h.src + 1
                and h.src == h.round]
        rows = ([n] * (servers - 1) if program == "baseline"
                else [(t + 1) * b for t in range(servers - 1)])
        assert live == [8 * r * n for r in rows]
    for n, servers, itemsize in [(1024, 8, 8), (4096, 4, 8), (96, 3, 4),
                                 (16, 2, 8)]:
        assert pipeline_collective_bytes(n, servers, itemsize) == \
            r_pipeline.pipeline_collective_bytes(n, servers, itemsize)
    info = pipeline_collective_bytes(1024, 8)
    assert info["paper_exact_bytes"] < info["relay_bytes"]
    assert info["overcount_factor"] <= 4.0


def test_each_slot_holds_only_its_own_block_row(monkeypatch):
    """Ownership as the reference's in_specs give it: each slot's input
    is its own (B, b, n) block row of X, a copy in storage of its own,
    never a view of X or another server's rows."""
    held = []

    class Recording(t_pipeline._Server):
        def __init__(self, slot, x_row, n):
            super().__init__(slot, x_row, n)
            held.append((slot.index, x_row))

    monkeypatch.setattr(t_pipeline, "_Server", Recording)
    x = torch.from_numpy(_wellcond(24, 6, batch=2))
    lu_nserver_shardmap(x, 4, device=CPU, program="stream")
    assert [i for i, _ in held] == [0, 1, 2, 3]
    for i, row in held:
        assert row.shape == (2, 6, 24)
        assert torch.equal(row, x[:, 6 * i:6 * i + 6, :])
        assert row.untyped_storage().nbytes() == row.numel() * 8
        assert row.data_ptr() != x.data_ptr()


# ------------------------------------------------------------------ protocol
def test_distributed_protocol_end_to_end():
    """distributed=True: the reference's sign, log|det| and verdict; the
    slogdet of the plaintext."""
    m = _wellcond(24, seed=3)
    got = repro_torch.outsource_determinant(m, 4, distributed=True,
                                            device=CPU)
    want = r_protocol.outsource_determinant(m, 4, distributed=True)
    assert got.verified and want.verified
    assert got.det.sign == want.det.sign
    assert _same_det(got.det, want.det)
    assert got.report.verdict.ok == want.report.verdict.ok
    assert got.report.verdict.culprit == want.report.verdict.culprit
    want_s, want_la = np.linalg.slogdet(m)
    assert got.det.sign == want_s
    np.testing.assert_allclose(got.det.logabs, want_la, rtol=1e-9)


def test_f32_distributed_pipeline():
    """The relay programs are dtype-generic: an f32 stack runs the
    pipeline verified, with the reference's signs and determinants
    (Determinant.allclose's f32 bar)."""
    stack = _wellcond(32, seed=11, batch=2)
    got = repro_torch.outsource_determinant(stack, 4, dtype="float32",
                                            distributed=True, device=CPU)
    want = r_protocol.outsource_determinant(jnp.asarray(stack), 4,
                                            dtype="float32", distributed=True)
    assert bool(np.all(got.verified)) and bool(np.all(want.verified))
    for g, w, m in zip(got.dets, want.dets, stack):
        assert g.sign == w.sign == np.linalg.slogdet(m)[0]
        assert _same_det(g, w)


@pytest.mark.parametrize("program", PROGRAMS)
def test_shardmap_transport_config_runs_its_program(program):
    """TransportConfig("shardmap", program=) builds a transport whose
    sweep is that program on its mesh; a session through it verifies
    with the reference's determinant."""
    cfg = TransportConfig("shardmap", program=program)
    transport = cfg.build(device=CPU)
    try:
        assert isinstance(transport, ShardMapTransport)
        assert transport.program == program and transport.style == "pipeline"
        x = torch.from_numpy(_wellcond(16, seed=8))
        l, u = transport.sweep(x, 4)
        _close((l.numpy(), u.numpy()), _ref(x.numpy(), 4, program=program))
        assert len(transport.mesh(4).hops) == (16 if program == "baseline"
                                               else 12)
        m = _wellcond(16, seed=9)
        got = repro_torch.outsource_determinant(m, 4, transport=transport,
                                                device=CPU)
        want = r_protocol.outsource_determinant(
            m, 4, transport=r_api.TransportConfig("shardmap", program=program))
        assert got.verified and want.verified and _same_det(got.det, want.det)
    finally:
        transport.close()


def test_transport_config_program_rules_match_reference():
    """program= applies to shardmap only, as the reference rules; an
    unknown program is refused when the sweep runs, with the reference's
    message."""
    for kw in ({"name": "inline", "program": "exact"},
               {"name": "threadpool", "program": "baseline"}):
        with pytest.raises(ValueError, match="program= applies to shardmap"):
            TransportConfig(**kw)
        with pytest.raises(ValueError, match="program= applies to shardmap"):
            r_api.TransportConfig(**kw)
    assert hash(TransportConfig("shardmap", program="exact")) == \
        hash(TransportConfig("shardmap", program="exact"))
    bad = TransportConfig("shardmap", program="telepathy").build(device=CPU)
    with pytest.raises(ValueError, match="unknown program"):
        bad.sweep(torch.from_numpy(_wellcond(8, 0)), 2)
