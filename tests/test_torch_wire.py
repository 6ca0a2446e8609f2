"""The port's wire frames and edge servers against the JAX reference, on
the CPU.

Frames of every kind must be byte-identical to the reference's for the
same scalars and arrays, and each side must decode the other's. Malformed
and malicious frames are rejected as tests/test_api.py rejects them. A
port ShardTask is served by the reference's `serve_frame` over its
EdgeServer and the reverse; the strips agree at rtol 1e-10 / atol 1e-12
and honest results verify on both sides.
"""
import dataclasses
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as r_api
from repro.api import messages as r_msg
from repro.api import transport as r_transport
from repro.core import faults as r_faults
from repro.core import verify as r_verify
from repro.core.decipher import Determinant as RDeterminant
from repro_torch.api import messages as t_msg
from repro_torch.api import transport as t_transport
from repro_torch.api import wire
from repro_torch.api.client import SPDCClient
from repro_torch.api.server import EdgeServer
from repro_torch.core import faults as t_faults
from repro_torch.core import verify as t_verify
from repro_torch.core.decipher import Determinant

N = 4
CPU = "cpu"


def _wellcond(n, seed=0, batch=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return (rng.standard_normal(shape) + n * np.eye(n)).astype(dtype)


def _both(cls_name, **fields):
    """The same message in the reference and the port."""
    return getattr(r_msg, cls_name)(**fields), getattr(t_msg, cls_name)(**fields)


def _messages(dtype, batch):
    x = _wellcond(8, seed=1, batch=batch, dtype=dtype)
    strip = x[..., :2, :]
    up = x[..., :1, :] if batch is not None else None
    return [
        _both("ShardTask", server=1, num_servers=4, x_row=strip,
              subseed=b"\x07" * 32, style="nserver", attempt=2,
              u_upstream=up, session_id="abc123"),
        _both("ShardResult", server=3, l_row=strip, u_row=2 * strip,
              subseed=b"\x01" * 32, attempt=1, session_id="ff"),
        _both("TriSolveTask", server=0, num_servers=2, l=x[..., :4, :4],
              u=x[..., 4:, 4:], rhs=x[..., :4, :3], subseed=b"\x02" * 32,
              transpose=1, col0=3, attempt=0, session_id="aa"),
        _both("TriSolveResult", server=1, y=x[..., :4, :2],
              subseed=b"\x03" * 32, transpose=0, col0=2, attempt=1,
              session_id="bb"),
    ]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch", [None, 3])
def test_message_frames_byte_identical_both_directions(dtype, batch):
    for ref, port in _messages(dtype, batch):
        frame = port.to_bytes()
        assert frame == ref.to_bytes(), type(port).__name__
        # each side decodes the other's frame back to the same bytes
        assert type(ref).from_bytes(frame).to_bytes() == frame
        assert type(port).from_bytes(ref.to_bytes()).to_bytes() == frame
        assert isinstance(wire.decode_message(frame), type(port))


def test_tensor_payloads_encode_as_host_arrays():
    x = _wellcond(8, seed=4)
    ref = r_msg.ShardResult(server=0, l_row=x[:2], u_row=x[2:4])
    port = t_msg.ShardResult(server=0, l_row=torch.from_numpy(x[:2]),
                             u_row=torch.from_numpy(x)[2:4])
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("plan", [
    (),
    (dict(server=1, mode="block", magnitude=0.3),),
    (dict(server=2, kind="delay", delay_s=0.5, delay_dist="pareto", seed=4),
     dict(server=0, kind="dropout", matrices=(1, 2)),
     dict(server=3, target="lu", in_band=True)),
])
def test_fault_plan_frames_byte_identical(plan):
    ref = r_msg.FaultPlanFrame(tuple(r_faults.ServerFault(**f) for f in plan))
    port = t_msg.FaultPlanFrame(tuple(t_faults.ServerFault(**f) for f in plan))
    frame = port.to_bytes()
    assert frame == ref.to_bytes()
    assert t_msg.FaultPlanFrame.from_bytes(frame) == port
    assert r_msg.FaultPlanFrame.from_bytes(frame) == ref


@pytest.mark.parametrize("batched", [False, True])
def test_verdict_frames_byte_identical(batched):
    """The same verdict fields give the same frame; a tampered run's
    verdict from each package decodes on the other side."""
    a = _wellcond(16, seed=6, batch=3 if batched else None)
    matrices = (1,) if batched else None
    from repro.core.lu import lu_nserver as r_lu_nserver

    l, u, _ = r_lu_nserver(jnp.asarray(a), N, faults=(
        r_faults.ServerFault(server=2, matrices=matrices),))
    want = r_verify.authenticate(l, u, jnp.asarray(a), num_servers=N,
                                 method="q2", rng=np.random.default_rng(1))
    frame = want.to_bytes()
    assert t_verify.Verdict(**vars(want)).to_bytes() == frame
    back = t_verify.Verdict.from_bytes(frame)
    assert back.to_bytes() == frame
    got = t_verify.authenticate(torch.tensor(np.asarray(l)),
                                torch.tensor(np.asarray(u)),
                                torch.from_numpy(a), num_servers=N,
                                method="q2", rng=np.random.default_rng(1))
    mine = got.to_bytes()
    assert r_verify.Verdict.from_bytes(mine).to_bytes() == mine
    assert t_verify.Verdict.from_bytes(mine).to_bytes() == mine
    np.testing.assert_array_equal(got.culprit, want.culprit)
    np.testing.assert_array_equal(got.ok, want.ok)


@pytest.mark.parametrize("sign,logabs,dtype", [
    (1.0, 3.5, "float64"), (-1.0, 1234.5678901234567, "float32"),
    (0.0, float("-inf"), "float64"),
])
def test_determinant_frames_byte_identical(sign, logabs, dtype):
    ref = RDeterminant(sign=sign, logabs=logabs, dtype=dtype)
    port = Determinant(sign=sign, logabs=logabs, dtype=dtype)
    frame = port.to_bytes()
    assert frame == ref.to_bytes()
    assert Determinant.from_bytes(frame) == port
    assert isinstance(wire.decode_message(frame), Determinant)


# ------------------------------------------------- malformed and malicious
def test_wire_rejects_malformed_frames():
    good = Determinant(sign=1.0, logabs=1.0).to_bytes()
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode(b"JUNK" + good[4:])
    with pytest.raises(wire.WireError):
        wire.decode(good[:10])  # truncated header
    with pytest.raises(wire.WireError, match="version"):
        wire.decode(good[:4] + b"\x02" + good[5:])
    t = t_msg.ShardTask(server=0, num_servers=2, x_row=_wellcond(4)[:2],
                        subseed=b"\x03" * 32)
    with pytest.raises(wire.WireError):  # truncated array body
        wire.decode(t.to_bytes()[:-16])
    with pytest.raises(wire.WireError, match="expected ShardResult"):
        t_msg.ShardResult.from_bytes(good)
    with pytest.raises(wire.WireError, match="unknown message kind"):
        wire.decode_message(wire.encode("Nonsense", {}, {}))


def test_wire_rejects_malicious_array_specs():
    """Header fields are attacker-controlled: each bad spec must raise
    WireError, never reinterpret header bytes as strip data."""

    def tampered(mutate):
        frame = t_msg.ShardResult(server=0, l_row=_wellcond(4)[:2],
                                  u_row=_wellcond(4)[:2]).to_bytes()
        hlen = struct.unpack_from(">BI", frame, 4)[1]
        header = json.loads(frame[9 : 9 + hlen].decode())
        body = frame[wire._pad(9 + hlen):]
        mutate(header)
        hjson = json.dumps(header, separators=(",", ":")).encode()
        head = wire.MAGIC + struct.pack(">BI", wire.VERSION, len(hjson)) + hjson
        return head.ljust(wire._pad(len(head)), b"\x00") + body

    def set_field(name, value):
        def mutate(header):
            header["arrays"][0][name] = value
        return mutate

    for bad in (set_field("offset", -64), set_field("nbytes", -8),
                set_field("shape", [-2, 4]), set_field("dtype", "O"),
                set_field("offset", "no"), set_field("shape", [3, 5])):
        with pytest.raises(wire.WireError):
            wire.decode(tampered(bad))


def test_serve_frame_answers_garbage_with_an_err_frame():
    edge = EdgeServer(0, device=CPU)
    state = {}
    assert t_transport.serve_frame(edge, state, b"JUNK").startswith(b"ERR:")
    plan = t_msg.FaultPlanFrame((t_faults.ServerFault(server=0),))
    assert t_transport.serve_frame(edge, state, plan.to_bytes()) == b"ACK"
    assert state["plan"] == plan.plan
    # a trisolve chunk is answered; one whose factors disagree in shape
    # gets an ERR frame like any other failure
    solve = t_msg.TriSolveTask(server=0, num_servers=1, l=np.eye(2),
                               u=2 * np.eye(2), rhs=np.ones((2, 1)),
                               subseed=b"\x00" * 32)
    res = t_msg.TriSolveResult.from_bytes(
        t_transport.serve_frame(edge, {}, solve.to_bytes()))
    np.testing.assert_array_equal(res.y, np.full((2, 1), 0.5))
    bad = dataclasses.replace(solve, u=np.eye(3))
    reply = t_transport.serve_frame(edge, state, bad.to_bytes())
    assert reply.startswith(b"ERR:") and b"disagree" in reply


# ------------------------------------------------------------------- interop
@pytest.mark.parametrize("batch", [None, 2])
def test_port_tasks_served_by_reference_edge_servers(batch):
    m = _wellcond(24, seed=21, batch=batch)
    session = SPDCClient(device=CPU).open_session(m, N)
    ref_edges = [r_api.EdgeServer(i) for i in range(N)]
    port_edges = [EdgeServer(i, device=CPU) for i in range(N)]
    results, u_rows = [], []
    for task in session.tasks():
        if task.server:
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        reply = r_transport.serve_frame(ref_edges[task.server], {},
                                        task.to_bytes())
        res = t_msg.ShardResult.from_bytes(reply)
        own = port_edges[task.server].run(task)
        for got, want in ((res.l_row, own.l_row), (res.u_row, own.u_row)):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        assert res.subseed == task.subseed and res.session_id == task.session_id
        results.append(res)
        u_rows.append(res.u_row)
    out = session.collect(results)
    assert np.all(out.verified)


@pytest.mark.parametrize("batch", [None, 2])
def test_reference_tasks_served_by_port_edge_servers(batch):
    m = _wellcond(24, seed=22, batch=batch)
    session = r_api.SPDCClient().open_session(m, N)
    port_edges = [EdgeServer(i, device=CPU) for i in range(N)]
    ref_edges = [r_api.EdgeServer(i) for i in range(N)]
    results, u_rows = [], []
    for task in session.tasks():
        if task.server:
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        reply = t_transport.serve_frame(port_edges[task.server], {},
                                        task.to_bytes())
        res = r_msg.ShardResult.from_bytes(reply)
        own = ref_edges[task.server].run(task)
        for got, want in ((res.l_row, own.l_row), (res.u_row, own.u_row)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                       atol=1e-12)
        results.append(res)
        u_rows.append(res.u_row)
    out = session.collect(results)
    assert np.all(out.verified)
