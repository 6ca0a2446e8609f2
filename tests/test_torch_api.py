"""The port's role-split API on the CPU: the trust boundary of
`Session.tasks()`, the transports (inline, thread pool, worker processes)
against the fused sweep and against the JAX reference, the session
surfaces (`run`, `start`, `run_pipelined`, manual roles, `collect` of
ShardResults), fault plans through the transports, and the rule that
nothing server-side falls back to the CPU unless asked. Mirrors
tests/test_api.py.

Agreement: the thread pool's factors are bit-equal to the inline sweep's
on the same device; determinants match the reference's by
`Determinant.allclose` and numpy's slogdet at rtol 1e-10.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as r_api
import repro_torch
from repro.core.decipher import Determinant as RDeterminant
from repro.core.faults import ServerFault as RServerFault
from repro_torch.api import (
    BoundaryViolation,
    EdgeServer,
    InlineTransport,
    MultiprocessTransport,
    ShardMapTransport,
    ShardResult,
    ShardTask,
    SocketTransport,
    SPDCClient,
    ThreadPoolTransport,
    TransportConfig,
    TransportError,
    TransportTimeout,
    resolve_transport,
)
from repro_torch.core.faults import ServerFault
from repro_torch.core.lu import lu_nserver

N = 4
CPU = "cpu"


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.standard_normal(shape) + n * np.eye(n)


def _dets(res):
    return res.dets if hasattr(res, "dets") else [res.det]


def _matches_slogdet(res, m):
    ms = m if m.ndim == 3 else m[None]
    for det, mi in zip(_dets(res), ms):
        sign, logabs = np.linalg.slogdet(mi)
        assert det.sign == sign
        np.testing.assert_allclose(det.logabs, logabs, rtol=1e-10)


# ----------------------------------------------------------- trust boundary
def test_shard_tasks_carry_no_plaintext_or_key_material():
    from repro_torch.core.keygen import keygen

    n = 24
    m = _wellcond(n, seed=11)
    client = SPDCClient(device=CPU)
    session = client.open_session(m, N)
    tasks = session.tasks(check_boundary=True)
    seed = session.seeds[0]
    secrets = np.concatenate([[seed.psi], keygen(client.lambda2, seed, n).v])

    def informative(a):
        a = np.asarray(a).ravel()
        return a[(a != 0.0) & (np.abs(a) != 1.0)]

    assert [t.server for t in tasks] == list(range(N))
    for t in tasks:
        assert isinstance(t.x_row, np.ndarray)
        payload = informative(t.x_row)
        assert np.intersect1d(payload, informative(m)).size == 0
        assert np.intersect1d(payload, secrets).size == 0
        assert t.u_upstream is None  # the relay is the transport's job
        assert len(t.subseed) == 32 and t.subseed != seed.digest
        assert not np.shares_memory(t.x_row, session.x_aug.numpy())
        b = session.block
        rows = slice(t.server * b, min((t.server + 1) * b, n))
        plain = m[rows, :]
        if plain.size:
            crypt = t.x_row[: plain.shape[0], :n]
            c = np.corrcoef(plain.ravel(), crypt.ravel())[0, 1]
            assert abs(c) < 0.5, f"server {t.server} strip correlates: {c}"


def test_tasks_match_the_reference_bit_for_bit():
    """No border (p = 0), so the ciphertext rows, sub-seeds and session
    ids equal the reference's, and so do the frames."""
    m = _wellcond(16, seed=12)
    ours = SPDCClient(device=CPU).open_session(m, N)
    theirs = r_api.SPDCClient().open_session(m, N)
    assert ours.session_id == theirs.session_id
    for got, want in zip(ours.tasks(), theirs.tasks()):
        assert got.to_bytes() == want.to_bytes()


def test_boundary_violation_on_plaintext_payload():
    n = 16
    m = _wellcond(n, seed=13)
    session = SPDCClient(device=CPU).open_session(m, N)
    session.x_aug = session.x_aug.clone()
    session.x_aug[:n, :n] = torch.from_numpy(m)
    with pytest.raises(BoundaryViolation, match="plaintext"):
        session.tasks(check_boundary=True)


def test_boundary_violation_on_unreviewed_field():
    session = SPDCClient(device=CPU).open_session(_wellcond(8, seed=14), 2)
    task = session.tasks()[0]
    object.__setattr__(task, "psi", 1.0)
    with pytest.raises(BoundaryViolation, match="unreviewed"):
        session._assert_boundary([task], False)


# ------------------------------------------------- transport equivalence
@pytest.mark.parametrize("batch", [None, 3, "mixed"])
def test_threadpool_bit_equal_to_inline(batch):
    if batch == "mixed":
        base = _wellcond(20, seed=17)
        m = [base, base[:9, :9], base[:14, :14]]
    else:
        m = _wellcond(20 if batch is None else 16, seed=17, batch=batch)
    client = SPDCClient(device=CPU)
    with ThreadPoolTransport(device=CPU) as tp:
        session = client.open_session(m, N)
        l, u = session._assemble(tp.factor(session.tasks()))
        l_inline, u_inline = InlineTransport().sweep(session.x_aug, N)
        assert torch.equal(l, l_inline) and torch.equal(u, u_inline)
        a = repro_torch.outsource_determinant(m, N, device=CPU)
        b = repro_torch.outsource_determinant(m, N, device=CPU, transport=tp)
    assert np.all(b.verified)
    for da, db in zip(_dets(a), _dets(b)):
        assert da == db
    ref = r_api.SPDCClient().open_session(m, N).run("threadpool")
    for got, want in zip(_dets(b), _dets(ref)):
        assert RDeterminant(**dataclasses.asdict(got)).allclose(want)


def test_session_roles_drive_manually():
    """Client, EdgeServer farm and collect without the facade, every
    message through the wire — the determinant the facade gives."""
    n = 20
    m = _wellcond(n, seed=23)
    session = SPDCClient(method="q2", device=CPU).open_session(m, N)
    edges = [EdgeServer(i, device=CPU) for i in range(N)]
    results, u_rows = [], []
    for task in session.tasks():
        task = ShardTask.from_bytes(task.to_bytes())
        if task.server > 0:
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        res = ShardResult.from_bytes(edges[task.server].run(task).to_bytes())
        results.append(res)
        u_rows.append(res.u_row)
    out = session.collect(results)
    ref = repro_torch.outsource_determinant(m, N, method="q2", device=CPU)
    assert out.verified and out.det == ref.det
    with pytest.raises(ValueError, match="one ShardResult per server"):
        session.collect(results[:-1])


def test_edge_server_requires_relay_rows():
    t = ShardTask(server=1, num_servers=2, x_row=_wellcond(8)[:4],
                  subseed=b"\x04" * 32)
    with pytest.raises(ValueError, match="upstream"):
        EdgeServer(device=CPU).run(t)
    bad = dataclasses.replace(t, num_servers=3)
    with pytest.raises(ValueError, match="tile"):
        EdgeServer(device=CPU).run(bad)
    with pytest.raises(ValueError, match="style"):
        EdgeServer(device=CPU).run(dataclasses.replace(t, style="other"))


# ----------------------------------------------------- resolution, lifecycle
def test_resolve_transport_rules():
    assert resolve_transport(None).name == "inline"
    tp = resolve_transport("threadpool", device=CPU)
    assert tp.name == "threadpool" and tp is resolve_transport("threadpool",
                                                               device=CPU)
    inst = InlineTransport()
    assert resolve_transport(inst) is inst
    with pytest.raises(ValueError, match="unknown transport"):
        resolve_transport("carrier-pigeon")
    # "shardmap" (ROADMAP A12, ported; it raised before) resolves to one
    # shared pipeline transport per device, as distributed=True does
    sm = resolve_transport("shardmap", device=CPU)
    assert isinstance(sm, ShardMapTransport) and sm.name == "shardmap"
    assert sm.fused and sm.style == "pipeline" and sm.program == "baseline"
    assert sm is resolve_transport(None, distributed=True, device=CPU)
    assert resolve_transport(None, distributed=True).name == "shardmap"
    with pytest.raises(ValueError, match="conflicts"):
        resolve_transport("threadpool", distributed=True)
    with pytest.raises(ValueError, match="conflicts"):
        resolve_transport(inst, distributed=True)
    assert resolve_transport(sm, distributed=True) is sm
    # "socket" (ROADMAP A9, ported) resolves to one shared self-hosting
    # transport per device; its daemons spawn at the first dispatch only
    sock = resolve_transport("socket", device=CPU)
    try:
        assert isinstance(sock, SocketTransport) and sock.name == "socket"
        assert sock is resolve_transport("socket", device=CPU)
        assert sock.addresses == () and sock._spawned == {}
    finally:
        sock.close()


def test_transport_config_rules():
    cfg = TransportConfig("threadpool", max_workers=2)
    assert hash(cfg) == hash(TransportConfig("threadpool", max_workers=2))
    shared = resolve_transport(cfg, device=CPU)
    assert shared is resolve_transport(TransportConfig("threadpool",
                                                       max_workers=2),
                                       device=CPU)
    owned = cfg.build(device=CPU)
    try:
        assert owned is not shared and owned.name == "threadpool"
    finally:
        owned.close()
    shared.close()
    rebuilt = resolve_transport(cfg, device=CPU)
    assert rebuilt is not shared and not rebuilt.closed
    with pytest.raises(ValueError, match="unknown transport"):
        TransportConfig("carrier-pigeon")
    with pytest.raises(ValueError, match="max_workers"):
        TransportConfig("socket", max_workers=3)
    with pytest.raises(ValueError, match="timeout"):
        TransportConfig("inline", timeout=5.0)
    with pytest.raises(ValueError, match="addresses"):
        TransportConfig("threadpool", addresses=("unix:///w.sock",))
    # the socket config (ROADMAP A9, ported) builds a SocketTransport
    # with its addresses (a list is kept hashable) and deadline
    sock_cfg = TransportConfig("socket", addresses=["unix:///w.sock"],
                               timeout=5.0)
    assert hash(sock_cfg) == hash(TransportConfig(
        "socket", addresses=("unix:///w.sock",), timeout=5.0))
    built = sock_cfg.build(device=CPU)
    try:
        assert isinstance(built, SocketTransport)
        assert built.addresses == ("unix:///w.sock",) and built.timeout == 5.0
    finally:
        built.close()


def test_transport_lifecycle_uniform():
    for make in (InlineTransport, lambda: ThreadPoolTransport(device=CPU)):
        with make() as t:
            assert not t.closed
        assert t.closed
        t.close()  # idempotent
        with pytest.raises(TransportError, match="closed"):
            t.factor([])
        with pytest.raises(TransportError, match="closed"):
            t.driver_submit(lambda: None)


def test_client_owns_config_transport_not_instances():
    with SPDCClient(transport=TransportConfig("threadpool"),
                    device=CPU) as client:
        inner = client.transport
        assert isinstance(inner, ThreadPoolTransport)
        assert client.open_session(_wellcond(12, seed=63), 2).run().verified
    assert inner.closed
    mine = ThreadPoolTransport(device=CPU)
    try:
        with SPDCClient(transport=mine, device=CPU) as client:
            assert client.transport is mine
        assert not mine.closed
    finally:
        mine.close()


def test_facade_takes_every_transport_spec():
    """outsource_determinant resolves a name, a config or an instance on
    its own device; all give the inline sweep's determinant."""
    m = _wellcond(12, seed=61)
    want = repro_torch.outsource_determinant(m, 2, device=CPU)
    with ThreadPoolTransport(device=CPU) as mine:
        for spec in ("inline", "threadpool", TransportConfig("threadpool"),
                     mine):
            got = repro_torch.outsource_determinant(m, 2, device=CPU,
                                                    transport=spec)
            assert got.verified and got.det == want.det, spec


# ------------------------------------------------------ async surfaces
def test_run_pipelined_overlaps_and_preserves_order():
    mats = [_wellcond(12 + 2 * i, seed=70 + i) for i in range(5)]
    client = SPDCClient(device=CPU)
    with ThreadPoolTransport(device=CPU) as tp:
        outs = client.run_pipelined(mats, 2, depth=3, transport=tp)
    assert len(outs) == len(mats)
    for m, r in zip(mats, outs):
        assert r.verified
        _matches_slogdet(r, m)
        assert r.report.timings.dispatch_s > 0
    with pytest.raises(ValueError, match="depth"):
        client.run_pipelined(mats, 2, depth=0)


def test_session_start_matches_run_on_inline():
    m = _wellcond(16, seed=67)
    client = SPDCClient(device=CPU)
    pending = client.open_session(m, 2).start()
    assert pending.done()
    a = pending.result()
    b = client.open_session(m, 2).run()
    assert a.verified and b.verified and a.det == b.det


# --------------------------------------------------- faults via transports
def test_threadpool_tamper_rejected_with_culprit_like_reference():
    m = _wellcond(16, seed=29)
    plan = dict(server=1, mode="block", magnitude=0.3)
    got = repro_torch.outsource_determinant(
        m, N, faults=ServerFault(**plan), transport="threadpool", device=CPU)
    want = r_api.SPDCClient().open_session(
        m, N, faults=RServerFault(**plan)).run("threadpool")
    assert not got.verified and not want.verified
    assert got.report.verdict.culprit == want.report.verdict.culprit == 1


@pytest.mark.parametrize("batch", [None, 3])
def test_inline_in_band_tamper_rejected_with_culprit(batch):
    m = _wellcond(16, seed=31, batch=batch)
    plan = dict(server=2, mode="single", in_band=True,
                matrices=None if batch is None else (1,))
    got = repro_torch.outsource_determinant(
        m, N, method="q2", faults=ServerFault(**plan), device=CPU)
    want = r_api.SPDCClient(method="q2").open_session(
        m, N, faults=RServerFault(**plan)).run()
    np.testing.assert_array_equal(got.verified, want.verified)
    np.testing.assert_array_equal(got.report.verdict.culprit,
                                  want.report.verdict.culprit)
    assert np.count_nonzero(~np.atleast_1d(got.verified)) == 1


# ---------------------------------------------------------- no fallback
@pytest.mark.parametrize("make", [
    lambda: ThreadPoolTransport(),
    lambda: MultiprocessTransport(),
    lambda: EdgeServer(),
    lambda: EdgeServer(3),
    lambda: TransportConfig("threadpool").build(),
], ids=["threadpool", "multiprocess", "edge", "edge-id", "config"])
def test_server_side_refuses_cpu_fallback(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_inline_message_methods_refuse_cpu_fallback():
    """The inline transport's sweep follows its tensors; its message
    methods build an EdgeServer on the transport's device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    session = SPDCClient(device=CPU).open_session(_wellcond(8, seed=3), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        InlineTransport().factor(session.tasks())
    results = InlineTransport(device=CPU).factor(session.tasks())
    assert session.collect(results).verified


# -------------------------------------------------- worker processes
@pytest.fixture(scope="module")
def mp_transport():
    t = MultiprocessTransport(device=CPU)
    yield t
    t.close()


def test_multiprocess_honest_end_to_end(mp_transport):
    m = _wellcond(16, seed=31)
    res = repro_torch.outsource_determinant(m, N, device=CPU,
                                            transport=mp_transport)
    assert len(mp_transport.workers) == N  # genuinely 4 processes
    assert res.verified
    _matches_slogdet(res, m)
    session = SPDCClient(device=CPU).open_session(m, N)
    l, u = session._assemble(mp_transport.factor(session.tasks()))
    l_inline, u_inline, _ = lu_nserver(session.x_aug, N)
    assert torch.equal(l, l_inline) and torch.equal(u, u_inline)


def test_multiprocess_batched_sweep(mp_transport):
    stack = _wellcond(16, seed=41, batch=2)
    res = repro_torch.outsource_determinant(stack, N, device=CPU,
                                            transport=mp_transport)
    assert np.asarray(res.verified).all()
    _matches_slogdet(res, stack)


def test_multiprocess_timeout_is_typed_and_worker_respawns(mp_transport):
    import time

    m = _wellcond(16, seed=43)
    task = SPDCClient(device=CPU).open_session(m, N).tasks()[0]
    mp_transport.submit(task, 0)  # worker 0 is up and warm
    pid_before = mp_transport._procs[0].pid
    slow = ServerFault(server=0, kind="delay", delay_s=30.0)
    t0 = time.monotonic()
    fut = mp_transport.start(task, 0, faults=(slow,), timeout=2.0)
    with pytest.raises(TransportTimeout, match="request deadline"):
        mp_transport.result(fut, timeout=60)
    assert time.monotonic() - t0 < 20.0  # did not wait out the sleep
    assert issubclass(TransportTimeout, TransportError)
    assert 0 not in mp_transport.workers  # killed and discarded
    res = mp_transport.submit(task, 0)
    assert res.server == 0
    assert mp_transport._procs[0].pid != pid_before
