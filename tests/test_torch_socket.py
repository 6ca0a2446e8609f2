"""The port's SocketTransport on the CPU: warm worker daemons over Unix
sockets, the fault matrix (honest / tamper-localize-heal / death /
rateless streaming), wire-level adversaries (truncated frames, oversized
length prefixes, HELLO version mismatches, mid-session disconnects) as
typed TransportErrors, and the two packages' daemons and clients serving
each other. Mirrors tests/test_socket.py.

Against the reference: HELLO frames and length-prefixed framing
bit-equal; a port client over a reference daemon and a reference client
over a port daemon both verify, with determinants equal by
`Determinant.allclose`, and a tamper gets the same verdict and culprit.

The module's fleet is two port daemons and two reference daemons, each
in its own spawned process on the CPU, serving any worker id (worker i
reaches addresses[i % 2]). The self-hosting test spawns and kills its
own daemons, because that is what it checks; the disconnect test runs
its daemons in this process.
"""
import dataclasses
import multiprocessing
import os
import socket as socketlib
import struct
import threading
import time

import numpy as np
import pytest
import torch

import repro.api as r_api
from repro.api import socket_transport as r_sock
from repro.core import ServerFault as RServerFault
from repro.core import outsource_determinant as r_outsource
from repro_torch import ServerFault, outsource_determinant
from repro_torch.api import (
    MultiprocessTransport,
    SPDCClient,
    TransportConfig,
    TransportError,
    TransportProtocolError,
    TransportWorkerDied,
    resolve_transport,
    wire,
)
from repro_torch.api.socket_transport import (
    CAPS,
    MAX_FRAME,
    SOCKET_PROTO,
    SocketTransport,
    WorkerDaemon,
    _daemon_main,
    _hello_frame,
    _parse_hello,
    parse_address,
    recv_frame,
    send_frame,
)
from repro_torch.configs import RatelessConfig
from repro_torch.core.decipher import Determinant
from repro_torch.core.lu import lu_nserver

N = 4
CPU = "cpu"
#: seconds any one wait of this module may take
WAIT_S = 120.0


def _wellcond(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _same_det(got, want):
    """A port Determinant against a reference one (other class)."""
    return Determinant(**dataclasses.asdict(want)).allclose(got)


# ----------------------------------------------------------- fixtures
def _spawn(target, *args):
    proc = multiprocessing.get_context("spawn").Process(
        target=target, args=args, daemon=True)
    proc.start()
    return proc


def _wait_bound(address, proc, timeout=WAIT_S):
    """Block until the daemon's UDS path exists (it binds once it has
    imported its package and warmed up)."""
    path = parse_address(address)[1]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return
        if not proc.is_alive():
            raise RuntimeError(f"daemon for {address} exited ({proc.exitcode})")
        time.sleep(0.05)
    raise RuntimeError(f"daemon never bound {address}")


def _probe_hello(address, worker_id=0):
    """One throwaway wire-level handshake: the daemon's lifetime
    counters as a NEW client would see them."""
    s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    s.settimeout(WAIT_S)
    s.connect(parse_address(address)[1])
    with s:
        send_frame(s, _hello_frame(
            proto=SOCKET_PROTO, wire=wire.VERSION,
            role="client", worker_id=int(worker_id),
        ))
        return _parse_hello(recv_frame(s))


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{"port": 2 port daemon addresses, "ref": 2 reference daemon
    addresses}: real spawned processes on Unix sockets, shared by the
    module — their lifetime HELLO counters are how tests observe
    warmth. The reference daemons run with x64 on."""
    root = tmp_path_factory.mktemp("spdc-fleet")
    addrs = {kind: [f"unix://{root}/{kind}{i}.sock" for i in range(2)]
             for kind in ("port", "ref")}
    procs = [(a, _spawn(_daemon_main, a, None, CPU)) for a in addrs["port"]]
    procs += [(a, _spawn(r_sock._daemon_main, a, None, True))
              for a in addrs["ref"]]
    try:
        for a, p in procs:
            _wait_bound(a, p)
        yield {kind: tuple(a) for kind, a in addrs.items()}
    finally:
        for _, p in procs:
            p.terminate()
        for _, p in procs:
            p.join(timeout=10)


@pytest.fixture(scope="module")
def fleet(fleets):
    return fleets["port"]


@pytest.fixture()
def sock_transport(fleet):
    t = SocketTransport(fleet, connect_timeout=WAIT_S)
    yield t
    t.close()


# ------------------------------------------------- framing primitives
def test_parse_address():
    assert parse_address("unix:///tmp/x.sock") == ("unix", "/tmp/x.sock")
    assert parse_address("tcp://127.0.0.1:8471") == ("tcp", ("127.0.0.1", 8471))
    for bad in ("http://x", "unix://", "tcp://noport"):
        with pytest.raises(ValueError):
            parse_address(bad)


def test_frame_roundtrip_and_goodbye():
    a, b = socketlib.socketpair()
    with a, b:
        send_frame(a, b"payload-bytes")
        assert recv_frame(b) == b"payload-bytes"
        big = os.urandom(200_000)  # sent as prefix + payload
        send_frame(a, big)
        assert recv_frame(b) == big
        send_frame(a, b"")  # goodbye sentinel
        assert recv_frame(b) == b""
        a.close()
        assert recv_frame(b) is None  # clean EOF at a frame boundary


# --------------------------------------------------- wire adversaries
def test_adversary_truncated_frame_is_typed():
    """A peer that dies mid-frame produced a truncated frame — a
    protocol violation, never retried."""
    a, b = socketlib.socketpair()
    with b:
        a.sendall(struct.pack(">I", 100) + b"only-ten-b")
        a.close()
        with pytest.raises(TransportProtocolError, match="truncated"):
            recv_frame(b)


def test_adversary_oversized_length_prefix_never_allocated():
    """A malicious length prefix must not OOM the client: the reader
    refuses before allocating."""
    a, b = socketlib.socketpair()
    with a, b:
        a.sendall(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(TransportProtocolError, match="oversized"):
            recv_frame(b)
    assert issubclass(TransportProtocolError, TransportError)


def _fake_daemon(reply_hello):
    """One-connection fake worker: accepts, reads the client HELLO,
    replies with `reply_hello` bytes, then serves nothing."""
    lsock = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(WAIT_S)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        with conn, lsock:
            recv_frame(conn)  # client HELLO
            send_frame(conn, reply_hello)
            recv_frame(conn)  # linger until the client hangs up

    threading.Thread(target=serve, daemon=True).start()
    return f"tcp://127.0.0.1:{port}"


def _one_task(n=8, servers=2):
    return SPDCClient(device=CPU).open_session(_wellcond(n), servers).tasks()[0]


def test_adversary_hello_version_mismatch_not_retried():
    """A daemon speaking the wrong socket-proto version is a protocol
    violation: typed, immediate, no reconnect storm."""
    addr = _fake_daemon(_hello_frame(
        proto=SOCKET_PROTO + 1, wire=wire.VERSION, role="worker",
        worker_id=0, served=None, caps=[], accept=True,
        connections=1, frames_served=0,
    ))
    with SocketTransport((addr,), connect_timeout=5.0) as t:
        with pytest.raises(TransportProtocolError, match="version mismatch"):
            t.submit(_one_task(), 0)


def test_adversary_non_worker_role_rejected():
    addr = _fake_daemon(_hello_frame(
        proto=SOCKET_PROTO, wire=wire.VERSION, role="client",
        worker_id=0, accept=True,
    ))
    with SocketTransport((addr,), connect_timeout=5.0) as t:
        with pytest.raises(TransportProtocolError, match="not a worker"):
            t.submit(_one_task(), 0)


def test_daemon_refuses_bad_client_hello(tmp_path):
    """Daemon side of the handshake: wrong version or an unserved worker
    id gets an explicit accept=False HELLO, not a silent EOF."""
    with WorkerDaemon(f"unix://{tmp_path}/w.sock", workers=(0, 1),
                      device=CPU) as d:
        def handshake(**fields):
            s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
            s.settimeout(WAIT_S)
            s.connect(parse_address(d.address)[1])
            with s:
                send_frame(s, _hello_frame(**fields))
                return _parse_hello(recv_frame(s))

        good = dict(proto=SOCKET_PROTO, wire=wire.VERSION, role="client")
        assert handshake(**good, worker_id=1)["accept"] is True
        assert handshake(**good, worker_id=7)["accept"] is False  # unserved
        assert handshake(**{**good, "proto": 99}, worker_id=0)["accept"] is False
        assert handshake(**{**good, "role": "worker"}, worker_id=0)["accept"] is False
        hello = handshake(**good, worker_id=0)
        assert hello["served"] == [0, 1] and hello["role"] == "worker"


def test_mid_session_disconnect_heals(tmp_path):
    """The daemon dies and is replaced between sweeps: the stale pooled
    connection surfaces a TYPED TransportWorkerDied, and a full session
    through the same transport heals by reconnecting — one drop costs
    one reconnect, not the session. (The daemons run in this process:
    closing one drops its live connections as a dead process would.)"""
    address = f"unix://{tmp_path}/w.sock"
    m = _wellcond(16, seed=5)
    d1 = WorkerDaemon(address, device=CPU)
    d1.start()
    d2 = None
    t = SocketTransport((address,), connect_timeout=10.0)
    try:
        assert outsource_determinant(m, 2, transport=t, device=CPU).verified
        d1.close()  # takes its live connections down with it
        d2 = WorkerDaemon(address, device=CPU)
        d2.start()
        task = _one_task(16)
        with pytest.raises((TransportWorkerDied, TransportProtocolError)):
            with t._worker_lock(0):
                t._request(0, task.to_bytes())
        res = outsource_determinant(m, 2, transport=t, device=CPU)  # reconnects
        assert res.verified
        assert t.hello(0)["connections"] >= 1  # the NEW daemon's counter
    finally:
        t.close()
        for d in (d1, d2):
            if d is not None:
                d.close()


# ------------------------------------------- acceptance matrix (UDS, N=4)
def test_honest_end_to_end(sock_transport, fleet):
    """N = 4 workers on two real daemons; every message crosses as
    length-prefixed wire frames; det matches numpy at rtol 1e-10."""
    m = _wellcond(16, seed=31)
    res = outsource_determinant(m, N, transport=sock_transport, device=CPU)
    assert len(sock_transport.workers) == N  # one connection per worker
    ws, wl = np.linalg.slogdet(m)
    assert res.verified and res.det.sign == ws
    np.testing.assert_allclose(res.det.logabs, wl, rtol=1e-10)
    hello = sock_transport.hello(0)
    assert hello["role"] == "worker" and hello["proto"] == SOCKET_PROTO
    # a fresh handshake reads each daemon's LIFETIME counter: all served
    assert all(_probe_hello(a)["frames_served"] >= 1 for a in fleet)


def test_socket_factors_bit_identical_to_multiprocess(fleet):
    """The equivalence bar: the same session's ShardTasks produce
    bit-identical ShardResults over sockets and over process pipes — the
    transport moves bytes, it must not change a single one. (N = 2, so
    the pipes spawn two workers.)"""
    session = SPDCClient(device=CPU).open_session(_wellcond(16, seed=33), 2)
    tasks = session.tasks()
    with SocketTransport(fleet, connect_timeout=WAIT_S) as st, \
            MultiprocessTransport(device=CPU, timeout=WAIT_S) as mt:
        rs = st.factor(tasks)
        rm = mt.factor(tasks)
    for a, b in zip(rs, rm, strict=True):
        assert a.server == b.server and a.subseed == b.subseed
        np.testing.assert_array_equal(a.l_row, b.l_row)  # bit-exact
        np.testing.assert_array_equal(a.u_row, b.u_row)
    assert session.collect(rs).verified


@pytest.mark.parametrize("method", ["q2", "q3"])
def test_tamper_localize_heal(sock_transport, method):
    """Worker 1 tampers its strip in-band; the client localizes it over
    the socket boundary and heals via re-dispatched ShardTasks — the
    replacement id N wraps onto the same fleet (addresses[N % 2])."""
    m = _wellcond(16, seed=37)
    honest = outsource_determinant(m, N, device=CPU)
    res = outsource_determinant(
        m, N, method=method,
        faults=ServerFault(server=1, mode="block", magnitude=0.3),
        recover=True, standby=1, transport=sock_transport, device=CPU,
    )
    assert res.verified and res.report.recovery.ok
    assert res.report.recovery.events[0].server == 1
    assert 1 in res.report.recovery.servers_replaced
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs,
                               rtol=1e-10)


def test_rateless_streams_over_sockets(fleet):
    """Rateless dispatch over real daemons: a sleeping worker's request
    times out, its CONNECTION is dropped (the daemon survives), the
    strip re-streams to a live sibling, and the fleet report attributes
    the slowness."""
    m = _wellcond(16, seed=53)
    cfg = RatelessConfig(request_timeout_s=1.0, probation_cooldown_s=60.0)
    client = SPDCClient(rateless=cfg, recover=True, device=CPU)
    fault = ServerFault(server=1, kind="delay", delay_s=8.0)
    with SocketTransport(fleet, connect_timeout=WAIT_S) as t:
        out = client.open_session(m, N, faults=fault).run(t)
    assert out.verified
    assert out.report.fleet.timeouts >= 1
    w1 = out.report.fleet.workers[1]
    assert w1["failures"] >= 1 and w1["completed"] == 0
    ws, wl = np.linalg.slogdet(m)
    np.testing.assert_allclose(out.det.logabs, wl, rtol=1e-8)


def test_rateless_over_sockets_bit_equal_to_lu_nserver(sock_transport):
    """An honest rateless single matrix over the daemons: one lane, each
    strip lu_block_row's "nserver" order over the accepted U rows, so
    the factors are bit-equal to lu_nserver(x_aug, F) on the same
    device."""
    client = SPDCClient(rateless=True, device=CPU)
    session = client.open_session(_wellcond(32, seed=57), N)
    from repro_torch.distrib.rateless import run_rateless

    l, u, rpt = run_rateless(session, sock_transport, client.rateless,
                             client.fleet)
    assert rpt.inline_strips == 0 and rpt.dispatches == session.partitions
    wl, wu, _ = lu_nserver(session.x_aug, session.partitions)
    assert torch.equal(torch.from_numpy(l), wl)
    assert torch.equal(torch.from_numpy(u), wu)


def test_daemons_stay_warm_across_clients(fleet):
    """The point of the transport: a NEW client (fresh SocketTransport,
    as after a client restart) lands on the SAME daemon — its lifetime
    counters keep growing and earlier clients' frames are visible."""
    m = _wellcond(12, seed=61)
    with SocketTransport(fleet, connect_timeout=WAIT_S) as t1:
        assert outsource_determinant(m, N, transport=t1, device=CPU).verified
        first = t1.hello(0)["connections"]
    with SocketTransport(fleet, connect_timeout=WAIT_S) as t2:
        assert outsource_determinant(m, N, transport=t2, device=CPU).verified
        hello = t2.hello(0)
    assert hello["connections"] > first  # same daemon, one more client
    assert hello["frames_served"] > 0  # warm: it served before we arrived


def test_session_start_overlaps_wire(sock_transport):
    """The async-overlap API end to end on real sockets: session k+1's
    PMOP runs while session k's ShardTasks ride the wire; both collect on
    the calling thread, in order, verified."""
    client = SPDCClient(device=CPU)
    m1, m2 = _wellcond(16, seed=71), _wellcond(16, seed=72)
    p1 = client.open_session(m1, N).start(sock_transport)
    # this PMOP overlaps p1's wire time — the pipeline's whole point
    p2 = client.open_session(m2, N).start(sock_transport)
    r2, r1 = p2.result(timeout=WAIT_S), p1.result(timeout=WAIT_S)
    assert p1.done() and p2.done()
    for m, r in ((m1, r1), (m2, r2)):
        ws, wl = np.linalg.slogdet(m)
        assert r.verified and r.det.sign == ws
        np.testing.assert_allclose(r.det.logabs, wl, rtol=1e-10)
    t = r1.report.timings
    assert t.pmop_s > 0 and t.dispatch_s > 0 and t.collect_s > 0


# ------------------------------------------ self-hosting and lifecycle
def test_self_hosted_daemons_death_respawn_and_leak_free():
    """Bare `SocketTransport(device="cpu")` self-hosts one warm UDS
    daemon process per worker id; a killed daemon is respawned
    transparently; close() terminates every spawned process and removes
    the socket dir — the leak check."""
    m = _wellcond(16, seed=81)
    t = SocketTransport(connect_timeout=WAIT_S, device=CPU)
    try:
        res = outsource_determinant(m, 2, transport=t, device=CPU)
        assert res.verified
        assert sorted(t._spawned) == [0, 1]
        victim = t._spawned[1][0]
        victim.terminate()
        victim.join(timeout=10)
        res2 = outsource_determinant(m, 2, transport=t, device=CPU)
        assert res2.verified  # respawn heals
        assert t._spawned[1][0].pid != victim.pid
    finally:
        procs = [p for p, _ in t._spawned.values()]
        tmpdir = t._tmpdir
        t.close()
    assert t.closed
    assert tmpdir is not None and not os.path.exists(tmpdir)
    for p in procs:
        assert not p.is_alive()
    with pytest.raises(TransportError, match="closed"):
        t.factor([])


def test_transport_config_socket_resolution(fleet):
    """The unified transport= surface reaches sockets: a TransportConfig
    with addresses builds a working transport, equal configs share ONE
    process-wide instance via resolve_transport, and build() is the
    fresh-owned escape hatch."""
    cfg = TransportConfig("socket", addresses=fleet, timeout=WAIT_S)
    shared = resolve_transport(cfg, device=CPU)
    assert shared is resolve_transport(TransportConfig(
        "socket", addresses=fleet, timeout=WAIT_S), device=CPU)
    owned = cfg.build(device=CPU)
    assert owned is not shared
    m = _wellcond(12, seed=91)
    try:
        res = outsource_determinant(m, N, transport=cfg, device=CPU)
        assert res.verified
        ws, wl = np.linalg.slogdet(m)
        np.testing.assert_allclose(res.det.logabs, wl, rtol=1e-10)
    finally:
        owned.close()
    # the client OWNS a config-built transport and closes it
    with SPDCClient(transport=cfg, device=CPU) as client:
        inner = client.transport
        assert isinstance(inner, SocketTransport) and inner is not shared
        assert client.open_session(m, N).run().verified
    assert inner.closed
    assert not shared.closed  # the registry instance is untouched
    shared.close()


# ------------------------------------------------ parity with the reference
def test_constants_and_hello_frames_bit_equal_to_reference():
    assert (SOCKET_PROTO, MAX_FRAME, CAPS) == \
        (r_sock.SOCKET_PROTO, r_sock.MAX_FRAME, r_sock.CAPS)
    client = dict(proto=SOCKET_PROTO, wire=wire.VERSION, role="client",
                  worker_id=3)
    worker = dict(proto=SOCKET_PROTO, wire=wire.VERSION, role="worker",
                  worker_id=3, served=[0, 3], caps=list(CAPS), accept=True,
                  connections=7, frames_served=41)
    for fields in (client, worker, {**worker, "served": None}):
        assert _hello_frame(**fields) == r_sock._hello_frame(**fields)
        assert _parse_hello(r_sock._hello_frame(**fields)) == \
            r_sock._parse_hello(_hello_frame(**fields))
    # the same bytes on the socket, short frames and long ones
    for payload in (b"", b"abc", os.urandom(100_000)):
        a, b = socketlib.socketpair()
        with a, b:
            send_frame(a, payload)
            r_sock.send_frame(a, payload)
            a.shutdown(socketlib.SHUT_WR)
            assert r_sock.recv_frame(b) == payload
            assert recv_frame(b) == payload


def test_daemon_hellos_agree_with_reference(fleets):
    """A port daemon and a reference daemon answer the same client HELLO
    with the same fields (their lifetime counters aside)."""
    port, ref = _probe_hello(fleets["port"][0], 5), \
        _probe_hello(fleets["ref"][0], 5)
    counters = ("connections", "frames_served")
    assert {k: v for k, v in port.items() if k not in counters} == \
        {k: v for k, v in ref.items() if k not in counters}
    assert port["accept"] is True and port["worker_id"] == 5


def test_port_client_against_reference_daemon(fleets):
    """A port client over SocketTransport to reference daemons: verified,
    the reference's determinant; a tamper gets the reference's own
    verdict and culprit on the same daemons."""
    m = _wellcond(16, seed=97)
    fault = dict(server=1, mode="block", magnitude=0.3)
    with SocketTransport(fleets["ref"], connect_timeout=WAIT_S) as pt, \
            r_sock.SocketTransport(fleets["ref"], connect_timeout=WAIT_S) as rt:
        got = outsource_determinant(m, N, transport=pt, device=CPU)
        want = r_outsource(m, N, transport=rt)
        bad = outsource_determinant(m, N, transport=pt, device=CPU,
                                    faults=ServerFault(**fault))
        rbad = r_outsource(m, N, transport=rt, faults=RServerFault(**fault))
    assert got.verified and want.verified and _same_det(got.det, want.det)
    assert not bad.verified and not rbad.verified
    assert bad.report.verdict.culprit == rbad.report.verdict.culprit == 1


def test_reference_client_against_port_daemon(fleets):
    """A reference client over its SocketTransport to port daemons:
    verified, the port's determinant; a tamper gets the port's own
    verdict and culprit on the same daemons."""
    m = _wellcond(16, seed=101)
    fault = dict(server=2, mode="block", magnitude=0.3)
    with r_sock.SocketTransport(fleets["port"], connect_timeout=WAIT_S) as rt, \
            SocketTransport(fleets["port"], connect_timeout=WAIT_S) as pt:
        want = r_outsource(m, N, transport=rt)
        got = outsource_determinant(m, N, transport=pt, device=CPU)
        rbad = r_outsource(m, N, transport=rt, faults=RServerFault(**fault))
        bad = outsource_determinant(m, N, transport=pt, device=CPU,
                                    faults=ServerFault(**fault))
        hello = rt.hello(0)
    assert want.verified and got.verified and _same_det(got.det, want.det)
    assert not rbad.verified and not bad.verified
    assert rbad.report.verdict.culprit == bad.report.verdict.culprit == 2
    assert hello["role"] == "worker" and hello["caps"] == list(CAPS)


def test_reference_client_heals_on_port_daemon(fleets):
    """Recovery across the packages: the reference client localizes a
    port daemon's tamper and heals it with re-dispatches to the same
    port daemons, as the port client does."""
    m = _wellcond(16, seed=103)
    fault = dict(server=1, mode="block", magnitude=0.3)
    with r_sock.SocketTransport(fleets["port"], connect_timeout=WAIT_S) as rt:
        want = r_outsource(m, N, transport=rt, recover=True, standby=1,
                           faults=RServerFault(**fault))
    with SocketTransport(fleets["port"], connect_timeout=WAIT_S) as pt:
        got = outsource_determinant(m, N, transport=pt, device=CPU,
                                    recover=True, standby=1,
                                    faults=ServerFault(**fault))
    for res in (want, got):
        assert res.verified and res.report.recovery.ok
        assert res.report.recovery.events[0].server == 1
    assert _same_det(got.det, want.det)
    assert r_api.SocketTransport is r_sock.SocketTransport
