"""SocketTransport — the SPDC trust boundary over real sockets (port of
repro.api.socket_transport; frames and handshakes are byte-identical to
the reference's, so port and reference daemons serve each other's
clients).

This is the networked realization of the role-split API (DESIGN.md §9):
edge workers are PERSISTENT DAEMONS (`python -m
repro_torch.launch.serve_worker`, or the in-library `WorkerDaemon`)
reached over TCP or Unix-domain sockets, and the client holds a
connection pool to them. Where MultiprocessTransport pays a process
spawn, the torch import and the CUDA context per client process, a
socket daemon pays them ONCE, before it binds: its EdgeServers, its
loaded kernels and its device context stay warm across sessions, across
client restarts, and across every client that connects — the deployment
shape the paper's edge-server fleet actually has.

Framing (one frame = one protocol message):

    ┌───────────────┬───────────────────────────────┐
    │ length  u32 BE│ payload — a wire.py codec frame│
    └───────────────┴───────────────────────────────┘

  * a ZERO length is the goodbye sentinel (polite close);
  * a length above ``MAX_FRAME`` (1 GiB) is an oversized prefix —
    the reader refuses to allocate and drops the connection with
    ``TransportProtocolError`` (a malicious peer cannot OOM the client
    by lying about length);
  * a peer that closes mid-frame produced a truncated frame — also
    ``TransportProtocolError``. Protocol violations are never retried:
    a peer speaking the wrong protocol will speak it again.

Handshake: the first frame each way is a HELLO (wire-codec kind
``"Hello"``) carrying the socket-protocol version ``SOCKET_PROTO``, the
wire-codec version, the speaker's role, the worker id the client wants,
the id set the daemon serves, and capability strings. Either side that
sees an incompatible version or role drops the connection; the daemon
additionally answers ``accept=False`` before closing so the client gets
a typed error instead of a silent EOF. The daemon's HELLO also reports
its lifetime ``connections``/``frames_served`` counters — how tests (and
operators) observe that a warm daemon, not a fresh spawn, served them.

Request discipline mirrors the multiprocess pipe: strict lock-step
request-reply per connection (ShardTask → ShardResult frame,
FaultPlanFrame → b"ACK", failures → b"ERR:..."), one connection per
worker id on the client, a per-worker lock so different workers'
requests overlap while one worker's connection stays in lock-step. A
request deadline kills the CONNECTION (the daemon and its warm state
survive; the late reply dies with the socket) and raises
TransportTimeout; a dead connection raises TransportWorkerDied and the
request is retried once over a fresh connection before the error
surfaces. Reconnects ride the SAME FleetHealth machinery the rateless
scheduler uses (distrib.rateless): every failed connect is an
``observe_failure`` — exponential backoff with deterministic jitter —
and the pool won't hammer a dead endpoint any harder than the scheduler
would dispatch to it.

Addressing: ``addresses`` lists the fleet's endpoints
(``"tcp://host:port"`` or ``"unix:///path.sock"``); worker i connects to
``addresses[i % len(addresses)]``, so verification-driven replacement
ids N, N+1, … (recovery standbys) wrap onto the same physical fleet.
With NO addresses the transport self-hosts: it spawns (never forks) one
local warm UDS daemon per worker id on demand, computing on the
transport's device (and respawns it if it dies), which is what makes the
bare string ``"socket"`` meaningful everywhere a ``transport=`` argument
is accepted. On a CUDA device the kernels are built here before the
first daemon starts, so the daemons load them and never run nvcc
side by side.

Devices: a daemon computes on the device it was started with (None =
the CUDA device, RuntimeError without one; "cpu" runs the plain path).
The dtype rides on each frame: there is no process-wide precision
switch to configure, where the reference's daemons take ``enable_x64``.
"""
from __future__ import annotations

import os
import shutil
import socket
import struct
import tempfile
import threading
import time

import torch

from ..device import resolve_device
from . import wire
from .messages import FaultPlanFrame
from .server import EdgeServer
from .transport import (
    Transport,
    TransportError,
    TransportProtocolError,
    TransportTimeout,
    TransportWorkerDied,
    _run_relay,
    serve_frame,
)

__all__ = [
    "SocketTransport",
    "WorkerDaemon",
    "SOCKET_PROTO",
    "MAX_FRAME",
    "parse_address",
    "send_frame",
    "recv_frame",
]

#: socket-protocol version spoken in HELLO; bumped when the framing or
#: handshake changes incompatibly (independent of wire.VERSION, which
#: versions the payload codec).
SOCKET_PROTO = 1

#: refuse to allocate a frame larger than this — an attacker-controlled
#: length prefix must not be able to OOM the reader.
MAX_FRAME = 1 << 30

#: capabilities advertised by this implementation's daemons.
CAPS = ("faultplan", "rateless")

_HELLO_KIND = "Hello"


# -- framing primitives ------------------------------------------------------


def parse_address(addr: str) -> tuple[str, object]:
    """``"unix:///path.sock"`` → ("unix", path); ``"tcp://host:port"`` →
    ("tcp", (host, port))."""
    if addr.startswith("unix://"):
        path = addr[len("unix://"):]
        if not path:
            raise ValueError(f"empty unix socket path in {addr!r}")
        return "unix", path
    if addr.startswith("tcp://"):
        host, sep, port = addr[len("tcp://"):].rpartition(":")
        if not sep or not host:
            raise ValueError(f"tcp address needs host:port, got {addr!r}")
        return "tcp", (host, int(port))
    raise ValueError(
        f"unsupported address {addr!r}; use tcp://host:port or "
        "unix:///path.sock"
    )


def _stream_socket(family: str) -> socket.socket:
    """A stream socket of the address family; TCP without Nagle's
    delay, so a frame's payload never waits on the ACK of its length
    prefix (send_frame sends the two apart)."""
    if family == "unix":
        return socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def send_frame(sock: socket.socket, payload: bytes) -> None:
    """One length-prefixed frame; ``b""`` sends the goodbye sentinel.
    The prefix goes out on its own, so a payload of hundreds of MB is
    never copied to prepend four bytes."""
    sock.sendall(struct.pack(">I", len(payload)))
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Exactly n bytes, read into one buffer allocated up front, or None
    on EOF at a frame boundary (no bytes read). EOF MID-read is a
    truncated frame → TransportProtocolError."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            if not got:
                return None
            raise TransportProtocolError(
                f"truncated frame: peer closed after {got}/{n} bytes"
            )
        got += k
    return buf


def recv_frame(sock: socket.socket, max_frame: int = MAX_FRAME
               ) -> bytearray | None:
    """One frame's payload (a bytearray); empty for the goodbye
    sentinel, None for a clean EOF (peer closed between frames). Raises
    TransportProtocolError on a truncated frame or an oversized length
    prefix — the reader never allocates more than `max_frame`."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack(">I", head)
    if length == 0:
        return bytearray()
    if length > max_frame:
        raise TransportProtocolError(
            f"oversized length prefix: peer claims a {length}-byte frame "
            f"(cap {max_frame}); refusing to allocate"
        )
    body = _recv_exact(sock, length)
    if body is None:
        raise TransportProtocolError(
            f"truncated frame: peer closed before its {length}-byte payload"
        )
    return body


# -- HELLO handshake ---------------------------------------------------------


def _hello_frame(**fields) -> bytes:
    return wire.encode(_HELLO_KIND, fields, {})


def _parse_hello(data) -> dict:
    try:
        kind, scalars, _ = wire.decode(data)
    except wire.WireError as e:
        raise TransportProtocolError(f"bad HELLO frame: {e}") from e
    if kind != _HELLO_KIND:
        raise TransportProtocolError(
            f"handshake violation: expected a HELLO frame, got {kind!r}"
        )
    return scalars


def _check_server_hello(hello: dict, worker_id: int, addr: str) -> None:
    proto, wirev = hello.get("proto"), hello.get("wire")
    if proto != SOCKET_PROTO or wirev != wire.VERSION:
        raise TransportProtocolError(
            f"version mismatch at {addr}: daemon speaks socket-proto "
            f"{proto}/wire {wirev}, client speaks {SOCKET_PROTO}/"
            f"{wire.VERSION}"
        )
    if hello.get("role") != "worker":
        raise TransportProtocolError(
            f"peer at {addr} is not a worker daemon "
            f"(role={hello.get('role')!r})"
        )
    if not hello.get("accept", False):
        raise TransportProtocolError(
            f"daemon at {addr} refused worker id {worker_id} "
            f"(serves {hello.get('served')})"
        )


# -- worker daemon -----------------------------------------------------------


class WorkerDaemon:
    """One warm edge-worker daemon: a listener + a thread per client
    connection, all sharing this process's EdgeServers, one per worker
    id (and so its loaded kernels and device context — the warmth the
    transport exists for).

    `workers=None` serves ANY requested worker id (one daemon = whole
    fleet, connections for different ids run concurrently on their own
    threads); a tuple restricts the served set and the HELLO advertises
    it. Per-CONNECTION fault-plan state keeps one client's simulated
    fault plan from leaking into another client's session. `device` is
    where the strips are computed (None = the CUDA device, RuntimeError
    without one; "cpu" runs the plain path); the handler threads launch
    the kernels on the device's current stream.
    """

    def __init__(self, bind: str, workers=None, *, device=None):
        self.bind = bind
        self.workers = None if workers is None else tuple(workers)
        self.device = resolve_device(device)
        self.address: str | None = None  # actual (ephemeral ports resolved)
        self._family, self._target = parse_address(bind)
        self._edges: dict[int, EdgeServer] = {}  #: guarded-by: self._lock
        self._lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        #: live connections
        #: guarded-by: self._lock
        self._open: set[socket.socket] = set()
        self._stop = threading.Event()
        #: lifetime accepted connections
        self.connections = 0  #: guarded-by: self._lock
        #: lifetime request frames answered
        self.frames_served = 0  #: guarded-by: self._lock

    def _warm_up(self) -> None:
        """On a CUDA device: build (or load) the kernels and create the
        device context before binding, so no request pays nvcc or the
        context, and a bound daemon is a ready one."""
        if self.device.type != "cuda":
            return
        from ..kernels import build

        build.build()
        torch.empty(1, device=self.device)
        torch.cuda.synchronize(self.device)

    def start(self) -> str:
        """Warm up, bind + listen + spawn the accept loop; returns the
        actual address (ephemeral tcp ports resolved)."""
        self._warm_up()
        if self._family == "unix":
            if os.path.exists(self._target):
                os.unlink(self._target)
            sock = _stream_socket("unix")
            sock.bind(self._target)
            self.address = f"unix://{self._target}"
        else:
            host, port = self._target
            sock = _stream_socket("tcp")
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            self.address = f"tcp://{host}:{sock.getsockname()[1]}"
        sock.listen(32)
        self._listener = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="spdc-sockd-accept", daemon=True
        )
        self._accept_thread.start()
        return self.address

    def serve_forever(self) -> None:
        if self._listener is None:
            self.start()
        self._stop.wait()

    def _edge(self, worker_id: int) -> EdgeServer:
        with self._lock:
            if worker_id not in self._edges:
                self._edges[worker_id] = EdgeServer(worker_id,
                                                    device=self.device)
            return self._edges[worker_id]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            if self._family == "tcp":
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._handle, args=(conn,),
                name="spdc-sockd-conn", daemon=True,
            ).start()

    def _handle(self, sock: socket.socket) -> None:
        with self._lock:
            self._open.add(sock)
        try:
            self._serve_connection(sock)
        finally:
            with self._lock:
                self._open.discard(sock)

    def _serve_connection(self, sock: socket.socket) -> None:
        with sock:
            try:
                data = recv_frame(sock)
            except (TransportProtocolError, OSError):
                return  # garbage before HELLO: drop silently
            if not data:
                return
            try:
                hello = _parse_hello(data)
            except TransportProtocolError:
                return
            wid = hello.get("worker_id")
            ok = (
                hello.get("proto") == SOCKET_PROTO
                and hello.get("wire") == wire.VERSION
                and hello.get("role") == "client"
                and isinstance(wid, int)
                and (self.workers is None or wid in self.workers)
            )
            with self._lock:
                self.connections += 1
                conns, frames = self.connections, self.frames_served
            try:
                send_frame(sock, _hello_frame(
                    proto=SOCKET_PROTO,
                    wire=wire.VERSION,
                    role="worker",
                    worker_id=wid if isinstance(wid, int) else -1,
                    served=None if self.workers is None
                    else list(self.workers),
                    caps=list(CAPS),
                    accept=ok,
                    connections=conns,
                    frames_served=frames,
                ))
            except OSError:
                return
            if not ok:
                return
            edge = self._edge(wid)
            state: dict = {}  # per-connection fault plan
            while not self._stop.is_set():
                try:
                    data = recv_frame(sock)
                except (TransportProtocolError, OSError):
                    return
                if not data:
                    return  # goodbye or clean EOF
                reply = serve_frame(edge, state, data)
                with self._lock:
                    self.frames_served += 1
                try:
                    send_frame(sock, reply)
                except OSError:
                    return

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            # shutdown() first: a thread blocked in accept() is NOT woken
            # by close() alone on Linux — shutting the listening socket
            # down makes the pending accept raise, so the loop exits
            # instead of leaking a blocked thread per daemon
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # genuinely disconnect live clients: shutdown() wakes handler
        # threads blocked in recv (closing the fd alone would not)
        with self._lock:
            conns = list(self._open)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if self._family == "unix" and os.path.exists(self._target):
            try:
                os.unlink(self._target)
            except OSError:
                pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


def _daemon_main(bind: str, workers, device: str) -> None:
    """Entry point of a spawned daemon process: serve `workers` (None =
    any id) on `bind`, computing on `device` (a device string)."""
    from repro_torch.api.socket_transport import WorkerDaemon as _Daemon

    _Daemon(bind, workers, device=device).serve_forever()


# -- client transport --------------------------------------------------------


class SocketTransport(Transport):
    """Connection pool to a fleet of warm worker daemons (module doc).

    addresses: daemon endpoints; worker i → addresses[i % len]. Empty →
        self-host local UDS daemons per worker id on demand.
    timeout: default per-request deadline; a miss drops the CONNECTION
        (the daemon survives) and raises TransportTimeout.
    connect_timeout: total budget for one connect-with-backoff cycle,
        handshake included. Longer than the reference's 10 s by default:
        a self-hosted daemon imports torch and creates its device
        context before it binds.
    device: where self-hosted daemons compute (None = the CUDA device,
        RuntimeError without one; "cpu" the plain path); resolved when
        the first daemon is spawned. Daemons reached by address compute
        on their own devices.
    """

    name = "socket"

    def __init__(self, addresses=(), *, timeout: float = 600.0,
                 connect_timeout: float = 30.0, device=None):
        # lazy import: distrib.rateless imports api.transport, so a
        # module-level import here would cycle through the package
        from ..distrib.rateless import FleetHealth

        self.addresses = tuple(addresses)
        self.timeout = float(timeout)
        self.connect_timeout = float(connect_timeout)
        self.device = device
        self.health = FleetHealth()  # reconnect/backoff bookkeeping
        self._socks: dict[int, socket.socket] = {}  #: guarded-by: self._meta
        self._hellos: dict[int, dict] = {}  #: guarded-by: self._meta
        self._sent_plan: dict[int, tuple | None] = {}  #: guarded-by: self._meta
        self._locks: dict[int, threading.Lock] = {}
        self._meta = threading.RLock()
        self._io = None  # lazy executor behind start()
        #: wid -> (proc, uds path)
        #: guarded-by: self._meta
        self._spawned: dict[int, tuple] = {}
        self._tmpdir: str | None = None
        self._ctx = None
        self._host_device: torch.device | None = None  # resolved at first spawn

    @property
    def workers(self) -> tuple[int, ...]:
        with self._meta:
            return tuple(sorted(self._socks))

    def hello(self, worker_id: int) -> dict | None:
        """The daemon's HELLO for this worker's current connection —
        `connections`/`frames_served` counters expose daemon warmth."""
        with self._meta:
            return self._hellos.get(worker_id)

    # -- addressing / self-hosting ------------------------------------------

    def _address_for(self, worker_id: int) -> str:
        if self.addresses:
            return self.addresses[worker_id % len(self.addresses)]
        return self._spawn_local(worker_id)

    def _daemon_device(self) -> torch.device:
        """The self-hosted daemons' device; on CUDA the kernels are built
        here, once, before any daemon starts."""
        if self._host_device is None:
            dev = resolve_device(self.device)
            if dev.type == "cuda":
                from ..kernels import build

                build.build()
            self._host_device = dev
        return self._host_device

    def _spawn_local(self, worker_id: int) -> str:
        device = self._daemon_device()
        with self._meta:
            spawned = self._spawned.get(worker_id)
            if spawned is not None and spawned[0].is_alive():
                return f"unix://{spawned[1]}"
            if self._tmpdir is None:
                self._tmpdir = tempfile.mkdtemp(prefix="spdc-sock-")
            if self._ctx is None:
                import multiprocessing as mp

                self._ctx = mp.get_context("spawn")
            path = os.path.join(self._tmpdir, f"w{worker_id}.sock")
            if os.path.exists(path):
                os.unlink(path)  # stale socket from a dead daemon
            proc = self._ctx.Process(
                target=_daemon_main,
                args=(f"unix://{path}", (worker_id,), str(device)),
                daemon=True,
                name=f"spdc-sockd-{worker_id}",
            )
            proc.start()
            self._spawned[worker_id] = (proc, path)
            return f"unix://{path}"

    # -- connection pool ------------------------------------------------------

    def _worker_lock(self, worker_id: int) -> threading.Lock:
        with self._meta:
            return self._locks.setdefault(worker_id, threading.Lock())

    def _connect(self, worker_id: int) -> tuple[socket.socket, dict]:
        """Connect + HELLO, with FleetHealth exponential backoff between
        attempts — the pool won't hammer a dead endpoint. Protocol
        violations abort immediately (no retry); connect errors retry
        until `connect_timeout` is spent, then TransportWorkerDied."""
        deadline = time.monotonic() + self.connect_timeout
        last: Exception | None = None
        while True:
            now = time.monotonic()
            gate = self.health.worker(worker_id).next_ok_at
            if gate > now:
                time.sleep(max(0.0, min(gate - now, deadline - now)))
            addr = self._address_for(worker_id)
            family, target = parse_address(addr)
            sock = _stream_socket(family)
            try:
                sock.settimeout(max(0.1, deadline - time.monotonic()))
                sock.connect(target)
                send_frame(sock, _hello_frame(
                    proto=SOCKET_PROTO, wire=wire.VERSION,
                    role="client", worker_id=int(worker_id),
                ))
                reply = recv_frame(sock)
                if not reply:
                    raise TransportWorkerDied(
                        f"daemon at {addr} closed during the handshake"
                    )
                hello = _parse_hello(reply)
                _check_server_hello(hello, worker_id, addr)
            except TransportProtocolError:
                sock.close()
                raise
            except (OSError, TransportWorkerDied) as e:
                sock.close()
                last = e
                self.health.observe_failure(
                    worker_id, time.monotonic(), kind="connect"
                )
                if time.monotonic() >= deadline:
                    raise TransportWorkerDied(
                        f"could not connect to worker {worker_id} at "
                        f"{addr} within {self.connect_timeout}s: {last!r}"
                    ) from last
                continue
            self.health.worker(worker_id).consecutive_failures = 0
            return sock, hello

    def _sock(self, worker_id: int) -> socket.socket:
        with self._meta:
            sock = self._socks.get(worker_id)
        if sock is not None:
            return sock
        sock, hello = self._connect(worker_id)
        with self._meta:
            self._socks[worker_id] = sock
            self._hellos[worker_id] = hello
            self._sent_plan[worker_id] = None  # fresh connection: resend
        return sock

    def _discard(self, worker_id: int) -> None:
        """Drop a connection that can no longer be trusted (timed out
        with a reply still owed, died, or spoke garbage). The daemon —
        and its warm state — survive; the next dispatch reconnects."""
        with self._meta:
            sock = self._socks.pop(worker_id, None)
            self._sent_plan.pop(worker_id, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- request path ---------------------------------------------------------

    def _request(self, worker_id: int, frame: bytes,
                 timeout: float | None = None):
        """One lock-step request-reply round trip (raw reply payload).
        Caller holds the worker's lock."""
        deadline = self.timeout if timeout is None else float(timeout)
        sock = self._sock(worker_id)
        try:
            sock.settimeout(deadline)
            send_frame(sock, frame)
            reply = recv_frame(sock)
        except TransportProtocolError:
            self._discard(worker_id)
            raise
        except TimeoutError as e:  # socket.timeout
            self._discard(worker_id)
            raise TransportTimeout(
                f"worker {worker_id} exceeded its {deadline}s request "
                "deadline (connection dropped; the warm daemon survives "
                "and the next dispatch reconnects)"
            ) from e
        except OSError as e:
            self._discard(worker_id)
            raise TransportWorkerDied(
                f"connection to worker {worker_id} died mid-request: {e!r}"
            ) from e
        if reply is None:
            self._discard(worker_id)
            raise TransportWorkerDied(
                f"worker {worker_id} closed the connection mid-request"
            )
        if not reply:
            self._discard(worker_id)
            raise TransportProtocolError(
                f"worker {worker_id} sent a goodbye frame in place of a "
                "reply"
            )
        if reply[:4] == b"ERR:":
            raise TransportError(
                f"worker {worker_id} failed: {reply[4:].decode()}"
            )
        return reply

    def _configure_faults(self, worker_id: int, faults,
                          timeout: float | None = None) -> None:
        plan = tuple(faults)
        # _sent_plan is _meta-guarded: close() clears it from another
        # thread, and dict reads concurrent with that clear are racy.
        # The caller's per-worker lock serializes the check-then-send
        # pair for THIS worker; the socket round-trip stays outside
        # _meta (never block the fleet on one worker's I/O).
        with self._meta:
            if self._sent_plan.get(worker_id) == plan:
                return
        ack = self._request(
            worker_id, FaultPlanFrame(plan).to_bytes(), timeout
        )
        if ack != b"ACK":
            self._discard(worker_id)
            raise TransportProtocolError(
                f"worker {worker_id} mis-acknowledged a fault-plan frame: "
                f"{bytes(ack[:32])!r}"
            )
        with self._meta:
            self._sent_plan[worker_id] = plan

    def _run_on(self, task, worker_id: int, faults=(),
                timeout: float | None = None):
        from .wire import WireError, decode_message

        def once():
            self._configure_faults(worker_id, faults, timeout)
            reply = self._request(worker_id, task.to_bytes(), timeout)
            # decode by wire kind, not a pinned class: the same daemon
            # connection carries ShardResult and TriSolveResult replies
            try:
                return decode_message(reply)
            except WireError as e:
                self._discard(worker_id)
                raise TransportProtocolError(
                    f"worker {worker_id} replied with a bad frame: {e}"
                ) from e

        with self._worker_lock(worker_id):
            try:
                return once()
            except TransportWorkerDied:
                # the connection was discarded; the retry reconnects
                # (respawning a dead self-hosted daemon) and re-sends the
                # fault plan — one drop costs one reconnect, not the
                # session. Protocol violations deliberately not retried.
                return once()

    # -- Transport surface ----------------------------------------------------

    def factor(self, tasks, faults=()):
        self._ensure_open()
        return _run_relay(tasks, lambda t, wid: self._run_on(t, wid, faults))

    def repair(self, task, *, replacement):
        self._ensure_open()
        return self._run_on(task, replacement)

    def start(self, task, worker_id, *, faults=(), timeout=None):
        """Future[ShardResult]: the blocking request-reply runs on an IO
        thread; per-worker locks keep one connection in lock-step while
        different workers' requests fly concurrently. `timeout` is REAL —
        a deadline miss drops the straggler's connection."""
        self._ensure_open()
        with self._meta:
            if self._io is None:
                from concurrent.futures import ThreadPoolExecutor

                self._io = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="spdc-sock-io"
                )
            io = self._io
        return io.submit(self._run_on, task, worker_id, faults, timeout)

    def close(self):
        # swap state out under _meta, then do the goodbye/teardown I/O
        # unlocked: a slow or dead daemon must not wedge every other
        # thread that needs the metadata lock while close() waits on it
        with self._meta:
            io, self._io = self._io, None
            socks, self._socks = dict(self._socks), {}
            self._hellos.clear()
            self._sent_plan.clear()
            self._locks.clear()
            spawned, self._spawned = dict(self._spawned), {}
            tmpdir, self._tmpdir = self._tmpdir, None
        for sock in socks.values():
            try:
                send_frame(sock, b"")  # goodbye
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for proc, _path in spawned.values():
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=5)
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        if io is not None:
            io.shutdown(wait=False)
        super().close()
