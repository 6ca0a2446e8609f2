"""Transports — how ShardTasks reach edge servers and results come back
(port of repro.api.transport).

All transports execute the same protocol messages; they differ in what
the wire physically is:

  * ``InlineTransport``       — client and servers share one process and
    the wire is elided: `sweep()` runs the fused N-server schedule
    (core.lu.lu_nserver) on the session's device, the throughput path.
  * ``ThreadPoolTransport``   — one EdgeServer per worker slot, tasks on a
    thread pool, the relay threaded between them as in-memory messages.
  * ``MultiprocessTransport`` — spawned worker processes; every message
    crosses the boundary as `to_bytes()` frames over an OS pipe.
  * ``SocketTransport`` (socket_transport.py) — warm worker daemons
    reached over TCP or Unix sockets, the same frames length-prefixed.

  * ``ShardMapTransport``     — the multi-device pipeline
    (distrib.spdc_pipeline): one mesh slot per server, each with a stream
    of its own on the CUDA device, the relay a device copy per hop.

Dispatch surface: ``start(task, worker_id) -> Future`` ships one
ShardTask to one worker; ``result(future, timeout)`` resolves it;
``submit`` is the blocking facade; ``factor(tasks)`` runs one session's
whole relay sweep; ``repair(task, replacement=)`` runs one
verification-driven re-dispatch (distrib.recovery) on a replacement
worker, honestly: faults bind to initial dispatches only;
``solve_shards(tasks)`` runs one triangular-solve round of the secure
linalg sessions (TriSolveTasks, one column chunk each, concurrently where
the transport can).

One-way model: for the message transports the relay is run by the
transport — task i executes only after i−1's result, and its
``u_upstream`` is exactly the U rows servers 0..i−1 reported. No server
receives anything from downstream, and the client never ships plaintext
or key material (messages.ShardTask).

Devices: each server-side object takes ``device`` (None = the CUDA
device, RuntimeError without one; "cpu" runs the plain path). Worker
processes are spawned, never forked, and each computes on the parent's
device; the parent builds the CUDA kernels before the first worker
starts.

Lifecycle: every transport is a context manager with an idempotent
``close()`` and a ``closed`` flag; dispatching on a closed transport
raises TransportError. `resolve_transport` maps names and
`TransportConfig`s to process-wide shared instances (one per device);
`close_all()` runs at interpreter exit.

Fault simulation: ``factor(tasks, faults=plan)`` plays core.faults
misbehaviour on the matching workers (a FaultPlanFrame control message on
the multiprocess transport).
"""
from __future__ import annotations

import atexit
import threading
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass

import numpy as np
import torch

from ..core.lu import lu_nserver
from ..device import resolve_device
from .messages import FaultPlanFrame, ShardResult, ShardTask
from .server import EdgeServer

__all__ = [
    "Transport",
    "TransportConfig",
    "TransportError",
    "TransportTimeout",
    "TransportWorkerDied",
    "TransportProtocolError",
    "InlineTransport",
    "ThreadPoolTransport",
    "MultiprocessTransport",
    "ShardMapTransport",
    "resolve_transport",
    "close_all",
]


class TransportError(RuntimeError):
    """A worker died, timed out, replied with a malformed frame, or the
    transport was used after close()."""


class TransportTimeout(TransportError):
    """A per-request wall-clock deadline expired before the worker
    replied. The multiprocess worker is killed (a late reply would
    desynchronize the lock-step pipe) and respawned on the next dispatch;
    the relay treats the request as a dropout (zero strips)."""


class TransportWorkerDied(TransportError):
    """The worker process went away mid-request. The transport respawns
    it and retries the request once before surfacing this."""


class TransportProtocolError(TransportError):
    """The far side violated the framing protocol: its reply is an ERR
    frame or not a wire-codec frame. Not retried."""


def serve_frame(edge: EdgeServer, state: dict, data: bytes) -> bytes:
    """One worker-side request → reply step.

    Strict request-reply: every frame gets exactly one reply — ShardTask
    → ShardResult bytes, TriSolveTask → TriSolveResult bytes,
    FaultPlanFrame → b"ACK", anything that fails
    (including a frame that does not decode) → an ERR frame — so a
    failure never desynchronizes later replies. `state` holds the
    channel's fault plan.
    """
    from .wire import decode_message

    try:  # noqa: SIM105 — report every failure, don't die silently
        msg = decode_message(data)
        if isinstance(msg, FaultPlanFrame):
            state["plan"] = msg.plan
            return b"ACK"
        return edge.run(msg, faults=state.get("plan", ())).to_bytes()
    except Exception as e:  # noqa: BLE001
        return b"ERR:" + repr(e).encode()


class Transport:
    """Base transport: the message-executing interface.

    fused: True when `sweep()` runs the whole factorization in one go and
        the Session skips task materialization.
    style: the core.lu.lu_block_row operation order of this transport's
        factors.
    """

    name = "abstract"
    fused = False
    style = "nserver"

    _closed = False
    _driver_pool = None
    _driver_lock = threading.Lock()

    @property
    def closed(self) -> bool:
        """True once close() ran; a closed transport refuses dispatch."""
        return self._closed

    def _ensure_open(self) -> None:
        if self._closed:
            raise TransportError(
                f"transport {self.name!r} is closed; build or resolve a "
                "fresh one"
            )

    # -- whole-sweep surface -------------------------------------------------

    def factor(self, tasks, faults=()) -> list[ShardResult]:
        """Run one session's initial ShardTasks (the full sweep)."""
        raise NotImplementedError

    def repair(self, task: ShardTask, *, replacement: int) -> ShardResult:
        """Run one verification-driven re-dispatch on worker
        `replacement` (a standby or a healthy neighbour)."""
        raise NotImplementedError

    def driver_submit(self, fn, *args) -> Future:
        """Run `fn(*args)` on this transport's driver threads — the
        mechanism behind `Session.start`. 4 drivers
        bound the pipeline depth, not the worker parallelism."""
        self._ensure_open()
        with Transport._driver_lock:
            if self._driver_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                # instance attribute (class default is None)
                self._driver_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix=f"spdc-{self.name}-drv"
                )
        return self._driver_pool.submit(fn, *args)

    def factor_async(self, tasks, faults=()) -> Future:
        """`factor` as a Future on this transport's driver threads: the
        relay inside stays sequential (the one-way chain is a data
        dependency); only the session boundary is asynchronous."""
        return self.driver_submit(self.factor, tasks, faults)

    # -- per-task surface ----------------------------------------------------

    def start(self, task: ShardTask, worker_id: int, *, faults=(),
              timeout: float | None = None) -> Future:
        """Nonblocking single-task dispatch → Future resolving to a
        ShardResult (or raising a TransportError). `timeout` bounds the
        request where the transport can enforce one (multiprocess kills
        the worker); a thread cannot be preempted, so there it is
        advisory."""
        raise NotImplementedError(
            f"transport {self.name!r} has no per-task dispatch surface"
        )

    def result(self, future: Future, timeout: float | None = None
               ) -> ShardResult:
        """Resolve a `start`ed dispatch. `timeout` is a client-side wait
        bound: expiry raises TransportTimeout but does not kill the
        worker (pass timeout= to `start` for an enforced deadline)."""
        try:
            return future.result(timeout)
        except _FutureTimeout as e:
            raise TransportTimeout(
                f"dispatch did not resolve within the {timeout}s "
                "client-side wait (the worker-side request may still be "
                "running; start(timeout=) enforces a worker deadline)"
            ) from e

    def submit(self, task: ShardTask, worker_id: int, *, faults=(),
               timeout: float | None = None) -> ShardResult:
        """Blocking single-task facade: `result(start(...))`."""
        return self.result(
            self.start(task, worker_id, faults=faults, timeout=timeout)
        )

    def solve_shards(self, tasks, faults=(), timeout: float | None = None):
        """One triangular-solve round (DESIGN.md §12): each TriSolveTask
        started on its chunk's worker (`task.server`), the
        TriSolveResults gathered in task order. Chunks are independent
        (no relay), so they run concurrently where the transport can. A
        chunk past `timeout` gets None in its slot: the caller treats it
        as a dropout, which its check localizes and recovery
        re-dispatches."""
        self._ensure_open()
        futures = [self.start(t, t.server, faults=faults, timeout=timeout)
                   for t in tasks]
        out = []
        for fut in futures:
            try:
                out.append(self.result(fut, timeout))
            except TransportTimeout:
                out.append(None)
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Release workers/pools; idempotent. Subclasses extend this and
        must call super().close() so `closed` flips and the driver pool
        shuts down."""
        self._closed = True
        pool, self._driver_pool = self._driver_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InlineTransport(Transport):
    """Single-process transport: `sweep()` is one call of lu_nserver on
    the ciphertext's device, for one matrix or a stack. The message
    methods run an EdgeServer on `device` (resolved when they first need
    it: None = the CUDA device)."""

    name = "inline"
    fused = True

    def __init__(self, *, device=None):
        self.device = device

    def _edge(self, worker_id) -> EdgeServer:
        return EdgeServer(worker_id, device=self.device)

    def sweep(self, x_aug: torch.Tensor, num_servers: int,
              faults=()) -> tuple[torch.Tensor, torch.Tensor]:
        self._ensure_open()
        l, u, _ = lu_nserver(x_aug, num_servers, faults=faults)
        return l, u

    def factor(self, tasks, faults=()):
        self._ensure_open()
        return _run_relay(tasks, lambda t, wid: self._edge(wid).run(t, faults))

    def repair(self, task, *, replacement):
        self._ensure_open()
        return self._edge(replacement).run(task)

    def start(self, task, worker_id, *, faults=(), timeout=None):
        """Synchronous start: compute now, return a completed Future."""
        self._ensure_open()
        fut: Future = Future()
        try:
            fut.set_result(self._edge(worker_id).run(task, faults))
        except Exception as e:  # noqa: BLE001 — future carries it
            fut.set_exception(e)
        return fut


class ShardMapTransport(Transport):
    """distrib.spdc_pipeline as a transport: one mesh slot per server,
    each on `device` with a stream of its own (None = the CUDA device,
    "cpu" for the plain path), the relay a device copy per hop
    (DESIGN.md §2). Fused: the sweep is one pipeline program (`program`:
    "baseline", "exact" or "stream"); repairs recompute one block row on
    an EdgeServer in the pipeline's operation order ("pipeline" style).
    `mesh(N)` is the mesh of the N-server sweeps, whose `hops` log the
    last sweep's relay."""

    name = "shardmap"
    fused = True
    style = "pipeline"

    def __init__(self, program: str = "baseline", *, device=None):
        self.program = program
        self.device = device
        self._meshes: dict = {}  #: guarded-by: self._lock
        self._lock = threading.Lock()

    def mesh(self, num_servers: int):
        """The mesh of this transport's N-server sweeps, built at first
        use on the transport's device."""
        from ..distrib.spdc_pipeline import ServerMesh

        with self._lock:
            if num_servers not in self._meshes:
                self._meshes[num_servers] = ServerMesh(num_servers,
                                                       self.device)
            return self._meshes[num_servers]

    def sweep(self, x_aug, num_servers: int, faults=()):
        self._ensure_open()
        from ..distrib.spdc_pipeline import lu_nserver_shardmap

        return lu_nserver_shardmap(
            x_aug, num_servers, mesh=self.mesh(num_servers),
            program=self.program, faults=faults,
        )

    def repair(self, task, *, replacement):
        self._ensure_open()
        return EdgeServer(replacement, device=self.device).run(task)


def _run_relay(tasks, execute) -> list[ShardResult]:
    """The one-way relay over single-shot workers: execute task i with
    u_upstream = the U rows servers 0..i−1 reported. `execute(task,
    worker_id)` runs one task on one worker.

    A per-request TransportTimeout is absorbed as a dropout: the
    straggler's strips become zeros, what a ``kind="dropout"`` fault
    reports, so verification localizes it.
    """
    tasks = sorted(tasks, key=lambda t: t.server)
    if [t.server for t in tasks] != list(range(len(tasks))):
        raise ValueError(
            f"factor() needs exactly one task per server 0..N-1, got "
            f"{[t.server for t in tasks]}"
        )
    results: list[ShardResult] = []
    u_rows: list[np.ndarray] = []
    for t in tasks:
        if t.server > 0:
            t = t.with_upstream(np.concatenate(u_rows, axis=-2))
        try:
            r = execute(t, t.server)
        except TransportTimeout:
            zero = np.zeros_like(np.asarray(t.x_row))
            r = ShardResult(
                server=t.server, l_row=zero, u_row=zero,
                subseed=t.subseed, attempt=t.attempt,
                session_id=t.session_id,
            )
        results.append(r)
        u_rows.append(np.asarray(r.u_row))
    return results


class ThreadPoolTransport(Transport):
    """EdgeServers on a thread pool: in-memory messages, a real scheduler
    boundary, no serialization. The relay is sequential per sweep (the
    one-way chain is a data dependency); concurrency comes from
    independent sessions sharing the pool."""

    name = "threadpool"

    def __init__(self, max_workers: int | None = None, *, device=None):
        from concurrent.futures import ThreadPoolExecutor

        self.device = resolve_device(device)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="spdc-edge"
        )
        self._edges: dict[int, EdgeServer] = {}  #: guarded-by: self._lock
        self._lock = threading.Lock()

    def _edge(self, worker_id: int) -> EdgeServer:
        with self._lock:
            if worker_id not in self._edges:
                self._edges[worker_id] = EdgeServer(worker_id,
                                                    device=self.device)
            return self._edges[worker_id]

    def factor(self, tasks, faults=()):
        self._ensure_open()

        def execute(t, wid):
            return self._pool.submit(self._edge(wid).run, t, faults).result()

        return _run_relay(tasks, execute)

    def repair(self, task, *, replacement):
        self._ensure_open()
        return self._pool.submit(self._edge(replacement).run, task).result()

    def start(self, task, worker_id, *, faults=(), timeout=None):
        """Future[ShardResult] on the shared pool. Threads cannot be
        preempted, so `timeout` is advisory here."""
        self._ensure_open()
        return self._pool.submit(self._edge(worker_id).run, task, faults)

    def close(self):
        self._pool.shutdown(wait=True)
        super().close()


def _edge_worker_main(conn, worker_id: int, device: str) -> None:
    """Entry point of one spawned edge-server process.

    One `serve_frame` reply per received frame keeps the pipe in strict
    lock-step; an empty frame is the shutdown sentinel. Everything in and
    out is the wire codec — no pickle of task data crosses the boundary.
    """
    from repro_torch.api.server import EdgeServer as _Edge
    from repro_torch.api.transport import serve_frame as _serve

    edge = _Edge(worker_id, device=device)
    state: dict = {}
    while True:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            return
        if not data:
            return
        conn.send_bytes(_serve(edge, state, data))


class MultiprocessTransport(Transport):
    """Spawned worker processes; ShardTask/ShardResult cross as bytes.

    Workers spawn lazily per worker id (the first dispatch pays the
    process start and the torch import) and compute on this transport's
    device.

    Request discipline: each pipe is strict lock-step request-reply, so
    each worker has its own lock (requests to different workers run
    concurrently) and every request takes a per-request wall-clock
    deadline (`timeout` is only the default). A deadline miss kills the
    worker and raises TransportTimeout; a worker found dead mid-request
    is respawned and the request retried once before TransportWorkerDied
    surfaces. A worker's ERR reply raises TransportProtocolError: the
    request is never retried elsewhere, on the CPU or otherwise.
    """

    name = "multiprocess"

    def __init__(self, *, timeout: float = 600.0, device=None):
        import multiprocessing as mp

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # one nvcc per kernel here, not one per worker at first use
            from ..kernels import build

            build.build()
        self._ctx = mp.get_context("spawn")
        self._conns: dict[int, object] = {}  #: guarded-by: self._meta
        self._procs: dict[int, object] = {}  #: guarded-by: self._meta
        self._sent_plan: dict[int, tuple] = {}  #: guarded-by: self._meta
        self._locks: dict[int, threading.Lock] = {}
        self._meta = threading.RLock()  # guards the dicts, not the pipes
        self._io = None  # lazy executor behind start()
        self.timeout = float(timeout)

    @property
    def workers(self) -> tuple[int, ...]:
        with self._meta:
            return tuple(sorted(self._procs))

    def _worker_lock(self, worker_id: int) -> threading.Lock:
        with self._meta:
            return self._locks.setdefault(worker_id, threading.Lock())

    def _conn(self, worker_id: int):
        with self._meta:
            conn = self._conns.get(worker_id)
            if conn is not None and self._procs[worker_id].is_alive():
                return conn
            parent, child = self._ctx.Pipe()
            proc = self._ctx.Process(
                target=_edge_worker_main,
                args=(child, worker_id, str(self.device)),
                daemon=True,
                name=f"spdc-edge-{worker_id}",
            )
            proc.start()
            child.close()
            self._conns[worker_id] = parent
            self._procs[worker_id] = proc
            self._sent_plan[worker_id] = ()
            return parent

    def _discard(self, worker_id: int) -> None:
        """Forget a worker whose pipe can no longer be trusted (dead, or
        timed out with a reply still owed); the next dispatch respawns
        it with a fresh pipe."""
        with self._meta:
            conn = self._conns.pop(worker_id, None)
            proc = self._procs.pop(worker_id, None)
            self._sent_plan.pop(worker_id, None)
        if conn is not None:
            try:
                conn.close()
            except (OSError, ValueError):
                pass
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)

    def _request(self, worker_id: int, frame: bytes,
                 timeout: float | None = None) -> bytes:
        """One lock-step request-reply round trip (raw reply bytes).
        Caller holds the worker's lock. Raises TransportTimeout (worker
        killed) past the deadline, TransportWorkerDied on a dead pipe,
        TransportProtocolError on an ERR reply."""
        deadline = self.timeout if timeout is None else float(timeout)
        conn = self._conn(worker_id)
        try:
            conn.send_bytes(frame)
            if not conn.poll(deadline):
                self._discard(worker_id)
                raise TransportTimeout(
                    f"edge worker {worker_id} exceeded its {deadline}s "
                    "request deadline (killed; respawns on next dispatch)"
                )
            data = conn.recv_bytes()
        except (EOFError, OSError, BrokenPipeError) as e:
            self._discard(worker_id)
            raise TransportWorkerDied(
                f"edge worker {worker_id} died mid-request: {e!r}"
            ) from e
        if data[:4] == b"ERR:":
            raise TransportProtocolError(
                f"edge worker {worker_id} failed: {data[4:].decode()}"
            )
        return data

    def _configure_faults(self, worker_id: int, faults,
                          timeout: float | None = None) -> None:
        plan = tuple(faults)
        # _sent_plan is _meta-guarded: close() clears it from another
        # thread. The caller's per-worker lock serializes the
        # check-then-send pair for this worker; the pipe round-trip stays
        # outside _meta.
        with self._meta:
            if self._sent_plan.get(worker_id) == plan:
                return
        ack = self._request(worker_id, FaultPlanFrame(plan).to_bytes(),
                            timeout)
        if ack != b"ACK":
            raise TransportProtocolError(
                f"edge worker {worker_id} mis-acknowledged a fault-plan "
                f"frame: {ack[:32]!r}"
            )
        with self._meta:
            self._sent_plan[worker_id] = plan

    def _run_on(self, task, worker_id: int, faults=(),
                timeout: float | None = None):
        from .wire import WireError, decode_message

        def once():
            self._configure_faults(worker_id, faults, timeout)
            reply = self._request(worker_id, task.to_bytes(), timeout)
            try:
                return decode_message(reply)
            except WireError as e:
                raise TransportProtocolError(
                    f"edge worker {worker_id} replied with a bad frame: {e}"
                ) from e

        with self._worker_lock(worker_id):
            try:
                return once()
            except TransportWorkerDied:
                # the pipe state was discarded, so the retry spawns a
                # fresh worker (and re-sends the fault plan)
                return once()

    def factor(self, tasks, faults=()):
        self._ensure_open()
        return _run_relay(tasks, lambda t, wid: self._run_on(t, wid, faults))

    def repair(self, task, *, replacement):
        """The re-dispatch runs on worker process `replacement`, spawned
        at first use like any other (a standby id gets a process of its
        own)."""
        self._ensure_open()
        return self._run_on(task, replacement)

    def start(self, task, worker_id, *, faults=(), timeout=None):
        """Future[ShardResult]: the blocking request-reply runs on an IO
        thread; the per-worker lock serializes a worker's pipe while
        different workers' requests proceed concurrently. `timeout` is
        enforced: a deadline miss kills the straggling process."""
        self._ensure_open()
        with self._meta:
            if self._io is None:
                from concurrent.futures import ThreadPoolExecutor

                self._io = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="spdc-mp-io"
                )
            io = self._io
        return io.submit(self._run_on, task, worker_id, faults, timeout)

    def close(self):
        # swap state out under _meta, then do the goodbye sends and the
        # joins unlocked: a wedged worker must not hold the metadata lock
        with self._meta:
            io, self._io = self._io, None
            conns, self._conns = dict(self._conns), {}
            procs, self._procs = dict(self._procs), {}
            self._sent_plan.clear()
            self._locks.clear()
        for conn in conns.values():
            try:
                conn.send_bytes(b"")
                conn.close()
            except (OSError, ValueError):
                pass
        for proc in procs.values():
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        if io is not None:
            io.shutdown(wait=False)
        super().close()


def _socket_transport(**kwargs) -> Transport:
    # socket_transport imports this module; the factory imports it late
    from .socket_transport import SocketTransport

    return SocketTransport(**kwargs)


_FACTORIES = {
    "inline": InlineTransport,
    "shardmap": ShardMapTransport,
    "threadpool": ThreadPoolTransport,
    "multiprocess": MultiprocessTransport,
    "socket": _socket_transport,
}


@dataclass(frozen=True)
class TransportConfig:
    """Declarative transport spec — the third leg of `resolve_transport`.

    name: "inline" | "shardmap" | "threadpool" | "multiprocess" | "socket".
    addresses: socket only — the worker fleet's endpoints
        ("tcp://host:port" / "unix:///path.sock"), worker_id i connecting
        to addresses[i % len]. Empty = spawn local warm UDS daemons on
        demand, computing on the build's device.
    timeout: default per-request deadline (multiprocess / socket).
    max_workers: thread pool width (threadpool only).
    program: relay program (shardmap only).

    `build(device=)` returns a fresh instance the caller owns (and must
    close); `resolve_transport(config)` instead returns a process-wide
    shared instance keyed by the config and the device.
    """

    name: str
    addresses: tuple[str, ...] = ()
    timeout: float | None = None
    max_workers: int | None = None
    program: str | None = None

    def __post_init__(self):
        if self.name not in _FACTORIES:
            raise ValueError(
                f"unknown transport {self.name!r}; expected one of "
                f"{sorted(_FACTORIES)}"
            )
        # tolerate list input without breaking hashability
        object.__setattr__(self, "addresses", tuple(self.addresses))
        if self.addresses and self.name != "socket":
            raise ValueError("addresses= applies to the socket transport")
        if self.max_workers is not None and self.name != "threadpool":
            raise ValueError("max_workers= applies to threadpool")
        if self.program is not None and self.name != "shardmap":
            raise ValueError("program= applies to shardmap")
        if self.timeout is not None and self.name not in (
            "multiprocess", "socket",
        ):
            raise ValueError(
                "timeout= applies to the message transports "
                "(multiprocess, socket)"
            )

    def build(self, *, device=None) -> Transport:
        """Instantiate a fresh transport the caller owns, on `device`."""
        kwargs: dict = {}
        if self.addresses:
            kwargs["addresses"] = self.addresses
        if self.timeout is not None:
            kwargs["timeout"] = self.timeout
        if self.max_workers is not None:
            kwargs["max_workers"] = self.max_workers
        if self.program is not None:
            kwargs["program"] = self.program
        return _FACTORIES[self.name](device=device, **kwargs)


_SHARED: dict[object, Transport] = {}
_SHARED_LOCK = threading.Lock()


def resolve_transport(spec=None, *, distributed: bool = False,
                      device=None) -> Transport:
    """The transport resolver — every `transport=` argument funnels here.

      * None          → inline (or shardmap when `distributed=True`);
      * a name string from {"inline", "shardmap", "threadpool",
        "multiprocess", "socket"} → the process-wide shared instance on
        `device` (the bare "socket" self-hosts one daemon per worker on
        `device`);
      * a `TransportConfig` → a shared instance keyed by the config and
        the device (`config.build()` gives a fresh one);
      * a `Transport` instance → returned as is (caller-owned).

    Shared instances that were closed are rebuilt on the next resolve;
    `close_all()` (atexit) closes the whole registry.
    """
    if isinstance(spec, Transport):
        if distributed and spec.name != "shardmap":
            raise ValueError(
                "distributed=True conflicts with an explicit non-shardmap "
                f"transport ({spec.name!r}); drop one of the two"
            )
        return spec
    if spec is None:
        spec = "shardmap" if distributed else "inline"
    elif distributed and getattr(spec, "name", spec) != "shardmap":
        raise ValueError(
            f"distributed=True conflicts with transport={spec!r}; "
            "pass transport='shardmap' (or drop distributed)"
        )
    where = None if device is None else str(torch.device(device))
    if isinstance(spec, TransportConfig):
        with _SHARED_LOCK:
            inst = _SHARED.get((spec, where))
            if inst is None or inst.closed:
                _SHARED[(spec, where)] = inst = spec.build(device=device)
            return inst
    if spec not in _FACTORIES:
        raise ValueError(
            f"unknown transport {spec!r}; expected one of "
            f"{sorted(_FACTORIES)}, a TransportConfig, or a Transport "
            "instance"
        )
    with _SHARED_LOCK:
        inst = _SHARED.get((spec, where))
        if inst is None or inst.closed:
            _SHARED[(spec, where)] = inst = _FACTORIES[spec](device=device)
        return inst


def close_all() -> None:
    """Close every shared transport (atexit; tests may call it)."""
    with _SHARED_LOCK:
        for t in _SHARED.values():
            t.close()
        _SHARED.clear()


atexit.register(close_all)
