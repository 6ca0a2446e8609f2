"""Role-split API of the port (mirrors repro.api, DESIGN.md §7):

  * `SPDCClient` / `Session` (client.py) — the trusted role: KeyGen,
    Cipher, Authenticate, Decipher, and the async-overlap pipeline
    (`Session.start` → `PendingResult`, `SPDCClient.run_pipelined`);
  * `EdgeServer` (server.py) — the untrusted role, a stateless
    `run(ShardTask) → ShardResult` worker that also answers the secure
    linalg rounds, `run(TriSolveTask) → TriSolveResult`;
  * `ShardTask` / `ShardResult`, `TriSolveTask` / `TriSolveResult`
    (messages.py) and the codec (wire.py) — what crosses the boundary,
    as versioned pickle-free byte frames;
  * transports (transport.py, socket_transport.py) — inline (the fused
    sweep), shardmap (the multi-device pipeline), threadpool,
    multiprocess and socket (warm worker daemons over TCP/UDS),
    selected by name, `TransportConfig` or instance
    through `resolve_transport`; `Transport.solve_shards` runs one
    triangular-solve round on any of them.
"""
from .client import BoundaryViolation, PendingResult, Session, SPDCClient
from .messages import (
    FaultPlanFrame,
    ShardResult,
    ShardTask,
    TriSolveResult,
    TriSolveTask,
)
from .server import EdgeServer
from .transport import (
    InlineTransport,
    MultiprocessTransport,
    ShardMapTransport,
    ThreadPoolTransport,
    Transport,
    TransportConfig,
    TransportError,
    TransportProtocolError,
    TransportTimeout,
    TransportWorkerDied,
    close_all,
    resolve_transport,
)
from .wire import WireError, decode_message

__all__ = [
    "SPDCClient", "Session", "PendingResult", "BoundaryViolation",
    "EdgeServer",
    "ShardTask", "ShardResult", "TriSolveTask", "TriSolveResult",
    "FaultPlanFrame",
    "Transport", "TransportConfig", "TransportError", "TransportTimeout",
    "TransportWorkerDied", "TransportProtocolError",
    "InlineTransport", "ShardMapTransport", "ThreadPoolTransport",
    "MultiprocessTransport",
    "SocketTransport", "WorkerDaemon",
    "resolve_transport", "close_all",
    "WireError", "decode_message",
]


def __getattr__(name):
    # SocketTransport/WorkerDaemon import lazily: socket_transport pulls
    # in distrib.rateless (FleetHealth), which itself imports this
    # package's transport module
    if name in ("SocketTransport", "WorkerDaemon"):
        from . import socket_transport

        return getattr(socket_transport, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
