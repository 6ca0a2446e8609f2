"""Protocol messages of the role-split SPDC API (DESIGN.md §7; port of
repro.api.messages, byte-identical on the wire).

Exactly four object kinds exist at the client ↔ edge-server boundary, and
only the first two ever cross it:

  * ``ShardTask``   — client → server. One server's unit of work: its
    ENCRYPTED block row of the augmented ciphertext, the dispatch-channel
    sub-seed keying this (re-)issue, and — for repair tasks or transports
    that materialize the relay — the upstream U rows it would have
    received over the one-way chain. Nothing else: no plaintext entries,
    no blinding vector, no Ψ, no probe material (the boundary the paper's
    security analysis assumes; enforced by `Session.tasks()` and the
    negative tests in tests/test_api.py).
  * ``ShardResult`` — server → client. The (L strip, U strip) the server
    claims, echoing the task's sub-seed so the client can match a result
    to the dispatch that requested it (a stale strip from a retired
    server cannot impersonate a re-dispatch).
  * ``Verdict`` / ``Determinant`` (core.verify / core.decipher) — stay on
    the client side of the boundary but serialize with the same codec so
    gateways and archives can move them between processes.

``FaultPlanFrame`` is NOT a protocol message: it is the simulation
control frame transports use to tell a worker which misbehavior to play
(core.faults semantics) — a real deployment has real faults instead.

``TriSolveTask`` / ``TriSolveResult`` are the same pair for the secure
linalg rounds (DESIGN.md §12, linalg.session): the session's verified
factors and one blinded or public right-hand-side column chunk out, the
solved chunk back; `EdgeServer.run` answers them.

All wire frames use api/wire.py (versioned, pickle-free — see that
module's docstring for why). Array fields hold host numpy arrays; a
tensor handed to a message is copied to the host when it is encoded.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.faults import FaultPlan, ServerFault, normalize_plan
from . import wire

__all__ = [
    "ShardTask", "ShardResult", "TriSolveTask", "TriSolveResult",
    "FaultPlanFrame",
]


def _np_or_none(a):
    """A host numpy array (tensors are copied off their device), or None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@wire.register("ShardTask")
@dataclass(frozen=True, eq=False)
class ShardTask:
    """One server's unit of work — the only client → server message.

    x_row: the server's (…, b, n') block row of the augmented CIPHERTEXT
        (post-EWO, post-PRT, post-border). A leading batch dim means the
        whole stack's strip ships in one task (DESIGN.md §3).
    u_upstream: the (…, s0, n') U rows of the servers above — what the
        one-way relay S_{i-1} → S_i delivers. None on initial dispatch
        when the transport itself threads the relay; always present on
        repair tasks (the replacement is stateless and the culprit's
        relay cannot be trusted).
    subseed: H(Ψ-digest ‖ server ‖ attempt) — the dispatch-channel key.
        Derived from the client secret but reveals nothing about it
        (SHA-256 preimage); it is the re-keying that stops a replayed
        strip from the original server impersonating a re-dispatch.
    style: operation order the result must match ("nserver" | "pipeline",
        core.lu.lu_block_row) so a recomputed strip splices bit-cleanly.
    attempt: 0 = initial dispatch; > 0 = verification-driven re-issue.
    session_id: opaque routing tag (hex), NOT secret material.
    """

    server: int
    num_servers: int
    x_row: np.ndarray
    subseed: bytes
    style: str = "nserver"
    attempt: int = 0
    u_upstream: np.ndarray | None = None
    session_id: str = ""

    @property
    def n(self) -> int:
        """Padded sweep size n' (the full matrix the strips tile)."""
        return int(self.x_row.shape[-1])

    @property
    def block(self) -> int:
        return int(self.x_row.shape[-2])

    def with_upstream(self, u_upstream) -> "ShardTask":
        return replace(self, u_upstream=_np_or_none(u_upstream))

    def to_bytes(self) -> bytes:
        return wire.encode(
            "ShardTask",
            {
                "server": self.server,
                "num_servers": self.num_servers,
                "subseed": self.subseed,
                "style": self.style,
                "attempt": self.attempt,
                "session_id": self.session_id,
            },
            {"x_row": _np_or_none(self.x_row),
             "u_upstream": _np_or_none(self.u_upstream)},
        )

    @classmethod
    def _from_wire(cls, scalars, arrays):
        return cls(
            server=int(scalars["server"]),
            num_servers=int(scalars["num_servers"]),
            x_row=arrays["x_row"],
            subseed=scalars["subseed"],
            style=scalars["style"],
            attempt=int(scalars["attempt"]),
            u_upstream=arrays["u_upstream"],
            session_id=scalars["session_id"],
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "ShardTask":
        kind, scalars, arrays = wire.decode(data)
        if kind != "ShardTask":
            raise wire.WireError(f"expected ShardTask frame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


@wire.register("ShardResult")
@dataclass(frozen=True, eq=False)
class ShardResult:
    """One server's reported strips — the only server → client message.

    l_row / u_row: the (…, b, n') L and U strips of the server's block
    row. The client trusts NOTHING here until Authenticate accepts it.
    subseed/attempt echo the ShardTask so the client can bind the result
    to a specific dispatch.
    """

    server: int
    l_row: np.ndarray
    u_row: np.ndarray
    subseed: bytes = b""
    attempt: int = 0
    session_id: str = ""

    def to_bytes(self) -> bytes:
        return wire.encode(
            "ShardResult",
            {
                "server": self.server,
                "subseed": self.subseed,
                "attempt": self.attempt,
                "session_id": self.session_id,
            },
            {"l_row": _np_or_none(self.l_row),
             "u_row": _np_or_none(self.u_row)},
        )

    @classmethod
    def _from_wire(cls, scalars, arrays):
        return cls(
            server=int(scalars["server"]),
            l_row=arrays["l_row"],
            u_row=arrays["u_row"],
            subseed=scalars["subseed"],
            attempt=int(scalars["attempt"]),
            session_id=scalars["session_id"],
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "ShardResult":
        kind, scalars, arrays = wire.decode(data)
        if kind != "ShardResult":
            raise wire.WireError(f"expected ShardResult frame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


@wire.register("TriSolveTask")
@dataclass(frozen=True, eq=False)
class TriSolveTask:
    """One triangular-solve shard — client → server (DESIGN.md §12).

    Ships the session's ALREADY-VERIFIED factors of the augmented
    ciphertext plus one blinded right-hand-side column chunk; the server
    answers X' y = rhs (or X'ᵀ y = rhs) through two triangular solves.
    Everything here is already on the server side of the trust boundary:
    l/u are what the fleet itself reported during factorization, and rhs
    is either a public permutation block (inverse rounds) or passed
    through the `blind_rhs` one-time-pad chokepoint (solve rounds) — no
    new plaintext crosses with the op plan's extra rounds.

    col0: first column index of this chunk in the round's full RHS (the
        client reassembles chunks by columns, not by rows).
    transpose: 0 solves through X' = L·U, 1 through X'ᵀ (the adjoint
        round the VJPs use).
    subseed: the trisolve dispatch-channel key
        (distrib.recovery.trisolve_subseed) — a lane disjoint from the
        LU dispatch keys, re-derived per attempt so a replayed chunk
        cannot impersonate a re-issue.
    """

    server: int
    num_servers: int
    l: np.ndarray
    u: np.ndarray
    rhs: np.ndarray
    subseed: bytes
    transpose: int = 0
    col0: int = 0
    attempt: int = 0
    session_id: str = ""

    @property
    def n(self) -> int:
        """Padded solve size n' (the factors are (n', n'))."""
        return int(self.l.shape[-1])

    @property
    def cols(self) -> int:
        return int(self.rhs.shape[-1])

    def to_bytes(self) -> bytes:
        return wire.encode(
            "TriSolveTask",
            {
                "server": self.server,
                "num_servers": self.num_servers,
                "subseed": self.subseed,
                "transpose": self.transpose,
                "col0": self.col0,
                "attempt": self.attempt,
                "session_id": self.session_id,
            },
            {"l": _np_or_none(self.l), "u": _np_or_none(self.u),
             "rhs": _np_or_none(self.rhs)},
        )

    @classmethod
    def _from_wire(cls, scalars, arrays):
        return cls(
            server=int(scalars["server"]),
            num_servers=int(scalars["num_servers"]),
            l=arrays["l"],
            u=arrays["u"],
            rhs=arrays["rhs"],
            subseed=scalars["subseed"],
            transpose=int(scalars["transpose"]),
            col0=int(scalars["col0"]),
            attempt=int(scalars["attempt"]),
            session_id=scalars["session_id"],
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "TriSolveTask":
        kind, scalars, arrays = wire.decode(data)
        if kind != "TriSolveTask":
            raise wire.WireError(f"expected TriSolveTask frame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


@wire.register("TriSolveResult")
@dataclass(frozen=True, eq=False)
class TriSolveResult:
    """One solved column chunk — server → client.

    y: the (n', c) solution chunk the server claims. Untrusted until the
    client's residual check accepts it (linalg.session; a failed chunk is
    re-dispatched through distrib.recovery.recover_solve). subseed /
    attempt / col0 echo the task so the client binds the chunk to its
    dispatch.
    """

    server: int
    y: np.ndarray
    subseed: bytes = b""
    transpose: int = 0
    col0: int = 0
    attempt: int = 0
    session_id: str = ""

    def to_bytes(self) -> bytes:
        return wire.encode(
            "TriSolveResult",
            {
                "server": self.server,
                "subseed": self.subseed,
                "transpose": self.transpose,
                "col0": self.col0,
                "attempt": self.attempt,
                "session_id": self.session_id,
            },
            {"y": _np_or_none(self.y)},
        )

    @classmethod
    def _from_wire(cls, scalars, arrays):
        return cls(
            server=int(scalars["server"]),
            y=arrays["y"],
            subseed=scalars["subseed"],
            transpose=int(scalars["transpose"]),
            col0=int(scalars["col0"]),
            attempt=int(scalars["attempt"]),
            session_id=scalars["session_id"],
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "TriSolveResult":
        kind, scalars, arrays = wire.decode(data)
        if kind != "TriSolveResult":
            raise wire.WireError(
                f"expected TriSolveResult frame, got {kind!r}"
            )
        return cls._from_wire(scalars, arrays)


@wire.register("FaultPlanFrame")
@dataclass(frozen=True)
class FaultPlanFrame:
    """Simulation control frame: configure a worker's misbehavior.

    Carries a core.faults FaultPlan as plain data (no pickle — a worker
    decodes field dicts and rebuilds frozen ServerFaults). Sent by
    transports before a sweep whose session requested fault injection;
    real deployments never send one.
    """

    plan: FaultPlan = ()

    def to_bytes(self) -> bytes:
        faults = []
        for f in self.plan:
            d = {
                "server": f.server, "kind": f.kind, "mode": f.mode,
                "target": f.target, "magnitude": f.magnitude,
                "delay_rounds": f.delay_rounds,
                "delay_s": f.delay_s, "delay_dist": f.delay_dist,
                "delay_alpha": f.delay_alpha,
                "matrices": None if f.matrices is None else list(f.matrices),
                "in_band": f.in_band, "seed": f.seed,
            }
            faults.append(d)
        return wire.encode("FaultPlanFrame", {"faults": faults}, {})

    @classmethod
    def _from_wire(cls, scalars, arrays):
        plan = []
        for d in scalars["faults"]:
            mats = d.pop("matrices")
            plan.append(
                ServerFault(matrices=None if mats is None else tuple(mats),
                            **d)
            )
        return cls(plan=normalize_plan(plan))

    @classmethod
    def from_bytes(cls, data: bytes) -> "FaultPlanFrame":
        kind, scalars, arrays = wire.decode(data)
        if kind != "FaultPlanFrame":
            raise wire.WireError(f"expected FaultPlanFrame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


# Verdict and Determinant live in core (they predate the role split) but
# speak the same codec; register them so decode_message dispatches all
# four protocol-adjacent kinds.
def _register_core_kinds() -> None:
    from ..core.decipher import Determinant
    from ..core.verify import Verdict

    wire.MESSAGE_KINDS.setdefault("Verdict", Verdict)
    wire.MESSAGE_KINDS.setdefault("Determinant", Determinant)


_register_core_kinds()
