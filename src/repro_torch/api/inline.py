"""Transports of the port — how the Parallelize stage reaches the servers
(port of the inline part of repro.api.transport).

Only the in-process transport is ported: `InlineTransport.sweep` runs
the N-server schedule (core.lu.lu_nserver) as one fused sweep, which is
the reference's default and its throughput path. The message transports
come with their own slices (ROADMAP A7, A9, A12); this module moves to
`api/transport.py` when they do.
"""
from __future__ import annotations

import torch

from ..core.lu import lu_nserver

__all__ = ["Transport", "TransportError", "InlineTransport", "resolve_transport"]

#: transports of the reference that the port does not have yet, and the
#: ROADMAP item that ports each
_NOT_PORTED = {
    "threadpool": "A7", "multiprocess": "A7", "socket": "A9",
    "shardmap": "A12",
}


class TransportError(RuntimeError):
    """The transport was used after close()."""


class Transport:
    """Base transport.

    fused: True when `sweep()` runs the whole factorization in one go and
        the Session skips per-server messages.
    style: the operation order of this transport's factors (the order a
        recovery recompute must replay).
    """

    name = "abstract"
    fused = False
    style = "nserver"

    _closed = False

    @property
    def closed(self) -> bool:
        """True once close() ran; a closed transport refuses dispatch."""
        return self._closed

    def _ensure_open(self) -> None:
        if self._closed:
            raise TransportError(
                f"transport {self.name!r} is closed; build a fresh one"
            )

    def close(self) -> None:
        """Release what the transport holds; idempotent."""
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class InlineTransport(Transport):
    """Single-process transport: the servers' stage is one call of
    lu_nserver on the session's device, for one matrix or a stack."""

    name = "inline"
    fused = True

    def sweep(self, x_aug: torch.Tensor, num_servers: int,
              faults=()) -> tuple[torch.Tensor, torch.Tensor]:
        self._ensure_open()
        l, u, _ = lu_nserver(x_aug, num_servers, faults=faults)
        return l, u


def resolve_transport(spec=None) -> Transport:
    """None or "inline" → a new InlineTransport; an InlineTransport →
    itself. The reference's other transports raise NotImplementedError
    naming the ROADMAP item that ports them."""
    if isinstance(spec, InlineTransport):
        return spec
    if spec is None or spec == "inline":
        return InlineTransport()
    name = getattr(spec, "name", spec)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"transport {name!r}: ROADMAP {_NOT_PORTED[name]}"
        )
    raise ValueError(
        f"unknown transport {spec!r}; the port has 'inline' only"
    )
