"""Role-split API of the port (mirrors repro.api): the trusted client
(`SPDCClient`/`Session`) and the transport that carries the Parallelize
stage (`InlineTransport`)."""
from .client import Session, SPDCClient
from .inline import InlineTransport, Transport, TransportError, resolve_transport

__all__ = [
    "InlineTransport",
    "SPDCClient",
    "Session",
    "Transport",
    "TransportError",
    "resolve_transport",
]
