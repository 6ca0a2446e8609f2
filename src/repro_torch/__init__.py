"""repro_torch — the SPDC protocol on PyTorch, with hand-written Hopper
kernels for its arithmetic.

A second package beside the JAX reference (`src/repro/`), mirroring its
layout module for module so each file's reference sits at the same
relative path. It imports torch, numpy and the standard library only —
never jax, never the reference package.

Entry points: `outsource_determinant(m, num_servers, device=...)`, with
`transport="socket"` (or `TransportConfig("socket", addresses=...)`) to
reach warm worker daemons (`python -m repro_torch.launch.serve_worker`)
and `rateless=RatelessConfig(...)` for straggler-adaptive dispatch; the
secure linalg family on one verified factorization (`LinalgSession`,
`outsource_solve`, `outsource_inverse`, and the differentiable
`secure_slogdet` / `secure_solve` / `secure_inv`); mixed-size lists in
one coalesced sweep (`outsource_determinant_mixed`) and the gateway that
serves them (`SPDCGateway`, `AsyncSPDCGateway`,
`python -m repro_torch.launch.serve_spdc`). Every entry point runs on the
CUDA device unless the caller passes ``device="cpu"``; on the CPU each kernel's plain PyTorch version
(kernels/ref.py) computes the same function.
"""
from .api import (
    EdgeServer,
    InlineTransport,
    MultiprocessTransport,
    Session,
    SPDCClient,
    ThreadPoolTransport,
    TransportConfig,
)
from .core.protocol import (
    SPDCBatchResult,
    SPDCResult,
    outsource_determinant,
    outsource_determinant_mixed,
    resolve_dtype,
)
from .configs.spdc import RatelessConfig
from .core.faults import ServerFault
from .core.inverse import SPDCInverseResult, outsource_inverse
from .device import resolve_device
from .linalg import (
    LinalgSession,
    SecureLinalg,
    outsource_solve,
    secure_inv,
    secure_slogdet,
    secure_solve,
)
from .serve.spdc_gateway import AsyncSPDCGateway, SPDCGateway

__all__ = [
    "AsyncSPDCGateway",
    "EdgeServer",
    "InlineTransport",
    "LinalgSession",
    "MultiprocessTransport",
    "RatelessConfig",
    "SPDCBatchResult",
    "SPDCClient",
    "SPDCGateway",
    "SPDCInverseResult",
    "SPDCResult",
    "SecureLinalg",
    "ServerFault",
    "Session",
    "SocketTransport",
    "ThreadPoolTransport",
    "TransportConfig",
    "WorkerDaemon",
    "outsource_determinant",
    "outsource_determinant_mixed",
    "outsource_inverse",
    "outsource_solve",
    "resolve_device",
    "resolve_dtype",
    "secure_inv",
    "secure_slogdet",
    "secure_solve",
]


def __getattr__(name):
    # the socket transport's names resolve lazily, as in repro_torch.api
    if name in ("SocketTransport", "WorkerDaemon"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
