"""repro_torch — the SPDC protocol on PyTorch, with hand-written Hopper
kernels for its arithmetic.

A second package beside the JAX reference (`src/repro/`), mirroring its
layout module for module so each file's reference sits at the same
relative path. It imports torch, numpy and the standard library only —
never jax, never the reference package.

Entry point: `outsource_determinant(m, num_servers, device=...)`. Every
entry point runs on the CUDA device unless the caller passes
``device="cpu"``; on the CPU each kernel's plain PyTorch version
(kernels/ref.py) computes the same function.
"""
from .api import InlineTransport, Session, SPDCClient
from .core.protocol import (
    SPDCBatchResult,
    SPDCResult,
    outsource_determinant,
    resolve_dtype,
)
from .device import resolve_device

__all__ = [
    "InlineTransport",
    "SPDCBatchResult",
    "SPDCClient",
    "SPDCResult",
    "Session",
    "outsource_determinant",
    "resolve_device",
    "resolve_dtype",
]
