"""SeedGen — paper §IV.A.

Ψ = H(λ₁, μ, M_max): a cryptographic hash of the security parameter and the
matrix's statistical properties (mean and max), mapped to a positive float
in a numerically safe range.

The hash-to-float mapping matters for numerics: Ψ is the *product* of the n
blinding-vector entries (§IV.B), so each entry has geometric mean Ψ^{1/n}.
We map the 256-bit digest to Ψ ∈ [2^-4, 2^4] — wide enough for 8 bits of
entropy in the exponent alone (plus 52 mantissa bits), narrow enough that
blinding never overflows float64 for any n. Security rests on the digest,
not on Ψ's magnitude.

The port's own copy of repro.core.seed: host numpy and hashlib code, bit-equal
to the reference down to the digest bytes.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Seed:
    """The client-secret seed Ψ plus the matrix statistics that fed it."""

    psi: float
    mu: float
    m_max: float
    digest: bytes  # full H(λ₁, μ, M_max) — feeds KeyGen's CSPRNG

    def __float__(self) -> float:
        return self.psi


def _hash(lambda1: int, mu: float, m_max: float) -> bytes:
    h = hashlib.sha256()
    h.update(struct.pack(">q", int(lambda1)))
    h.update(struct.pack(">d", float(mu)))
    h.update(struct.pack(">d", float(m_max)))
    return h.digest()


def seedgen(lambda1: int, m: np.ndarray) -> Seed:
    """SeedGen(λ₁, M) → (Ψ, μ, M_max). Runs on the client, off-accelerator."""
    arr = np.asarray(m, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(f"M must be square, got shape {arr.shape}")
    mu = float(arr.mean())
    m_max = float(arr.max())
    digest = _hash(lambda1, mu, m_max)
    # Map first 8 digest bytes to u ∈ [0, 1), then Ψ = 2^(8u - 4) ∈ [2^-4, 2^4).
    u = struct.unpack(">Q", digest[:8])[0] / 2**64
    psi = float(2.0 ** (8.0 * u - 4.0))
    return Seed(psi=psi, mu=mu, m_max=m_max, digest=digest)


def seedgen_batch(lambda1: int, m: np.ndarray) -> list[Seed]:
    """SeedGen over a (B, n, n) stack — one independent seed per matrix.

    Hashing is host-side and O(1) per matrix; the heavy per-matrix numerics
    downstream (cipher/LU/verify) consume the stacked outputs in one
    batched device program (DESIGN.md §3).
    """
    arr = np.asarray(m, dtype=np.float64)
    if arr.ndim != 3 or arr.shape[-1] != arr.shape[-2]:
        raise ValueError(f"M must be a (B, n, n) stack, got shape {arr.shape}")
    return [seedgen(lambda1, arr[i]) for i in range(arr.shape[0])]
