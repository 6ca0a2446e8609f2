"""KeyGen — paper §IV.B.

Constructs the secret blinding vector v = [v₁ … v_n] with

    ∏ v_i = Ψ,   v_i ≠ 1 ∀i,

drawn from a CSPRNG keyed by (λ₂, Ψ-digest). We sample log-space offsets so
every v_i has geometric mean Ψ^{1/n} — entries stay in a tight positive band
and the product telescopes to Ψ exactly (up to one float64 rounding in the
last entry, which we absorb by construction: v_n := Ψ / ∏_{i<n} v_i).

The port's own copy of repro.core.keygen: host numpy and hashlib code, bit-equal
to the reference down to the digest bytes.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

import numpy as np

from .seed import Seed


@dataclass(frozen=True)
class Key:
    """Secret key K = {v}. Held by the client only."""

    v: np.ndarray  # float64 (n,)

    @property
    def n(self) -> int:
        return int(self.v.shape[0])


def _csprng(digest: bytes, lambda2: int, count: int) -> np.ndarray:
    """Deterministic CSPRNG stream: SHA-256 in counter mode → floats in [0,1).

    hashlib is the only cryptographic primitive available offline; counter-
    mode SHA-256 is a standard PRF construction for this purpose.
    """
    out = np.empty(count, dtype=np.float64)
    block = b""
    need = count * 8
    chunks = []
    ctr = 0
    while need > 0:
        h = hashlib.sha256()
        h.update(digest)
        h.update(struct.pack(">qq", int(lambda2), ctr))
        block = h.digest()
        chunks.append(block)
        need -= len(block)
        ctr += 1
    raw = b"".join(chunks)[: count * 8]
    ints = np.frombuffer(raw, dtype=">u8").astype(np.float64)
    out[:] = ints / 2.0**64
    return out


def keygen(lambda2: int, seed: Seed, n: int, *, spread: float = 0.5) -> Key:
    """KeyGen(λ₂, Ψ, μ, M_max) → K.

    spread controls the log-uniform band around the geometric mean; entries
    land in [g·2^-spread, g·2^spread] with g = Ψ^{1/n}, and the v_i ≠ 1
    constraint is enforced by nudging any entry that rounds to exactly 1.
    """
    if n < 2:
        raise ValueError("blinding vector needs n >= 2")
    u = _csprng(seed.digest, lambda2, n - 1)
    g = float(seed.psi) ** (1.0 / n)
    logs = (u * 2.0 - 1.0) * spread + np.log2(g)
    v = np.empty(n, dtype=np.float64)
    v[: n - 1] = np.exp2(logs)
    # exact product constraint
    v[n - 1] = float(seed.psi) / float(np.prod(v[: n - 1]))
    # v_i != 1 (paper constraint); measure-zero event, nudge deterministically
    ones = v == 1.0
    if ones.any():
        v[ones] = np.nextafter(1.0, 2.0)
        v[n - 1] = float(seed.psi) / float(np.prod(v[: n - 1]))
    return Key(v=v)


def keygen_batch(lambda2: int, seeds: list[Seed], n: int, *,
                 spread: float = 0.5) -> np.ndarray:
    """KeyGen over a batch of seeds → stacked blinding vectors (B, n).

    Each row satisfies the per-matrix product constraint ∏ v_i = Ψ_b; the
    stack feeds the batched cipher in one device call (DESIGN.md §3).
    """
    return np.stack([keygen(lambda2, s, n, spread=spread).v for s in seeds])
