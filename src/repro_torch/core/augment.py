"""Determinant-preserving matrix augmentation — paper §II.B and §IV.D.1
(port of repro.core.augment).

Pads an n×n matrix A to (n+p)×(n+p) as

    B = [[A, 0],
         [R, I_p]]

with R random and the lower-right block the p×p identity, so
det(B) = det(A). p is the smallest non-negative integer such that n+p
is divisible by the server count N and (n+p)/N > 1.

By design the R block is drawn from a numpy Generator (the client seeds
it from the Ψ digest), not from jax.random as the reference's
uniform-batch path does: torch cannot reproduce threefry bits. With
p = 0 the border is absent and the port is bit-equal; with p > 0 the
determinants agree, the factors do not.
"""
from __future__ import annotations

import numpy as np
import torch


def padding_for_servers(n: int, num_servers: int) -> int:
    """Minimum p ≥ 0 with (n+p) % N == 0 and (n+p)/N > 1 (paper §IV.D.1)."""
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    p = 0
    while (n + p) % num_servers != 0 or (n + p) // num_servers <= 1:
        p += 1
    return p


def padding_to_even(n: int) -> int:
    """Nearest-even padding (paper §VI.C): p ∈ {0, 1}."""
    return n % 2


def border_rng(digest: bytes) -> np.random.Generator:
    """The R-block generator keyed to client-secret material — the seed
    the reference's own numpy path uses (repro/api/client.py:395)."""
    return np.random.default_rng(int.from_bytes(digest[8:16], "big") % (2**31))


def augment(a: torch.Tensor, p: int, *,
            rng: np.random.Generator | None = None) -> torch.Tensor:
    """Pad a to (n+p)×(n+p) preserving det; the R block is uniform in
    [-1, 1) from `rng`, or zero without one.

    Batch-aware: (..., n, n) inputs get independent R blocks from one
    draw of shape (..., p, n).
    """
    if p == 0:
        return a
    n = a.shape[-1]
    batch = tuple(a.shape[:-2])
    out = torch.zeros((*batch, n + p, n + p), dtype=a.dtype, device=a.device)
    out[..., :n, :n] = a
    if rng is not None:
        r = rng.uniform(-1.0, 1.0, (*batch, p, n))
        out[..., n:, :n] = torch.as_tensor(r, dtype=a.dtype, device=a.device)
    out[..., n:, n:] = torch.eye(p, dtype=a.dtype, device=a.device)
    return out


def augment_block_row(a: torch.Tensor, p: int, row0: int, rows: int, *,
                      rng: np.random.Generator | None = None) -> torch.Tensor:
    """Rows [row0, row0 + rows) of `augment(a, p, rng=rng)` without
    building the whole augmented matrix.

    Recovery re-derives one server's shard, a (..., rows, n + p) strip,
    when it re-dispatches after a localized fault, so the client need not
    keep the augmented ciphertext. `rng` must be a fresh generator seeded
    as the one `augment` drew from (`border_rng` of the same digest): the
    whole R block is drawn again, so the rows are bit-equal to the slice
    of the full augmentation.
    """
    n = a.shape[-1]
    if not 0 <= row0 <= row0 + rows <= n + p:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside n+p={n + p}")
    if p == 0:
        return a[..., row0 : row0 + rows, :]
    batch = tuple(a.shape[:-2])
    out = torch.zeros((*batch, rows, n + p), dtype=a.dtype, device=a.device)
    top = max(min(row0 + rows, n) - row0, 0)
    if top:
        out[..., :top, :n] = a[..., row0 : row0 + top, :]
    if rows > top:
        b0 = max(row0, n) - n
        if rng is not None:
            r = rng.uniform(-1.0, 1.0, (*batch, p, n))[..., b0 : b0 + rows - top, :]
            out[..., top:, :n] = torch.as_tensor(r, dtype=a.dtype, device=a.device)
        eye = torch.eye(p, dtype=a.dtype, device=a.device)
        out[..., top:, n:] = eye[b0 : b0 + rows - top]
    return out
