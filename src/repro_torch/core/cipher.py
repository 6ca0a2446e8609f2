"""Cipher — Composite Element Distortion (CED), paper §IV.C (port of
repro.core.cipher).

CED = EWO ∘ PRT: row i is divided (EWD) or multiplied (EWM) by the
blinding entry v_i, and the scaled matrix is rotated by
k = Rotate(Ψ) ∈ {1, 2, 3} clockwise quarter-turns. On a CUDA tensor both
run in one pass of the CED kernel (kernels/csrc/ced.cu); on a CPU tensor
the plain rot90_cw(EWO(...)) runs. Division, rotation and power-of-two
scaling are exact, so the ciphertext is bit-equal to the reference's.

Determinant bookkeeping (used by Decipher):

    EWD:  det(X) = det(M) / Ψ · s      EWM:  det(X) = det(M) · Ψ · s

with s = rotation_sign(n, k), or growth_safe_sign(n, k) when the
growth-safe relayout is on (DESIGN.md §6.1): an odd rotation composed
with an exchange flip, which is the transpose.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

from ..kernels import ops
from .keygen import Key
from .prt import rotate_degree
from .seed import Seed

Mode = Literal["ewd", "ewm"]


@dataclass(frozen=True)
class CipherMeta:
    """Public-side record of how M was ciphered (client keeps this)."""

    mode: Mode
    rotate_k: int  # quarter-turns applied
    n: int
    #: growth-safe relayout: the ciphertext is the transposed, not the
    #: rotated, scaled matrix; Decipher uses growth_safe_sign
    flipped: bool = False


def ewo(m: torch.Tensor, v: torch.Tensor, mode: Mode) -> torch.Tensor:
    """Element-wise obfuscation: row-scale by the blinding vector."""
    vcol = v.to(m.dtype)[..., :, None]
    if mode == "ewd":
        return m / vcol
    if mode == "ewm":
        return m * vcol
    raise ValueError(f"unknown EWO mode: {mode!r}")


def _flip_rotated(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exchange flip that undoes an odd rotation's diagonal→anti-diagonal
    map: column flip after k=1, row flip after k=3 — both give the
    transpose of the unrotated input."""
    if k % 2 == 0:
        return x
    if k % 4 == 1:
        return torch.flip(x, dims=(-1,))
    return torch.flip(x, dims=(-2,))


def _blinding(v, m: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), dtype=m.dtype, device=m.device)


def cipher(
    m: torch.Tensor,
    key: Key,
    seed: Seed,
    *,
    mode: Mode = "ewd",
    growth_safe: bool = False,
) -> tuple[torch.Tensor, CipherMeta]:
    """Cipher(K, M) → X for one (n, n) matrix; returns the ciphertext and
    the (client-held) meta. One CED launch on CUDA."""
    n = int(m.shape[-1])
    if m.ndim != 2 or m.shape[0] != n:
        raise ValueError(f"expected a square matrix, got {tuple(m.shape)}")
    if key.v.shape[0] != n:
        raise ValueError(f"blinding vector length {key.v.shape[0]} != n {n}")
    k = rotate_degree(seed.psi)
    x = ops.ced(m.contiguous(), _blinding(key.v, m), k, mode=mode,
                growth_safe=growth_safe)
    return x, CipherMeta(mode=mode, rotate_k=k, n=n,
                         flipped=growth_safe and k % 2 == 1)


def cipher_batch(
    m: torch.Tensor,
    key_vs: np.ndarray,
    seeds: list[Seed],
    *,
    mode: Mode = "ewd",
    growth_safe: bool = False,
) -> tuple[torch.Tensor, list[CipherMeta]]:
    """Batched Cipher: (B, n, n) stack + (B, n) stacked blinding vectors.

    Each matrix has its own rotation degree and one CED launch shares
    one k, so the batch is grouped by k: at most 3 launches for any B
    (as the reference's kernel path, core/cipher.py:190-198).
    """
    B, n = int(m.shape[0]), int(m.shape[-1])
    if len(seeds) != B:
        raise ValueError(f"{len(seeds)} seeds for batch of {B}")
    v = _blinding(key_vs, m)
    if tuple(v.shape) != (B, n):
        raise ValueError(f"blinding stack shape {tuple(v.shape)} != {(B, n)}")
    ks = np.array([rotate_degree(s.psi) for s in seeds], dtype=np.int64)
    metas = [
        CipherMeta(mode=mode, rotate_k=int(k), n=n,
                   flipped=growth_safe and int(k) % 2 == 1)
        for k in ks
    ]
    m = m.contiguous()
    x = torch.empty_like(m)
    for k in sorted(set(ks.tolist())):
        idx = torch.as_tensor(np.nonzero(ks == k)[0], device=m.device)
        x[idx] = ops.ced(m[idx], v[idx], int(k), mode=mode,
                         growth_safe=growth_safe)
    return x, metas


def equilibrate(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-sided power-of-two equilibration of a ciphertext (DESIGN.md §6.2).

    Scales row i by r_i = 2^{-round(log2 max_j |x_ij|)}, then column j
    by c_j = 2^{-round(log2 max_i |(r x)_ij|)}. Powers of two make the
    scaling exact, so the transform is lossless. Returns (x_eq,
    log2_scale), log2_scale the int32 Σ log2 r_i + Σ log2 c_j per
    matrix, so log|det x| = log|det x_eq| − log2_scale · ln 2.
    All-zero rows and columns scale by 1. Batch-aware.
    """
    def pow2_exp(maxabs):
        safe = torch.where(maxabs > 0, maxabs, torch.ones_like(maxabs))
        return torch.round(torch.log2(safe)).to(torch.int32)

    e_r = pow2_exp(x.abs().amax(dim=-1))
    x = x * torch.exp2(-e_r.to(x.dtype))[..., :, None]
    e_c = pow2_exp(x.abs().amax(dim=-2))
    x = x * torch.exp2(-e_c.to(x.dtype))[..., None, :]
    log2_scale = -(e_r.sum(dim=-1, dtype=torch.int32)
                   + e_c.sum(dim=-1, dtype=torch.int32))
    return x, log2_scale


def cipher_flops(n: int) -> int:
    """Cipher cost model — paper Table I claims n² flops for the protocol:
    one multiply (or divide) per element; the rotation is pure data
    movement (0 flops)."""
    return n * n
