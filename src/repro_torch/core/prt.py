"""Panth Rotation Theorem (PRT) — paper §II.A (port of repro.core.prt).

For an n×n matrix X and k clockwise quarter-turns,

    det(rot90_cw^k(X)) = ((-1)^{floor(n/2)})^k · det(X)

so the determinant sign is invariant for n ≡ 0,1 (mod 4) and flips per
quarter-turn for n ≡ 2,3 (mod 4). 180° (k=2) always preserves the sign.

The sign laws are host integer arithmetic, identical to the reference;
the rotation itself is a torch relayout over the last two axes.
"""
from __future__ import annotations

import math

import torch


def rot90_cw(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Rotate the last two axes by k clockwise quarter-turns.

    torch.rot90 turns counter-clockwise from dims[0] toward dims[1], so
    k clockwise turns are -k counter-clockwise ones. Batch-aware.
    """
    return torch.rot90(x, -(k % 4), dims=(-2, -1))


def rotation_sign(n: int, k: int) -> int:
    """det(rot90_cw^k(X)) = rotation_sign(n, k) * det(X)."""
    return (-1) ** ((n // 2) * (k % 4))


def rotation_sign_paper(k: int) -> int:
    """The paper's literal Decipher factor (-1)^{Rotate(Ψ)} — ignores n;
    correct only for n ≡ 2,3 (mod 4) (DESIGN.md §1.1)."""
    return (-1) ** (k % 4)


def flip_sign(n: int) -> int:
    """det of the n×n exchange matrix J: (-1)^{floor(n/2)}."""
    return (-1) ** (n // 2)


def growth_safe_sign(n: int, k: int) -> int:
    """Determinant sign of the growth-safe relayout (DESIGN.md §6.1):
    +1 for odd k (the composite map is a transpose), the rotation sign
    for even k."""
    if k % 2 == 1:
        return 1
    return rotation_sign(n, k)


def sign_preserved(n: int, k: int) -> bool:
    """True iff a k-quarter-turn rotation preserves det's sign for size n:
    always for n ≡ 0, 1 (mod 4), for even k only for n ≡ 2, 3 (mod 4)."""
    return rotation_sign(n, k) == 1


def quantize_seed(psi: float, method: str = "floor") -> int:
    """Quantized seed Ψ' — paper §IV.C.2 offers floor/ceil/round/trunc."""
    if method == "floor":
        return int(math.floor(psi))
    if method == "ceil":
        return int(math.ceil(psi))
    if method == "round":
        return int(round(psi))
    if method == "trunc":
        return int(psi)
    raise ValueError(f"unknown quantization method: {method!r}")


def rotate_degree(psi: float, method: str = "floor") -> int:
    """Rotate(Ψ) ∈ {1,2,3}: (Ψ' mod 3) + 1 clockwise quarter-turns."""
    return (quantize_seed(psi, method) % 3) + 1
