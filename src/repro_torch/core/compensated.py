"""Compensated sums and dot products: results as if computed in twice the
working precision and rounded once.

The error-free transformations of Ogita, Rump and Oishi ("Accurate sum
and dot product", SIAM J. Sci. Comput. 26(6), 2005): TwoSum gives the
rounding error of an addition exactly, TwoProduct (Veltkamp's split, so
no fused multiply-add is needed) that of a product, and a pairwise
cascade of TwoSums sums a row with the errors carried beside it.

Authenticate's Q3 uses them (core/verify.py). Under the element growth
of a no-pivot LU the terms of a diagonal sum Σ_j L_ij U_ji cancel by
many orders of magnitude, so a sum in the working precision is off by
up to u·Σ|L_ij U_ji|, which can be more than ε(N) allows. In twice the
precision the error falls to u·|result| + O(u²)·Σ|terms|.

The cascade is elementwise and the error terms' sums are plain
reductions, so a row's result does not depend on the other rows of its
batch, and differs between devices by at most a rounding of terms of
order u² times the terms' sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _splitter(dtype: torch.dtype) -> float:
    """2^⌈t/2⌉ + 1 for a t-digit significand: 134217729 for float64,
    4097 for float32."""
    digits = 1 - round(math.log2(torch.finfo(dtype).eps))
    return float(2 ** -(-digits // 2) + 1)


def two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, e) with s = fl(a + b) and s + e = a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def two_product(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(p, e) with p = fl(a · b) and p + e = a · b exactly (barring
    underflow), by Veltkamp's split of each factor into two halves."""
    factor = _splitter(a.dtype)
    ca, cb = factor * a, factor * b
    a_hi = ca - (ca - a)
    b_hi = cb - (cb - b)
    a_lo, b_lo = a - a_hi, b - b_hi
    p = a * b
    return p, ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


def _halve(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The even and odd columns of t, padded with a zero to even width."""
    if t.shape[-1] % 2:
        t = F.pad(t, (0, 1))
    return t[..., 0::2], t[..., 1::2]


def accurate_sum(terms: torch.Tensor,
                 errors: torch.Tensor | None = None) -> torch.Tensor:
    """Σ over the last axis, as if in twice the working precision and
    rounded once: a pairwise cascade of TwoSums, whose rounding errors
    (each at most u times a partial sum) are summed in the working
    precision beside it, with `errors` (a row's known error terms), and
    added at the end."""
    s = terms
    total = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                        device=terms.device) if errors is None else errors
    while s.shape[-1] > 1:
        s, e = two_sum(*_halve(s))
        total = total + e.sum(dim=-1)
    return s[..., 0] + total


def diagonal_residuals(l: torch.Tensor, u: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Σ_{j≤i} L_ij U_ji − x_ii of each row i, compensated: the products
    split exactly by TwoProduct, x_ii folded into the diagonal term by a
    TwoSum, the products' high parts summed by `accurate_sum` and their
    low parts, each at most u times its product, in the working
    precision."""
    p, e = two_product(torch.tril(l), torch.triu(u).transpose(-1, -2))
    diag = torch.diagonal(p, dim1=-2, dim2=-1)
    s, e_diag = two_sum(diag, -torch.diagonal(x, dim1=-2, dim2=-1))
    diag.copy_(s)
    return accurate_sum(p, e.sum(dim=-1) + e_diag)
