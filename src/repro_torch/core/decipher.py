"""Decipher — paper §IV.F: recover det(M) from the LU of the ciphertext
(port of repro.core.decipher).

    det(X) = Π_i L_ii U_ii                      (from the servers' LU)
    EWD:  det(M) = det(X) · sign · Ψ
    EWM:  det(M) = det(X) · sign / Ψ

The rotation sign is ((-1)^{⌊n/2⌋})^k (PRT); the paper's literal (-1)^k
is available with faithful=True; the growth-safe relayout uses
growth_safe_sign. All arithmetic is in (sign, log|·|) space, the
compensated log-sum recombined in float64 on the host (DESIGN.md §1.1, §6).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cipher import CipherMeta
from .lu import slogdet_pair_from_lu
from .prt import growth_safe_sign, rotation_sign, rotation_sign_paper
from .seed import Seed

_LN2 = float(np.log(2.0))

#: largest log|det| whose exp still fits a float64
_MAX_VALUE_LOGABS = float(np.log(np.finfo(np.float64).max))

#: dtype-aware default relative det tolerance for allclose(), keyed by
#: the dtype's plain name ("float64", never "torch.float64")
_DEFAULT_RTOL = {"float64": 1e-8, "float32": 1e-4, "float16": 1e-2,
                 "bfloat16": 1e-1}


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float64 → "float64": the name Determinant.dtype carries."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class Determinant:
    """Determinant in overflow-safe (sign, log|det|) form.

    `dtype` names the compute dtype of the factorization ("float64",
    "float32") and selects allclose()'s default tolerance; `logabs` is
    always a host float64. Serializes with the wire codec, byte-identical
    to the reference's frames.
    """

    sign: float
    logabs: float
    dtype: str = "float64"

    @property
    def value(self) -> float:
        """det as a plain float — raises OverflowError when it does not fit."""
        if self.logabs > _MAX_VALUE_LOGABS:
            raise OverflowError(
                f"|det| = exp({self.logabs:.1f}) overflows float64; compare "
                "in (sign, logabs) space instead of .value"
            )
        return float(self.sign * np.exp(self.logabs))

    def is_zero(self, atol_logabs: float = -np.inf) -> bool:
        """True for an exact zero sign, a -inf logabs, or logabs at or
        below `atol_logabs`."""
        return self.sign == 0 or self.logabs == float("-inf") \
            or self.logabs <= atol_logabs

    def allclose(
        self,
        other: "Determinant",
        rtol: float | None = None,
        atol: float = 0.0,
        zero_logabs: float = -np.inf,
    ) -> bool:
        """Relative-determinant comparison in log space: equal signs and
        |Δ logabs| ≤ log1p(rtol) + atol. rtol=None takes the dtype-aware
        default of the coarser operand (1e-8 float64, 1e-4 float32).
        Zeros equal each other regardless of sign and nothing else."""
        if rtol is None:
            rtol = max(_DEFAULT_RTOL.get(d, 1e-8)
                       for d in (self.dtype, other.dtype))
        a_zero = self.is_zero(zero_logabs)
        b_zero = other.is_zero(zero_logabs)
        if a_zero or b_zero:
            return a_zero and b_zero
        if self.sign != other.sign:
            return False
        return bool(
            abs(self.logabs - other.logabs) <= float(np.log1p(rtol)) + atol
        )

    def to_bytes(self) -> bytes:
        """Serialize with the wire codec (api/wire.py); (sign, logabs)
        round-trip bit-exactly, ±inf included."""
        from ..api import wire

        return wire.encode(
            "Determinant",
            {"sign": float(self.sign), "logabs": float(self.logabs),
             "dtype": self.dtype},
            {},
        )

    @classmethod
    def _from_wire(cls, scalars, arrays):
        return cls(sign=scalars["sign"], logabs=scalars["logabs"],
                   dtype=scalars["dtype"])

    @classmethod
    def from_bytes(cls, data: bytes) -> "Determinant":
        from ..api import wire

        kind, scalars, arrays = wire.decode(data)
        if kind != "Determinant":
            raise wire.WireError(f"expected Determinant frame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


def _assemble(
    sign_x: float,
    logabs_x: float,
    seed: Seed,
    meta: CipherMeta,
    *,
    faithful: bool,
    log2_scale: float,
    dtype: str,
) -> Determinant:
    """Shared Decipher bookkeeping: relayout sign, equilibration
    correction, Ψ factor — all in host float64."""
    if faithful:
        s = rotation_sign_paper(meta.rotate_k)
    elif meta.flipped:
        s = growth_safe_sign(meta.n, meta.rotate_k)
    else:
        s = rotation_sign(meta.n, meta.rotate_k)
    log_psi = float(np.log(seed.psi))
    logabs = logabs_x - float(log2_scale) * _LN2
    if meta.mode == "ewd":
        return Determinant(sign=sign_x * s, logabs=logabs + log_psi,
                           dtype=dtype)
    if meta.mode == "ewm":
        return Determinant(sign=sign_x * s, logabs=logabs - log_psi,
                           dtype=dtype)
    raise ValueError(f"unknown mode {meta.mode!r}")


def decipher(
    seed: Seed,
    meta: CipherMeta,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    faithful: bool = False,
    log2_scale: float = 0.0,
) -> Determinant:
    """Decipher(Ψ, L, U) → det(M) for one matrix. log2_scale is the
    equilibration exponent sum (0 without equilibration)."""
    sign_x, hi, lo = slogdet_pair_from_lu(l, u)
    logabs_x = float(hi) + float(lo)  # recombine the pair in float64
    return _assemble(
        float(sign_x), logabs_x, seed, meta,
        faithful=faithful, log2_scale=log2_scale, dtype=dtype_name(l.dtype),
    )


def decipher_batch(
    seeds: list[Seed],
    metas: list[CipherMeta],
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    faithful: bool = False,
    log2_scale: np.ndarray | None = None,
) -> list[Determinant]:
    """Batched Decipher: (B, n, n) LU factors → one Determinant per
    matrix. log2_scale: per-matrix equilibration exponents, shape (B,)."""
    sign_x, hi, lo = slogdet_pair_from_lu(l, u)
    logabs_x = hi.astype(np.float64) + lo.astype(np.float64)
    dtype = dtype_name(l.dtype)
    if log2_scale is None:
        log2_scale = np.zeros(len(seeds))
    log2_scale = np.asarray(log2_scale)
    return [
        _assemble(
            float(sign_x[i]), float(logabs_x[i]), seed, meta,
            faithful=faithful, log2_scale=float(log2_scale[i]), dtype=dtype,
        )
        for i, (seed, meta) in enumerate(zip(seeds, metas, strict=True))
    ]


def decipher_flops(n: int) -> int:
    """Paper Table I Decipher cost: 2n (n diagonal products and about n
    for the running product or log accumulation)."""
    return 2 * n
