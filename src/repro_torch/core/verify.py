"""Result authentication — paper §IV.E: Q1 (prior work), Q2, Q3, ε(N) —
plus per-server tamper localization (DESIGN.md §4). Port of
repro.core.verify.

Q1 (Gao & Yu):  vector residual   L(U r) − X r
Q2 (paper):     scalar residual   (Lᵀr)ᵀ(U r) − (rᵀ X) r
Q3 (paper):     deterministic     Σ_i |Σ_{j≤i} L_ij U_ji − x_ii|

Q3's diagonal sums are compensated (`compensated.diagonal_residuals`),
so a Q3 residual is the factors' exact one. Under the element growth of
a rotated ciphertext their terms cancel by many orders of magnitude, and
a sum in the working precision, as the reference's, is off by up to
u·Σ_j|L_ij U_ji|, which can pass the capped ε (ROADMAP §C).

All are O(n²): matrix–vector products or the diagonal band terms. Every
check is batch-aware: (..., n, n) factors give per-matrix residuals, so a
tampered matrix in a batch is flagged on its own.

ε(N) = c · (1 + N) · n · u · max(scale(X), 1)², u the compute dtype's
unit roundoff and scale(X) = ‖X‖_F / √n, widened by the observed element
growth max|U| / max|X| (clamped ≥ 1). The diagonal-only Q3 forms clamp
the widening at q3_growth_cap(n) = c·n, because planted cancelling
strictly-upper entries would otherwise inflate it for free; the
secret-probed Q1/Q2 residuals see every entry and use the raw growth.
The reference module's docstring carries the full argument.

Localization: server i owns block row i of both factors, so blocking the
Q1 residual by rows [i·b, (i+1)·b) names the first corrupted strip.

Verdicts are host values (Python scalars or numpy arrays), as in the
reference; the probes r are drawn with numpy and moved to the factors'
device, so they are bit-equal to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .compensated import accurate_sum, diagonal_residuals


def q1(l: torch.Tensor, u: torch.Tensor, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Gao & Yu's vector check: L(Ur) − Xr. Zero vector iff LU consistent."""
    ur = torch.einsum("...ij,...j->...i", u, r)
    return (torch.einsum("...ij,...j->...i", l, ur)
            - torch.einsum("...ij,...j->...i", x, r))


def q2(l: torch.Tensor, u: torch.Tensor, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Paper's scalar probabilistic check: (Lᵀr)ᵀ(Ur) − (rᵀX)r."""
    lt_r = torch.einsum("...ij,...i->...j", l, r)
    u_r = torch.einsum("...ij,...j->...i", u, r)
    rx = torch.einsum("...i,...ij->...j", r, x)
    return (lt_r * u_r).sum(dim=-1) - (rx * r).sum(dim=-1)


def q3(l: torch.Tensor, u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Deterministic diagonal check, per-element abs (the form the paper's
    own correctness proof §V.C.2 uses): Σ_i |(L·U)_ii − x_ii|."""
    return torch.abs(diagonal_residuals(l, u, x)).sum(dim=-1)


def q3_paper_literal(l: torch.Tensor, u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Q3 exactly as §IV.E.2 writes it: |Σ_i (Σ_{j≤i} L_ij U_ji − x_ii)| —
    weaker than q3, opposite-sign per-row errors cancel."""
    return torch.abs(accurate_sum(diagonal_residuals(l, u, x)))


def _host(t: torch.Tensor):
    """A 0-d tensor as a float, anything else as a numpy array."""
    if t.ndim == 0:
        return float(t)
    return t.detach().cpu().numpy()


def epsilon(
    num_servers: int,
    n: int,
    x: torch.Tensor | None = None,
    *,
    dtype: torch.dtype = torch.float64,
    c: float = 64.0,
):
    """Acceptance threshold ε(N) — grows with server count (paper §IV.E.3).

    A float for a single matrix; a (B,) array for a (B, n, n) stack.
    """
    u = float(torch.finfo(dtype).eps)
    if x is None:
        scale = 1.0
    else:
        scale = _host(torch.linalg.matrix_norm(x) / np.sqrt(n))
    out = c * (1.0 + num_servers) * n * u * np.maximum(scale, 1.0) ** 2
    return float(out) if np.ndim(out) == 0 else np.asarray(out)


def growth_estimate(u_factor: torch.Tensor, x: torch.Tensor):
    """Observed element growth of the no-pivot elimination, clamped ≥ 1:
    max|U| / max|X| per matrix (a float, or (B,) for a stack)."""
    num = u_factor.abs().amax(dim=(-2, -1))
    den = torch.clamp(x.abs().amax(dim=(-2, -1)), min=torch.finfo(x.dtype).tiny)
    return _host(torch.clamp(num / den, min=1.0))


def q3_growth_cap(n: int, *, c: float = 4.0) -> float:
    """Ceiling on the ε-widening a diagonal-only (Q3) residual may claim:
    c·n keeps the acceptance tolerance client-chosen (module docstring)."""
    return c * n


def _probe(rng: np.random.Generator, x: torch.Tensor) -> torch.Tensor:
    """One standard-normal probe per matrix, drawn on the host."""
    n = x.shape[-1]
    shape = (x.shape[0], n) if x.ndim == 3 else (n,)
    return torch.as_tensor(rng.standard_normal(shape), dtype=x.dtype,
                           device=x.device)


def per_server_residuals(
    l: torch.Tensor,
    u: torch.Tensor,
    x: torch.Tensor,
    *,
    num_servers: int,
    method: str = "q1",
    r: torch.Tensor | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Blocked residuals attributing the check to Alg. 3's block rows:
    (N,) for a single matrix, (B, N) for a stack. "q1" (what `localize`
    uses) blocks the Q1 residual by owner row; "q3" blocks the diagonal
    terms by diagonal owner — a diagnostic view, not a culprit-namer."""
    n = x.shape[-1]
    if n % num_servers != 0:
        raise ValueError(f"n={n} not partitioned by N={num_servers}")
    if method == "q1":
        if r is None:
            r = _probe(rng or np.random.default_rng(1), x)
        terms = torch.abs(q1(l, u, x, r))
        blocked = terms.reshape(*terms.shape[:-1], num_servers, n // num_servers)
        out = blocked.amax(dim=-1)
    elif method == "q3":
        terms = torch.abs(diagonal_residuals(l, u, x))
        blocked = terms.reshape(*terms.shape[:-1], num_servers, n // num_servers)
        out = blocked.sum(dim=-1)
    else:
        raise ValueError(f"unknown localization method {method!r}")
    return out.detach().cpu().numpy()


#: Verdict fields that may be scalars (single matrix) or per-matrix
#: numpy arrays (a stack) — the wire codec branches on this
_VERDICT_POLY = ("ok", "residual", "eps", "culprit")


@dataclass
class Verdict:
    """Structured Authenticate outcome: global accept/reject plus the
    per-server attribution the recovery scheduler consumes.

    Scalars (bool/float) for a single matrix; per-matrix numpy arrays for
    a (B, n, n) stack. `culprit` is the FIRST server whose residual block
    exceeds ε(N), every strip above it clean (-1 when all blocks pass).
    Serializes with the wire codec (`to_bytes`/`from_bytes`, api/wire.py),
    byte-identical to the reference's frames.
    """

    ok: bool | np.ndarray
    residual: float | np.ndarray
    method: str
    eps: float | np.ndarray
    num_servers: int
    server_residual: np.ndarray | None = None  # (N,) or (B, N)
    server_ok: np.ndarray | None = None
    culprit: int | np.ndarray = -1

    @property
    def all_ok(self) -> bool:
        return bool(np.all(self.ok))

    def to_bytes(self) -> bytes:
        from ..api import wire

        scalars = {"method": self.method, "num_servers": self.num_servers}
        arrays = {"server_residual": self.server_residual,
                  "server_ok": self.server_ok}
        for name in _VERDICT_POLY:
            val = getattr(self, name)
            if isinstance(val, np.ndarray):
                arrays[name] = val
            elif isinstance(val, (bool, np.bool_)):
                scalars[name] = bool(val)
            elif isinstance(val, (int, np.integer)):
                scalars[name] = int(val)
            else:
                scalars[name] = float(val)
        return wire.encode("Verdict", scalars, arrays)

    @classmethod
    def _from_wire(cls, scalars, arrays):
        fields = {
            "method": scalars["method"],
            "num_servers": int(scalars["num_servers"]),
            "server_residual": arrays["server_residual"],
            "server_ok": arrays["server_ok"],
        }
        for name in _VERDICT_POLY:
            fields[name] = arrays[name] if name in arrays else scalars[name]
        return cls(**fields)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Verdict":
        from ..api import wire

        kind, scalars, arrays = wire.decode(data)
        if kind != "Verdict":
            raise wire.WireError(f"expected Verdict frame, got {kind!r}")
        return cls._from_wire(scalars, arrays)


def _first_culprit(server_ok: np.ndarray) -> int | np.ndarray:
    """Index of the first failing block row; -1 if all pass. (B,) if batched."""
    bad = ~server_ok
    if server_ok.ndim == 1:
        return int(np.argmax(bad)) if bad.any() else -1
    first = np.argmax(bad, axis=-1)
    return np.where(bad.any(axis=-1), first, -1).astype(np.int64)


def localize(
    l: torch.Tensor,
    u: torch.Tensor,
    x: torch.Tensor,
    *,
    num_servers: int,
    eps: float | np.ndarray | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, int | np.ndarray]:
    """(server_residual, server_ok, culprit) via the blocked Q1 residual."""
    n = x.shape[-1]
    if eps is None:
        eps = epsilon(num_servers, n, x, dtype=x.dtype) * growth_estimate(u, x)
    sres = per_server_residuals(l, u, x, num_servers=num_servers, rng=rng)
    eps_col = np.asarray(eps)[..., None] if np.ndim(eps) else eps
    sok = sres <= eps_col
    return sres, sok, _first_culprit(sok)


def authenticate(
    l: torch.Tensor,
    u: torch.Tensor,
    x: torch.Tensor,
    *,
    num_servers: int,
    method: str = "q3",
    rng: np.random.Generator | None = None,
    eps: float | np.ndarray | None = None,
    attribute: bool | str = "auto",
) -> Verdict:
    """Authenticate(L, U, X) → Verdict (accept/reject + per-server blame).

    method ∈ {"q1", "q2", "q3", "q3_literal"}. For q1/q2 a probe r is
    drawn client-side from `rng`, which SHOULD be seeded from client-held
    secret material (the protocol seeds it from the Ψ digest): a probe a
    server can predict can be evaded.

    attribute="auto" runs the blocked-Q1 localization only when the
    verdict rejects (and n divides over num_servers); True forces it,
    False skips it. Fields are scalars for a single matrix and per-matrix
    numpy arrays for a stack.
    """
    n = x.shape[-1]
    batched = x.ndim == 3
    widened_eps = None
    if eps is None:
        base_eps = epsilon(num_servers, n, x, dtype=x.dtype)
        growth = growth_estimate(u, x)
        widened_eps = base_eps * growth
        if method in ("q3", "q3_literal"):
            eps = base_eps * np.minimum(growth, q3_growth_cap(n))
        else:
            eps = widened_eps
    if method in ("q1", "q2"):
        rng = rng or np.random.default_rng(0)
        r = _probe(rng, x)
        if method == "q1":
            resid = torch.abs(q1(l, u, x, r)).amax(dim=-1)
        else:
            resid = torch.abs(q2(l, u, x, r))
            # Q2 contracts twice with r: widen by the extra ‖r‖² factor
            eps = eps * n
    elif method == "q3":
        resid = q3(l, u, x)
    elif method == "q3_literal":
        resid = q3_paper_literal(l, u, x)
    else:
        raise ValueError(f"unknown authentication method {method!r}")
    if batched:
        resid = resid.detach().cpu().numpy()
        ok = np.asarray(resid <= eps)
        eps_out = np.asarray(eps) + np.zeros_like(resid)
    else:
        resid = float(resid)
        ok = bool(resid <= eps)
        eps_out = float(np.asarray(eps))
    verdict = Verdict(ok=ok, residual=resid, method=method, eps=eps_out,
                      num_servers=num_servers)
    wanted = attribute is True or (
        attribute == "auto" and not bool(np.all(verdict.ok))
    )
    if wanted and n % num_servers == 0:
        # the blocked check is Q1-shaped: raw growth-widened ε(N)
        if widened_eps is None:
            widened_eps = epsilon(num_servers, n, x, dtype=x.dtype) \
                * growth_estimate(u, x)
        sres, sok, culprit = localize(
            l, u, x, num_servers=num_servers, eps=widened_eps, rng=rng
        )
        verdict.server_residual = sres
        verdict.server_ok = sok
        verdict.culprit = culprit
    return verdict


def verification_flops(n: int, method: str) -> int:
    """Authenticate's cost models (paper Table I's Authenticate column)."""
    if method == "q1":
        return 3 * 2 * n * n  # three mat-vec products
    if method == "q2":
        return 3 * 2 * n * n + 2 * 2 * n  # three mat-vec + two dot products
    if method in ("q3", "q3_literal"):
        return 2 * n * (n + 1) // 2 + n  # Σ_i 2i muls/adds + n subtractions
    raise ValueError(method)
