"""Secure outsourced matrix inversion — a facade over the shared-LU op
plan (port of repro.core.inverse).

The paper's §VII.B enhancement, as `repro_torch.linalg.LinalgSession.inv`
(DESIGN.md §12): one verified outsourced factorization, one wide
public-permutation-RHS triangular-solve round over any transport of the
port, and the client's O(n²) recovery (counter-rotations and the secret
column scaling by v).

Verification runs at two layers. The session verifies the factors
(Q2 + Q3) and every chunk of the round (healed through
`distrib.recovery.recover_solve`); the facade then re-checks the final
recovered inverse with a Freivalds projection against the plaintext M.
The projection vector comes from a secret domain-separated lane of the
session digest, fresh per attempt, so no server can precompute a tamper
orthogonal to it (the adaptive attack on a fixed-seed probe).

`tamper=` is facade-level fault injection: it alters the reported inverse
after recovery, which only the final projection can catch.
Transport-level misbehaviour (per chunk, healed) is the `faults=` path.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from .cipher import CipherMeta, Mode
from .protocol import SPDCReport
from .seed import Seed

__all__ = ["SPDCInverseResult", "outsource_inverse"]


def _deprecated_protocol_field(name: str, hint: str):
    """One-cycle shim: `result.seed` / `result.meta` still answer, loudly."""

    @property
    def shim(self):
        warnings.warn(
            f"SPDCInverseResult.{name} is deprecated; {hint}",
            DeprecationWarning,
            stacklevel=2,
        )
        return getattr(self, f"_{name}")

    return shim


@dataclass
class SPDCInverseResult:
    """Outcome of one secure inversion (or a (B, n, n) stack of them).

    `report.ops` records the factorization and the inverse round(s) with
    per-op verdicts, residuals and heal counts. `verified` folds the
    session's checks and the facade's final Freivalds projection.
    """

    inverse: torch.Tensor
    verified: bool
    residual: float
    padding: int
    #: per-op verdicts, recovery and timings
    report: SPDCReport = field(default_factory=SPDCReport)
    #: one-cycle deprecated protocol internals (the pre-facade fields)
    _seed: Seed | None = field(default=None, repr=False)
    _meta: CipherMeta | None = field(default=None, repr=False)

    seed = _deprecated_protocol_field(
        "seed", "the protocol seed is session-internal now; key "
        "client-side state off the matrix bytes instead")
    meta = _deprecated_protocol_field(
        "meta", "the cipher meta is session-internal now; read "
        "result.report.ops for per-op diagnostics")


def _final_probe_residual(m: torch.Tensor, inverse: torch.Tensor,
                          digest: bytes, attempt: int) -> float:
    """Freivalds residual ‖M·(Y·r) − r‖/‖r‖ of the recovered inverse, r
    from the secret `inverse-probe` lane of the session digest (drawn on
    the host, bit for bit the reference's probe)."""
    from ..api.client import _NUMPY_DTYPES
    from ..linalg.session import _lane_rng

    rng = _lane_rng(digest, b"inverse-probe", attempt)
    r = rng.standard_normal(inverse.shape[-1])
    r = torch.from_numpy(r.astype(_NUMPY_DTYPES[inverse.dtype])).to(
        inverse.device)
    m = m.to(inverse.device, inverse.dtype)
    return float(torch.linalg.vector_norm(m @ (inverse @ r) - r)
                 / torch.linalg.vector_norm(r))


def _invert_one(m, num_servers, *, lambda1, lambda2, mode, dtype, eps,
                tamper, transport, faults, recover, standby, device):
    from ..linalg import LinalgSession

    s = LinalgSession(
        m, num_servers,
        transport=transport, faults=faults, recover=recover,
        standby=standby, mode=mode, lambda1=lambda1, lambda2=lambda2,
        dtype=dtype, device=device,
    )
    inverse = s.inv()
    if tamper is not None:
        inverse = tamper(inverse.clone())
    resid = _final_probe_residual(torch.as_tensor(m), inverse, s.digest, 0)
    rep = s.report
    session_ok = all(o.verified for o in rep.ops)
    return SPDCInverseResult(
        inverse=inverse,
        verified=bool(session_ok and resid < eps),
        residual=resid,
        padding=s.padding,
        report=rep,
        _seed=s._session.seeds[0],
        _meta=s._session.metas[0],
    )


def outsource_inverse(
    m,
    num_servers: int,
    *,
    lambda1: int = 128,
    lambda2: int = 128,
    mode: Mode = "ewd",
    dtype=None,
    eps: float = 1e-6,
    tamper=None,
    transport=None,
    faults=None,
    recover: bool = True,
    standby: int = 0,
    device=None,
) -> SPDCInverseResult:
    """Secure inversion through one verified shared-LU session.

    m: one (n, n) matrix, or a (B, n, n) stack (array or tensor). A stack
        runs one session per matrix and returns one result: a (B, n, n)
        inverse, verified = all, residual = max, and every session's
        per-op records in report.ops.
    transport: any transport of the port (name, config, instance, or
        None for inline).
    faults / recover / standby: the transport-level fault model: a
        tampering server's chunks are localized and healed by the
        session's per-chunk checks (recover=True), unlike `tamper=`, a
        function of the final inverse tensor, which only the facade's
        projection can catch.
    eps: acceptance threshold of that final projection residual.
    device: where the sessions compute (None: the CUDA device,
        RuntimeError without one; "cpu" the plain path).
    """
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m)
    kwargs = dict(lambda1=lambda1, lambda2=lambda2, mode=mode, dtype=dtype,
                  eps=eps, tamper=tamper, transport=transport, faults=faults,
                  recover=recover, standby=standby, device=device)
    if m.ndim == 3:
        parts = [_invert_one(mi, num_servers, **kwargs) for mi in m]
        return SPDCInverseResult(
            inverse=torch.stack([p.inverse for p in parts]),
            verified=all(p.verified for p in parts),
            residual=max(p.residual for p in parts),
            padding=parts[0].padding,
            report=SPDCReport(ops=tuple(
                o for p in parts for o in p.report.ops
            )),
            _seed=parts[0]._seed,
            _meta=parts[0]._meta,
        )
    return _invert_one(m, num_servers, **kwargs)
