"""Untrusted-server fault models (port of repro.core.faults).

The paper's threat model (§IV.E) is that the N edge servers are
untrusted: Q2/Q3 exist so the client can reject bad results. These
models make the misbehaviour itself first-class, so verification can be
exercised deterministically:

  * ``tamper``  — the server corrupts the L/U strip it reports:
    ``single`` (one element perturbed), ``sign_flip`` (one element
    negated) or ``block`` (the whole strip scaled).
  * ``dropout`` — the server's strip never arrives; the client sees
    zeros.
  * ``delay``   — a straggler. ``delay_rounds`` counts pipeline rounds of
    the fused sweep and is resolved against a rounds deadline before
    dispatch (``resolve_delays``); ``delay_s`` is wall-clock seconds, a
    real sleep played by a worker on the message transports
    (``sample_delay``).

Faults are per server (a server's contribution is one L strip and one U
strip) and batch-aware (``matrices`` restricts a fault to chosen
matrices of a stack). ``in_band=True`` marks a tamper that enters the
one-way relay: the corrupted U row is what downstream servers consume
(``core.lu.lu_nserver``). Positions and delays are host arithmetic and
equal the reference's; every function here returns new tensors.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

TAMPER_MODES = ("single", "sign_flip", "block")
FAULT_KINDS = ("tamper", "dropout", "delay")
DELAY_DISTS = ("fixed", "exponential", "pareto")


@dataclass(frozen=True)
class ServerFault:
    """One misbehaving server. On message transports a fault binds to the
    physical worker id, which for the N-server dispatch is the block-row
    index."""

    server: int
    kind: str = "tamper"  # "tamper" | "dropout" | "delay"
    mode: str = "single"  # tamper only: "single" | "sign_flip" | "block"
    target: str = "u"  # tamper only: corrupt "l", "u", or "lu"
    magnitude: float = 0.05
    delay_rounds: int = 0  # delay only: pipeline rounds late (fused paths)
    delay_s: float = 0.0  # delay only: wall-clock seconds (message paths)
    delay_dist: str = "fixed"  # "fixed" | "exponential" | "pareto"
    delay_alpha: float = 1.5  # pareto shape (mean-preserving)
    matrices: tuple[int, ...] | None = None  # batch indices hit; None = all
    in_band: bool = False  # corruption enters the relay chain
    seed: int = 0  # position PRNG for single/sign_flip

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}"
            )
        if self.kind == "tamper" and self.mode not in TAMPER_MODES:
            raise ValueError(
                f"unknown tamper mode {self.mode!r}; expected one of {TAMPER_MODES}"
            )
        if self.target not in ("l", "u", "lu"):
            raise ValueError(f"target must be 'l', 'u', or 'lu', got {self.target!r}")
        if self.server < 0:
            raise ValueError("server must be >= 0")
        if self.delay_dist not in DELAY_DISTS:
            raise ValueError(
                f"unknown delay_dist {self.delay_dist!r}; expected one of "
                f"{DELAY_DISTS}"
            )
        if self.delay_s < 0.0:
            raise ValueError("delay_s must be >= 0 seconds")
        if self.delay_dist == "pareto" and self.delay_alpha <= 1.0:
            raise ValueError(
                "pareto delay_alpha must be > 1 (finite mean; delay_s is "
                "the mean of the sampled distribution)"
            )
        if self.in_band and self.kind != "tamper":
            raise ValueError(
                "in_band is only meaningful for tamper faults (a dropped or "
                "late server sends nothing downstream)"
            )


#: A fault plan is a (possibly empty) tuple of ServerFaults.
FaultPlan = tuple[ServerFault, ...]


def normalize_plan(faults) -> FaultPlan:
    """Accept None, a single ServerFault, or an iterable → canonical tuple."""
    if faults is None:
        return ()
    if isinstance(faults, ServerFault):
        return (faults,)
    plan = tuple(faults)
    for f in plan:
        if not isinstance(f, ServerFault):
            raise TypeError(f"fault plan entries must be ServerFault, got {f!r}")
    return plan


def resolve_delays(faults, deadline: int | None) -> FaultPlan:
    """Client-side straggler policy for round-denominated delays: a delay
    later than ``deadline`` rounds becomes a dropout of the same server,
    an on-time one is removed, ``deadline=None`` tolerates any. Wall-clock
    delays (``delay_s > 0``) stay in the plan for the workers to play."""
    out = []
    for f in normalize_plan(faults):
        if f.kind != "delay":
            out.append(f)
        elif deadline is not None and f.delay_rounds > deadline:
            out.append(
                ServerFault(server=f.server, kind="dropout", matrices=f.matrices)
            )
        elif f.delay_s > 0.0:
            out.append(f)
    return tuple(out)


def sample_delay(fault: ServerFault, token: bytes = b"") -> float:
    """One wall-clock delay (seconds) for a delay fault, deterministic
    given (fault, token). ``delay_s`` is the mean of every distribution."""
    if fault.kind != "delay" or fault.delay_s <= 0.0:
        return 0.0
    if fault.delay_dist == "fixed":
        return float(fault.delay_s)
    h = hashlib.sha256(
        token + fault.seed.to_bytes(8, "big", signed=True)
        + fault.server.to_bytes(8, "big", signed=True)
    ).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "big"))
    if fault.delay_dist == "exponential":
        return float(rng.exponential(fault.delay_s))
    # pareto: delay_s * (alpha-1) * Lomax(alpha) has mean delay_s
    a = fault.delay_alpha
    return float(fault.delay_s * (a - 1.0) * rng.pareto(a))


def _tamper_position(
    fault: ServerFault, *, block: int, n: int, factor: str
) -> tuple[int, int]:
    """Deterministic (local_row, global_col) inside the faulty strip, kept
    within the named factor's triangle ("l": strictly lower, "u": upper)."""
    row0 = fault.server * block
    h = (fault.seed * 1315423911 + fault.server * 2654435761) & 0x7FFFFFFF
    if factor == "l" and fault.server > 0:
        r = h % block
        g = row0 + r
        c = (h >> 8) % g  # strictly lower: 0 <= c < g
        return r, c
    if factor == "l":
        # server 0's L strip: strictly-lower entries need r >= 1
        r = 1 + h % max(1, block - 1)
        c = (h >> 8) % (row0 + r)
        return r, c
    r = h % block
    g = row0 + r
    c = g + (h >> 8) % (n - g)  # upper: g <= c < n
    return r, c


def corrupt_strip(
    strip: torch.Tensor,
    fault: ServerFault,
    *,
    n: int,
    factor: str | None = None,
) -> torch.Tensor:
    """Apply one tamper/dropout fault to a server's (..., b, n) strip and
    return the result as a new tensor. ``factor`` names which strip this
    is ("l"/"u") so single-element positions stay in its triangle.
    Batch targeting (``fault.matrices``) is the callers' job; this
    corrupts every leading index it is given."""
    b = strip.shape[-2]
    if fault.kind == "dropout":
        return torch.zeros_like(strip)
    if fault.kind == "delay":
        return strip
    if fault.mode == "block":
        return strip * (1.0 + fault.magnitude)
    if factor is None:
        factor = "u" if fault.target == "lu" else fault.target
    r, c = _tamper_position(fault, block=b, n=n, factor=factor)
    out = strip.clone()
    if fault.mode == "sign_flip":
        out[..., r, c] = -strip[..., r, c]
    else:
        # single: multiplicative + additive so structural zeros move too
        out[..., r, c] = strip[..., r, c] * (1.0 + fault.magnitude) \
            + fault.magnitude
    return out


def _splice(full: torch.Tensor, strip: torch.Tensor, fault: ServerFault,
            b: int) -> torch.Tensor:
    """A copy of the full factor with the corrupted strip written back,
    honouring the fault's batch targeting."""
    sl = slice(fault.server * b, (fault.server + 1) * b)
    out = full.clone()
    if fault.matrices is not None and full.ndim == 3:
        idx = torch.as_tensor(fault.matrices, dtype=torch.long)
        out[idx, sl, :] = strip[idx]
    else:
        out[..., sl, :] = strip
    return out


def apply_faults(
    l: torch.Tensor,
    u: torch.Tensor,
    faults,
    *,
    num_servers: int,
    deadline: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Report-level faults on full (..., n, n) factors: what the client
    receives, each fault corrupting (or zeroing) the responsible server's
    strip of L and/or U. ``deadline`` resolves delay faults first.
    In-band faults are skipped — they belong inside the factorization
    (``lu_nserver(faults=…)``)."""
    n = l.shape[-1]
    b = n // num_servers
    for f in resolve_delays(faults, deadline):
        if f.in_band:
            continue
        if f.server >= num_servers:
            raise ValueError(f"fault targets server {f.server} of {num_servers}")
        targets = ("l", "u") if f.kind == "dropout" else tuple(f.target)
        sl = slice(f.server * b, (f.server + 1) * b)
        if "l" in targets:
            bad = corrupt_strip(l[..., sl, :], f, n=n, factor="l")
            l = _splice(l, bad, f, b)
        if "u" in targets:
            bad = corrupt_strip(u[..., sl, :], f, n=n, factor="u")
            u = _splice(u, bad, f, b)
    return l, u


def split_plan(faults) -> tuple[FaultPlan, FaultPlan]:
    """(in_band, report_level) partition of a plan."""
    plan = normalize_plan(faults)
    in_band = tuple(f for f in plan if f.in_band)
    report = tuple(f for f in plan if not f.in_band)
    return in_band, report
