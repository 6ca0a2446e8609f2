"""SPDC end-to-end protocol — the paper's six-algorithm tuple (SeedGen,
KeyGen, Cipher, Parallelize, Authenticate, Decipher), §III–§IV. Port of
repro.core.protocol.

`outsource_determinant(m, N)` is the one-call facade over the client
role in `repro_torch.api`:

    outsource_determinant(m, N) == SPDCClient(...).open_session(m, N).run()

It accepts one (n, n) matrix or a (B, n, n) stack: independent seeds,
keys, rotations, probes and verdicts per matrix, one cipher pass per
rotation degree, one sweep of the N-server schedule and one verification
over the stack (DESIGN.md §3). It runs on the CUDA device unless the
caller passes device="cpu".
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .cipher import CipherMeta, Mode
from .decipher import Determinant
from .lu import CommLog
from .seed import Seed
from .verify import Verdict

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
}


def resolve_dtype(dtype) -> torch.dtype:
    """Canonical compute dtype: a torch dtype, a numpy dtype or a name
    ("float32", "float64", "torch.float64"). torch has no x64 switch, so
    "float64" is always torch.float64."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype.removeprefix("torch.") if isinstance(dtype, str) \
        else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype!r}")
    return _DTYPES[name]


def _low_precision(dtype: torch.dtype) -> bool:
    """True for compute dtypes that need the growth-control stages."""
    return torch.finfo(dtype).bits < 64


def _resolve_growth_controls(
    dtype, growth_safe, equilibrate, faithful_sign
) -> tuple[bool, bool]:
    """Default growth_safe/equilibrate ON for sub-f64 compute (where the
    no-pivot growth eats the mantissa — DESIGN.md §6), OFF for float64.
    Explicit booleans win."""
    auto = _low_precision(dtype)
    growth_safe = auto if growth_safe is None else bool(growth_safe)
    equilibrate = auto if equilibrate is None else bool(equilibrate)
    if growth_safe and faithful_sign:
        raise ValueError(
            "faithful_sign reproduces the paper's literal (-1)^k Decipher "
            "factor, which has no growth-safe-relayout analog; pass "
            "growth_safe=False (and expect float32 accuracy loss) or drop "
            "faithful_sign"
        )
    return growth_safe, equilibrate


@dataclass
class SessionTimings:
    """Wall-clock phase breakdown of one protocol run (seconds).

    pmop_s is the client-side prepare (seed/key/cipher/equilibrate/
    border); dispatch_s the Parallelize stage; collect_s the tail
    (authenticate → decipher). On CUDA each phase ends with a device
    synchronize, so each covers its device work and not only its enqueue.
    """

    pmop_s: float = 0.0
    dispatch_s: float = 0.0
    collect_s: float = 0.0
    total_s: float = 0.0


@dataclass(frozen=True)
class OpRecord:
    """One operation of a multi-op linalg session (DESIGN.md §12):
    `round_trips` counts triangular-solve rounds through the transport,
    `healed` the chunks recovery re-dispatched."""

    op: str  # "factor" | "slogdet" | "solve" | "solve_t" | "inv"
    verified: bool = True
    residual: float = 0.0
    wall_s: float = 0.0
    round_trips: int = 0
    healed: int = 0


@dataclass
class SPDCReport:
    """The typed diagnostics surface on a protocol result: the
    Authenticate verdict, the recovery report (a
    distrib.recovery.RecoveryReport when recovery ran, else None), the
    rateless fleet report (a distrib.rateless.RatelessReport: strip
    counts and per-worker health; None on classic sessions), the phase
    timings, and per-op records of multi-op sessions."""

    verdict: Verdict | None = None
    recovery: object | None = None
    fleet: object | None = None
    timings: SessionTimings | None = None
    ops: tuple = ()


@dataclass
class SPDCResult:
    det: Determinant
    verified: bool
    residual: float
    seed: Seed
    meta: CipherMeta
    comm: CommLog | None
    padding: int
    num_servers: int
    report: SPDCReport = field(default_factory=SPDCReport)


@dataclass
class SPDCBatchResult:
    """Per-matrix protocol outcomes for a (B, n, n) stack: `verified` and
    `residual` are (B,) arrays, one accept/reject decision per matrix."""

    dets: list[Determinant]
    verified: np.ndarray
    residual: np.ndarray
    seeds: list[Seed]
    metas: list[CipherMeta]
    comm: CommLog | None
    padding: int
    num_servers: int
    report: SPDCReport = field(default_factory=SPDCReport)

    @property
    def batch(self) -> int:
        return len(self.dets)


def _probe_rng(digest: bytes) -> np.random.Generator:
    """Verification-probe generator keyed to client-secret material."""
    return np.random.default_rng(int.from_bytes(digest[:8], "big"))


def _batch_digest(seeds: list[Seed]) -> bytes:
    """One digest for a whole stack: H(Ψ₀-digest ‖ … ‖ Ψ_{B-1}-digest)."""
    h = hashlib.sha256()
    for s in seeds:
        h.update(s.digest)
    return h.digest()


def outsource_determinant(
    m,
    num_servers: int,
    *,
    lambda1: int = 128,
    lambda2: int = 128,
    mode: Mode = "ewd",
    method: str = "q3",
    distributed: bool = False,
    faithful_sign: bool = False,
    tamper=None,
    faults=None,
    recover: bool = False,
    standby: int = 0,
    straggler_deadline: int | None = None,
    dtype="float64",
    growth_safe: bool | None = None,
    equilibrate: bool | None = None,
    transport=None,
    rateless=False,
    device=None,
) -> SPDCResult | SPDCBatchResult:
    """Run the full SPDC protocol — the package's main entry point.

    m: one (n, n) matrix or a (B, n, n) stack (numpy array or tensor).
    num_servers: N, the edge-server count; the ciphertext is padded so N
        divides its size (paper §IV.D.1).
    lambda1 / lambda2: security parameters of SeedGen / KeyGen.
    mode: "ewd" (row-divide by v, the paper's default) or "ewm".
    method: Authenticate residual — "q1", "q2", "q3" (default) or
        "q3_literal" (DESIGN.md §1.1.4).
    faithful_sign: the paper's literal (−1)^k Decipher sign
        (DESIGN.md §1.1.3).
    tamper: optional fn (L, U) -> (L, U) applied to the servers' factors
        before Authenticate — models a malicious edge server.
    faults: a core.faults plan (a ServerFault or an iterable of them)
        played by the servers: in the sweep on the inline transport,
        worker-side on the message transports. The verdict names the
        culprit.
    recover: heal a rejected result by re-dispatching the blamed shards
        (distrib.recovery; DESIGN.md §4), reported on
        `report.recovery`.
    standby: spare servers recovery may re-dispatch to, before it falls
        back to the culprit's healthy neighbour.
    straggler_deadline: rounds a delayed server may lag (round-denominated
        delay faults) before it counts as dropped out; None waits.
    dtype: compute dtype, "float64" (default) or "float32". float16 and
        bfloat16 are not verified protocol dtypes and raise.
    growth_safe / equilibrate: growth controls (DESIGN.md §6); None = on
        below float64, off for float64.
    transport: None or "inline" (the fused in-process sweep),
        "threadpool", "multiprocess", "socket" (warm worker daemons;
        the bare name self-hosts one local daemon per worker), a
        TransportConfig (`TransportConfig("socket", addresses=...)`
        reaches running daemons), or a Transport instance; names and
        configs resolve to shared instances on `device`.
    rateless: straggler-adaptive streaming dispatch (DESIGN.md §8) —
        True or a configs.spdc.RatelessConfig. The session
        over-decomposes into F = overdecompose·N strips streamed to
        whichever workers are free, each verified by a secret probe;
        straggler_deadline is ignored. The scheduler's report rides
        `report.fleet`.
    device: where the protocol computes; None = the CUDA device
        (RuntimeError without one), "cpu" for the plain path.

    Not ported yet, and raising NotImplementedError: mixed-size lists
    (ROADMAP A11), distributed= and the shardmap transport (A12).

    Returns SPDCResult for one matrix, SPDCBatchResult for a stack.
    """
    from ..api import SPDCClient

    if distributed:
        raise NotImplementedError("the shard_map pipeline: ROADMAP A12")
    client = SPDCClient(
        lambda1=lambda1, lambda2=lambda2, mode=mode, method=method,
        faithful_sign=faithful_sign, recover=recover, standby=standby,
        straggler_deadline=straggler_deadline, dtype=dtype,
        growth_safe=growth_safe, equilibrate=equilibrate,
        rateless=rateless, device=device,
    )
    session = client.open_session(m, num_servers, faults=faults,
                                  tamper=tamper)
    return session.run(transport)
