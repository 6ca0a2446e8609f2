"""SPDC end-to-end protocol — the paper's six-algorithm tuple (SeedGen,
KeyGen, Cipher, Parallelize, Authenticate, Decipher), §III–§IV. Port of
repro.core.protocol.

`outsource_determinant(m, N)` is the one-call facade over the client
role in `repro_torch.api`:

    outsource_determinant(m, N) == SPDCClient(...).open_session(m, N).run()

It accepts one (n, n) matrix, a (B, n, n) stack, or a list of
mixed-size matrices (`outsource_determinant_mixed`, the gateway's
batching primitive): independent seeds, keys, rotations, probes and
verdicts per matrix, one sweep of the N-server schedule and one
verification over the stack (DESIGN.md §3, §5). It runs on the CUDA
device unless the caller passes device="cpu".
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
    `residual` are (B,) arrays, one accept/reject decision per matrix.

    `padding` is always a border *amount* (rows added); on a stack it is
    the one amount every matrix got, and `paddings`/`pad_to` are None. On
    the mixed-size path the amount differs per matrix: `paddings` lists
    them, `pad_to` is the common padded size n' the stack ran at, and
    `padding` is 0 — there is no single amount, so consumers of
    `n + padding` must use `pad_to`."""

    dets: list[Determinant]
    verified: np.ndarray
    residual: np.ndarray
    seeds: list[Seed]
    metas: list[CipherMeta]
    comm: CommLog | None
    padding: int
    num_servers: int
    report: SPDCReport = field(default_factory=SPDCReport)
    #: mixed-size path only: per-matrix border amounts (pad_to − n_i)
    paddings: list[int] | None = None
    #: mixed-size path only: the common padded size n' of the sweep
    pad_to: int | None = None

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


def common_padded_size(sizes, num_servers: int) -> int:
    """Smallest n' ≥ max(sizes) that the N-server schedule accepts
    (n' % N == 0 and n'/N > 1) — the shared shape a mixed-size stack is
    padded to before one coalesced sweep."""
    from .augment import padding_for_servers

    n = max(int(s) for s in sizes)
    return n + padding_for_servers(n, num_servers)


def outsource_determinant_mixed(
    ms,
    num_servers: int,
    *,
    pad_to: int | None = None,
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
) -> SPDCBatchResult:
    """Run the SPDC protocol for a *mixed-size* list of matrices in ONE
    coalesced N-server sweep — the gateway's batching primitive.

    Each matrix is ciphered at its own size (its own Ψ, blinding vector
    and rotation; one CED launch each on CUDA), then its ciphertext is
    padded post-cipher to the common size `pad_to` with the
    determinant-preserving [[X, 0], [R, I]] border, so the whole stack
    shares one (B, n', n') shape: one sweep of the N-server schedule, one
    batched verification, per-request Decipher.

    Padding MUST happen after Cipher: the PRT stage rotates the matrix by
    a secret quarter-turn count, and a pre-cipher identity/zero border
    lands in a rotated position where the no-pivot LU hits structurally
    singular leading minors (DESIGN.md §5.1). The post-cipher border
    never rotates; its Schur complement is exactly I.

    pad_to: common padded size (default: the smallest valid size for the
    largest matrix, `common_padded_size`); it must satisfy
    pad_to % N == 0 and pad_to / N > 1 (F = overdecompose·N for rateless
    sessions). The other keywords are `outsource_determinant`'s, which
    routes list and tuple inputs here.

    Returns an SPDCBatchResult whose `pad_to` is the common n' and whose
    `paddings` list the per-matrix border amounts.
    """
    return _outsource(
        list(ms), num_servers, pad_to=pad_to, distributed=distributed,
        faults=faults, tamper=tamper, transport=transport,
        lambda1=lambda1, lambda2=lambda2, mode=mode, method=method,
        faithful_sign=faithful_sign, recover=recover, standby=standby,
        straggler_deadline=straggler_deadline, dtype=dtype,
        growth_safe=growth_safe, equilibrate=equilibrate,
        rateless=rateless, device=device,
    )


def _outsource(m, num_servers, *, pad_to, distributed, faults, tamper,
               transport, **client_kwargs):
    """The one-call facade's body: a client, its session, one run."""
    from ..api import SPDCClient, resolve_transport

    client = SPDCClient(**client_kwargs)
    session = client.open_session(
        m, num_servers, faults=faults, tamper=tamper, pad_to=pad_to)
    return session.run(resolve_transport(
        transport, distributed=distributed, device=client.device))


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

    m: one (n, n) matrix or a (B, n, n) stack (numpy array or tensor),
        or a list/tuple of square matrices of mixed sizes, which takes
        the path of `outsource_determinant_mixed` (one coalesced sweep at
        the smallest shared padded size — the gateway path,
        serve.spdc_gateway).
    num_servers: N, the edge-server count; the ciphertext is padded so N
        divides its size (paper §IV.D.1).
    lambda1 / lambda2: security parameters of SeedGen / KeyGen.
    mode: "ewd" (row-divide by v, the paper's default) or "ewm".
    method: Authenticate residual — "q1", "q2", "q3" (default) or
        "q3_literal" (DESIGN.md §1.1.4).
    distributed: route Parallelize through the multi-device pipeline
        (distrib.spdc_pipeline: one mesh slot per server, each with a
        stream of its own on the device); the same as
        transport="shardmap". DESIGN.md §2.
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
        "shardmap" (the multi-device pipeline), "threadpool",
        "multiprocess", "socket" (warm worker daemons;
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

    Returns SPDCResult for one matrix, SPDCBatchResult for a stack or a
    list.
    """
    return _outsource(
        m, num_servers, pad_to=None, distributed=distributed, faults=faults, tamper=tamper,
        transport=transport,
        lambda1=lambda1, lambda2=lambda2, mode=mode, method=method,
        faithful_sign=faithful_sign, recover=recover, standby=standby,
        straggler_deadline=straggler_deadline, dtype=dtype,
        growth_safe=growth_safe, equilibrate=equilibrate,
        rateless=rateless, device=device,
    )
