"""SPDCClient / Session — the trusted-client role of the SPDC protocol
(port of repro.api.client).

SeedGen, KeyGen, Cipher, Authenticate and Decipher run on the client;
only the Parallelize stage (the N-server LU) runs on untrusted edge
hardware:

    client  = SPDCClient(method="q3", dtype="float64")
    session = client.open_session(m, num_servers=4)      # PMOP runs here
    result  = session.run()                              # servers + verify

`open_session` performs the PMOP (seed → key → cipher → equilibrate →
det-preserving border) and keeps every secret on the Session: seeds,
blinding keys, rotation metadata, and the augmented ciphertext the
probes verify against. What leaves the session is only what
`Session.tasks()` emits: per-server ShardTasks holding encrypted block
rows and dispatch sub-seeds, boundary-checked as they are minted.
`Session.collect()` authenticates the factors (a full pair, or the
servers' ShardResults) with a secret-keyed probe, then, when the client
opted into recovery (`recover=True`), runs the verification-driven
re-dispatch loop (distrib.recovery): the session mints new ShardTasks
for the blamed servers (a fresh sub-seed per attempt, the verified
upstream U rows attached) and runs them on replacement workers through
the same transport, then deciphers. Servers still never talk backwards;
the client re-issues work.

Rateless dispatch (`SPDCClient(rateless=True | RatelessConfig(...))`,
distrib.rateless, DESIGN.md §8): the session over-decomposes n' into
F = overdecompose·N strips (`Session.partitions`) and streams them to
whichever of the N workers are free, each strip verified by a secret
probe before the next one consumes its U rows; tasks, Authenticate and
recovery are keyed on the F partitions, and the client's FleetHealth
carries what one session learned about the workers into the next.

Ported here: one matrix, same-size stacks and mixed-size lists (the
gateway's coalesced sweep: each matrix ciphered at its own size, then
bordered to one common n'), on the inline, thread-pool, multiprocess and
socket transports, with simulated fault plans, recovery with N + r
standbys and the straggler deadline, and rateless dispatch;
`Session.start` and `SPDCClient.run_pipelined` overlap one session's
wire time with the next one's PMOP.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.augment import augment, border_rng, padding_for_servers
from ..core.cipher import CipherMeta, cipher, cipher_batch
from ..core.cipher import equilibrate as ced_equilibrate
from ..core.decipher import decipher, decipher_batch
from ..core.faults import normalize_plan, resolve_delays
from ..core.keygen import keygen, keygen_batch
from ..core.lu import nserver_comm_model
from ..core.seed import Seed, seedgen, seedgen_batch
from ..core.verify import authenticate
from ..device import resolve_device, synchronize
from .messages import ShardResult, ShardTask
from .server import EdgeServer
from .transport import TransportConfig, resolve_transport

__all__ = ["SPDCClient", "Session", "PendingResult", "BoundaryViolation"]


class BoundaryViolation(AssertionError):
    """A ShardTask was about to carry plaintext or key material."""


#: everything a ShardTask is allowed to hold — a new field on the message
#: is a deliberate API change, not something a refactor may smuggle in
_TASK_FIELDS = frozenset(
    {"server", "num_servers", "x_row", "subseed", "style", "attempt",
     "u_upstream", "session_id"}
)

#: everything a TriSolveTask (linalg.session's triangular-solve rounds,
#: DESIGN.md §12) is allowed to hold — same contract as _TASK_FIELDS:
#: repro-lint's SPDC105 cross-checks this set against the dataclass
_SOLVE_TASK_FIELDS = frozenset(
    {"server", "num_servers", "l", "u", "rhs", "subseed", "transpose",
     "col0", "attempt", "session_id"}
)

#: auto boundary check: full entry-level plaintext-disjointness screening
#: up to this many payload elements per sweep (beyond it the structural
#: checks still run; tests force the full check at every size)
_FULL_CHECK_ELEMS = 1 << 20

_NUMPY_DTYPES = {torch.float64: np.float64, torch.float32: np.float32,
                 torch.float16: np.float16}
#: the compute dtypes the protocol is verified in; the panel and
#: triangular-solve kernels take no half-precision storage on their own
_PROTOCOL_DTYPES = (torch.float64, torch.float32)


def _equilibrate_augment(x, rng, *, padding, equilibrate):
    """PMOP tail: optional two-sided power-of-two equilibration, then the
    det-preserving [[X,0],[R,I]] border. Both are exact in floating
    point. Returns (x_aug, log2_scale as a host array)."""
    if equilibrate:
        x, log2_scale = ced_equilibrate(x)
        log2_scale = log2_scale.cpu().numpy()
    else:
        log2_scale = np.zeros(x.shape[:-2], dtype=np.int32)
    return augment(x, padding, rng=rng), log2_scale


@dataclass
class SPDCClient:
    """The trusted client role: holds the security configuration and
    mints Sessions; per-matrix secrets live on the Session.

    Parameters mirror `core.protocol.outsource_determinant`. `device` is
    where the client's sessions compute: None means the CUDA device and
    raises RuntimeError without one; "cpu" runs the plain path.
    """

    lambda1: int = 128
    lambda2: int = 128
    mode: str = "ewd"
    method: str = "q3"
    faithful_sign: bool = False
    #: heal a rejected result by re-dispatching the blamed shards
    recover: bool = False
    #: spare servers provisioned for recovery (ServerPool)
    standby: int = 0
    #: rounds a delayed server may lag before it counts as dropped out
    #: (core.faults.resolve_delays); None waits for any delay
    straggler_deadline: int | None = None
    dtype: Any = "float64"
    growth_safe: bool | None = None
    equilibrate: bool | None = None
    #: rateless straggler-adaptive dispatch (DESIGN.md §8): True uses the
    #: default RatelessConfig, or pass one. Sessions over-decompose into
    #: F = overdecompose·N strips streamed to whichever workers are free;
    #: straggler_deadline is ignored (there is no deadline to tune).
    rateless: Any = False
    #: default transport of this client's sessions: a name, a
    #: TransportConfig, or a Transport instance (None = inline). A config
    #: is built here and owned — `close()` tears it down; names resolve
    #: to the process-shared instance on the client's device, and
    #: instances stay caller-owned.
    transport: Any = None
    device: Any = None

    def __post_init__(self):
        from ..configs.spdc import RATELESS_DEFAULT, RatelessConfig
        from ..core.protocol import _resolve_growth_controls, resolve_dtype

        self.device = resolve_device(self.device)
        self._owns_transport = False
        if isinstance(self.transport, TransportConfig):
            self.transport = self.transport.build(device=self.device)
            self._owns_transport = True
        elif self.transport is not None:
            self.transport = resolve_transport(self.transport,
                                               device=self.device)
        self.dtype = resolve_dtype(self.dtype)
        self.growth_safe, self.equilibrate = _resolve_growth_controls(
            self.dtype, self.growth_safe, self.equilibrate,
            self.faithful_sign,
        )
        if self.rateless is True:
            self.rateless = RATELESS_DEFAULT
        elif not self.rateless:
            self.rateless = None
        elif not isinstance(self.rateless, RatelessConfig):
            raise ValueError(
                "rateless must be a bool or a configs.spdc.RatelessConfig, "
                f"got {self.rateless!r}"
            )
        # fleet health outlives sessions: what one session learned about
        # the workers (speed, tamper history) steers the next
        if self.rateless is not None:
            from ..distrib.rateless import FleetHealth

            self.fleet = FleetHealth(self.rateless)
        else:
            self.fleet = None

    def _partitions(self, num_servers: int) -> int:
        """Strips per matrix: F = overdecompose·N rateless, N classic."""
        if self.rateless is None:
            return num_servers
        return num_servers * self.rateless.overdecompose

    def _padding_for(self, n: int, parts: int) -> int:
        """Identity-border padding to the partition grid; the rateless
        grid (F strips) additionally keeps strips ≥ 2 rows — the same
        n'/N > 1 floor the paper puts on the classic schedule."""
        padding = padding_for_servers(n, parts)
        if (n + padding) // parts < 2:
            padding = 2 * parts - n
        return padding

    # -- transport lifecycle -------------------------------------------------

    def close(self) -> None:
        """Close the transport this client owns (built from a
        TransportConfig). Shared and caller-provided instances are left
        to their owners. Idempotent."""
        if self._owns_transport and self.transport is not None:
            self.transport.close()

    def __enter__(self) -> "SPDCClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- async-overlap pipeline (DESIGN.md §9) --------------------------------

    def run_pipelined(self, inputs, num_servers: int, *, depth: int = 2,
                      transport=None, faults=None, tamper=None) -> list:
        """Run many independent protocol inputs with PMOP/wire overlap:
        up to `depth` sessions in flight, session k's tasks riding the
        transport (a `Session.start` Future) while session k+1's PMOP
        runs here. Results come back in input order, each collected on
        this thread. depth=1 is the sequential loop."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        results: list = []
        pending: list[PendingResult] = []
        for m in inputs:
            if len(pending) >= depth:
                results.append(pending.pop(0).result())
            session = self.open_session(m, num_servers, faults=faults,
                                        tamper=tamper)
            pending.append(session.start(transport))
        while pending:
            results.append(pending.pop(0).result())
        return results

    def _host_copy(self, m) -> np.ndarray:
        """The plaintext as a host array in the compute dtype — what
        SeedGen hashes, bit for bit the reference's `np.asarray(m)`."""
        if self.dtype not in _NUMPY_DTYPES:
            raise ValueError(f"no host dtype for {self.dtype}")
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        # copies only when the dtype or layout differs (nothing downstream
        # writes to the plaintext), or when the buffer is read-only, which
        # torch.from_numpy does not take
        host = np.ascontiguousarray(m, dtype=_NUMPY_DTYPES[self.dtype])
        return host if host.flags.writeable else host.copy()

    # -- PMOP: everything before any server is involved ---------------------

    def open_session(self, m, num_servers: int, *, faults=None,
                     tamper=None, pad_to: int | None = None) -> "Session":
        """Run the client-side PMOP and return the dispatchable Session.

        m: one (n, n) matrix, a (B, n, n) stack, or a list of mixed-size
        square matrices (coalesced at a shared padded size — `pad_to`
        applies only there). faults / tamper configure simulated
        misbehaviour: faults (a core.faults plan) ride to the Parallelize
        stage (in the sweep on the inline transport, worker-side on the
        message transports); tamper is a client-side hook on the
        assembled factors.
        """
        if self.dtype not in _PROTOCOL_DTYPES:
            raise ValueError(
                f"dtype {self.dtype} is not a verified protocol dtype "
                "(float64 or float32): the servers' panel and triangular-"
                "solve kernels compute half precision only as mixed "
                "routes (ROADMAP B7)")
        t0 = time.perf_counter()
        plan = resolve_delays(
            normalize_plan(faults),
            # rateless has no rounds deadline — slow servers just do less
            None if self.rateless is not None else self.straggler_deadline,
        )
        if isinstance(m, (list, tuple)):
            sess = self._open_mixed(m, num_servers, tamper, pad_to)
        elif pad_to is not None:
            raise ValueError("pad_to applies to mixed-size lists only")
        else:
            m_host = self._host_copy(m)
            m_dev = torch.from_numpy(m_host).to(self.device)
            if m_host.ndim == 3 and m_host.shape[-1] == m_host.shape[-2]:
                sess = self._open_batch(m_dev, m_host, num_servers, tamper)
            elif m_host.ndim == 2 and m_host.shape[0] == m_host.shape[1]:
                sess = self._open_single(m_dev, m_host, num_servers, tamper)
            else:
                raise ValueError(
                    "expected a square matrix or a (B, n, n) stack, got "
                    f"{m_host.shape}"
                )
        sess.plan = plan
        synchronize(self.device)
        sess._pmop_s = time.perf_counter() - t0
        return sess

    def _open_single(self, m, m_host, num_servers, tamper) -> "Session":
        n = int(m.shape[0])
        seed = seedgen(self.lambda1, m_host)
        key = keygen(self.lambda2, seed, n)
        x, meta = cipher(m, key, seed, mode=self.mode,
                         growth_safe=self.growth_safe)
        parts = self._partitions(num_servers)
        padding = self._padding_for(n, parts)
        x_aug, log2_scale = _equilibrate_augment(
            x, border_rng(seed.digest), padding=padding,
            equilibrate=self.equilibrate,
        )
        return Session(
            client=self, kind="single", num_servers=num_servers,
            x_aug=x_aug, seeds=[seed], metas=[meta],
            log2_scale=float(log2_scale), n=n, padding=padding,
            digest=seed.digest, tamper=tamper,
            num_strips=parts if parts != num_servers else None,
            _m_host=m_host,
        )

    def _open_batch(self, m, m_host, num_servers, tamper) -> "Session":
        from ..core.protocol import _batch_digest

        n = int(m.shape[-1])
        seeds = seedgen_batch(self.lambda1, m_host)
        v = keygen_batch(self.lambda2, seeds, n)
        x, metas = cipher_batch(m, v, seeds, mode=self.mode,
                                growth_safe=self.growth_safe)
        parts = self._partitions(num_servers)
        padding = self._padding_for(n, parts)
        x_aug, log2_scale = _equilibrate_augment(
            x, border_rng(seeds[0].digest), padding=padding,
            equilibrate=self.equilibrate,
        )
        return Session(
            client=self, kind="batch", num_servers=num_servers,
            x_aug=x_aug, seeds=seeds, metas=metas,
            log2_scale=log2_scale, n=n, padding=padding,
            digest=_batch_digest(seeds), tamper=tamper,
            num_strips=parts if parts != num_servers else None,
            _m_host=m_host,
        )

    def _open_mixed(self, ms, num_servers, tamper, pad_to) -> "Session":
        """The mixed-size PMOP: SeedGen and KeyGen on the host per matrix,
        its Cipher on the session's device at its own size (one CED
        launch on CUDA), then equilibration and the post-cipher
        [[X, 0], [R, I]] border written into one preallocated
        (B, n', n') stack — the reference's host functions
        (`_cipher_host`, `_equilibrate_host`, `_augment_host`) step for
        step, with R drawn from the same per-matrix generator, so the
        stack is bit-equal to the reference's."""
        from ..core.protocol import _batch_digest, common_padded_size

        ms = [self._host_copy(mi) for mi in ms]
        if not ms:
            raise ValueError("outsource_determinant_mixed needs >= 1 matrix")
        for mi in ms:
            if mi.ndim != 2 or mi.shape[0] != mi.shape[1]:
                raise ValueError(
                    f"expected square matrices, got shape {mi.shape}"
                )
        sizes = [int(mi.shape[0]) for mi in ms]
        parts = self._partitions(num_servers)
        if pad_to is None:
            pad_to = common_padded_size(sizes, parts)
        if pad_to % parts != 0 or pad_to // parts <= 1:
            raise ValueError(
                f"pad_to={pad_to} not servable by {parts} partitions "
                f"(N={num_servers}"
                + (f" × overdecompose={parts // num_servers}"
                   if parts != num_servers else "")
                + "; need pad_to % parts == 0 and pad_to / parts > 1)"
            )
        if max(sizes) > pad_to:
            raise ValueError(
                f"matrix of size {max(sizes)} exceeds pad_to={pad_to}"
            )
        x_aug = torch.zeros((len(ms), pad_to, pad_to), dtype=self.dtype,
                            device=self.device)
        seeds, metas, paddings, log2_scales = [], [], [], []
        for i, mi in enumerate(ms):
            n = int(mi.shape[0])
            seed = seedgen(self.lambda1, mi)
            key = keygen(self.lambda2, seed, n)
            x, meta = cipher(torch.from_numpy(mi).to(self.device), key, seed,
                             mode=self.mode, growth_safe=self.growth_safe)
            if self.equilibrate:
                x, ls = ced_equilibrate(x)
                log2_scales.append(ls)
            x_aug[i, :n, :n] = x
            p = pad_to - n
            if p:
                r = border_rng(seed.digest).uniform(-1.0, 1.0, (p, n))
                x_aug[i, n:, :n] = torch.as_tensor(r, dtype=self.dtype,
                                                   device=self.device)
                x_aug[i, n:, n:].diagonal().fill_(1.0)
            seeds.append(seed)
            metas.append(meta)
            paddings.append(p)
        # one device-to-host read for the whole stack's exponents
        log2_scale = (torch.stack(log2_scales).cpu().numpy().astype(np.int64)
                      if log2_scales else np.zeros(len(ms), dtype=np.int64))
        return Session(
            client=self, kind="mixed", num_servers=num_servers,
            x_aug=x_aug, seeds=seeds, metas=metas,
            log2_scale=log2_scale, n=pad_to, padding=0,
            digest=_batch_digest(seeds), tamper=tamper,
            paddings=paddings, pad_to=pad_to,
            num_strips=parts if parts != num_servers else None,
            _m_host=None, _m_hosts=ms,
        )


@dataclass
class Session:
    """One protocol run: the client's secrets and the dispatchable
    ciphertext. Everything here except `tasks()`'s output is
    client-private. The life cycle is tasks → (transport) → collect, or
    just `run(transport)`, which prefers the fused sweep on fused
    transports."""

    client: SPDCClient
    kind: str  # "single" | "batch" | "mixed"
    num_servers: int
    x_aug: torch.Tensor  # (…, n', n') augmented CIPHERTEXT (client-held)
    seeds: list[Seed]
    metas: list[CipherMeta]
    log2_scale: Any
    n: int  # raw size (single/batch) or the common n' (mixed)
    padding: int
    digest: bytes
    plan: tuple = ()
    tamper: Any = None
    #: mixed-size sessions: per-matrix border amounts and the common n'
    paddings: list[int] | None = None
    pad_to: int | None = None
    #: rateless over-decomposition: F > N strips (None = classic, one
    #: strip per server). The partition geometry (authenticate blocks,
    #: strip minting, recovery) keys off `partitions`; `num_servers`
    #: stays the physical fleet size.
    num_strips: int | None = None
    #: the rateless scheduler's distrib.rateless.RatelessReport
    fleet_report: Any = None
    #: keep the factors Authenticate accepted (after any recovery) on
    #: `_factors`, as tensors on the session's device, so a
    #: linalg.LinalgSession builds its solve and inverse rounds on them
    #: instead of outsourcing a second factorization
    keep_factors: bool = False
    _factors: tuple | None = None
    _m_host: np.ndarray | None = None
    #: mixed-size sessions: every request's plaintext, for the boundary
    #: screen (each ciphertext must be checked against all of them)
    _m_hosts: list[np.ndarray] = field(default_factory=list)
    # phase timings feeding SPDCReport.timings
    _pmop_s: float = 0.0
    _dispatch_s: float = 0.0

    def __post_init__(self):
        from ..distrib.recovery import dispatch_subseed

        # opaque routing tag: one-way derived from the secret digest so it
        # can be logged/echoed without leaking probe or channel material
        self.session_id = dispatch_subseed(self.digest, -1, -1)[:8].hex()

    # -- geometry ------------------------------------------------------------

    @property
    def n_aug(self) -> int:
        return int(self.x_aug.shape[-1])

    @property
    def block(self) -> int:
        return self.n_aug // self.num_servers

    @property
    def partitions(self) -> int:
        """Block rows the protocol partitions n' into: F when rateless,
        N classically. Verification, recovery and task minting all key
        off this count — authenticate works for any divisor of n'."""
        return self.num_strips or self.num_servers

    @property
    def strip_block(self) -> int:
        return self.n_aug // self.partitions

    # -- dispatch ------------------------------------------------------------

    def tasks(self, *, check_boundary: bool | None = None) -> list[ShardTask]:
        """The initial ShardTasks — one encrypted block row (a host copy)
        and dispatch sub-seed per partition (N classically, F when
        rateless); u_upstream is left to the transport's relay.

        check_boundary: None (default) runs the structural boundary checks
        always and the full entry-level plaintext screening up to ~1M
        payload elements; True forces the full screening at any size;
        False runs structural checks only.
        """
        from ..distrib.recovery import dispatch_subseed

        b = self.strip_block
        out = []
        for i in range(self.partitions):
            out.append(
                ShardTask(
                    server=i,
                    num_servers=self.partitions,
                    x_row=self.x_aug[..., i * b : (i + 1) * b, :]
                    .detach().to("cpu", copy=True).numpy(),
                    subseed=dispatch_subseed(self.digest, i, 0),
                    style="nserver",
                    session_id=self.session_id,
                )
            )
        self._assert_boundary(out, check_boundary)
        return out

    def _repair_task(self, server: int, attempt: int, u) -> ShardTask:
        """A verification-driven re-issue of one blamed block row: a
        fresh dispatch sub-seed and the verified upstream U rows attached
        (the replacement is stateless and the culprit's relay is not
        trusted)."""
        from ..distrib.recovery import dispatch_subseed

        b, s0 = self.strip_block, server * self.strip_block
        return ShardTask(
            server=server,
            num_servers=self.partitions,
            x_row=self.x_aug[..., s0 : s0 + b, :]
            .detach().to("cpu", copy=True).numpy(),
            subseed=dispatch_subseed(self.digest, server, attempt),
            style=self._style,
            attempt=attempt,
            u_upstream=u[..., :s0, :].detach().to("cpu", copy=True).numpy(),
            session_id=self.session_id,
        )

    def _repair_dispatch(self, transport):
        """recover_lu's dispatch hook: each re-dispatch minted by
        `_repair_task` and run on its replacement through `transport`;
        the strips come back as tensors on the session's device.

        Recovery is re-streaming one strip: a rateless session routes the
        re-issue to the healthiest live worker by its fleet health, or,
        with the fleet gone, computes it here on the session's device,
        instead of the pool's positional replacement."""
        dev, dt = self.x_aug.device, self.x_aug.dtype
        fleet = self.client.fleet

        def dispatch(x, u_now, server, attempt, replacement):
            task = self._repair_task(server, attempt, u_now)
            if fleet is None:
                res = transport.repair(task, replacement=replacement)
            else:
                ids = tuple(range(self.num_servers))
                live = (fleet.assignable(ids, set(), time.monotonic())
                        or fleet.live(ids))
                if live:
                    res = transport.repair(task, replacement=live[0])
                else:
                    res = EdgeServer(None, device=dev).run(task)
            return (torch.tensor(np.asarray(res.l_row), dtype=dt, device=dev),
                    torch.tensor(np.asarray(res.u_row), dtype=dt, device=dev))

        return dispatch

    def _assert_boundary(self, tasks, check_boundary) -> None:
        """No plaintext, no key material, no unexpected fields — checked
        at the moment messages are minted, not left to code review."""
        plaintexts = (
            self._m_hosts if self._m_hosts
            else ([self._m_host] if self._m_host is not None else [])
        )
        total = sum(t.x_row.size for t in tasks)
        full = check_boundary or (
            check_boundary is None and total <= _FULL_CHECK_ELEMS
        )
        secrets = np.asarray([s.psi for s in self.seeds])

        def informative(a):
            # exact 0/±1 entries are structural constants (zero border,
            # identity block) that carry no client information
            a = np.asarray(a).ravel()
            return a[(a != 0.0) & (np.abs(a) != 1.0)]

        # the plaintext side of the screen is loop-invariant: filter and
        # sort it once, not once per task
        plain_sorted = [np.sort(informative(m)) for m in plaintexts] \
            if full else []

        def leaks(payload, reference_sorted):
            if not reference_sorted.size or not payload.size:
                return False
            idx = np.clip(np.searchsorted(reference_sorted, payload),
                          0, reference_sorted.size - 1)
            return bool(np.any(reference_sorted[idx] == payload))

        for t in tasks:
            extra = set(vars(t)) - _TASK_FIELDS
            if extra:
                raise BoundaryViolation(
                    f"ShardTask grew unreviewed fields {sorted(extra)}"
                )
            if not (isinstance(t.subseed, bytes) and len(t.subseed) == 32):
                raise BoundaryViolation("subseed must be a 32-byte digest")
            for m in plaintexts:
                if np.shares_memory(t.x_row, m):
                    raise BoundaryViolation(
                        "ShardTask payload aliases the plaintext buffer"
                    )
            if full:
                payload = informative(t.x_row)
                for ref in plain_sorted:
                    if leaks(payload, ref):
                        raise BoundaryViolation(
                            "ShardTask payload contains verbatim plaintext "
                            "entries — cipher did not run?"
                        )
                if leaks(payload, np.sort(secrets)):
                    raise BoundaryViolation(
                        "ShardTask payload contains client key material"
                    )

    # -- execution -----------------------------------------------------------

    #: the core.lu.lu_block_row operation order of the factors being
    #: verified: the transport's, "nserver" for the rateless scheduler's
    #: strips; repairs replay it
    _style: str = "nserver"

    def _resolve_transport(self, transport):
        """None falls back to the client's configured transport (itself
        defaulting to inline); names resolve on the client's device."""
        if transport is None:
            transport = self.client.transport
        return resolve_transport(transport, device=self.client.device)

    def _rateless(self, transport) -> tuple[torch.Tensor, torch.Tensor]:
        """The rateless scheduler's factors, on the session's device."""
        from ..distrib.rateless import run_rateless

        self._style = "nserver"  # the scheduler's strip primitive
        l_host, u_host, self.fleet_report = run_rateless(
            self, transport, self.client.rateless, self.client.fleet,
            faults=self.plan,
        )
        return self._on_device(l_host, u_host)

    def run(self, transport=None):
        """Dispatch + collect through a transport (default: the client's
        configured one, else inline).

        Rateless sessions always take the streaming scheduler — the
        fused sweep has no per-strip dispatch for health tracking to
        steer (distrib.rateless; DESIGN.md §8)."""
        transport = self._resolve_transport(transport)
        self._style = transport.style
        t0 = time.perf_counter()
        if self.num_strips is not None:
            l, u = self._rateless(transport)
        elif transport.fused:
            l, u = transport.sweep(self.x_aug, self.num_servers,
                                   faults=self.plan)
        else:
            results = transport.factor(self.tasks(), faults=self.plan)
            l, u = self._assemble(results)
        synchronize(self.x_aug.device)
        self._dispatch_s = time.perf_counter() - t0
        return self.collect((l, u), transport=transport)

    def start(self, transport=None) -> "PendingResult":
        """Nonblocking dispatch: ship this session's Parallelize stage and
        return a PendingResult whose `.result()` runs the verify/decipher
        tail. On message transports the sweep rides the transport's
        driver threads, so the caller's next `open_session` overlaps this
        session's wire time; fused transports complete the future here.
        A rateless session's scheduler runs on the driver threads."""
        transport = self._resolve_transport(transport)
        self._style = transport.style
        t0 = time.perf_counter()
        if self.num_strips is not None:
            self._style = "nserver"

            def drive_rateless():
                out = self._rateless(transport)
                synchronize(self.x_aug.device)
                self._dispatch_s = time.perf_counter() - t0
                return out

            future = transport.driver_submit(drive_rateless)
        elif transport.fused:
            from concurrent.futures import Future

            future = Future()
            try:
                future.set_result(
                    transport.sweep(self.x_aug, self.num_servers,
                                    faults=self.plan)
                )
                synchronize(self.x_aug.device)
                self._dispatch_s = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — future carries it
                future.set_exception(e)
        else:
            tasks = self.tasks()  # boundary-checked on this thread

            def drive_factor():
                out = transport.factor(tasks, self.plan)
                self._dispatch_s = time.perf_counter() - t0
                return out

            future = transport.driver_submit(drive_factor)
        return PendingResult(session=self, transport=transport,
                             future=future)

    def _on_device(self, l, u) -> tuple[torch.Tensor, torch.Tensor]:
        """Host factors as tensors on the session's device and dtype."""
        dev, dt = self.x_aug.device, self.x_aug.dtype
        return (torch.from_numpy(l).to(dev, dt),
                torch.from_numpy(u).to(dev, dt))

    def _assemble(self, results) -> tuple[torch.Tensor, torch.Tensor]:
        """Stack per-partition strips into full (…, n', n') factors on
        the session's device."""
        byid = {r.server: r for r in results}
        if sorted(byid) != list(range(self.partitions)):
            raise ValueError(
                "need one ShardResult per server (per partition: "
                f"{self.partitions}), got {sorted(byid)}"
            )
        order = range(self.partitions)
        l = np.concatenate([np.asarray(byid[i].l_row) for i in order], axis=-2)
        u = np.concatenate([np.asarray(byid[i].u_row) for i in order], axis=-2)
        return self._on_device(l, u)

    # -- verify and decipher -------------------------------------------------

    def collect(self, results, *, transport=None):
        """Authenticate → (recovery) → Decipher. results: an (L, U) pair
        of full factors, or a list of ShardResults to assemble; transport:
        where recovery re-dispatches (default: the client's, else
        inline). Returns core.protocol.SPDCResult / SPDCBatchResult."""
        from ..core.protocol import (
            SessionTimings, SPDCBatchResult, SPDCReport, SPDCResult,
            _probe_rng,
        )
        from ..distrib.recovery import recover_lu

        t_collect = time.perf_counter()
        transport = self._resolve_transport(transport)
        self._style = transport.style
        if (isinstance(results, tuple) and len(results) == 2
                and not isinstance(results[0], ShardResult)):
            l, u = results
        else:
            l, u = self._assemble(results)
        if self.tamper is not None:
            l, u = self.tamper(l, u)
        verdict = authenticate(
            l, u, self.x_aug, num_servers=self.partitions,
            method=self.client.method, rng=_probe_rng(self.digest),
        )
        report = None
        if self.client.recover and not bool(np.all(verdict.ok)):
            l, u, verdict, report = recover_lu(
                l, u, self.x_aug, num_servers=self.partitions,
                method=self.client.method, standby=self.client.standby,
                digest=self.digest, style=self._style, verdict=verdict,
                dispatch=self._repair_dispatch(transport),
            )
        if self.keep_factors:
            # after recovery: every later trisolve round goes through the
            # healed factors Authenticate accepted
            self._factors = (l, u)
        comm = (None if transport.style == "pipeline"
                else nserver_comm_model(self.n_aug, self.partitions))

        def build_report() -> SPDCReport:
            collect_s = time.perf_counter() - t_collect
            return SPDCReport(
                verdict=verdict,
                recovery=report,
                fleet=self.fleet_report,
                timings=SessionTimings(
                    pmop_s=self._pmop_s,
                    dispatch_s=self._dispatch_s,
                    collect_s=collect_s,
                    total_s=self._pmop_s + self._dispatch_s + collect_s,
                ),
            )

        if self.kind == "single":
            det = decipher(self.seeds[0], self.metas[0], l, u,
                           faithful=self.client.faithful_sign,
                           log2_scale=self.log2_scale)
            return SPDCResult(
                det=det,
                verified=bool(np.all(verdict.ok)),
                residual=verdict.residual,
                seed=self.seeds[0],
                meta=self.metas[0],
                comm=comm,
                padding=self.padding,
                num_servers=self.num_servers,
                report=build_report(),
            )
        dets = decipher_batch(self.seeds, self.metas, l, u,
                              faithful=self.client.faithful_sign,
                              log2_scale=np.asarray(self.log2_scale))
        return SPDCBatchResult(
            dets=dets,
            verified=np.atleast_1d(np.asarray(verdict.ok)),
            residual=np.atleast_1d(np.asarray(verdict.residual)),
            seeds=self.seeds,
            metas=self.metas,
            comm=comm,
            padding=self.padding,
            num_servers=self.num_servers,
            report=build_report(),
            paddings=self.paddings,
            pad_to=self.pad_to,
        )


@dataclass
class PendingResult:
    """A `Session.start`ed protocol run awaiting its verify/decipher tail.

    `result(timeout=)` blocks on the in-flight Parallelize stage (expiry
    raises TransportTimeout and the dispatch keeps running), then runs
    `Session.collect` on the calling thread: authenticate, recovery and
    decipher touch session secrets and stay on the client thread.
    """

    session: Session
    transport: Any
    future: Any

    def done(self) -> bool:
        """True once the dispatch resolved (collect still pending)."""
        return self.future.done()

    def result(self, timeout: float | None = None):
        out = self.transport.result(self.future, timeout)
        return self.session.collect(out, transport=self.transport)
