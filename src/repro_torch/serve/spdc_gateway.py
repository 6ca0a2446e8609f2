"""SPDC edge gateway — async micro-batching determinant service (port of
repro.serve.spdc_gateway).

This is the layer that turns the protocol into a *service* (DESIGN.md
§5): many clients each submit one matrix; the gateway coalesces them into
batched, fault-tolerant protocol sweeps.

    client ──submit(M)──▶ gateway ──bucket by (n', security config)──▶
      ┌───────────────┐   flush on max_batch / max_wait_us
      │ bucket n'=64  │──▶ ONE outsource_determinant_mixed sweep
      │ bucket n'=256 │──▶   (one CED launch + border per request, one
      └───────────────┘      N-server LU over the (B, n', n') stack on
                             the panel and TRSM kernels, one batched
                             verify, per-request Decipher)
                             ──▶ per-request GatewayResult

Every gateway computes on one device (`device=`): the CUDA device by
default, raising without one; the CPU (the kernels' plain versions) only
on request. Sweeps may run on worker threads (AsyncSPDCGateway), and
each runs inside that device's scope.

Two surfaces:

  * ``SPDCGateway`` — the synchronous engine. `submit()` enqueues (and by
    default flushes a bucket the instant it fills), `poll(now)` flushes
    buckets whose oldest request exceeded the wait budget, `drain()`
    flushes everything. The clock is injected, so tests drive flush
    policy with virtual time.
  * ``AsyncSPDCGateway`` — the asyncio service: ``await submit(m)``
    resolves to that request's GatewayResult; a background flusher task
    runs the device sweeps off the event loop thread.

Production hardening (DESIGN.md §10) rides the same submit path:

  * per-tenant **admission control** — ``submit(tenant=...)`` charges a
    token bucket and a pending quota; over-budget tenants get a typed
    ``AdmissionRejected`` while the gateway keeps serving everyone else
    (tenancy is accounting-only: all tenants coalesce into shared sweeps);
  * a **circuit breaker per bucket** — consecutive sweep failures or a
    high unverified-rate open the breaker, and new submissions to that
    bucket fast-fail (``BreakerOpen``) or detour to the direct path until
    a half-open probe proves the bucket healthy again;
  * an **idempotency-keyed result cache** — det is deterministic given
    (matrix bytes, security tuple), so repeated matrices answer from a
    bounded LRU in O(hash), and concurrent identical submissions
    single-flight onto one sweep;
  * an **observability surface** — every event lands in a
    ``GatewayMetrics`` registry (``metrics_snapshot()`` /
    ``render_metrics()`` / ``healthz()``) AND fires the structured hook
    points ``on_flush`` / ``on_verdict`` / ``on_reject``, so tests,
    benchmarks, and dashboards read the same numbers.

Faults and recovery are per-bucket: a tampering server poisons only the
sweeps it participates in, and when a bucket's security config says
`recover=True`, the verification-driven re-dispatch (DESIGN.md §4) heals
that bucket's batch alone — co-batched requests in other buckets never
pay for it (test_gateway.py::test_tampered_bucket_isolated).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..api.transport import Transport, TransportConfig
from ..configs.spdc import SPDC_GATEWAY_DEFAULT, SPDCGatewayConfig
from ..core.decipher import dtype_name
from ..core.protocol import outsource_determinant_mixed, resolve_dtype
from ..device import resolve_device

from .locking import assert_owns_lock
from .metrics import (
    FlushEvent,
    GatewayMetrics,
    RejectEvent,
    VerdictEvent,
    render_healthz,
    render_prometheus,
)
from .queue import (
    BucketKey,
    DetRequest,
    GatewayOverloaded,
    GatewayStats,
    MicroBatchQueue,
    NoBucketFits,
    bucket_size_for,
)
from .resilience import (
    AdmissionController,
    AdmissionRejected,
    BreakerOpen,
    CircuitBreaker,
    ResultCache,
)

__all__ = [
    "GatewayResult",
    "SPDCGateway",
    "AsyncSPDCGateway",
    "GatewayOverloaded",
    "AdmissionRejected",
    "BreakerOpen",
]

#: per-request security-config overrides submit() accepts (the BucketKey
#: fields minus pad_to, which bucketing derives, and minus op, which is
#: submit()'s own first-class keyword)
_OVERRIDE_KEYS = frozenset(
    {"num_servers", "mode", "method", "lambda1", "lambda2", "recover",
     "standby", "straggler_deadline", "dtype", "growth_safe",
     "equilibrate", "transport", "rateless"}
)

#: secure-linalg operations the gateway serves (DESIGN.md §12): the
#: determinant family rides the coalesced batched sweep; "solve" runs one
#: LinalgSession per request on the bucket's warm transport.
_OPS = ("det", "slogdet", "solve")

#: warmup-dummy cache bound: entries are (n_bucket, dtype)-keyed full
#: matrices, so a long-lived gateway serving a diverse size/dtype mix must
#: not accumulate one per distinct bucket forever
_DUMMY_CACHE_MAX = 8


def _partition_divisor(num_servers: int, rateless: bool) -> int:
    """The strip count a padded size must divide into: N for deadline-based
    sweeps, F = overdecompose·N for rateless ones (the bucket grid has to
    accommodate the over-decomposed partition, not just the fleet size)."""
    if not rateless:
        return num_servers
    from ..configs.spdc import RATELESS_DEFAULT

    return num_servers * RATELESS_DEFAULT.overdecompose


def allowed_batch_sizes(max_batch: int) -> tuple[int, ...]:
    """The bounded set of sweep batch shapes under pad_batches: powers of
    two up to max_batch, plus max_batch itself."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


@dataclass
class GatewayResult:
    """One client request's outcome, unpacked from its bucket's sweep.

    `error` is set (with det=None, verified=False) when the request's
    sweep raised instead of completing — co-batched requests each get
    their own failed result rather than disappearing.
    """

    rid: int
    det: object  # core.decipher.Determinant (None when error is set)
    verified: bool
    residual: float
    n: int  # client's raw matrix size
    pad_to: int  # bucket size the sweep ran at (== n for direct calls)
    batch: int  # how many requests shared the sweep
    flush_reason: str  # "full"|"timeout"|"drain"|"direct"|"cache"|"coalesced"
    submitted_at: float
    completed_at: float
    recovery: object | None = None  # bucket's RecoveryReport, if it healed
    error: str | None = None  # sweep failure, delivered per-request
    tenant: str = "default"
    cache_hit: bool = False  # answered from the idempotency cache
    op: str = "det"  # which secure-linalg op served this request
    #: op="slogdet": the Determinant unpacked into its overflow-safe pair
    #: (det still carries the full object; these are the client-facing
    #: answer shape, matching torch.linalg.slogdet)
    sign: float | None = None
    logabs: float | None = None
    #: op="solve": the (n,) / (n, c) solution tensor (det is None)
    solution: object = None

    @property
    def latency_s(self) -> float:
        return self.completed_at - self.submitted_at


class _InFlight:
    """Single-flight bookkeeping for one idempotency key: the leader's
    rid plus follower requests registered while the leader is pending."""

    __slots__ = ("leader_rid", "followers")

    def __init__(self, leader_rid: int):
        self.leader_rid = leader_rid
        self.followers: list[DetRequest] = []


class SPDCGateway:
    """Synchronous micro-batching engine (see module docstring).

    config: an SPDCGatewayConfig preset (configs.spdc). Its `spdc` field
        supplies each request's default security config; `submit()`
        keyword overrides open separate buckets. `admission`/`breaker`/
        `cache` configure the resilience layer (DESIGN.md §10).
    clock: monotonic-seconds source; injectable for deterministic tests.
    faults_for: optional hook BucketKey -> FaultPlan | None injecting
        misbehaving servers into chosen buckets' sweeps (benchmarks and
        fault-isolation tests; a real deployment has real faults).
    auto_flush: flush a bucket synchronously inside submit() the moment it
        reaches max_batch. AsyncSPDCGateway disables this so sweeps always
        run on its flusher thread.
    device: where every sweep computes — None = the CUDA device
        (RuntimeError without one), "cpu" for the plain path.
    on_flush / on_verdict / on_reject: structured observer hooks, called
        with metrics.FlushEvent / VerdictEvent / RejectEvent AFTER the
        gateway's own bookkeeping (outside its lock). The internal
        GatewayMetrics registry consumes the identical events, so hook
        consumers and the /metrics surface can never disagree. Hooks must
        not raise.
    """

    def __init__(
        self,
        config: SPDCGatewayConfig = SPDC_GATEWAY_DEFAULT,
        *,
        clock=time.monotonic,
        faults_for=None,
        auto_flush: bool = True,
        on_flush=None,
        on_verdict=None,
        on_reject=None,
        device=None,
    ):
        self.device = resolve_device(device)
        if not config.buckets:
            raise ValueError("gateway config needs at least one bucket size")
        # validate the preset bucket list against the default server count
        # up front, naming the offending bucket: a bucket that fails the
        # schedule's divisibility rule is a config bug, and catching it at
        # construction beats every request of that size silently riding
        # the synthesized-fallback path
        divisor = _partition_divisor(
            config.spdc.num_servers, config.spdc.rateless
        )
        for b in config.buckets:
            if b % divisor != 0 or b // divisor <= 1:
                raise ValueError(
                    f"bucket {b} in {tuple(config.buckets)} is not "
                    f"servable by num_servers={config.spdc.num_servers}"
                    + (" under rateless over-decomposition"
                       if config.spdc.rateless else "")
                    + f" (need n' % {divisor} == 0 and n'/{divisor} > 1); "
                    "fix the preset's buckets or its spdc.num_servers"
                )
        self.config = config
        self._clock = clock
        self._faults_for = faults_for
        self._auto_flush = auto_flush
        self.on_flush = on_flush
        self.on_verdict = on_verdict
        self.on_reject = on_reject
        #: guarded-by: self._lock
        self._queue = MicroBatchQueue(
            max_batch=config.max_batch,
            max_wait_us=config.max_wait_us,
            max_pending=config.max_pending,
        )
        self._results: dict[int, GatewayResult] = {}  #: guarded-by: self._lock
        self._next_rid = 0  #: guarded-by: self._lock
        #: transports this gateway built from TransportConfig specs (its
        #: default spdc.transport or per-request overrides). Owned: the
        #: gateway closes them in close(). Keyed by the frozen config so
        #: equal configs resolve to ONE instance — and therefore one
        #: BucketKey, one bucket, one warm worker pool.
        #: guarded-by: self._lock
        self._owned_transports: dict[TransportConfig, Transport] = {}
        self.stats = GatewayStats()  #: guarded-by: self._lock
        self.metrics = GatewayMetrics()  #: guarded-by: self._lock
        self._admission = AdmissionController(config.admission)  #: guarded-by: self._lock
        self._breakers: dict[BucketKey, CircuitBreaker] = {}  #: guarded-by: self._lock
        #: guarded-by: self._lock
        self._cache = (
            ResultCache(config.cache.max_entries)
            if config.cache.enabled else None
        )
        self._inflight: dict[object, _InFlight] = {}  #: guarded-by: self._lock
        #: (n_bucket, dtype)-keyed warmup/padding dummies, LRU-bounded.
        #: OrderedDict.get + move_to_end MUTATE recency order — every
        #: touch, reads included, must hold the lock.
        #: guarded-by: self._lock
        self._dummies: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        #: guards queue/results/stats so AsyncSPDCGateway may run sweeps on
        #: a worker thread while the event loop keeps submitting. Held for
        #: bookkeeping only — never across a device sweep.
        self._lock = threading.RLock()

    # -- transports ---------------------------------------------------------

    def _resolve_transport(self, spec):
        """Fold a TransportConfig spec into an owned built instance.

        Names and live Transport instances pass through untouched (names
        resolve later through the shared registry; instances belong to the
        caller). A TransportConfig builds ONCE per distinct config and is
        cached — resolution happens BEFORE bucketing, so two requests
        carrying equal configs key the same bucket and share one warm
        pool. A cached instance someone closed is rebuilt.
        """
        if not isinstance(spec, TransportConfig):
            return spec
        with self._lock:
            t = self._owned_transports.get(spec)
            if t is None or t.closed:
                t = self._owned_transports[spec] = spec.build(
                    device=self.device)
            return t

    def close(self):
        """Close every transport this gateway built (idempotent).

        Only owned instances (resolved from TransportConfig specs) are
        closed — transports the caller passed in live or selected by name
        are the caller's/registry's to manage.
        """
        with self._lock:
            owned, self._owned_transports = self._owned_transports, {}
        for t in owned.values():
            t.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _key_for(self, n: int, overrides: dict, op: str = "det") -> BucketKey:
        spdc = self.config.spdc
        num_servers = overrides.get("num_servers", spdc.num_servers)
        rateless = overrides.get("rateless", spdc.rateless)
        # rateless sweeps partition into F = overdecompose·N strips, so the
        # bucket size must land on the F-grid, not merely the N-grid
        pad_to = bucket_size_for(
            n, self.config.buckets, _partition_divisor(num_servers, rateless)
        )
        return BucketKey(
            pad_to=pad_to,
            num_servers=num_servers,
            op=op,
            rateless=rateless,
            mode=overrides.get("mode", spdc.mode),
            method=overrides.get("method", spdc.method),
            lambda1=overrides.get("lambda1", spdc.lambda1),
            lambda2=overrides.get("lambda2", spdc.lambda2),
            recover=overrides.get("recover", spdc.recover),
            standby=overrides.get("standby", spdc.standby),
            straggler_deadline=overrides.get(
                "straggler_deadline", spdc.straggler_deadline
            ),
            # resolve_dtype folds spelling variants (np.float32,
            # "float32", torch dtypes) into one canonical name — equal
            # compute dtypes must share one bucket, one sweep shape, and
            # one warmup dummy
            dtype=dtype_name(resolve_dtype(overrides.get("dtype",
                                                         spdc.dtype))),
            growth_safe=overrides.get("growth_safe", spdc.growth_safe),
            equilibrate=overrides.get("equilibrate", spdc.equilibrate),
            transport=self._resolve_transport(
                overrides.get("transport", spdc.transport)
            ),
        )

    # -- resilience helpers -------------------------------------------------

    #: requires-lock: self._lock
    def _breaker_for(self, key: BucketKey) -> CircuitBreaker:
        br = self._breakers.get(key)
        if br is None:
            # jitter seed from the key's STABLE fields (a transport
            # instance's id would randomize probe times across runs)
            seed = zlib.crc32(
                f"{key.pad_to}:{key.num_servers}:{key.dtype}:"
                f"{key.mode}:{key.method}:{key.rateless}".encode()
            )
            br = self._breakers[key] = CircuitBreaker(
                self.config.breaker, seed=seed
            )
        return br

    def _cache_key(self, key: BucketKey, tenant: str, matrix: np.ndarray,
                   rhs: np.ndarray | None = None):
        """(BucketKey, tenant, content digest): the BucketKey carries the
        complete security tuple (transport identity AND op), so a hit can
        never cross configs or ops; the digest covers bytes + shape +
        dtype of the matrix — and of the RHS for op="solve", since two
        solves of one matrix against different b are different answers."""
        m = np.ascontiguousarray(matrix)
        h = hashlib.sha256()
        h.update(str(m.shape).encode())
        h.update(str(m.dtype).encode())
        h.update(m.tobytes())
        if rhs is not None:
            b = np.ascontiguousarray(rhs)
            h.update(str(b.shape).encode())
            h.update(str(b.dtype).encode())
            h.update(b.tobytes())
        return (key, tenant, h.digest())

    #: requires-lock: self._lock
    def _reject(self, reason: str, tenant: str, key: BucketKey | None):
        """Record + fire one typed rejection (caller raises afterwards)."""
        ev = RejectEvent(
            reason=reason, tenant=tenant,
            bucket=key.label() if key is not None else None,
        )
        self.metrics.record_reject(ev)
        return ev

    # -- submission ---------------------------------------------------------

    def submit(self, matrix, *, now: float | None = None,
               tenant: str = "default", op: str = "det", rhs=None,
               **overrides) -> int:
        """Enqueue one (n, n) matrix; returns its request id.

        `op` selects the secure-linalg operation (DESIGN.md §12):
          * "det" (default) — the classic determinant sweep;
          * "slogdet" — same sweep, result unpacked as the (sign, logabs)
            pair on GatewayResult (its own buckets/metrics series);
          * "solve" — requires `rhs` of shape (n,) or (n, c); served by a
            per-request verified LinalgSession on the bucket's warm
            transport (solve traffic never shares a sweep with
            determinant traffic, but equal transports mean the SAME warm
            worker pool serves both).

        Rejections are typed and nothing is ever half-enqueued:
          * GatewayOverloaded — the gateway-wide pending queue is full
            (capacity backpressure; retry elsewhere);
          * AdmissionRejected — THIS tenant is over its token-bucket rate
            or pending quota (policy; slow down — the gateway is fine);
          * BreakerOpen — the request's bucket is fast-failing after
            repeated sweep failures (carries a retry_after_s hint; only
            when the breaker config says on_open="fastfail" — "direct"
            detours such requests to the un-coalesced path instead).

        A matrix identical (bytes, security config, tenant) to a
        previously verified one answers from the idempotency cache in
        O(hash); identical submissions already in flight coalesce onto the
        leader's sweep (single-flight). A matrix larger than every bucket
        — or whose synthesized fallback size would exceed the largest
        configured bucket — is served immediately as a direct un-coalesced
        protocol call (stats.direct). Keyword overrides (num_servers,
        mode, method, recover, standby, straggler_deadline, dtype,
        transport) place the request in a bucket matching that
        security/precision/execution config — an f32 client never shares
        a sweep with f64 clients, and an inline sweep never coalesces
        with a multiprocess one.
        """
        unknown = set(overrides) - _OVERRIDE_KEYS
        if unknown:
            # a misspelled security override must fail loudly — silently
            # serving under the gateway defaults would hand the client a
            # weaker config than it asked for
            raise TypeError(
                f"unknown submit() overrides {sorted(unknown)}; "
                f"allowed: {sorted(_OVERRIDE_KEYS)}"
            )
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
        if isinstance(matrix, torch.Tensor):
            matrix = matrix.detach().cpu().numpy()
        matrix = np.asarray(matrix)
        if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
            raise ValueError(f"expected one square matrix, got {matrix.shape}")
        n = int(matrix.shape[0])
        if n < 2:
            raise ValueError("matrices must be at least 2x2 (KeyGen needs "
                             "n >= 2 blinding elements)")
        if not np.all(np.isfinite(matrix)):
            raise ValueError("matrix contains non-finite entries")
        if op == "solve":
            if rhs is None:
                raise ValueError('op="solve" needs an rhs')
            if isinstance(rhs, torch.Tensor):
                rhs = rhs.detach().cpu().numpy()
            rhs = np.asarray(rhs)
            if rhs.ndim not in (1, 2) or rhs.shape[0] != n:
                raise ValueError(
                    f"rhs shape {rhs.shape} does not match matrix "
                    f"({n}, {n})"
                )
            if not np.all(np.isfinite(rhs)):
                raise ValueError("rhs contains non-finite entries")
        elif rhs is not None:
            raise ValueError(f'op={op!r} takes no rhs')
        now = self._clock() if now is None else now
        hook_events = []
        try:
            with self._lock:
                try:
                    key = self._key_for(n, overrides, op)
                except NoBucketFits:
                    key = None
                self.metrics.record_submit(tenant)
                # 1. admission: the tenant's token bucket guards the door
                # for EVERY request shape (bucketed, direct, cache hit)
                try:
                    self._admission.charge(tenant, now)
                except AdmissionRejected:
                    self.stats.rejected_admission += 1
                    hook_events.append(
                        ("reject", self._reject("rate", tenant, key)))
                    raise
                rid = self._next_rid
                self._next_rid += 1
                self.stats.submitted += 1
                breaker = None
                probe_granted = False
                req = DetRequest(rid=rid, matrix=matrix, n=n,
                                 enqueued_at=now, tenant=tenant,
                                 op=op, rhs=rhs)
                if key is not None:
                    # 2. idempotency cache / single-flight (cache hits cost
                    # O(hash) — they bypass breaker and quota entirely)
                    if self._cache is not None:
                        req.ckey = self._cache_key(key, tenant, matrix, rhs)
                        hit = self._cache.get(req.ckey)
                        if hit is not None:
                            self.stats.cache_hits += 1
                            self.metrics.counters["cache_hits"] += 1
                            gres = replace(
                                hit, rid=rid, submitted_at=now,
                                completed_at=now, flush_reason="cache",
                                batch=1, recovery=None, cache_hit=True,
                                tenant=tenant,
                            )
                            self.metrics.counters["admitted"] += 1
                            hook_events.append(("verdict", self._deliver(
                                gres, key.label())))
                            return rid
                        self.stats.cache_misses += 1
                        self.metrics.counters["cache_misses"] += 1
                        if self.config.cache.single_flight:
                            entry = self._inflight.get(req.ckey)
                            if entry is not None:
                                # ride the leader's sweep; quota still holds
                                # a slot (the follower occupies memory and a
                                # waiter until delivery)
                                try:
                                    self._admission.acquire_slot(tenant)
                                except AdmissionRejected:
                                    self.stats.submitted -= 1
                                    self.stats.rejected_admission += 1
                                    hook_events.append(
                                        ("reject",
                                         self._reject("quota", tenant, key)))
                                    raise
                                entry.followers.append(req)
                                self.stats.coalesced += 1
                                self.metrics.counters["coalesced"] += 1
                                self.metrics.counters["admitted"] += 1
                                return rid
                    # 3. circuit breaker: a poisoned bucket fast-fails or
                    # detours instead of poisoning a shared sweep
                    breaker = self._breaker_for(key)
                    verdict = breaker.allow(now)
                    if verdict == "open":
                        if self.config.breaker.on_open == "direct":
                            self.stats.degraded_direct += 1
                            key = None  # detour: served, but un-coalesced
                        else:
                            self.stats.submitted -= 1
                            self.stats.rejected_breaker += 1
                            hook_events.append(
                                ("reject",
                                 self._reject("breaker", tenant, key)))
                            raise BreakerOpen(
                                f"bucket {key.label()} is fast-failing "
                                "after repeated sweep failures; retry in "
                                f"{breaker.retry_after(now):.3f}s",
                                bucket=key.label(),
                                retry_after_s=breaker.retry_after(now),
                            )
                    elif verdict == "probe":
                        probe_granted = True
                        self.stats.breaker_probes += 1
                        self.metrics.counters["breaker_probes"] += 1
                if key is not None:
                    # 4. per-tenant pending quota, then the gateway-wide
                    # capacity door; BOTH unwind completely on rejection —
                    # including a just-granted half-open probe, which must
                    # return to "open" (with next_probe_at already in the
                    # past) or no flush would ever record() and the bucket
                    # would fast-fail forever
                    try:
                        self._admission.acquire_slot(tenant)
                    except AdmissionRejected:
                        if probe_granted:
                            breaker.revert_probe()
                        self.stats.submitted -= 1
                        self.stats.rejected_admission += 1
                        hook_events.append(
                            ("reject", self._reject("quota", tenant, key)))
                        raise
                    try:
                        full = self._queue.push(key, req)
                    except GatewayOverloaded:
                        if probe_granted:
                            breaker.revert_probe()
                        self._admission.release_slot(tenant)
                        self.stats.submitted -= 1
                        self.stats.rejected += 1
                        hook_events.append(
                            ("reject", self._reject("overload", tenant, key)))
                        raise
                    if req.ckey is not None and self.config.cache.single_flight:
                        self._inflight[req.ckey] = _InFlight(rid)
                self.metrics.counters["admitted"] += 1
        finally:
            self._fire(hook_events)
        if key is None:
            self._run_direct(req, overrides, now)
        elif full and self._auto_flush:
            self._flush(key, "full", now)
        return rid

    # -- flushing -----------------------------------------------------------

    def poll(self, now: float | None = None) -> list[GatewayResult]:
        """Flush every due bucket (full, or past the wait budget) and
        return the newly completed results."""
        now = self._clock() if now is None else now
        out: list[GatewayResult] = []
        while True:
            with self._lock:
                due = self._queue.due(now)
            if not due:
                return out
            for key, reason in due:
                out.extend(self._flush(key, reason, now))

    def drain(self) -> list[GatewayResult]:
        """Flush every bucket regardless of policy (shutdown / test sync),
        still in max_batch chunks so sweeps keep the bucket's shapes."""
        now = self._clock()
        out: list[GatewayResult] = []
        while True:
            with self._lock:
                keys = self._queue.keys()
            if not keys:
                return out
            for key in keys:
                out.extend(self._flush(key, "drain", now))

    def next_deadline(self, now: float | None = None) -> float | None:
        """Seconds until the earliest pending flush deadline (the async
        flusher's sleep bound); None when no requests are queued."""
        now = self._clock() if now is None else now
        with self._lock:
            return self._queue.next_deadline(now)

    def has_full_bucket(self) -> bool:
        with self._lock:
            return self._queue.has_full()

    @property
    def pending(self) -> int:
        return self._queue.pending

    def take(self, rid: int) -> GatewayResult | None:
        """Claim a completed result (None while its bucket is pending)."""
        with self._lock:
            return self._results.pop(rid, None)

    #: requires-lock: self._lock
    def _deliver(self, gres: GatewayResult, bucket_label: str | None):
        """Store one finished result + its bookkeeping (lock held).

        Returns the VerdictEvent for the caller's hook batch."""
        assert_owns_lock(self._lock, "gateway results/metrics")
        self._results[gres.rid] = gres
        ev = VerdictEvent(
            rid=gres.rid, bucket=bucket_label, tenant=gres.tenant,
            verified=gres.verified, latency_s=gres.latency_s,
            flush_reason=gres.flush_reason, cache_hit=gres.cache_hit,
            error=gres.error,
        )
        self.metrics.record_verdict(ev)
        return ev

    def _fire(self, hook_events) -> None:
        """Invoke observer hooks OUTSIDE the gateway lock."""
        for kind, ev in hook_events:
            hook = {"flush": self.on_flush, "verdict": self.on_verdict,
                    "reject": self.on_reject}[kind]
            if hook is not None:
                hook(ev)

    #: requires-lock: self._lock
    def _followers_of(self, req: DetRequest) -> list[DetRequest]:
        """Pop the single-flight followers riding this leader (lock held)."""
        if req.ckey is None:
            return []
        entry = self._inflight.pop(req.ckey, None)
        if entry is None or entry.leader_rid != req.rid:
            # a follower of an older leader re-registered under a new one;
            # only the true leader's completion pops the entry
            if entry is not None:
                self._inflight[req.ckey] = entry
            return []
        return entry.followers

    def _device_scope(self):
        """The gateway's device as the calling thread's current CUDA
        device (it is per thread; sweeps may run on worker threads);
        nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _flush(self, key: BucketKey, reason: str, now: float):
        with self._lock:
            reqs = self._queue.pop(key, limit=self.config.max_batch)
            if not reqs:
                return []
            self.stats.flushes += 1
            if reason == "full":
                self.stats.flushes_full += 1
            elif reason == "timeout":
                self.stats.flushes_timeout += 1
            else:
                self.stats.flushes_drain += 1
        if key.op == "solve":
            return self._flush_solve(key, reqs, reason, now)
        mats = [r.matrix for r in reqs]
        sweep_t0 = self._clock()
        try:
            # padding runs inside the try: the requests are already popped
            # from the queue, so a padding failure must fail THEM (below),
            # not vanish them and hang their waiters
            if self.config.pad_batches:
                target = next(
                    b for b in allowed_batch_sizes(self.config.max_batch)
                    if b >= len(mats)
                )
                mats = mats + [
                    self._dummy(key.pad_to, key.dtype)
                    for _ in range(target - len(mats))
                ]
            faults = self._faults_for(key) if self._faults_for else None
            with self._device_scope():
                res = outsource_determinant_mixed(
                    mats,
                    key.num_servers,
                    faults=faults,
                    device=self.device,
                    **key.protocol_kwargs(),
                )
        except Exception as e:  # noqa: BLE001 — fail the requests, not the service
            # the bucket is already popped: every co-batched request gets
            # its own failed result instead of vanishing (and the async
            # flusher keeps running)
            return self._fail_requests(
                reqs, key, reason, f"{type(e).__name__}: {e}",
                flush_now=now, sweep_t0=sweep_t0, padded_batch=len(mats),
            )
        done = self._clock()
        label = key.label()
        out = []
        hook_events = []
        # the results carry the recovery report, not the healed factors
        # it holds: the (B, n', n') pair is freed with this flush
        recovery = res.report.recovery
        if recovery is not None:
            recovery = replace(recovery, factors=None)
        with self._lock:
            if recovery is not None:
                self.stats.recovered_flushes += 1
            n_verified = sum(
                1 for i in range(len(reqs)) if bool(res.verified[i])
            )
            unverified_rate = 1.0 - n_verified / len(reqs)
            self._record_breaker(key, now=done, failed=False,
                                 unverified_rate=unverified_rate)
            flush_ev = FlushEvent(
                bucket=label, reason=reason, batch=len(reqs),
                padded_batch=len(mats),
                queue_waits_s=tuple(now - r.enqueued_at for r in reqs),
                sweep_s=done - sweep_t0,
                recovered=recovery is not None,
            )
            self.metrics.record_flush(flush_ev)
            hook_events.append(("flush", flush_ev))
            for i, req in enumerate(reqs):
                det = res.dets[i]
                gres = GatewayResult(
                    rid=req.rid,
                    det=det,
                    verified=bool(res.verified[i]),
                    residual=float(res.residual[i]),
                    n=req.n,
                    pad_to=key.pad_to,
                    batch=len(reqs),
                    flush_reason=reason,
                    submitted_at=req.enqueued_at,
                    completed_at=done,
                    recovery=recovery,
                    tenant=req.tenant,
                    op=key.op,
                    # slogdet answers in the overflow-safe pair the client
                    # asked for; .value would overflow exactly where the
                    # protocol's log-space arithmetic was built to survive
                    sign=float(det.sign) if key.op == "slogdet" else None,
                    logabs=float(det.logabs) if key.op == "slogdet" else None,
                )
                hook_events.append(("verdict", self._deliver(gres, label)))
                out.append(gres)
                self.stats.served += 1
                self._admission.release_slot(req.tenant)
                # cache-aside: ONLY verified results (a rejected verdict
                # must not outlive its sweep), stored before followers so
                # late identical submissions hit instead of re-leading
                if (req.ckey is not None and self._cache is not None
                        and gres.verified and gres.error is None):
                    self._cache.put(req.ckey, gres)
                for f in self._followers_of(req):
                    fres = replace(
                        gres, rid=f.rid, submitted_at=f.enqueued_at,
                        flush_reason="coalesced", tenant=f.tenant,
                    )
                    hook_events.append(("verdict", self._deliver(fres, label)))
                    out.append(fres)
                    self.stats.served += 1
                    self._admission.release_slot(f.tenant)
        self._fire(hook_events)
        return out

    def _flush_solve(self, key: BucketKey, reqs, reason: str, now: float):
        """op="solve" flush engine: one verified LinalgSession per request.

        Solve requests carry private RHS payloads and run blinded
        triangular-solve rounds against a per-matrix verified LU — there
        is no batched sweep to coalesce them into (and pad_batches does
        not apply). They still flow through the same bucket/flush
        machinery so they inherit the breaker, cache, metrics, and the
        bucket's WARM transport: a solve bucket and a det bucket keyed to
        the same transport instance share one worker pool.

        Failures are per-request: one rejected session fails that request
        alone; the breaker sees the flush's unverified rate.
        """
        from ..linalg import outsource_solve

        sweep_t0 = self._clock()
        faults = self._faults_for(key) if self._faults_for else None
        outcomes = []  # (req, solution, residual, recovery, healed, error)
        for req in reqs:
            try:
                with self._device_scope():
                    y, s = outsource_solve(req.matrix, req.rhs,
                                           key.num_servers, faults=faults,
                                           device=self.device,
                                           **key.linalg_kwargs())
                rep = s.report
                residual = max(
                    (float(o.residual) for o in rep.ops), default=0.0
                )
                outcomes.append((req, y, residual, rep.recovery, None))
            except Exception as e:  # noqa: BLE001 — fail the request, not the flush
                outcomes.append(
                    (req, None, float("nan"), None,
                     f"{type(e).__name__}: {e}")
                )
        done = self._clock()
        label = key.label()
        out = []
        hook_events = []
        with self._lock:
            n_failed = sum(1 for o in outcomes if o[4] is not None)
            if any(o[3] is not None for o in outcomes):
                self.stats.recovered_flushes += 1
            self._record_breaker(
                key, now=done, failed=n_failed == len(reqs),
                unverified_rate=n_failed / len(reqs),
            )
            flush_ev = FlushEvent(
                bucket=label, reason=reason, batch=len(reqs),
                padded_batch=len(reqs),
                queue_waits_s=tuple(now - r.enqueued_at for r in reqs),
                sweep_s=done - sweep_t0,
                recovered=any(o[3] is not None for o in outcomes),
            )
            self.metrics.record_flush(flush_ev)
            hook_events.append(("flush", flush_ev))
            for req, y, residual, recovery, error in outcomes:
                ok = error is None
                gres = GatewayResult(
                    rid=req.rid,
                    det=None,
                    verified=ok,
                    residual=residual,
                    n=req.n,
                    pad_to=key.pad_to,
                    batch=len(reqs),
                    flush_reason=reason,
                    submitted_at=req.enqueued_at,
                    completed_at=done,
                    recovery=recovery,
                    error=error,
                    tenant=req.tenant,
                    op="solve",
                    solution=y,
                )
                hook_events.append(("verdict", self._deliver(gres, label)))
                out.append(gres)
                if ok:
                    self.stats.served += 1
                else:
                    self.stats.failed += 1
                self._admission.release_slot(req.tenant)
                if (req.ckey is not None and self._cache is not None
                        and ok):
                    self._cache.put(req.ckey, gres)
                for f in self._followers_of(req):
                    fres = replace(
                        gres, rid=f.rid, submitted_at=f.enqueued_at,
                        flush_reason="coalesced", tenant=f.tenant,
                    )
                    hook_events.append(("verdict", self._deliver(fres, label)))
                    out.append(fres)
                    if ok:
                        self.stats.served += 1
                    else:
                        self.stats.failed += 1
                    self._admission.release_slot(f.tenant)
        self._fire(hook_events)
        return out

    #: requires-lock: self._lock
    def _record_breaker(self, key: BucketKey, *, now: float, failed: bool,
                        unverified_rate: float = 0.0) -> None:
        """Feed a flush outcome to the bucket's breaker (lock held)."""
        breaker = self._breaker_for(key)
        before = breaker.state
        after = breaker.record(now, failed=failed,
                               unverified_rate=unverified_rate)
        if after == "open" and before != "open":
            self.stats.breaker_opens += 1
            self.metrics.counters["breaker_opens"] += 1
        elif before == "half_open" and after == "closed":
            self.stats.breaker_closes += 1
            self.metrics.counters["breaker_closes"] += 1

    def _fail_requests(self, reqs, key: BucketKey, reason: str, error: str,
                       *, flush_now: float | None = None,
                       sweep_t0: float | None = None,
                       padded_batch: int | None = None):
        """Deliver a per-request failure result for a sweep that raised."""
        done = self._clock()
        label = key.label()
        out = []
        hook_events = []
        with self._lock:
            if reason != "direct":
                self._record_breaker(key, now=done, failed=True)
                flush_ev = FlushEvent(
                    bucket=label, reason=reason, batch=len(reqs),
                    padded_batch=padded_batch or len(reqs),
                    queue_waits_s=tuple(
                        (flush_now if flush_now is not None else done)
                        - r.enqueued_at for r in reqs
                    ),
                    sweep_s=done - (sweep_t0 if sweep_t0 is not None else done),
                    error=error,
                )
                self.metrics.record_flush(flush_ev)
                hook_events.append(("flush", flush_ev))
            self.stats.failed += len(reqs)
            for req in reqs:
                gres = GatewayResult(
                    rid=req.rid,
                    det=None,
                    verified=False,
                    residual=float("nan"),
                    n=req.n,
                    pad_to=key.pad_to,
                    batch=len(reqs),
                    flush_reason=reason,
                    submitted_at=req.enqueued_at,
                    completed_at=done,
                    error=error,
                    tenant=req.tenant,
                    op=req.op,
                )
                hook_events.append(("verdict", self._deliver(
                    gres, label if reason != "direct" else None)))
                out.append(gres)
                if reason != "direct":
                    self._admission.release_slot(req.tenant)
                # single-flight followers fail WITH their leader — a
                # stranded follower would hang an async waiter forever
                for f in self._followers_of(req):
                    fres = replace(
                        gres, rid=f.rid, submitted_at=f.enqueued_at,
                        tenant=f.tenant,
                    )
                    hook_events.append(("verdict", self._deliver(
                        fres, label if reason != "direct" else None)))
                    out.append(fres)
                    self.stats.failed += 1
                    self._admission.release_slot(f.tenant)
        self._fire(hook_events)
        return out

    def _run_direct(self, req: DetRequest, overrides: dict, now: float):
        """Oversize / breaker-detour escape hatch: one un-coalesced call.

        Op-aware like the flush path: solve requests run their own
        LinalgSession, slogdet unpacks the Determinant's overflow-safe
        pair, det stays the classic protocol call.
        """
        from ..core.protocol import outsource_determinant
        from ..linalg import outsource_solve

        spdc = self.config.spdc
        transport = self._resolve_transport(
            overrides.get("transport", spdc.transport)
        )
        try:
            if req.op == "solve":
                method = overrides.get("method", spdc.method)
                with self._device_scope():
                    y, s = outsource_solve(
                        req.matrix,
                        req.rhs,
                        overrides.get("num_servers", spdc.num_servers),
                        transport=transport,
                        mode=overrides.get("mode", spdc.mode),
                        # same q3→q2 promotion as BucketKey.linalg_kwargs
                        method="q2" if method == "q3" else method,
                        lambda1=overrides.get("lambda1", spdc.lambda1),
                        lambda2=overrides.get("lambda2", spdc.lambda2),
                        recover=overrides.get("recover", spdc.recover),
                        standby=overrides.get("standby", spdc.standby),
                        dtype=overrides.get("dtype", spdc.dtype),
                        growth_safe=overrides.get(
                            "growth_safe", spdc.growth_safe
                        ),
                        device=self.device,
                    )
                rep = s.report
                det = None
                verified = True
                residual = max(
                    (float(o.residual) for o in rep.ops), default=0.0
                )
                padding = s.padding
                recovery = rep.recovery
            else:
                with self._device_scope():
                    res = outsource_determinant(
                        req.matrix,
                        overrides.get("num_servers", spdc.num_servers),
                        mode=overrides.get("mode", spdc.mode),
                        method=overrides.get("method", spdc.method),
                        lambda1=overrides.get("lambda1", spdc.lambda1),
                        lambda2=overrides.get("lambda2", spdc.lambda2),
                        recover=overrides.get("recover", spdc.recover),
                        standby=overrides.get("standby", spdc.standby),
                        straggler_deadline=overrides.get(
                            "straggler_deadline", spdc.straggler_deadline
                        ),
                        dtype=overrides.get("dtype", spdc.dtype),
                        growth_safe=overrides.get("growth_safe",
                                                  spdc.growth_safe),
                        equilibrate=overrides.get("equilibrate",
                                                  spdc.equilibrate),
                        transport=transport,
                        rateless=overrides.get("rateless", spdc.rateless),
                        device=self.device,
                    )
                y = None
                det = res.det
                verified = res.verified
                residual = res.residual
                padding = res.padding
                recovery = res.report.recovery
                if recovery is not None:
                    recovery = replace(recovery, factors=None)
        except Exception as e:  # noqa: BLE001 — fail the request, not the service
            key = BucketKey(pad_to=req.n, num_servers=spdc.num_servers,
                            op=req.op, rateless=spdc.rateless)
            self._fail_requests([req], key, "direct",
                                f"{type(e).__name__}: {e}")
            return
        hook_events = []
        with self._lock:
            self.stats.direct += 1
            self.metrics.counters["direct"] += 1
            gres = GatewayResult(
                rid=req.rid,
                det=det,
                verified=verified,
                residual=residual,
                n=req.n,
                pad_to=req.n + padding,
                batch=1,
                flush_reason="direct",
                submitted_at=req.enqueued_at,
                completed_at=self._clock(),
                recovery=recovery,
                tenant=req.tenant,
                op=req.op,
                sign=float(det.sign) if req.op == "slogdet" else None,
                logabs=float(det.logabs) if req.op == "slogdet" else None,
                solution=y,
            )
            hook_events.append(("verdict", self._deliver(gres, None)))
        self._fire(hook_events)

    def _dummy(self, n_bucket: int, dtype: str = "float64") -> np.ndarray:
        """Client-profile filler matrix for batch padding: diag-dominant
        noise, cached per (bucket size, dtype) with an LRU bound. (A bare
        scaled identity would rotate to an exactly singular anti-diagonal
        under the cipher's PRT stage — fillers must look like real client
        matrices.) dtype is part of the key so an f32 bucket warms and
        pads with f32 fillers — the exact matrix profile its sweeps see —
        and the bound keeps a long-lived gateway serving a diverse mix
        from accumulating one full matrix per distinct bucket forever.
        The result is discarded; it exists so the sweep runs at a warmed
        batch shape."""
        ckey = (n_bucket, str(dtype))
        with self._lock:  # RLock: safe from flush (unlocked) and warmup
            assert_owns_lock(self._lock, "_dummies LRU")
            cached = self._dummies.get(ckey)
            if cached is None:
                rng = np.random.default_rng(n_bucket)
                cached = (
                    rng.standard_normal((n_bucket, n_bucket))
                    + n_bucket * np.eye(n_bucket)
                ).astype(np.dtype(str(dtype)))
                self._dummies[ckey] = cached
                while len(self._dummies) > _DUMMY_CACHE_MAX:
                    self._dummies.popitem(last=False)
            else:
                self._dummies.move_to_end(ckey)
        return cached

    # -- observability ------------------------------------------------------

    def metrics_snapshot(self):
        """Point-in-time MetricsSnapshot: counters + quantiles from the
        registry, live gauges (queue depth, breaker states, cache size,
        tenant pending) folded in from the serving structures."""
        with self._lock:
            bucket_gauges: dict[str, dict] = {}
            for key, depth in self._queue.depth_by_key().items():
                bucket_gauges.setdefault(key.label(), {})["depth"] = depth
            for key, br in self._breakers.items():
                bucket_gauges.setdefault(key.label(), {})["breaker"] = br.state
            return self.metrics.snapshot(gauges={
                "pending": self._queue.pending,
                "buckets": bucket_gauges,
                "tenant_pending": self._admission.pending_by_tenant(),
                "cache_entries": len(self._cache) if self._cache else 0,
                "cache_evictions": self._cache.evictions if self._cache else 0,
            })

    def healthz(self) -> dict:
        """Health verdict dict (the /healthz body): ok | degraded (open
        breaker) | overloaded (pending at the backpressure bound)."""
        return render_healthz(
            self.metrics_snapshot(), max_pending=self.config.max_pending
        )

    def render_metrics(self) -> str:
        """Prometheus-style text exposition (the /metrics body)."""
        return render_prometheus(self.metrics_snapshot())

    def breaker_state(self, key: BucketKey) -> str:
        """Current breaker state for a bucket ("closed" when never used)."""
        with self._lock:
            br = self._breakers.get(key)
            return br.state if br is not None else "closed"

    # -- warmup -------------------------------------------------------------

    def warmup(self, batch_sizes: tuple[int, ...] | None = None) -> int:
        """Prime each bucket's sweep at the given batch sizes.

        There is nothing to jit: the port's first sweep builds the CUDA
        kernels (kernels/build.py, once per process) and its first sweep
        at a (B, n', n') shape has the caching allocator take the blocks
        that shape needs, so a cold bucket's first flush would pay both
        in a client's latency. The default shape set is exactly what
        pad_batches can produce (allowed_batch_sizes). Returns the number
        of (bucket, batch) shapes primed. Runs the protocol sweep directly
        on well-conditioned dummy matrices — results are discarded and
        the serving queue/stats are never touched.
        """
        sizes = batch_sizes or self.config.warmup_batches
        if not sizes:
            sizes = (
                allowed_batch_sizes(self.config.max_batch)
                if self.config.pad_batches
                else (self.config.max_batch,)
            )
        primed = 0
        # every configured bucket is servable — __init__ validates the
        # preset against spdc.num_servers and raises otherwise
        for n_bucket in self.config.buckets:
            key = self._key_for(n_bucket, {})
            for b in sizes:
                # the same cached filler live batch padding uses, so warmup
                # runs the exact matrix profile flushes see
                dummies = [self._dummy(n_bucket, key.dtype)] * b
                with self._device_scope():
                    res = outsource_determinant_mixed(
                        dummies, key.num_servers, device=self.device,
                        **key.protocol_kwargs()
                    )
                assert bool(np.all(res.verified))
                primed += 1
        return primed


class AsyncSPDCGateway:
    """asyncio front-end: ``await submit(m)`` → GatewayResult.

    A background flusher task wakes on the earliest flush deadline (or
    immediately when a bucket fills) and runs the device sweep in a worker
    thread, so the event loop keeps accepting submissions while the
    servers factor the previous batch. Use as an async context manager:

        async with AsyncSPDCGateway(cfg) as gw:
            results = await asyncio.gather(*(gw.submit(m) for m in ms))

    Typed rejections (GatewayOverloaded / AdmissionRejected / BreakerOpen)
    propagate out of ``submit`` immediately — the future never enters the
    waiter table, so a rejection storm cannot leak futures
    (tests/test_torch_overload.py asserts this). Keyword arguments go to
    SPDCGateway (`device=` among them).
    """

    def __init__(self, config: SPDCGatewayConfig = SPDC_GATEWAY_DEFAULT,
                 **kwargs):
        kwargs.setdefault("auto_flush", False)
        self._gw = SPDCGateway(config, **kwargs)
        self._waiters: dict[int, object] = {}
        self._task = None
        self._kick = None
        self._closed = False

    @property
    def stats(self) -> GatewayStats:
        return self._gw.stats

    @property
    def pending(self) -> int:
        return self._gw.pending

    def metrics_snapshot(self):
        return self._gw.metrics_snapshot()

    def healthz(self) -> dict:
        return self._gw.healthz()

    def render_metrics(self) -> str:
        return self._gw.render_metrics()

    async def __aenter__(self):
        import asyncio

        self._kick = asyncio.Event()
        self._task = asyncio.create_task(self._flusher())
        return self

    async def __aexit__(self, *exc):
        await self.aclose()

    async def aclose(self):
        import asyncio

        self._closed = True
        if self._task is not None:
            self._kick.set()
            await self._task
            self._task = None
        if self._gw.pending:
            await asyncio.to_thread(self._gw.drain)
            self._deliver()
        # release owned transports (worker pools, socket daemons) after
        # the final drain so shutdown is deterministic, not GC-timed
        await asyncio.to_thread(self._gw.close)

    async def warmup(self, batch_sizes: tuple[int, ...] | None = None) -> int:
        """Prime bucket sweeps off the event loop (SPDCGateway.warmup)."""
        import asyncio

        return await asyncio.to_thread(self._gw.warmup, batch_sizes)

    async def submit(self, matrix, *, tenant: str = "default",
                     op: str = "det", rhs=None, **overrides) -> GatewayResult:
        """Enqueue one matrix and wait for its bucket's sweep.

        `op`/`rhs` select the secure-linalg operation exactly as on
        SPDCGateway.submit. Raises GatewayOverloaded / AdmissionRejected /
        BreakerOpen immediately (without queueing) when the gateway sheds
        the request.
        """
        import asyncio

        if self._task is None:
            raise RuntimeError("use `async with AsyncSPDCGateway(...)`")
        # to_thread keeps the event loop free even when submit() itself
        # does device work (the oversize direct-call escape hatch)
        rid = await asyncio.to_thread(
            self._gw.submit, matrix, tenant=tenant, op=op, rhs=rhs,
            **overrides
        )
        ready = self._gw.take(rid)
        if ready is not None:  # direct call or cache hit completed inline
            return ready
        fut = asyncio.get_running_loop().create_future()
        self._waiters[rid] = fut
        self._kick.set()
        if self._closed:
            # aclose() may have drained before our enqueue landed (its
            # pending check raced our to_thread); flush ourselves so this
            # future cannot be stranded
            await asyncio.to_thread(self._gw.drain)
            self._deliver()
        return await fut

    def _deliver(self):
        for rid in list(self._waiters):
            res = self._gw.take(rid)
            if res is None:
                continue
            fut = self._waiters.pop(rid)
            if not fut.done():
                fut.set_result(res)

    async def _flusher(self):
        import asyncio

        while not self._closed:
            deadline = self._gw.next_deadline()
            if not self._gw.has_full_bucket():
                timeout = deadline if deadline is not None else 0.5
                try:
                    await asyncio.wait_for(
                        self._kick.wait(), timeout=max(timeout, 1e-4)
                    )
                except asyncio.TimeoutError:
                    pass
                self._kick.clear()
                if self._closed:
                    break
            if self._gw.pending:
                # _flush already converts sweep failures into per-request
                # error results; anything else must not kill the flusher
                # (every later submission would hang on a dead task)
                try:
                    await asyncio.to_thread(self._gw.poll)
                except Exception:  # noqa: BLE001
                    pass
                self._deliver()
