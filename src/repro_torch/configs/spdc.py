"""The paper's own workload config: SPDC secure determinant outsourcing
(port of repro.configs.spdc).

`RatelessConfig` (the rateless dispatch layer's knobs, distrib.rateless),
`SPDCConfig` and its presets (the protocol parameters of a deployment),
and the gateway's configs: `AdmissionConfig`, `BreakerConfig`,
`CacheConfig` and `SPDCGatewayConfig` with their presets, consumed by
serve.spdc_gateway.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RatelessConfig:
    """Knobs of the rateless dispatch layer (distrib.rateless).

    The scheduler streams strip tasks to whichever workers are free and
    completes when enough VERIFIED strips arrived — so there is no
    deadline to tune; these knobs shape how hard it leans on a degraded
    fleet, not whether it finishes.

    overdecompose: strips per matrix = overdecompose × num_servers (the
        paper's F > N rateless factor; 2 doubles the strips so a fast
        worker can absorb a slow one's share strip-by-strip).
    request_timeout_s: per-request wall-clock deadline handed to the
        transport (None = the transport's own default). A miss counts as
        a failure against the worker and the strip is re-streamed.
    max_attempts: dispatch attempts per strip before the client computes
        it inline (the degradation ladder's last rung — the session
        answers even with the whole fleet dark).
    backoff_base_s / backoff_max_s / backoff_jitter: exponential backoff
        between a worker's consecutive failures — base·2^(k−1) capped at
        max, ±jitter fraction drawn deterministically from the dispatch
        sub-seed (reproducible runs, no thundering herd).
    quarantine_after: consecutive failures (or ONE tamper) that bench a
        worker; it re-admits only by passing a probation probe — a
        re-issue of an already-verified strip checked against the known
        answer.
    probation_cooldown_s: how long a quarantined worker sits out before
        the scheduler spends a probe on it.
    ewma_alpha: weight of the newest latency sample in the per-worker
        EWMA the work-stealing assignment ranks workers by.
    min_live: fleet floor — fewer live workers than this flips the
        session to inline completion of the remaining strips.
    lanes: independent dispatch lanes for BATCHED sessions (each lane
        owns a contiguous slice of the batch and its own sequential
        strip chain, so lanes are what actually run concurrently).
        None = min(batch, fleet size); single matrices always run 1 lane.
    """

    overdecompose: int = 2
    request_timeout_s: float | None = 30.0
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.25
    quarantine_after: int = 2
    probation_cooldown_s: float = 0.5
    ewma_alpha: float = 0.5
    min_live: int = 1
    lanes: int | None = None

    def __post_init__(self):
        if self.overdecompose < 1:
            raise ValueError("overdecompose must be >= 1")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.min_live < 0:
            raise ValueError("min_live must be >= 0")


RATELESS_DEFAULT = RatelessConfig()


@dataclass(frozen=True)
class SPDCConfig:
    name: str = "spdc"
    matrix_n: int = 4096
    num_servers: int = 16
    mode: str = "ewd"  # ewd | ewm
    method: str = "q3"  # q1 | q2 | q3
    lambda1: int = 128
    lambda2: int = 128
    dtype: str = "float64"
    # precision growth controls (DESIGN.md §6): None = the protocol's
    # dtype-keyed auto rule (on for sub-f64 compute, off for float64)
    growth_safe: bool | None = None
    equilibrate: bool | None = None
    block: int = 256  # per-server blocked-LU tile
    # fault tolerance (DESIGN.md §4): N+r standby servers provisioned for
    # localized-shard re-dispatch, whether the client heals rejected
    # verdicts instead of re-outsourcing, and the straggler policy (rounds
    # a server may run late before its shard is re-dispatched; None waits).
    standby: int = 0
    recover: bool = False
    straggler_deadline: int | None = None
    # execution boundary of the Parallelize stage (DESIGN.md §7/§9): a
    # name — "inline" (fused fast path) | "shardmap" | "threadpool" |
    # "multiprocess" (spawned workers, wire-codec messages) | "socket"
    # (warm worker daemons over TCP/UDS) — or an api.TransportConfig
    # (declarative: name + addresses + timeout; frozen/hashable, so this
    # config stays hashable). Resolved by api.resolve_transport.
    transport: object = "inline"
    # rateless straggler-adaptive dispatch (DESIGN.md §8): over-decompose
    # into F > N strips and stream them to whichever workers are free —
    # True uses RATELESS_DEFAULT knobs. Replaces straggler_deadline
    # (which a rateless session ignores: slow servers just do less).
    rateless: bool = False

    def protocol_kwargs(self) -> dict:
        """Keyword arguments for core.protocol.outsource_determinant —
        the bridge that keeps these fields from drifting away from the
        protocol's actual signature. Emits the FULL keyword set the config
        models; a reflection test (tests/test_torch_gateway.py) asserts
        every key stays a real `outsource_determinant` parameter."""
        return dict(
            lambda1=self.lambda1,
            lambda2=self.lambda2,
            mode=self.mode,
            method=self.method,
            recover=self.recover,
            standby=self.standby,
            straggler_deadline=self.straggler_deadline,
            dtype=self.dtype,
            growth_safe=self.growth_safe,
            equilibrate=self.equilibrate,
            transport=self.transport,
            rateless=self.rateless,
        )


SPDC_DEFAULT = SPDCConfig()
SPDC_EDGE_SMALL = SPDCConfig(name="spdc-edge-small", matrix_n=512, num_servers=4)
SPDC_POD = SPDCConfig(name="spdc-pod", matrix_n=8192, num_servers=16)
#: untrusted-edge profile: assume misbehavior, heal in place (N+2 spares)
SPDC_EDGE_HARDENED = SPDCConfig(
    name="spdc-edge-hardened", matrix_n=512, num_servers=4,
    standby=2, recover=True, straggler_deadline=8,
)
#: accelerator/edge precision profile: float32 compute end-to-end — half
#: the wire bytes of f64, and the dtype edge accelerators run fastest
#: (a GPU's f64 rate is a fraction of its f32). The protocol auto-enables the
#: growth-safe relayout + equilibration (DESIGN.md §6) and the ε(N)
#: thresholds read the f32 unit roundoff.
SPDC_EDGE_F32 = SPDCConfig(
    name="spdc-edge-f32", matrix_n=512, num_servers=4, dtype="float32",
)
#: role-split transports (DESIGN.md §7): same protocol, real execution
#: boundaries. threadpool = in-process workers with message dispatch;
#: multiprocess = spawned worker processes, ShardTask/ShardResult bytes
#: crossing an OS pipe — the closest profile to real remote edge servers.
SPDC_EDGE_THREADS = SPDCConfig(
    name="spdc-edge-threads", matrix_n=512, num_servers=4,
    transport="threadpool",
)
SPDC_EDGE_MP = SPDCConfig(
    name="spdc-edge-mp", matrix_n=256, num_servers=4,
    transport="multiprocess", standby=1, recover=True,
)
#: heterogeneous-fleet profile (DESIGN.md §8): rateless dispatch over
#: message workers — no straggler_deadline to tune, slow servers just
#: complete fewer strips, tamperers get quarantined mid-session.
SPDC_EDGE_RATELESS = SPDCConfig(
    name="spdc-edge-rateless", matrix_n=256, num_servers=4,
    transport="threadpool", recover=True, rateless=True,
)
#: networked-fleet profile (DESIGN.md §9): warm worker daemons over
#: TCP/UDS sockets — built kernels and CUDA contexts survive across
#: sessions and client restarts. The bare "socket" name self-hosts local UDS daemons; point
#: at a real fleet with transport=TransportConfig("socket",
#: addresses=("tcp://host:port", ...)).
SPDC_EDGE_SOCKET = SPDCConfig(
    name="spdc-edge-socket", matrix_n=256, num_servers=4,
    transport="socket", standby=1, recover=True,
)


@dataclass(frozen=True)
class AdmissionConfig:
    """Per-tenant admission control for the gateway (DESIGN.md §10.1).

    Tenancy is an ACCOUNTING dimension, not a bucketing one: all tenants'
    requests still coalesce into shared sweeps; what is per-tenant is the
    right to enter the queue. Both knobs default to off (None) so a
    gateway without multi-tenant policy behaves exactly as before.

    rate_per_sec: token-bucket refill rate per tenant (None = unlimited).
    burst: max banked tokens (None = max(1, rate_per_sec) — one second of
        headroom; a fresh tenant may burst this many at once).
    max_pending_per_tenant: pending-request quota per tenant (None =
        unlimited). Exceeding either raises a typed AdmissionRejected at
        submit time — distinct from GatewayOverloaded, which is the
        gateway-wide capacity door.
    """

    rate_per_sec: float | None = None
    burst: float | None = None
    max_pending_per_tenant: int | None = None

    def __post_init__(self):
        if self.rate_per_sec is not None and self.rate_per_sec <= 0:
            raise ValueError("rate_per_sec must be > 0 (or None for off)")
        if self.burst is not None and self.burst <= 0:
            raise ValueError("burst must be > 0 (or None for auto)")
        if (self.max_pending_per_tenant is not None
                and self.max_pending_per_tenant < 1):
            raise ValueError("max_pending_per_tenant must be >= 1 (or None)")


ADMISSION_OFF = AdmissionConfig()


@dataclass(frozen=True)
class BreakerConfig:
    """Per-bucket circuit breaker (DESIGN.md §10.2).

    failure_threshold: consecutive sweep failures (the sweep RAISED) that
        trip the breaker.
    max_unverified_rate: EWMA unverified-fraction above which the breaker
        trips even though sweeps complete (None = failures only). A
        bucket that keeps producing rejected verdicts burns device time
        for answers nobody can accept — operationally a failure.
    unverified_alpha / min_samples: EWMA weight of the newest flush and
        the flush count before the unverified signal may trip.
    cooldown_base_s / cooldown_max_s / probe_jitter: open-state cooldown
        base·2^(opens−1) capped at max, ±jitter fraction drawn
        deterministically from the bucket identity (no thundering herd,
        exact probe times on the virtual clock).
    on_open: what an open breaker does to NEW submissions — "fastfail"
        raises a typed BreakerOpen with a retry-after hint; "direct"
        detours them to the un-coalesced direct path (degraded but
        served, and isolated from the poisoned compiled sweep).
    enabled: master switch (False restores pre-breaker behavior).
    """

    failure_threshold: int = 3
    max_unverified_rate: float | None = 0.5
    unverified_alpha: float = 0.4
    min_samples: int = 4
    cooldown_base_s: float = 1.0
    cooldown_max_s: float = 60.0
    probe_jitter: float = 0.1
    on_open: str = "fastfail"
    enabled: bool = True

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.max_unverified_rate is not None and not (
                0.0 < self.max_unverified_rate <= 1.0):
            raise ValueError("max_unverified_rate must be in (0, 1] or None")
        if not 0.0 < self.unverified_alpha <= 1.0:
            raise ValueError("unverified_alpha must be in (0, 1]")
        if self.cooldown_base_s <= 0 or self.cooldown_max_s < self.cooldown_base_s:
            raise ValueError("need 0 < cooldown_base_s <= cooldown_max_s")
        if not 0.0 <= self.probe_jitter < 1.0:
            raise ValueError("probe_jitter must be in [0, 1)")
        if self.on_open not in ("fastfail", "direct"):
            raise ValueError("on_open must be 'fastfail' or 'direct'")


BREAKER_DEFAULT = BreakerConfig()
BREAKER_OFF = BreakerConfig(enabled=False)


@dataclass(frozen=True)
class CacheConfig:
    """Idempotency-keyed result cache (DESIGN.md §10.3).

    det is deterministic given (matrix bytes, security tuple), so a
    content-hash cache-aside turns repeated matrices into O(hash) hits.
    The key covers the full BucketKey (every protocol/security/dtype/
    transport field) plus the tenant, so a hit never crosses configs or
    tenants. Only verified results are stored.

    enabled: master switch.
    max_entries: LRU bound on cached results.
    single_flight: coalesce concurrent IDENTICAL submissions — followers
        ride the leader's sweep instead of enqueueing a duplicate, and
        each still receives its own result.
    """

    enabled: bool = True
    max_entries: int = 256
    single_flight: bool = True

    def __post_init__(self):
        if self.max_entries < 1:
            raise ValueError("max_entries must be >= 1")


CACHE_DEFAULT = CacheConfig()
CACHE_OFF = CacheConfig(enabled=False)


@dataclass(frozen=True)
class SPDCGatewayConfig:
    """Micro-batching gateway presets (DESIGN.md §5) — consumed by
    serve.spdc_gateway.SPDCGateway.

    buckets: the padded sizes n' requests are coalesced at. A request of
        raw size n lands in the smallest bucket >= n; each bucket flushes
        as ONE mixed-size protocol sweep. Every bucket must satisfy
        n' % num_servers == 0 and n' / num_servers > 1.
    max_batch: flush a bucket the moment it holds this many requests.
    max_wait_us: flush a partial bucket once its oldest request has waited
        this long (latency bound for light traffic).
    max_pending: backpressure — submissions beyond this many queued
        requests raise GatewayOverloaded instead of growing the queue
        without bound.
    pad_batches: round every flushed batch up to the next power-of-two
        (≤ max_batch) with discarded dummy matrices, so a bucket only ever
        runs log2(max_batch)+1 sweep shapes. The reference pads to bound
        its compile set; the port compiles nothing per shape but keeps
        the padding so that results and stats match the reference's
        (the dummies' cost on the card: PERF.md).
    warmup_batches: batch sizes each bucket is primed at by
        SPDCGateway.warmup() (kernels built, the allocator holding the
        bucket's shapes), so the first live flush doesn't pay for it
        (empty = the pad_batches shape set).
    spdc: the protocol parameters (server count, cipher mode, verification
        method, recovery policy) every bucket runs with by default;
        per-request overrides open extra buckets.
    admission: per-tenant rate limiting + pending quotas (DESIGN.md
        §10.1; defaults to off — single-tenant gateways are unchanged).
    breaker: per-bucket circuit breaker (DESIGN.md §10.2; on by default
        with a 3-consecutive-failure trip).
    cache: idempotency-keyed result cache + single-flight dedup
        (DESIGN.md §10.3; on by default, 256-entry LRU).
    """

    name: str = "spdc-gateway"
    buckets: tuple[int, ...] = (64, 128, 256, 512, 1024)
    max_batch: int = 32
    max_wait_us: float = 2_000.0
    max_pending: int = 4096
    pad_batches: bool = True
    warmup_batches: tuple[int, ...] = ()
    spdc: SPDCConfig = SPDC_EDGE_SMALL
    admission: AdmissionConfig = ADMISSION_OFF
    breaker: BreakerConfig = BREAKER_DEFAULT
    cache: CacheConfig = CACHE_DEFAULT


SPDC_GATEWAY_DEFAULT = SPDCGatewayConfig()
#: latency-biased: small batches, tight flush deadline
SPDC_GATEWAY_LOWLAT = SPDCGatewayConfig(
    name="spdc-gateway-lowlat", max_batch=8, max_wait_us=250.0,
)
#: throughput-biased: deep batches, generous coalescing window
SPDC_GATEWAY_BULK = SPDCGatewayConfig(
    name="spdc-gateway-bulk", max_batch=128, max_wait_us=20_000.0,
    max_pending=16384,
)
#: untrusted-edge serving: every bucket sweep heals rejected verdicts in
#: place with N+2 standby servers (DESIGN.md §4)
SPDC_GATEWAY_HARDENED = SPDCGatewayConfig(
    name="spdc-gateway-hardened", spdc=SPDC_EDGE_HARDENED,
)
#: float32 serving: every default bucket sweeps in f32 (f64 clients can
#: still opt up per request via submit(dtype="float64"))
SPDC_GATEWAY_F32 = SPDCGatewayConfig(
    name="spdc-gateway-f32", spdc=SPDC_EDGE_F32,
)
#: gateway over the threadpool transport: every bucket sweep dispatches
#: ShardTasks to in-process edge workers (per-request transport overrides
#: can still opt back to "inline")
SPDC_GATEWAY_THREADS = SPDCGatewayConfig(
    name="spdc-gateway-threads", spdc=SPDC_EDGE_THREADS,
)
#: gateway over warm socket daemons (DESIGN.md §9): bucket sweeps stream
#: ShardTasks to persistent worker processes whose built kernels outlive
#: any single gateway — the deployment shape for a long-lived edge fleet.
SPDC_GATEWAY_SOCKET = SPDCGatewayConfig(
    name="spdc-gateway-socket", spdc=SPDC_EDGE_SOCKET,
)
#: public-facing deployment profile (DESIGN.md §10): per-tenant admission
#: control ON (100 req/s, 256-pending quota per tenant), breaker + cache
#: at their defaults.
SPDC_GATEWAY_PROD = SPDCGatewayConfig(
    name="spdc-gateway-prod",
    admission=AdmissionConfig(rate_per_sec=100.0, burst=200.0,
                              max_pending_per_tenant=256),
)
