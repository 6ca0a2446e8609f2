"""Micro-batch request queue for the SPDC edge gateway (DESIGN.md §5;
port of repro.serve.queue, byte for byte in behaviour).

The paper's deployment story is a stream of resource-constrained IoT
clients each outsourcing ONE determinant at a time, while the repo's
throughput lever (DESIGN.md §3) is the batched protocol sweep. This module
is the piece between them: it holds in-flight single-matrix requests,
groups them into *buckets* that can legally share one coalesced sweep, and
decides when a bucket is ripe to flush.

Bucketing rule: two requests may share a sweep iff they agree on every
protocol parameter the sweep runs with — the padded size n' and the full
security config (server count, cipher mode, verification method,
recovery policy). That tuple is the `BucketKey`, so every flush of a
bucket runs one (B, n', n') stack shape through the same kernels.

Flush policy (the gateway's latency/throughput dial):
  * max_batch   — a full bucket flushes immediately (throughput bound);
  * max_wait_us — a partial bucket flushes once its oldest request has
                  waited this long (latency bound under light traffic);
  * max_pending — total queued requests beyond this raise
                  `GatewayOverloaded` at submit time (backpressure: shed
                  load at the door instead of growing an unbounded queue).

Pure bookkeeping — no torch, no clocks. The gateway injects `now` so tests
drive flush timing deterministically with a virtual clock.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field


class GatewayOverloaded(RuntimeError):
    """Backpressure rejection: the gateway's pending queue is full.

    Raised at submit time — the paper's edge clients are latency-bound, so
    shedding a request immediately (letting the client retry against
    another gateway) beats queueing it behind more work than the servers
    can drain.
    """


class NoBucketFits(ValueError):
    """The request's matrix is larger than every configured bucket size
    (the gateway then serves it as a direct un-coalesced call)."""


@dataclass(frozen=True)
class BucketKey:
    """Everything a coalesced sweep runs with: the shared padded size and
    the complete security configuration. Hashable — the queue index, the
    breaker and cache identity of the bucket."""

    pad_to: int
    num_servers: int
    #: which secure-linalg operation this bucket serves (DESIGN.md §12).
    #: Part of the key: "det" and "slogdet" sweeps coalesce per-op (they
    #: read the same Determinant differently but must report distinct
    #: metrics series), and "solve" requests carry an RHS payload that the
    #: batched determinant sweep has no lane for — they run per-request
    #: LinalgSessions instead. Same transport instance across ops ⇒ the
    #: buckets still share one warm worker pool.
    op: str = "det"
    mode: str = "ewd"
    method: str = "q3"
    lambda1: int = 128
    lambda2: int = 128
    recover: bool = False
    standby: int = 0
    straggler_deadline: int | None = None
    #: compute dtype of the bucket's sweep. Part of the key so float32 and
    #: float64 clients never share a sweep, a warmup dummy, or an ε(N)
    #: calibration — a coalesced sweep has ONE device dtype.
    dtype: str = "float64"
    #: growth-control overrides (DESIGN.md §6; None = the protocol's
    #: dtype-keyed auto rule). Part of the key: they change the cipher
    #: AND the factor values, so explicit settings cannot share a
    #: bucket with auto-ruled requests.
    growth_safe: bool | None = None
    equilibrate: bool | None = None
    #: execution boundary of the bucket's sweeps (DESIGN.md §7/§9). Part
    #: of the key: an inline sweep and a multiprocess sweep are different
    #: programs with different warm state, so requests targeting different
    #: transports must not coalesce. A name ("inline" | "threadpool" |
    #: "multiprocess" | "socket" | "shardmap") or a live Transport
    #: instance (hashed by identity; the gateway resolves TransportConfig
    #: overrides to its owned instances BEFORE keying, so equal configs
    #: land in one bucket and share one warm pool).
    transport: object = "inline"
    #: rateless dispatch (DESIGN.md §8). Part of the key: a rateless sweep
    #: partitions the bucket into F = overdecompose·N strips instead of N,
    #: so its padded size rides a different grid and its session carries
    #: fleet-health state a deadline-based sweep has no use for.
    rateless: bool = False

    def label(self) -> str:
        """Stable human-readable metrics label for this bucket.

        Leads with the fields operators actually scan for (size, fleet,
        dtype, method) and appends a short digest of the full key so two
        buckets differing only in a rarely-varied field (lambda1, a
        transport instance) never silently merge their metrics series.
        """
        import zlib

        core = (f"n{self.pad_to}.N{self.num_servers}.{self.dtype}"
                f".{self.mode}-{self.method}")
        if self.op != "det":
            core += f".{self.op}"
        if self.rateless:
            core += ".rateless"
        rest = (self.lambda1, self.lambda2, self.recover, self.standby,
                self.straggler_deadline, self.growth_safe, self.equilibrate,
                str(self.transport) if isinstance(self.transport, str)
                else f"transport@{id(self.transport):x}")
        return f"{core}#{zlib.crc32(repr(rest).encode()) & 0xFFFF:04x}"

    def protocol_kwargs(self) -> dict:
        """Keyword arguments for core.protocol.outsource_determinant_mixed.

        `op` is deliberately absent: it selects WHICH engine a flush runs
        (the batched determinant sweep vs per-request LinalgSessions), not
        a parameter of the sweep itself.
        """
        return dict(
            pad_to=self.pad_to,
            mode=self.mode,
            method=self.method,
            lambda1=self.lambda1,
            lambda2=self.lambda2,
            recover=self.recover,
            standby=self.standby,
            straggler_deadline=self.straggler_deadline,
            dtype=self.dtype,
            growth_safe=self.growth_safe,
            equilibrate=self.equilibrate,
            transport=self.transport,
            rateless=self.rateless,
        )

    def linalg_kwargs(self) -> dict:
        """Keyword arguments for linalg.LinalgSession (op="solve" flushes).

        The session has no equilibrate / straggler_deadline / rateless
        knobs (it forces equilibration off so the LU factors stay exactly
        reusable, and solve rounds are narrow enough that deadline and
        rateless dispatch buy nothing), so those BucketKey fields are
        dropped rather than forwarded. A "q3" method is promoted to "q2":
        Q3's diagonal-only residual cannot DRIVE recovery of in-band
        relay poisoning on factors that will be reused (linalg.session
        runs an explicit Q3 post-check on the accepted factors either
        way), so the secret-probed full-product check is the one the
        session's healing loop must steer by.
        """
        return dict(
            transport=self.transport,
            mode=self.mode,
            method="q2" if self.method == "q3" else self.method,
            lambda1=self.lambda1,
            lambda2=self.lambda2,
            recover=self.recover,
            standby=self.standby,
            dtype=self.dtype,
            growth_safe=self.growth_safe,
        )


@dataclass
class DetRequest:
    """One client request: a single square matrix awaiting a verdict."""

    rid: int
    matrix: object  # (n, n) ndarray — kept framework-agnostic here
    n: int
    enqueued_at: float
    #: admission-accounting dimension (DESIGN.md §10.1) — NOT part of the
    #: BucketKey: tenants coalesce into shared sweeps, only their quota
    #: bookkeeping is separate
    tenant: str = "default"
    #: idempotency cache key (BucketKey, tenant, content digest) the
    #: gateway resolved at submit time; None when caching is off or the
    #: request rides the direct path
    ckey: object = None
    #: which secure-linalg op the client asked for ("det" | "slogdet" |
    #: "solve"); mirrors the request's BucketKey.op for the direct path
    op: str = "det"
    #: right-hand side for op="solve" — an (n,) or (n, c) ndarray; None
    #: for determinant-family requests
    rhs: object = None


#: Granularity of synthesized fallback buckets: sizes are rounded up to
#: the next multiple of num_servers * SYNTH_GRID. Synthesizing the exact
#: smallest servable n' per request would open one bucket — one sweep
#: shape plus warmup — per distinct request size, silently unbounding the
#: gateway's bucket set under a diverse (or adversarial) size
#: distribution. The grid caps the synthesized-bucket count at
#: ~max(buckets)/(N·SYNTH_GRID) at the price of up to N·SYNTH_GRID − 1
#: extra padding rows (identity-extension rows are protocol-exact, so the
#: cost is compute only, and it is largest in relative terms exactly where
#: matrices are cheapest).
SYNTH_GRID = 16


def bucket_size_for(n: int, buckets: tuple[int, ...], num_servers: int) -> int:
    """Smallest configured bucket that can serve an (n, n) request.

    A bucket n' is eligible when n' >= n and the N-server schedule accepts
    it (n' % N == 0, n'/N > 1 — paper §IV.D.1).

    When a large-enough bucket exists but EVERY one fails the divisibility
    test (e.g. the default {64..1024} power-of-two buckets with a
    num_servers=3 override), a valid padded size still exists — a fallback
    bucket is synthesized on a coarse grid (next multiple of
    num_servers·SYNTH_GRID ≥ n, always servable: divisible by N with
    n'/N ≥ SYNTH_GRID > 1), so such requests keep coalescing with each
    other instead of erroring while the set of synthesized bucket sizes
    stays bounded (see SYNTH_GRID). A synthesized size never exceeds
    max(buckets) — the operator's configured size cap bounds every
    coalesced sweep, so a request whose grid round-up would overshoot it
    falls to the direct path like any oversize request.

    Raises NoBucketFits when the matrix exceeds every configured bucket,
    or when the synthesized grid size would — both land on the gateway's
    direct un-coalesced call.
    """
    eligible = [b for b in buckets if b >= n]
    for b in sorted(eligible):
        if b % num_servers == 0 and b // num_servers > 1:
            return b
    if not eligible:
        raise NoBucketFits(
            f"no bucket in {sorted(buckets)} fits n={n} with N={num_servers}"
        )
    step = num_servers * SYNTH_GRID
    synth = ((n + step - 1) // step) * step
    if synth > max(buckets):
        raise NoBucketFits(
            f"synthesized fallback n'={synth} (grid N·{SYNTH_GRID}) exceeds "
            f"the largest configured bucket {max(buckets)} for n={n} with "
            f"N={num_servers}"
        )
    return synth


@dataclass
class _Bucket:
    requests: list[DetRequest] = field(default_factory=list)

    @property
    def oldest_at(self) -> float:
        return self.requests[0].enqueued_at

    def __len__(self) -> int:
        return len(self.requests)


@dataclass
class GatewayStats:
    """Operational counters; surfaced by the serve_spdc launcher and the
    metrics surface."""

    submitted: int = 0
    rejected: int = 0  # backpressure at submit time (GatewayOverloaded)
    rejected_admission: int = 0  # per-tenant rate/quota (AdmissionRejected)
    rejected_breaker: int = 0  # bucket breaker open, fast-fail (BreakerOpen)
    direct: int = 0  # oversize requests served un-coalesced
    degraded_direct: int = 0  # breaker-open requests detoured direct
    served: int = 0  # requests answered through a coalesced flush
    failed: int = 0  # requests whose sweep raised (per-request error result)
    cache_hits: int = 0  # idempotency-cache hits (answered in O(hash))
    cache_misses: int = 0  # cache lookups that went on to enqueue
    coalesced: int = 0  # single-flight followers riding a leader's sweep
    breaker_opens: int = 0  # closed/half-open -> open transitions
    breaker_probes: int = 0  # half-open probe requests admitted
    breaker_closes: int = 0  # half-open -> closed recoveries
    flushes: int = 0
    flushes_full: int = 0  # max_batch reached
    flushes_timeout: int = 0  # max_wait_us exceeded on a partial bucket
    flushes_drain: int = 0  # explicit drain()
    recovered_flushes: int = 0  # flushes whose verdict needed re-dispatch

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class MicroBatchQueue:
    """Pending requests, grouped by BucketKey, FIFO within a bucket."""

    def __init__(self, *, max_batch: int, max_wait_us: float,
                 max_pending: int):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.max_pending = int(max_pending)
        # the queue has no lock of its own: every caller is the gateway,
        # already inside its RLock (enforced there via the gateway's own
        # guarded `_queue` reference — see tools/repro_lint, DESIGN.md §11)
        #: guarded-by: external(SPDCGateway._lock)
        self._buckets: "OrderedDict[BucketKey, _Bucket]" = OrderedDict()
        self._pending = 0  #: guarded-by: external(SPDCGateway._lock)

    @property
    def pending(self) -> int:
        return self._pending

    def push(self, key: BucketKey, req: DetRequest) -> bool:
        """Enqueue; returns True when the bucket just reached max_batch.

        Raises GatewayOverloaded when the gateway-wide pending total is at
        max_pending — the caller surfaces that to the client unserved.
        """
        if self._pending >= self.max_pending:
            raise GatewayOverloaded(
                f"{self._pending} requests pending (max_pending="
                f"{self.max_pending}); retry later"
            )
        bucket = self._buckets.setdefault(key, _Bucket())
        bucket.requests.append(req)
        self._pending += 1
        return len(bucket) >= self.max_batch

    def pop(self, key: BucketKey, limit: int | None = None) -> list[DetRequest]:
        """Remove and return up to `limit` of a bucket's requests (FIFO).

        The gateway flushes max_batch at a time even when a burst stacked
        more than that into one bucket — each sweep stays at the warmed-up
        (max_batch, n', n') shape instead of compiling a fresh program per
        burst size.
        """
        bucket = self._buckets.get(key)
        if bucket is None:
            return []
        if limit is None or len(bucket) <= limit:
            del self._buckets[key]
            taken = bucket.requests
        else:
            taken = bucket.requests[:limit]
            bucket.requests = bucket.requests[limit:]
        self._pending -= len(taken)
        return taken

    def due(self, now: float) -> list[tuple[BucketKey, str]]:
        """(bucket, reason) pairs ripe to flush at `now` — "full"
        (max_batch reached) or "timeout" (oldest request older than
        max_wait_us). Ordered oldest-bucket-first."""
        ready = []
        for key, bucket in self._buckets.items():
            if len(bucket) >= self.max_batch:
                ready.append((bucket.oldest_at, key, "full"))
            elif (now - bucket.oldest_at) * 1e6 >= self.max_wait_us:
                ready.append((bucket.oldest_at, key, "timeout"))
        ready.sort(key=lambda t: t[0])
        return [(k, reason) for _, k, reason in ready]

    def next_deadline(self, now: float) -> float | None:
        """Seconds until the earliest pending timeout flush (None when
        empty) — the async flusher's sleep bound."""
        if not self._buckets:
            return None
        oldest = min(b.oldest_at for b in self._buckets.values())
        return max(0.0, oldest + self.max_wait_us * 1e-6 - now)

    def has_full(self) -> bool:
        """True when some bucket already holds max_batch requests."""
        return any(len(b) >= self.max_batch for b in self._buckets.values())

    def keys(self) -> list[BucketKey]:
        return list(self._buckets)

    def depth_by_key(self) -> dict[BucketKey, int]:
        """Live per-bucket queue depth (the metrics depth gauge)."""
        return {k: len(b) for k, b in self._buckets.items()}
