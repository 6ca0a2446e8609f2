"""Gateway observability: counters, streaming quantiles, snapshots, and
the /healthz + /metrics text surfaces (DESIGN.md §10; port of
repro.serve.metrics, schema v1 and both renderings unchanged).

The gateway (serve.spdc_gateway) records every event — submission,
admission rejection, flush, verdict, cache hit — into ONE
``GatewayMetrics`` registry, and the same event objects are handed to the
operator hook points (``on_flush`` / ``on_verdict`` / ``on_reject``), so
benchmarks, tests, and dashboards all consume identical numbers: there is
no separate "test instrumentation" path that could drift from what a
deployment sees.

Quantiles (queue wait, sweep latency, flush size) come from a
deterministic bounded-memory streaming sketch: a sorted weighted-bin
histogram that, when full, merges the two adjacent bins closest in value
(the Ben-Haim/Tom-Toledano streaming-histogram step). No randomness — the
same event stream always yields the
same percentile estimates, so virtual-clock tests can assert on them —
and memory is O(capacity) no matter how long the gateway lives. min/max
are tracked exactly, and estimates degrade gracefully (each compression
at most halves the local resolution of the CDF).

Snapshots are schema-versioned (``MetricsSnapshot.SCHEMA_VERSION``): the
key set of ``as_dict()`` is a compatibility contract guarded by
tests/test_torch_resilience.py, so dashboards built on /metrics don't silently
break when the gateway grows new counters (additions bump the version).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "QuantileSketch",
    "FlushEvent",
    "VerdictEvent",
    "RejectEvent",
    "GatewayMetrics",
    "MetricsSnapshot",
    "render_prometheus",
    "render_healthz",
]


class QuantileSketch:
    """Deterministic bounded-memory streaming quantile estimator.

    Holds at most ``capacity`` sorted (value, weight) bins. New
    observations enter as weight-1 bins; when the histogram overflows, the
    two ADJACENT bins closest in value merge into their weighted midpoint
    (the Ben-Haim/Tom-Toledano streaming-histogram step). Merging by
    value gap — not by position — keeps bins spread across the observed
    range, so a drifting stream doesn't collapse its mass into a few
    stale mega-bins; mass is preserved exactly (== observation count).
    ``quantile(q)`` answers from the weighted bins; min/max are exact.
    All operations are deterministic — identical streams give identical
    answers, which is what lets the overload tier assert sharp p99 bounds
    on a virtual clock.
    """

    __slots__ = ("capacity", "_items", "count", "total", "min", "max")

    def __init__(self, capacity: int = 512):
        if capacity < 8:
            raise ValueError("sketch capacity must be >= 8")
        self.capacity = int(capacity)
        self._items: list[tuple[float, int]] = []  # (value, weight)
        self.count = 0  # observations seen (not samples kept)
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, value: float) -> None:
        import bisect

        value = float(value)
        self.count += 1
        self.total += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        bisect.insort(self._items, (value, 1))
        if len(self._items) > self.capacity:
            self._compress()

    def _compress(self) -> None:
        it = self._items
        # merge the adjacent bin pair closest in value (first such pair on
        # ties) into its weighted midpoint: mass is preserved exactly, and
        # gap-directed merging keeps bins spread over the observed range
        # instead of snowballing old mass into a few stale mega-bins
        gi = min(range(len(it) - 1), key=lambda i: it[i + 1][0] - it[i][0])
        (v1, w1), (v2, w2) = it[gi], it[gi + 1]
        w = w1 + w2
        it[gi:gi + 2] = [((v1 * w1 + v2 * w2) / w, w)]

    def quantile(self, q: float) -> float | None:
        """Weighted percentile estimate; None while empty. q in [0, 1]."""
        if not self._items:
            return None
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        mass = sum(w for _, w in self._items)
        target = q * mass
        acc = 0.0
        for v, w in self._items:
            acc += w
            if acc >= target:
                return v
        return self._items[-1][0]

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def summary(self) -> dict:
        """p50/p90/p99 + exact extremes, ready for a snapshot row."""
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


# ---------------------------------------------------------------- events


@dataclass(frozen=True)
class FlushEvent:
    """One bucket sweep, successful or not (``error`` set when it raised)."""

    bucket: str  # BucketKey label
    reason: str  # "full" | "timeout" | "drain"
    batch: int  # real requests in the sweep
    padded_batch: int  # batch after pad_batches dummies
    queue_waits_s: tuple[float, ...]  # per-request submit→flush wait
    sweep_s: float  # device sweep wall time (virtual-clock delta in tests)
    recovered: bool = False
    error: str | None = None


@dataclass(frozen=True)
class VerdictEvent:
    """One client request's outcome, as delivered."""

    rid: int
    bucket: str | None  # None for direct / oversize requests
    tenant: str
    verified: bool
    latency_s: float
    flush_reason: str  # "full"|"timeout"|"drain"|"direct"|"cache"|"coalesced"
    cache_hit: bool = False
    error: str | None = None


@dataclass(frozen=True)
class RejectEvent:
    """A typed admission refusal — nothing was enqueued."""

    reason: str  # "overload" | "rate" | "quota" | "breaker"
    tenant: str
    bucket: str | None = None


# ------------------------------------------------------------- registry


@dataclass
class _BucketMetrics:
    flushes: int = 0
    requests: int = 0
    verified: int = 0
    unverified: int = 0
    failed: int = 0
    recovered_flushes: int = 0
    sweep_errors: int = 0
    flush_size: QuantileSketch = field(default_factory=lambda: QuantileSketch(128))
    queue_wait_s: QuantileSketch = field(default_factory=QuantileSketch)
    sweep_s: QuantileSketch = field(default_factory=QuantileSketch)


@dataclass
class _TenantMetrics:
    submitted: int = 0
    served: int = 0
    rejected_rate: int = 0
    rejected_quota: int = 0
    rejected_overload: int = 0
    rejected_breaker: int = 0


class GatewayMetrics:
    """Passive registry the gateway records events into (under its lock).

    Pure bookkeeping — no clock, no locks of its own, no torch. Live gauges
    (queue depth, breaker states, cache entries, tenant pending) belong to
    the gateway's own structures and are folded in at snapshot() time via
    the ``gauges`` argument, so the registry never holds a second copy of
    serving state that could drift.
    """

    def __init__(self):
        self.counters: dict[str, int] = {
            "submitted": 0,
            "admitted": 0,
            "served": 0,
            "failed": 0,
            "direct": 0,
            "rejected_overload": 0,
            "rejected_rate": 0,
            "rejected_quota": 0,
            "rejected_breaker": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "coalesced": 0,
            "breaker_opens": 0,
            "breaker_probes": 0,
            "breaker_closes": 0,
        }
        self.request_latency_s = QuantileSketch()
        self._buckets: dict[str, _BucketMetrics] = {}
        self._tenants: dict[str, _TenantMetrics] = {}

    # -- recording (gateway-internal) -----------------------------------

    def bucket(self, label: str) -> _BucketMetrics:
        return self._buckets.setdefault(label, _BucketMetrics())

    def tenant(self, name: str) -> _TenantMetrics:
        return self._tenants.setdefault(name, _TenantMetrics())

    def record_submit(self, tenant: str) -> None:
        self.counters["submitted"] += 1
        self.tenant(tenant).submitted += 1

    def record_reject(self, ev: RejectEvent) -> None:
        key = f"rejected_{ev.reason}"
        self.counters[key] = self.counters.get(key, 0) + 1
        t = self.tenant(ev.tenant)
        setattr(t, key, getattr(t, key) + 1)

    def record_flush(self, ev: FlushEvent) -> None:
        b = self.bucket(ev.bucket)
        b.flushes += 1
        b.requests += ev.batch
        b.flush_size.observe(ev.batch)
        for w in ev.queue_waits_s:
            b.queue_wait_s.observe(w)
        b.sweep_s.observe(ev.sweep_s)
        if ev.recovered:
            b.recovered_flushes += 1
        if ev.error is not None:
            b.sweep_errors += 1

    def record_verdict(self, ev: VerdictEvent) -> None:
        self.request_latency_s.observe(ev.latency_s)
        if ev.error is not None:
            self.counters["failed"] += 1
        else:
            # tenant served mirrors the global served/failed split — a
            # failed request is not "served" in either view
            self.tenant(ev.tenant).served += 1
            self.counters["served"] += 1
        if ev.bucket is not None:
            b = self.bucket(ev.bucket)
            if ev.error is not None:
                b.failed += 1
            elif ev.verified:
                b.verified += 1
            else:
                b.unverified += 1

    # -- snapshotting ----------------------------------------------------

    def snapshot(self, gauges: dict | None = None) -> "MetricsSnapshot":
        gauges = gauges or {}
        bucket_gauges = gauges.get("buckets", {})
        buckets = {}
        for label, b in sorted(self._buckets.items()):
            extra = bucket_gauges.get(label, {})
            buckets[label] = {
                "depth": extra.get("depth", 0),
                "breaker": extra.get("breaker", "closed"),
                "flushes": b.flushes,
                "requests": b.requests,
                "verified": b.verified,
                "unverified": b.unverified,
                "failed": b.failed,
                "recovered_flushes": b.recovered_flushes,
                "sweep_errors": b.sweep_errors,
                "flush_size": b.flush_size.summary(),
                "queue_wait_s": b.queue_wait_s.summary(),
                "sweep_s": b.sweep_s.summary(),
            }
        # buckets with live gauges (e.g. an open breaker) that never
        # recorded a flush still must surface — an operator staring at a
        # stuck bucket needs to see its state, not an absence
        for label, extra in sorted(bucket_gauges.items()):
            if label not in buckets:
                empty = _BucketMetrics()
                buckets[label] = {
                    "depth": extra.get("depth", 0),
                    "breaker": extra.get("breaker", "closed"),
                    "flushes": 0, "requests": 0, "verified": 0,
                    "unverified": 0, "failed": 0, "recovered_flushes": 0,
                    "sweep_errors": 0,
                    "flush_size": empty.flush_size.summary(),
                    "queue_wait_s": empty.queue_wait_s.summary(),
                    "sweep_s": empty.sweep_s.summary(),
                }
        tenant_pending = gauges.get("tenant_pending", {})
        tenants = {
            name: {
                "pending": tenant_pending.get(name, 0),
                "submitted": t.submitted,
                "served": t.served,
                "rejected_rate": t.rejected_rate,
                "rejected_quota": t.rejected_quota,
                "rejected_overload": t.rejected_overload,
                "rejected_breaker": t.rejected_breaker,
            }
            for name, t in sorted(self._tenants.items())
        }
        hits = self.counters["cache_hits"]
        misses = self.counters["cache_misses"]
        lookups = hits + misses
        return MetricsSnapshot(
            counters=dict(self.counters),
            pending=gauges.get("pending", 0),
            request_latency_s=self.request_latency_s.summary(),
            buckets=buckets,
            tenants=tenants,
            cache={
                "entries": gauges.get("cache_entries", 0),
                "hits": hits,
                "misses": misses,
                "coalesced": self.counters["coalesced"],
                "hit_rate": (hits / lookups) if lookups else None,
                "evictions": gauges.get("cache_evictions", 0),
            },
        )


@dataclass(frozen=True)
class MetricsSnapshot:
    """Point-in-time operational view — the unit dashboards consume.

    ``as_dict()``'s key schema is versioned: tests pin the exact key set
    for SCHEMA_VERSION, so any widening is a deliberate, visible bump.
    """

    SCHEMA_VERSION = 1

    counters: dict
    pending: int
    request_latency_s: dict
    buckets: dict
    tenants: dict
    cache: dict

    def as_dict(self) -> dict:
        return {
            "schema_version": self.SCHEMA_VERSION,
            "counters": dict(self.counters),
            "pending": self.pending,
            "request_latency_s": dict(self.request_latency_s),
            "buckets": {k: dict(v) for k, v in self.buckets.items()},
            "tenants": {k: dict(v) for k, v in self.tenants.items()},
            "cache": dict(self.cache),
        }

    @property
    def open_breakers(self) -> list[str]:
        return [
            label for label, b in self.buckets.items()
            if b.get("breaker") not in (None, "closed")
        ]


# ------------------------------------------------------------- rendering


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(round(v, 9))
    return str(v)


def render_prometheus(snap: MetricsSnapshot) -> str:
    """Prometheus-style text exposition of a snapshot (the /metrics body).

    Stable line grammar: ``spdc_gateway_<name>{label="..."} value``.
    Quantile summaries expand to ``_p50`` / ``_p99`` / ``_max`` series.
    """
    lines = [
        f"# spdc gateway metrics (schema v{snap.SCHEMA_VERSION})",
    ]
    for name, v in sorted(snap.counters.items()):
        lines.append(f"spdc_gateway_{name}_total {_fmt(v)}")
    lines.append(f"spdc_gateway_pending {_fmt(snap.pending)}")
    for q in ("p50", "p99", "max"):
        lines.append(
            f"spdc_gateway_request_latency_seconds_{q} "
            f"{_fmt(snap.request_latency_s.get(q))}"
        )
    for label, b in sorted(snap.buckets.items()):
        tag = f'{{bucket="{label}"}}'
        for k in ("depth", "flushes", "requests", "verified", "unverified",
                  "failed", "recovered_flushes", "sweep_errors"):
            lines.append(f"spdc_gateway_bucket_{k}{tag} {_fmt(b[k])}")
        state = b.get("breaker", "closed")
        for s in ("closed", "open", "half_open"):
            lines.append(
                f'spdc_gateway_breaker_state{{bucket="{label}",state="{s}"}} '
                f"{_fmt(state == s)}"
            )
        for series in ("queue_wait_s", "sweep_s", "flush_size"):
            for q in ("p50", "p99", "max"):
                lines.append(
                    f"spdc_gateway_bucket_{series}_{q}{tag} "
                    f"{_fmt(b[series].get(q))}"
                )
    for name, t in sorted(snap.tenants.items()):
        tag = f'{{tenant="{name}"}}'
        for k, v in sorted(t.items()):
            lines.append(f"spdc_gateway_tenant_{k}{tag} {_fmt(v)}")
    for k, v in sorted(snap.cache.items()):
        lines.append(f"spdc_gateway_cache_{k} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def render_healthz(snap: MetricsSnapshot, *, max_pending: int | None = None) -> dict:
    """Health verdict from a snapshot (the /healthz body).

    ok        — serving normally;
    degraded  — at least one bucket's breaker is not closed (that bucket
                fast-fails or detours direct, everything else serves);
    overloaded— the pending queue is at/over the backpressure limit, new
                submissions are being shed.
    The dict renders as a one-line-per-key text body; ``status`` first.
    """
    status = "ok"
    if snap.open_breakers:
        status = "degraded"
    if max_pending is not None and snap.pending >= max_pending:
        status = "overloaded"
    return {
        "status": status,
        "pending": snap.pending,
        "open_breakers": snap.open_breakers,
        "served": snap.counters.get("served", 0),
        "failed": snap.counters.get("failed", 0),
        "rejected": sum(
            v for k, v in snap.counters.items() if k.startswith("rejected_")
        ),
    }
