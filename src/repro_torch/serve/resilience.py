"""Gateway resilience primitives: admission control, circuit breakers,
and the idempotency-keyed result cache (DESIGN.md §10; port of
repro.serve.resilience).

All three are pure bookkeeping on an injected clock — no torch, no threads,
no wall time — so every policy decision is reproducible on the virtual
clock the gateway tests already drive. The gateway (serve.spdc_gateway)
owns the instances and calls them under its lock.

Admission vs backpressure (DESIGN.md §10.1): ``GatewayOverloaded``
(serve.queue) is the *capacity* door — the gateway-wide pending total hit
its bound, nobody gets in regardless of who they are.
``AdmissionRejected`` is the *policy* door — THIS tenant exceeded its
token-bucket rate or its pending quota, while other tenants keep being
served. The two are distinct types because clients must react
differently: backpressure means retry against another gateway; an
admission reject means slow down (the gateway is healthy).

Circuit breaker (DESIGN.md §10.2): per-BUCKET, not per-gateway — the
failure domain of a poisoned size/config mix is exactly its bucket's
sweep, so that is the unit that trips. Unverified-rate counts as failure
alongside sweep exceptions: a bucket whose results keep failing
verification is burning device time to produce answers nobody can accept,
which is operationally identical to crashing.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, field

__all__ = [
    "AdmissionRejected",
    "BreakerOpen",
    "TokenBucket",
    "AdmissionController",
    "CircuitBreaker",
    "ResultCache",
]


class AdmissionRejected(RuntimeError):
    """Per-tenant policy rejection: rate limit or pending quota.

    Raised at submit time, before anything is enqueued; ``reason`` is
    "rate" (token bucket empty) or "quota" (tenant's pending cap hit).
    Distinct from GatewayOverloaded — the gateway has capacity, this
    tenant is over ITS share.
    """

    def __init__(self, msg: str, *, tenant: str, reason: str):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason


class BreakerOpen(RuntimeError):
    """Fast-fail rejection: the request's bucket has its breaker open.

    ``retry_after_s`` is the time until the next half-open probe — the
    client's backoff hint. Nothing is enqueued.
    """

    def __init__(self, msg: str, *, bucket: str, retry_after_s: float):
        super().__init__(msg)
        self.bucket = bucket
        self.retry_after_s = retry_after_s


# ------------------------------------------------------------- admission


class TokenBucket:
    """Classic token bucket on an injected clock: ``rate`` tokens/sec
    refill, at most ``burst`` banked. Deterministic — refill is computed
    from the now() values the caller passes, never wall time."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float, *, now: float = 0.0):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket needs rate > 0 and burst > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)  # start full: a fresh tenant may burst
        self._last = float(now)

    def try_take(self, now: float, amount: float = 1.0) -> bool:
        if now > self._last:
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
            self._last = now
        if self.tokens >= amount:
            self.tokens -= amount
            return True
        return False


class AdmissionController:
    """Per-tenant rate limiting + pending quotas (DESIGN.md §10.1).

    Tenancy rides *accounting*, not the BucketKey: requests from every
    tenant still coalesce into the same shared sweeps (a tenant dimension
    on the key would shatter batching — the whole point of the gateway).
    What is per-tenant is the right to enter the queue.

    Lifecycle per admitted request: ``charge`` (token) → ``acquire_slot``
    (quota, on enqueue) → ... → ``release_slot`` (on delivery, success or
    failure). Cache hits charge a token but never hold a slot — they cost
    O(hash), not sweep capacity.
    """

    def __init__(self, config=None):
        # config: configs.spdc.AdmissionConfig | None (None = everything off)
        self.config = config
        self._buckets: dict[str, TokenBucket] = {}
        self._pending: dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        c = self.config
        return c is not None and (
            c.rate_per_sec is not None or c.max_pending_per_tenant is not None
        )

    def charge(self, tenant: str, now: float) -> None:
        """Consume one rate token; raises AdmissionRejected("rate")."""
        c = self.config
        if c is None or c.rate_per_sec is None:
            return
        tb = self._buckets.get(tenant)
        if tb is None:
            burst = c.burst if c.burst is not None else max(1.0, c.rate_per_sec)
            tb = self._buckets[tenant] = TokenBucket(
                c.rate_per_sec, burst, now=now
            )
        if not tb.try_take(now):
            raise AdmissionRejected(
                f"tenant {tenant!r} over rate limit "
                f"({c.rate_per_sec}/s, burst {tb.burst:g}); slow down",
                tenant=tenant, reason="rate",
            )

    def acquire_slot(self, tenant: str) -> None:
        """Claim one pending slot; raises AdmissionRejected("quota")."""
        c = self.config
        held = self._pending.get(tenant, 0)
        if (
            c is not None
            and c.max_pending_per_tenant is not None
            and held >= c.max_pending_per_tenant
        ):
            raise AdmissionRejected(
                f"tenant {tenant!r} has {held} requests pending "
                f"(max_pending_per_tenant={c.max_pending_per_tenant})",
                tenant=tenant, reason="quota",
            )
        self._pending[tenant] = held + 1

    def release_slot(self, tenant: str) -> None:
        held = self._pending.get(tenant, 0)
        if held <= 1:
            self._pending.pop(tenant, None)
        else:
            self._pending[tenant] = held - 1

    def pending_of(self, tenant: str) -> int:
        return self._pending.get(tenant, 0)

    @property
    def total_pending(self) -> int:
        return sum(self._pending.values())

    def pending_by_tenant(self) -> dict[str, int]:
        return dict(self._pending)


# --------------------------------------------------------------- breaker


def _jitter_u(seed: int, attempt: int) -> float:
    """Deterministic uniform in [-1, 1) keyed by (breaker, open count) —
    probes are de-synchronized across buckets without wall-clock
    randomness, so virtual-clock tests can predict the exact probe time."""
    h = zlib.crc32(f"{seed}:{attempt}".encode()) & 0xFFFFFFFF
    return (h / 2**31) - 1.0


@dataclass
class CircuitBreaker:
    """closed → open → half-open breaker for one gateway bucket.

    Opens on either signal (DESIGN.md §10.2):
      * ``failure_threshold`` CONSECUTIVE sweep failures (the sweep
        raised — kernel build or launch error, transport death,
        pathological config);
      * the EWMA of the bucket's per-flush unverified-rate exceeding
        ``max_unverified_rate`` after ``min_samples`` flushes.

    While open, ``allow()`` answers "open" (the gateway fast-fails or
    detours direct) until the cooldown elapses; then exactly ONE "probe"
    is granted (half-open). The probe request flushes through the normal
    sweep; its outcome closes the breaker (success: full reset) or
    re-opens it with doubled cooldown. Cooldowns are
    base·2^(opens−1) capped at max, ±jitter drawn deterministically from
    the bucket identity — no thundering herd, no flaky tests.
    """

    config: object  # configs.spdc.BreakerConfig
    seed: int = 0
    state: str = "closed"  # "closed" | "open" | "half_open"
    consecutive_failures: int = 0
    opens: int = 0  # lifetime open transitions (drives backoff)
    next_probe_at: float = 0.0
    unverified_ewma: float = 0.0
    samples: int = 0
    #: set while a half-open probe's flush is in flight
    probe_pending: bool = field(default=False, repr=False)

    def _cooldown(self) -> float:
        c = self.config
        base = c.cooldown_base_s * (2.0 ** max(self.opens - 1, 0))
        base = min(base, c.cooldown_max_s)
        return max(base * (1.0 + c.probe_jitter * _jitter_u(self.seed, self.opens)),
                   1e-9)

    def _trip(self, now: float) -> None:
        self.state = "open"
        self.opens += 1
        self.probe_pending = False
        self.next_probe_at = now + self._cooldown()

    def allow(self, now: float) -> str:
        """Admission verdict for one submission: "ok" | "probe" | "open"."""
        if not self.config.enabled or self.state == "closed":
            return "ok"
        if self.state == "open" and now >= self.next_probe_at:
            self.state = "half_open"
            self.probe_pending = True
            return "probe"
        if self.state == "half_open" and not self.probe_pending:
            # previous probe was admitted but its flush hasn't reported
            # yet — shouldn't happen (probe_pending guards it), but a
            # second probe is never granted
            return "open"
        return "open"

    def retry_after(self, now: float) -> float:
        return max(0.0, self.next_probe_at - now)

    def revert_probe(self) -> None:
        """Undo an ``allow() == "probe"`` grant whose request never made
        it into the queue (shed by quota or gateway capacity after the
        verdict). ``next_probe_at`` is left unchanged — it is already in
        the past — so the NEXT submission gets a fresh probe instead of
        the bucket fast-failing forever on a probe that no flush will
        ever ``record()``."""
        if self.state == "half_open" and self.probe_pending:
            self.state = "open"
            self.probe_pending = False

    def record(self, now: float, *, failed: bool, unverified_rate: float = 0.0) -> str:
        """Feed one flush outcome; returns the resulting state.

        ``failed`` — the sweep raised. ``unverified_rate`` — fraction of
        the flush's REAL requests (padding dummies excluded) that failed
        verification; only meaningful when the sweep completed.
        """
        if not self.config.enabled:
            return self.state
        if self.state == "half_open":
            self.probe_pending = False
            if failed or (
                self.config.max_unverified_rate is not None
                and unverified_rate > self.config.max_unverified_rate
            ):
                self._trip(now)  # probe failed: re-open, doubled cooldown
            else:
                self.reset()  # probe verified: full recovery
            return self.state
        if failed:
            self.consecutive_failures += 1
            if self.consecutive_failures >= self.config.failure_threshold:
                self._trip(now)
            return self.state
        self.consecutive_failures = 0
        if self.config.max_unverified_rate is not None:
            a = self.config.unverified_alpha
            self.unverified_ewma = (
                a * unverified_rate + (1.0 - a) * self.unverified_ewma
            )
            self.samples += 1
            if (
                self.samples >= self.config.min_samples
                and self.unverified_ewma > self.config.max_unverified_rate
            ):
                self._trip(now)
        return self.state

    def reset(self) -> None:
        self.state = "closed"
        self.consecutive_failures = 0
        self.unverified_ewma = 0.0
        self.samples = 0
        self.probe_pending = False
        # `opens` is NOT reset: a bucket that keeps flapping keeps paying
        # longer cooldowns, which is the point of the backoff


# ----------------------------------------------------------------- cache


class ResultCache:
    """Bounded LRU for verified determinant results (cache-aside,
    DESIGN.md §10.3).

    Keys are (BucketKey, tenant, content-digest) tuples built by the
    gateway: the digest covers the exact matrix bytes + shape + dtype,
    and the BucketKey carries the complete security tuple — so a hit can
    never cross security configs, compute dtypes, transports, or tenants.
    Only VERIFIED results are stored; failures and rejected verdicts are
    never cached (a poisoned answer must not outlive its sweep).
    """

    def __init__(self, max_entries: int):
        if max_entries < 1:
            raise ValueError("cache max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._data: "OrderedDict[object, object]" = OrderedDict()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key):
        val = self._data.get(key)
        if val is not None:
            self._data.move_to_end(key)
        return val

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()
