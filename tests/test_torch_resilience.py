"""Unit tier of the port's gateway resilience and observability
primitives (mirrors tests/test_resilience.py; DESIGN.md §10): the token
bucket and admission controller's typed rejections, the per-bucket
circuit breaker's state machine on an explicit clock, the bounded LRU
result cache, the deterministic streaming quantile sketch, and the
schema-versioned metrics snapshot and its text renderings. Pure
bookkeeping — no torch, no gateway, no wall time.

Against the reference, on the same inputs and event streams: breaker
transitions and probe times, token-bucket grants, quantile estimates and
the snapshot, /metrics and /healthz renderings equal.
"""
import json

import numpy as np
import pytest

import repro.serve as r_serve
import repro_torch.serve as t_serve
from repro.configs import AdmissionConfig as RAdmissionConfig
from repro.configs import BreakerConfig as RBreakerConfig
from repro_torch.configs import AdmissionConfig, BreakerConfig
from repro_torch.serve import (
    AdmissionController,
    AdmissionRejected,
    CircuitBreaker,
    FlushEvent,
    GatewayMetrics,
    MetricsSnapshot,
    QuantileSketch,
    RejectEvent,
    ResultCache,
    TokenBucket,
    VerdictEvent,
    render_healthz,
    render_prometheus,
)

# ------------------------------------------------------------ token bucket


def test_token_bucket_starts_full_and_refills():
    tb = TokenBucket(rate=2.0, burst=4.0, now=0.0)
    assert all(tb.try_take(0.0) for _ in range(4))  # burst drains
    assert not tb.try_take(0.0)
    assert not tb.try_take(0.4)  # 0.8 tokens banked, need 1
    assert tb.try_take(0.5)  # 1.0 banked at rate 2/s
    assert tb.try_take(10.0)  # long idle refills, capped at burst
    assert sum(tb.try_take(10.0) for _ in range(10)) == 3  # burst-1 left


def test_token_bucket_ignores_clock_regression():
    tb = TokenBucket(rate=1.0, burst=1.0, now=5.0)
    assert tb.try_take(5.0)
    # a now() earlier than the last refill must not mint (or burn) tokens
    assert not tb.try_take(4.0)
    assert tb.try_take(6.0)


def test_token_bucket_validates():
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=1.0, burst=0.0)


# ------------------------------------------------------- admission control


def test_admission_rate_limit_is_per_tenant_and_typed():
    adm = AdmissionController(AdmissionConfig(rate_per_sec=1.0, burst=2.0))
    adm.charge("a", 0.0)
    adm.charge("a", 0.0)
    with pytest.raises(AdmissionRejected) as ei:
        adm.charge("a", 0.0)
    assert ei.value.tenant == "a" and ei.value.reason == "rate"
    # tenant b has its own bucket — a's exhaustion never touches it
    adm.charge("b", 0.0)
    # and a refills with time
    adm.charge("a", 1.5)


def test_admission_quota_tracks_slots_and_unwinds():
    adm = AdmissionController(AdmissionConfig(max_pending_per_tenant=2))
    adm.acquire_slot("a")
    adm.acquire_slot("a")
    with pytest.raises(AdmissionRejected) as ei:
        adm.acquire_slot("a")
    assert ei.value.reason == "quota"
    adm.acquire_slot("b")  # other tenants unaffected
    adm.release_slot("a")
    adm.acquire_slot("a")  # freed slot is reusable
    assert adm.pending_of("a") == 2
    assert adm.total_pending == 3
    for _ in range(2):
        adm.release_slot("a")
    adm.release_slot("b")
    assert adm.total_pending == 0
    assert adm.pending_by_tenant() == {}


def test_admission_disabled_is_a_noop():
    adm = AdmissionController(None)
    assert not adm.enabled
    for _ in range(1000):
        adm.charge("t", 0.0)
        adm.acquire_slot("t")
    assert adm.pending_of("t") == 1000  # accounting still works


def test_admission_config_validates():
    with pytest.raises(ValueError):
        AdmissionConfig(rate_per_sec=0.0)
    with pytest.raises(ValueError):
        AdmissionConfig(rate_per_sec=1.0, burst=0.0)
    with pytest.raises(ValueError):
        AdmissionConfig(max_pending_per_tenant=0)


# ------------------------------------------- breaker state machine (§10.2)


def _breaker(**kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("cooldown_base_s", 1.0)
    kw.setdefault("probe_jitter", 0.0)  # exact probe times for assertions
    kw.setdefault("max_unverified_rate", 0.5)
    kw.setdefault("min_samples", 4)
    return CircuitBreaker(BreakerConfig(**kw), seed=7)


def test_breaker_opens_at_consecutive_failure_threshold():
    br = _breaker()
    assert br.record(0.0, failed=True) == "closed"
    assert br.record(1.0, failed=True) == "closed"
    assert br.allow(1.5) == "ok"  # still closed: admits normally
    assert br.record(2.0, failed=True) == "open"  # third consecutive trips
    assert br.allow(2.1) == "open"


def test_breaker_success_resets_consecutive_count():
    br = _breaker()
    br.record(0.0, failed=True)
    br.record(1.0, failed=True)
    br.record(2.0, failed=False)  # streak broken
    br.record(3.0, failed=True)
    br.record(4.0, failed=True)
    assert br.state == "closed"  # 2 < threshold again
    assert br.record(5.0, failed=True) == "open"


def test_breaker_half_open_admits_exactly_one_probe():
    br = _breaker()
    for t in (0.0, 1.0, 2.0):
        br.record(t, failed=True)
    assert br.state == "open"
    assert br.allow(2.5) == "open"  # cooldown (1s) not elapsed
    assert br.allow(3.0) == "probe"  # exactly at next_probe_at
    assert br.state == "half_open"
    # a second submission while the probe is in flight is NOT admitted
    assert br.allow(3.1) == "open"
    assert br.allow(100.0) == "open"


def test_breaker_probe_success_closes_and_failure_reopens_with_backoff():
    br = _breaker()
    for t in (0.0, 1.0, 2.0):
        br.record(t, failed=True)
    assert br.allow(3.0) == "probe"
    assert br.record(3.5, failed=True) == "open"  # probe failed: re-trip
    # backoff doubled: second open waits base·2^1 = 2s
    assert br.allow(4.5) == "open"
    assert br.allow(5.5) == "probe"
    assert br.record(5.6, failed=False) == "closed"  # probe verified
    assert br.allow(5.7) == "ok"
    # `opens` survives the close: the NEXT trip pays the longer cooldown
    for t in (6.0, 6.1, 6.2):
        br.record(t, failed=True)
    assert br.state == "open"
    assert br.allow(9.0) == "open"  # base·2^2 = 4s now
    assert br.allow(10.2) == "probe"


def test_breaker_revert_probe_restores_reprobeable_open():
    """Regression: a granted probe whose request is shed before enqueue
    (quota / capacity) must be revocable — revert_probe() returns to
    "open" with next_probe_at untouched, so the NEXT submission re-probes
    instead of the bucket fast-failing forever on a probe that no flush
    will ever record()."""
    br = _breaker()
    for t in (0.0, 1.0, 2.0):
        br.record(t, failed=True)
    assert br.allow(3.0) == "probe"
    br.revert_probe()  # the probe's request never made it into the queue
    assert br.state == "open" and not br.probe_pending
    assert br.retry_after(3.0) == 0.0  # still due, not pushed out
    assert br.allow(3.0) == "probe"  # grant is re-issued immediately
    assert br.record(3.5, failed=False) == "closed"
    br.revert_probe()  # no-op outside a pending probe
    assert br.state == "closed"


def test_breaker_cooldown_caps_at_max():
    br = _breaker(cooldown_base_s=1.0, cooldown_max_s=4.0)
    for round_ in range(6):  # trip, fail the probe, repeat
        if br.state == "closed":
            t = float(round_ * 100)
            for dt in (0.0, 0.1, 0.2):
                br.record(t + dt, failed=True)
        assert br.state == "open"
        assert br.next_probe_at - (br.next_probe_at - br._cooldown()) <= 4.0 + 1e-9
        assert br.allow(br.next_probe_at) == "probe"
        br.record(br.next_probe_at + 0.01, failed=True)


def test_breaker_unverified_rate_ewma_trips_after_min_samples():
    br = _breaker(failure_threshold=100)  # isolate the verification signal
    # sweeps complete but most results fail verification
    for i in range(3):
        assert br.record(float(i), failed=False, unverified_rate=1.0) == "closed"
    # 4th sample crosses min_samples with EWMA ~1.0 > 0.5
    assert br.record(3.0, failed=False, unverified_rate=1.0) == "open"


def test_breaker_healthy_stream_never_trips():
    br = _breaker()
    for i in range(200):
        assert br.record(float(i), failed=False, unverified_rate=0.0) == "closed"
    assert br.opens == 0


def test_breaker_jitter_is_deterministic_and_bounded():
    cfg = BreakerConfig(probe_jitter=0.2, cooldown_base_s=1.0)
    a1 = CircuitBreaker(cfg, seed=1)
    a2 = CircuitBreaker(cfg, seed=1)
    b = CircuitBreaker(cfg, seed=2)
    for br in (a1, a2, b):
        for t in (0.0, 0.1, 0.2):
            br.record(t, failed=True)
    assert a1.next_probe_at == a2.next_probe_at  # same seed: same schedule
    assert a1.next_probe_at != b.next_probe_at  # probes de-synchronized
    for br in (a1, b):
        cd = br.next_probe_at - 0.2
        assert 0.8 - 1e-9 <= cd <= 1.2 + 1e-9  # within ±jitter of base


def test_breaker_disabled_never_blocks():
    br = CircuitBreaker(BreakerConfig(enabled=False), seed=0)
    for t in range(50):
        br.record(float(t), failed=True)
        assert br.allow(float(t)) == "ok"


def test_breaker_config_validates():
    with pytest.raises(ValueError):
        BreakerConfig(failure_threshold=0)
    with pytest.raises(ValueError):
        BreakerConfig(max_unverified_rate=1.5)
    with pytest.raises(ValueError):
        BreakerConfig(on_open="explode")


# ------------------------------------------------------------ result cache


def test_result_cache_lru_bound_and_evictions():
    c = ResultCache(max_entries=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # touch: a becomes most-recent
    c.put("c", 3)  # evicts b (LRU), not a
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert len(c) == 2 and c.evictions == 1
    with pytest.raises(ValueError):
        ResultCache(max_entries=0)


# -------------------------------------------------------- quantile sketch


def test_sketch_exact_until_capacity():
    s = QuantileSketch(capacity=64)
    for v in range(50):
        s.observe(float(v))
    assert s.quantile(0.0) == 0.0 and s.quantile(1.0) == 49.0
    assert s.quantile(0.5) == pytest.approx(24.0, abs=1.0)
    assert s.mean == pytest.approx(24.5)


def test_sketch_bounded_memory_and_graceful_accuracy():
    s = QuantileSketch(capacity=64)
    n = 100_000
    for v in range(n):
        s.observe(float(v))
    assert len(s._items) <= 64  # memory bound holds under a long stream
    assert s.count == n
    assert s.min == 0.0 and s.max == float(n - 1)  # extremes exact
    # estimates stay within a few compressed-resolution steps
    assert s.quantile(0.5) == pytest.approx(n / 2, rel=0.15)
    assert s.quantile(0.99) == pytest.approx(0.99 * n, rel=0.15)


def test_sketch_deterministic():
    a, b = QuantileSketch(capacity=32), QuantileSketch(capacity=32)
    vals = [(i * 37) % 1000 for i in range(5000)]
    for v in vals:
        a.observe(v)
        b.observe(v)
    for q in (0.1, 0.5, 0.9, 0.99):
        assert a.quantile(q) == b.quantile(q)


def test_sketch_empty_and_validation():
    s = QuantileSketch()
    assert s.quantile(0.5) is None and s.mean is None
    assert s.summary()["count"] == 0
    with pytest.raises(ValueError):
        QuantileSketch(capacity=4)


# ------------------------------------------- metrics registry + snapshot


def _populated_metrics():
    m = GatewayMetrics()
    m.record_submit("a")
    m.record_submit("a")
    m.record_submit("b")
    m.record_flush(FlushEvent(
        bucket="n8.N2.float64.ewd-q3#0000", reason="full", batch=2,
        padded_batch=2, queue_waits_s=(0.001, 0.002), sweep_s=0.05,
    ))
    m.record_verdict(VerdictEvent(
        rid=0, bucket="n8.N2.float64.ewd-q3#0000", tenant="a",
        verified=True, latency_s=0.051, flush_reason="full",
    ))
    m.record_verdict(VerdictEvent(
        rid=1, bucket="n8.N2.float64.ewd-q3#0000", tenant="a",
        verified=False, latency_s=0.052, flush_reason="full",
    ))
    m.record_reject(RejectEvent(reason="rate", tenant="b"))
    return m


#: the SCHEMA_VERSION=1 compatibility contract: dashboards key on these.
#: Widening the snapshot requires adding the key HERE and bumping the
#: version — that is the point of the test.
_V1_TOP_KEYS = {
    "schema_version", "counters", "pending", "request_latency_s",
    "buckets", "tenants", "cache",
}
_V1_COUNTER_KEYS = {
    "submitted", "admitted", "served", "failed", "direct",
    "rejected_overload", "rejected_rate", "rejected_quota",
    "rejected_breaker", "cache_hits", "cache_misses", "coalesced",
    "breaker_opens", "breaker_probes", "breaker_closes",
}
_V1_BUCKET_KEYS = {
    "depth", "breaker", "flushes", "requests", "verified", "unverified",
    "failed", "recovered_flushes", "sweep_errors", "flush_size",
    "queue_wait_s", "sweep_s",
}
_V1_TENANT_KEYS = {
    "pending", "submitted", "served", "rejected_rate", "rejected_quota",
    "rejected_overload", "rejected_breaker",
}
_V1_CACHE_KEYS = {"entries", "hits", "misses", "coalesced", "hit_rate",
                  "evictions"}
_V1_SUMMARY_KEYS = {"count", "mean", "min", "max", "p50", "p90", "p99"}


def test_snapshot_schema_v1_is_stable():
    assert MetricsSnapshot.SCHEMA_VERSION == 1
    d = _populated_metrics().snapshot().as_dict()
    assert set(d) == _V1_TOP_KEYS
    assert d["schema_version"] == 1
    assert set(d["counters"]) == _V1_COUNTER_KEYS
    assert set(d["request_latency_s"]) == _V1_SUMMARY_KEYS
    for b in d["buckets"].values():
        assert set(b) == _V1_BUCKET_KEYS
        for series in ("flush_size", "queue_wait_s", "sweep_s"):
            assert set(b[series]) == _V1_SUMMARY_KEYS
    for t in d["tenants"].values():
        assert set(t) == _V1_TENANT_KEYS
    assert set(d["cache"]) == _V1_CACHE_KEYS
    json.dumps(d)  # the whole snapshot must be JSON-serializable


def test_snapshot_folds_live_gauges():
    m = _populated_metrics()
    snap = m.snapshot(gauges={
        "pending": 3,
        "buckets": {
            "n8.N2.float64.ewd-q3#0000": {"depth": 3, "breaker": "open"},
            "n16.N2.float64.ewd-q3#0000": {"breaker": "half_open"},
        },
        "tenant_pending": {"a": 3},
        "cache_entries": 5,
        "cache_evictions": 1,
    })
    assert snap.pending == 3
    b = snap.buckets["n8.N2.float64.ewd-q3#0000"]
    assert b["depth"] == 3 and b["breaker"] == "open"
    # a bucket with a live gauge but no recorded flushes still surfaces
    assert snap.buckets["n16.N2.float64.ewd-q3#0000"]["breaker"] == "half_open"
    assert sorted(snap.open_breakers) == [
        "n16.N2.float64.ewd-q3#0000", "n8.N2.float64.ewd-q3#0000"]
    assert snap.tenants["a"]["pending"] == 3
    assert snap.cache["entries"] == 5 and snap.cache["evictions"] == 1


def test_tenant_isolation_in_metrics():
    snap = _populated_metrics().snapshot()
    assert snap.tenants["a"]["submitted"] == 2
    assert snap.tenants["b"]["submitted"] == 1
    assert snap.tenants["b"]["rejected_rate"] == 1
    assert snap.tenants["a"]["rejected_rate"] == 0


def test_tenant_served_excludes_failures():
    """Per-tenant served mirrors the global served/failed split: a
    request that completed WITH an error is failed, not served."""
    m = GatewayMetrics()
    m.record_verdict(VerdictEvent(
        rid=0, bucket="b", tenant="a", verified=True, latency_s=0.01,
        flush_reason="full"))
    m.record_verdict(VerdictEvent(
        rid=1, bucket="b", tenant="a", verified=False, latency_s=0.01,
        flush_reason="full", error="sweep raised"))
    snap = m.snapshot()
    assert snap.tenants["a"]["served"] == 1
    assert snap.counters["served"] == 1 and snap.counters["failed"] == 1


def test_render_prometheus_grammar():
    snap = _populated_metrics().snapshot(gauges={
        "buckets": {"n8.N2.float64.ewd-q3#0000": {"breaker": "open"}},
    })
    text = render_prometheus(snap)
    assert "spdc_gateway_submitted_total 3" in text
    assert 'spdc_gateway_bucket_verified{bucket="n8.N2.float64.ewd-q3#0000"} 1' in text
    assert ('spdc_gateway_breaker_state{bucket="n8.N2.float64.ewd-q3#0000",'
            'state="open"} 1') in text
    assert ('spdc_gateway_breaker_state{bucket="n8.N2.float64.ewd-q3#0000",'
            'state="closed"} 0') in text
    # every line is `name value` or `name{labels} value`
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        assert name and (value == "NaN" or float(value) == float(value))


def test_render_healthz_verdicts():
    m = _populated_metrics()
    assert render_healthz(m.snapshot())["status"] == "ok"
    degraded = m.snapshot(gauges={"buckets": {"x": {"breaker": "open"}}})
    assert render_healthz(degraded)["status"] == "degraded"
    over = m.snapshot(gauges={"pending": 64})
    assert render_healthz(over, max_pending=64)["status"] == "overloaded"
    body = render_healthz(m.snapshot())
    assert body["rejected"] == 1  # the one rate reject


# ------------------------------------------------ against the reference


def _event_stream(seed, serve):
    """A seeded stream of submissions, flushes, verdicts and rejections
    over three buckets and three tenants, built from `serve`'s event
    classes."""
    rng = np.random.default_rng(seed)
    buckets = ["n8.N2.float64.ewd-q3#0000", "n16.N2.float64.ewd-q3#0000",
               "n16.N2.float32.ewd-q3#1a2b"]
    events = []
    rid = 0
    for _ in range(400):
        tenant = f"t{int(rng.integers(0, 3))}"
        kind = int(rng.integers(0, 4))
        bucket = buckets[int(rng.integers(0, 3))]
        if kind == 0:
            events.append(("submit", tenant))
        elif kind == 1:
            b = int(rng.integers(1, 9))
            events.append(("flush", serve.FlushEvent(
                bucket=bucket, reason=["full", "timeout", "drain"][b % 3],
                batch=b, padded_batch=1 << (b - 1).bit_length(),
                queue_waits_s=tuple(float(w) for w in rng.exponential(
                    1e-3, b)),
                sweep_s=float(rng.exponential(0.05)),
                recovered=bool(rng.integers(0, 5) == 0),
                error="boom" if rng.integers(0, 20) == 0 else None)))
        elif kind == 2:
            err = "sweep raised" if rng.integers(0, 10) == 0 else None
            events.append(("verdict", serve.VerdictEvent(
                rid=rid, bucket=bucket, tenant=tenant,
                verified=err is None and bool(rng.integers(0, 8)),
                latency_s=float(rng.exponential(0.02)),
                flush_reason="full", cache_hit=bool(rng.integers(0, 6) == 0),
                error=err)))
            rid += 1
        else:
            events.append(("reject", serve.RejectEvent(
                reason=["rate", "quota", "overload", "breaker"][
                    int(rng.integers(0, 4))],
                tenant=tenant, bucket=bucket)))
    return events


def _replay(metrics, events):
    for kind, ev in events:
        if kind == "submit":
            metrics.record_submit(ev)
        else:
            getattr(metrics, f"record_{kind}")(ev)
    return metrics


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_renderings_match_reference(seed):
    """The same event stream into both registries: equal snapshots
    (schema v1), byte-identical /metrics text and equal /healthz."""
    gauges = {
        "pending": 7,
        "buckets": {"n8.N2.float64.ewd-q3#0000": {"depth": 3,
                                                  "breaker": "open"},
                    "n16.N2.float64.ewd-q3#0000": {"depth": 4,
                                                   "breaker": "closed"}},
        "tenant_pending": {"t0": 3, "t1": 4},
        "cache_entries": 5,
        "cache_evictions": 2,
    }
    want = _replay(r_serve.GatewayMetrics(), _event_stream(seed, r_serve))
    got = _replay(GatewayMetrics(), _event_stream(seed, t_serve))
    for g in (None, gauges):
        ws, gs = want.snapshot(gauges=g), got.snapshot(gauges=g)
        assert gs.as_dict() == ws.as_dict()
        assert render_prometheus(gs) == r_serve.render_prometheus(ws)
        for max_pending in (None, 7):
            assert render_healthz(gs, max_pending=max_pending) \
                == r_serve.render_healthz(ws, max_pending=max_pending)


def test_breaker_and_token_bucket_match_reference():
    """The same seeded outcome stream through both packages' breakers
    (jittered probes included) and token buckets: equal states, probe
    times and grants at every step."""
    rng = np.random.default_rng(3)
    kw = dict(failure_threshold=2, cooldown_base_s=0.5, probe_jitter=0.2,
              max_unverified_rate=0.5, min_samples=2)
    got = CircuitBreaker(BreakerConfig(**kw), seed=11)
    want = r_serve.CircuitBreaker(RBreakerConfig(**kw), seed=11)
    tb, rtb = TokenBucket(3.0, 4.0, now=0.0), r_serve.TokenBucket(
        3.0, 4.0, now=0.0)
    t = 0.0
    for _ in range(300):
        t += float(rng.exponential(0.2))
        assert got.allow(t) == want.allow(t)
        failed = bool(rng.integers(0, 3) == 0)
        rate = float(rng.uniform(0, 1))
        assert got.record(t, failed=failed, unverified_rate=rate) \
            == want.record(t, failed=failed, unverified_rate=rate)
        assert (got.state, got.opens, got.next_probe_at) \
            == (want.state, want.opens, want.next_probe_at)
        assert got.retry_after(t) == want.retry_after(t)
        assert tb.try_take(t) == rtb.try_take(t)
    adm = AdmissionController(AdmissionConfig(rate_per_sec=2.0, burst=3.0,
                                              max_pending_per_tenant=2))
    radm = r_serve.AdmissionController(RAdmissionConfig(
        rate_per_sec=2.0, burst=3.0, max_pending_per_tenant=2))
    for i in range(100):
        outcomes = []
        for a, exc in ((adm, AdmissionRejected),
                       (radm, r_serve.AdmissionRejected)):
            try:
                a.charge(f"t{i % 3}", i * 0.1)
                a.acquire_slot(f"t{i % 3}")
                outcomes.append("ok")
            except exc as e:
                outcomes.append(e.reason)
            if i % 4 == 3 and a.pending_of(f"t{(i + 1) % 3}"):
                a.release_slot(f"t{(i + 1) % 3}")
        assert outcomes[0] == outcomes[1]
    assert adm.pending_by_tenant() == radm.pending_by_tenant()


def test_quantile_sketch_matches_reference():
    got, want = QuantileSketch(capacity=32), r_serve.QuantileSketch(
        capacity=32)
    for v in np.random.default_rng(5).lognormal(size=5000):
        got.observe(float(v))
        want.observe(float(v))
    assert got.summary() == want.summary()
