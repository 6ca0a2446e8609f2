"""Overload & chaos tier of the port's hardened gateway on the CPU
(mirrors tests/test_overload.py; DESIGN.md §10).

Everything here is deterministic: arrivals come from seeded Poisson
processes mapped onto the injected virtual clock, breaker probe timing
uses zero (or seeded) jitter, and chaos is injected through the gateway's
``faults_for`` hook — no wall-clock sleeps outside the asyncio case.

Covered as in the reference: open-loop overload at 8× the admitted rate,
rejection storms leaving no half-enqueued state (sync and async), the
breaker opening on a poisoned bucket and recovering through a half-open
probe, idempotency-cache correctness, single-flight coalescing, the
(n, dtype) dummy-cache regression and a property test against the
sequential direct-call oracle. Against the reference: the same overload
storm through both gateways gives equal stats, rejections and /metrics
text.
"""
import asyncio

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

try:
    from hypothesis import example
except ImportError:  # the deterministic stub (tests/_hypothesis_stub.py)
    def example(**_):
        return lambda fn: fn

from repro.configs import AdmissionConfig as RAdmissionConfig
from repro.configs import BreakerConfig as RBreakerConfig
from repro.configs import SPDCConfig as RSPDCConfig
from repro.configs import SPDCGatewayConfig as RGatewayConfig
from repro.serve import AdmissionRejected as RAdmissionRejected
from repro.serve import GatewayOverloaded as RGatewayOverloaded
from repro.serve import SPDCGateway as RGateway
from repro_torch.configs import (
    AdmissionConfig,
    BreakerConfig,
    CacheConfig,
    SPDCConfig,
    SPDCGatewayConfig,
)
from repro_torch.core import ServerFault, outsource_determinant
from repro_torch.serve import (
    AdmissionRejected,
    AsyncSPDCGateway,
    BreakerOpen,
    GatewayOverloaded,
    SPDCGateway,
)
from repro_torch.serve.spdc_gateway import _DUMMY_CACHE_MAX

CPU = "cpu"


def _mat(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _cfg(**kw):
    kw.setdefault("buckets", (8, 16))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_us", 1000.0)
    kw.setdefault("spdc", SPDCConfig(num_servers=2))
    return SPDCGatewayConfig(name="test-gw", **kw)


def _nojitter(**kw):
    kw.setdefault("probe_jitter", 0.0)
    return BreakerConfig(**kw)


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


# ------------------------------------------------ open-loop overload (8×)


def test_overload_8x_bounded_p99_and_zero_loss():
    """Open-loop Poisson arrivals at 8× the admitted rate: every admitted
    request completes verified with bounded (virtual) p99 latency, every
    shed request is a TYPED, counted rejection, and after the storm every
    gauge — queue, tenant slots, single-flight table — is back to zero."""
    admit_rate = 50.0  # tokens/s
    cfg = _cfg(
        buckets=(8,), max_batch=4, max_wait_us=5000.0, max_pending=16,
        admission=AdmissionConfig(rate_per_sec=admit_rate, burst=5.0),
        breaker=_nojitter(),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock)
    rng = np.random.default_rng(42)
    n_arrivals = 300
    offered = 8 * admit_rate
    admitted, rejections = [], {"rate": 0, "overload": 0}
    for i in range(n_arrivals):
        clock.t += rng.exponential(1.0 / offered)
        gw.poll()
        try:
            admitted.append(gw.submit(_mat(4 + i % 5, seed=1000 + i)))
        except AdmissionRejected as e:
            assert e.reason in ("rate", "quota")
            rejections["rate"] += 1
        except GatewayOverloaded:
            rejections["overload"] += 1
    # drain the tail through the normal timeout path, not drain(): flush
    # reasons and latencies stay exactly what a live gateway would see
    for _ in range(100):
        if not gw.pending:
            break
        clock.t += 1e-3
        gw.poll()
    assert gw.pending == 0

    results = [gw.take(r) for r in admitted]
    assert all(r is not None for r in results)  # zero lost requests
    assert all(r.verified and r.error is None for r in results)
    lat = [r.latency_s for r in results]
    # sharp bound: worst admitted wait is the timeout budget (5ms) plus
    # the largest arrival gap until the next poll (the exponential tail
    # reaches ~13ms under this seed) — deterministic, so 20ms is tight
    assert _quantile(lat, 0.99) <= 0.020
    # the storm actually shed: ~7/8 of offered load rejected, all typed
    assert rejections["rate"] + rejections["overload"] == n_arrivals - len(admitted)
    assert rejections["rate"] > n_arrivals // 2
    assert gw.stats.rejected_admission == rejections["rate"]
    assert gw.stats.rejected == rejections["overload"]
    assert gw.stats.served == len(admitted)

    # post-storm: every gauge back to zero, nothing half-enqueued
    snap = gw.metrics_snapshot()
    assert snap.pending == 0
    assert all(b["depth"] == 0 for b in snap.buckets.values())
    assert snap.tenants["default"]["pending"] == 0
    assert gw._admission.total_pending == 0
    assert gw._inflight == {}
    assert snap.counters["admitted"] == len(admitted)
    assert snap.counters["served"] == len(admitted)
    assert snap.counters["rejected_rate"] == rejections["rate"]
    assert snap.counters["rejected_overload"] == rejections["overload"]
    assert gw.healthz()["status"] == "ok"


def test_overload_per_tenant_isolation():
    """A greedy tenant burning 10× its rate collects rejections; a polite
    tenant submitting under ITS rate is never shed — admission is per
    tenant, not per gateway."""
    cfg = _cfg(
        buckets=(8,), max_wait_us=1e9,
        admission=AdmissionConfig(rate_per_sec=20.0, burst=2.0),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, auto_flush=False)
    polite_rejects = greedy_rejects = 0
    seed = 0
    for step in range(200):  # 1 virtual second
        clock.t = step * 5e-3
        seed += 1
        try:  # greedy: every 5ms = 200/s against a 20/s budget
            gw.submit(_mat(4, seed=seed), tenant="greedy")
        except AdmissionRejected as e:
            assert e.tenant == "greedy"
            greedy_rejects += 1
        if step % 10 == 0:  # polite: 20/s exactly at budget
            seed += 1
            try:
                gw.submit(_mat(5, seed=seed), tenant="polite")
            except AdmissionRejected:
                polite_rejects += 1
        gw.poll()
    gw.drain()
    assert polite_rejects == 0
    assert greedy_rejects > 100
    snap = gw.metrics_snapshot()
    assert snap.tenants["polite"]["rejected_rate"] == 0
    assert snap.tenants["greedy"]["rejected_rate"] == greedy_rejects


def test_rejection_storm_leaves_no_half_enqueued_state():
    """Satellite: every rejection path (rate, quota, overload, breaker)
    unwinds completely — submitted/pending/slot counters return to their
    pre-storm values and later service is unaffected."""
    cfg = _cfg(
        buckets=(8,), max_batch=2, max_wait_us=1e9, max_pending=2,
        admission=AdmissionConfig(rate_per_sec=1000.0, burst=1000.0,
                                  max_pending_per_tenant=1),
        breaker=_nojitter(),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, auto_flush=False)
    r0 = gw.submit(_mat(4, seed=1), tenant="a")  # a's quota now full
    for i in range(20):  # quota storm
        with pytest.raises(AdmissionRejected) as ei:
            gw.submit(_mat(4, seed=100 + i), tenant="a")
        assert ei.value.reason == "quota"
    r1 = gw.submit(_mat(4, seed=2), tenant="b")  # gateway-wide cap now full
    for i in range(20):  # overload storm
        with pytest.raises(GatewayOverloaded):
            gw.submit(_mat(4, seed=200 + i), tenant="c")
    assert gw.pending == 2
    assert gw._admission.pending_by_tenant() == {"a": 1, "b": 1}
    assert gw.stats.submitted == 2  # storms never half-counted
    assert gw.stats.rejected_admission == 20 and gw.stats.rejected == 20
    gw.drain()
    for rid, tenant in ((r0, "a"), (r1, "b")):
        res = gw.take(rid)
        assert res.verified and res.tenant == tenant
    assert gw.pending == 0 and gw._admission.total_pending == 0
    # the tenants whose storms were shed are not poisoned for later work
    assert gw.take(gw.submit(_mat(4, seed=300), tenant="a")) is None
    gw.drain()
    assert gw.stats.served == 3


def test_async_rejection_storm_leaks_no_futures():
    """Typed rejections propagate out of async submit() BEFORE a waiter
    future exists — a storm of them cannot strand the event loop."""
    cfg = _cfg(
        buckets=(8,), max_batch=4, max_wait_us=2000.0, max_pending=4,
        admission=AdmissionConfig(max_pending_per_tenant=2),
    )

    async def main():
        async with AsyncSPDCGateway(cfg, device=CPU) as gw:
            outcomes = await asyncio.gather(
                *(gw.submit(_mat(4, seed=400 + i), tenant=f"t{i % 2}")
                  for i in range(16)),
                return_exceptions=True,
            )
            assert gw._waiters == {}  # nothing left hanging
            assert gw.pending == 0
            return outcomes, gw.stats.as_dict()

    outcomes, stats = asyncio.run(main())
    served = [o for o in outcomes if not isinstance(o, BaseException)]
    shed = [o for o in outcomes if isinstance(o, BaseException)]
    assert len(served) + len(shed) == 16  # every submission accounted for
    assert all(isinstance(o, (AdmissionRejected, GatewayOverloaded))
               for o in shed)
    assert all(r.verified for r in served)
    assert stats["served"] == len(served)
    assert (stats["rejected"] + stats["rejected_admission"]) == len(shed)


# -------------------------------------------------------- circuit breaker


def test_breaker_opens_then_recovers_through_probe():
    """Chaos leg: a bucket whose sweeps start failing trips its breaker
    after exactly failure_threshold flushes; submissions then fast-fail
    with a retry hint; after the cooldown ONE probe is admitted, and its
    verified flush closes the breaker for good."""
    chaos = {"on": True}

    def faults_for(key):
        if chaos["on"]:
            raise RuntimeError("injected chaos: fleet unreachable")
        return None

    cfg = _cfg(
        buckets=(8,), max_batch=1, pad_batches=False,
        breaker=_nojitter(failure_threshold=3, cooldown_base_s=1.0),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
    key = gw._key_for(4, {})
    for i in range(3):  # max_batch=1: each submit flushes (and fails)
        rid = gw.submit(_mat(4, seed=500 + i))
        assert "injected chaos" in gw.take(rid).error
    assert gw.breaker_state(key) == "open"
    assert gw.stats.breaker_opens == 1

    with pytest.raises(BreakerOpen) as ei:  # fast-fail while open
        gw.submit(_mat(4, seed=510))
    assert ei.value.retry_after_s == pytest.approx(1.0)
    assert gw.stats.rejected_breaker == 1
    assert gw.healthz()["status"] == "degraded"

    clock.t = 1.0  # cooldown elapsed; next submission is THE probe
    chaos["on"] = False  # fleet healed
    probe_rid = gw.submit(_mat(4, seed=511))
    assert gw.take(probe_rid).verified
    assert gw.breaker_state(key) == "closed"
    assert gw.stats.breaker_probes == 1 and gw.stats.breaker_closes == 1
    assert gw.healthz()["status"] == "ok"
    # full service restored
    rid = gw.submit(_mat(4, seed=512))
    assert gw.take(rid).verified


def test_breaker_failed_probe_reopens_with_backoff():
    def faults_for(key):
        raise RuntimeError("still down")

    cfg = _cfg(
        buckets=(8,), max_batch=1, pad_batches=False,
        breaker=_nojitter(failure_threshold=2, cooldown_base_s=1.0),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
    for i in range(2):
        gw.submit(_mat(4, seed=520 + i))
    key = gw._key_for(4, {})
    assert gw.breaker_state(key) == "open"
    clock.t = 1.0
    gw.submit(_mat(4, seed=522))  # probe admitted... and fails
    assert gw.breaker_state(key) == "open"
    assert gw.stats.breaker_opens == 2
    with pytest.raises(BreakerOpen) as ei:
        gw.submit(_mat(4, seed=523))
    # backoff doubled: second open cools down for 2s
    assert ei.value.retry_after_s == pytest.approx(2.0)


def test_breaker_on_open_direct_degrades_instead_of_failing():
    """on_open="direct": an open bucket detours submissions to the
    un-coalesced path — clients get verified answers, just slower."""
    chaos = {"on": True}

    def faults_for(key):
        if chaos["on"]:
            raise RuntimeError("bucket chaos")
        return None

    cfg = _cfg(
        buckets=(8,), max_batch=1, pad_batches=False,
        breaker=_nojitter(failure_threshold=1, on_open="direct"),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
    gw.submit(_mat(4, seed=530))  # trips instantly (threshold 1)
    chaos["on"] = False  # direct path is healthy; bucket still open
    m = _mat(4, seed=531)
    res = gw.take(gw.submit(m))
    assert res.verified and res.flush_reason == "direct"
    ws, wl = np.linalg.slogdet(m)
    assert res.det.sign == ws and np.isclose(res.det.logabs, wl, rtol=1e-10)
    assert gw.stats.degraded_direct == 1 and gw.stats.rejected_breaker == 0


@pytest.mark.parametrize("shed", ["quota", "overload"])
def test_breaker_probe_shed_before_enqueue_is_not_lost(shed):
    """Regression: a half-open probe grant whose request is then shed by
    tenant quota or gateway capacity must revert the breaker to "open"
    with the probe still due. Before the fix, probe_pending stayed set
    with no flush ever record()ing, so every later submission fast-failed
    with retry_after 0 — the bucket was permanently unavailable."""
    chaos = {"on": True}

    def faults_for(key):
        if chaos["on"] and key.pad_to == 8:
            raise RuntimeError("bucket chaos")
        return None

    kw = (dict(max_pending=1) if shed == "overload"
          else dict(admission=AdmissionConfig(max_pending_per_tenant=1)))
    cfg = _cfg(
        buckets=(8, 16), max_batch=2, pad_batches=False,
        max_wait_us=1000.0,
        breaker=_nojitter(failure_threshold=1, cooldown_base_s=1.0),
        **kw,
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
    key8 = gw._key_for(4, {})

    # trip bucket 8 via a timeout flush (threshold 1 → opens immediately)
    gw.submit(_mat(4, seed=540))
    clock.t = 0.01
    gw.poll()
    assert gw.breaker_state(key8) == "open"

    # a pending request in the CLEAN bucket pins the tenant slot /
    # gateway capacity, so the upcoming probe will be shed post-verdict
    blocker = gw.submit(_mat(12, seed=541))
    clock.t = 1.02  # cooldown (1s after the 0.01 failure) elapsed
    chaos["on"] = False  # fleet healed — the probe WOULD succeed
    expect = GatewayOverloaded if shed == "overload" else AdmissionRejected
    for _ in range(2):  # shed twice: each revoked grant must re-arm
        with pytest.raises(expect):
            gw.submit(_mat(4, seed=542))
        # the shed probe is revoked, not consumed: back to open, still due
        assert gw.breaker_state(key8) == "open"

    clock.t = 1.03
    gw.poll()  # the overdue clean-bucket blocker flushes, freeing capacity
    assert gw.take(blocker).verified
    probe_rid = gw.submit(_mat(4, seed=543))  # THE probe, finally enqueued
    assert gw.breaker_state(key8) == "half_open"
    clock.t = 1.05
    gw.poll()
    assert gw.take(probe_rid).verified
    assert gw.breaker_state(key8) == "closed"
    assert gw.stats.breaker_closes == 1
    assert gw.healthz()["status"] == "ok"


def test_padding_failure_fails_requests_instead_of_losing_them():
    """Regression: batch padding runs after the requests are popped from
    the queue — a filler failure must route them through _fail_requests
    (typed error results, slots released), not vanish them and hang
    their waiters."""
    cfg = _cfg(
        buckets=(8,), max_batch=4, pad_batches=True, max_wait_us=1000.0,
        admission=AdmissionConfig(max_pending_per_tenant=4),
        breaker=_nojitter(),
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock)

    def boom(n_bucket, dtype="float64"):
        raise RuntimeError("filler allocation failed")

    gw._dummy = boom
    # 3 requests pad to the next allowed shape (4) → one filler needed
    rids = [gw.submit(_mat(4, seed=910 + i)) for i in range(3)]
    clock.t = 0.01
    out = gw.poll()
    assert sorted(r.rid for r in out) == sorted(rids)
    for rid in rids:
        res = gw.take(rid)
        assert res.error is not None
        assert "filler allocation failed" in res.error
    assert gw.pending == 0
    assert gw._admission.total_pending == 0  # slots released on failure
    snap = gw.metrics_snapshot()
    assert snap.counters["failed"] == 3
    assert snap.tenants["default"]["served"] == 0


def test_breaker_containment_poisoned_bucket_does_not_starve_others():
    """Acceptance: chaos pinned to ONE bucket trips only that breaker;
    the co-resident bucket's full workload still serves verified, its
    breaker never leaves closed, and its flush count matches a no-fault
    run of the same workload exactly."""
    def run(poison: bool):
        def faults_for(key):
            if poison and key.pad_to == 8:
                raise RuntimeError("poisoned bucket")
            return None

        cfg = _cfg(
            buckets=(8, 16), max_batch=2, max_wait_us=1e9,
            breaker=_nojitter(failure_threshold=2),
        )
        clock = VirtualClock()
        gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
        outcomes = {"clean_served": 0, "poisoned_failed": 0, "breaker": 0}
        for i in range(12):
            try:
                rid = gw.submit(_mat(4, seed=600 + i))  # bucket 8
                res = gw.take(rid)
                if res is not None and res.error is not None:
                    outcomes["poisoned_failed"] += 1
            except BreakerOpen:
                outcomes["breaker"] += 1
            rid = gw.submit(_mat(12, seed=700 + i))  # bucket 16
            res = gw.take(rid)
            if res is not None and res.verified:
                outcomes["clean_served"] += 1
        gw.drain()
        clean_key = gw._key_for(12, {})
        return outcomes, gw.breaker_state(clean_key), gw.stats.as_dict()

    chaos_out, chaos_clean_state, chaos_stats = run(poison=True)
    base_out, _, base_stats = run(poison=False)
    # poisoned bucket: first failures then breaker fast-fails the rest
    assert chaos_out["poisoned_failed"] >= 2
    assert chaos_out["breaker"] >= 8
    assert chaos_stats["breaker_opens"] >= 1
    # clean bucket: IDENTICAL service to the no-fault baseline
    assert chaos_out["clean_served"] == base_out["clean_served"]
    assert chaos_clean_state == "closed"
    assert base_stats["breaker_opens"] == 0


# --------------------------------------------------- cache + single-flight


def test_cache_hit_identical_miss_tampered_and_cross_tenant():
    """Identical resubmission answers from the cache with the SAME det;
    a one-bit tamper or a different tenant/security config misses and is
    honestly recomputed — the key covers the full (bytes, security tuple,
    tenant) identity."""
    cfg = _cfg(buckets=(8,), max_batch=1, pad_batches=False,
               cache=CacheConfig(max_entries=8))
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock)
    m = _mat(4, seed=800)
    first = gw.take(gw.submit(m))
    assert first.verified and gw.stats.cache_misses == 1

    hit = gw.take(gw.submit(m.copy()))  # same bytes, new array object
    assert hit.cache_hit and hit.flush_reason == "cache"
    assert hit.det.sign == first.det.sign
    assert hit.det.logabs == first.det.logabs
    assert gw.stats.cache_hits == 1
    assert gw.stats.flushes == 1  # no second sweep ran

    tampered = m.copy()
    tampered[2, 3] += 1e-9  # sub-tolerance nudge still changes the bytes
    t_res = gw.take(gw.submit(tampered))
    assert not t_res.cache_hit and gw.stats.flushes == 2
    ws, wl = np.linalg.slogdet(tampered)
    assert t_res.det.sign == ws and np.isclose(t_res.det.logabs, wl,
                                               rtol=1e-10)

    other = gw.take(gw.submit(m.copy(), tenant="other"))  # tenant in key
    assert not other.cache_hit and gw.stats.flushes == 3
    lam = gw.take(gw.submit(m.copy(), lambda1=64))  # security tuple in key
    assert not lam.cache_hit and gw.stats.flushes == 4
    snap = gw.metrics_snapshot()
    assert snap.cache["hits"] == 1 and snap.cache["entries"] == 4


def test_cache_never_stores_unverified_results():
    """A tampered sweep's rejected verdict must not outlive its flush: the
    identical resubmission after the fleet heals is RECOMPUTED."""
    chaos = {"on": True}

    def faults_for(key):
        # server 0 owns the matrix's REAL rows (server 1's strip is the
        # identity padding for n=4 → n'=8, where a tamper is harmless)
        return ServerFault(server=0) if chaos["on"] else None

    cfg = _cfg(buckets=(8,), max_batch=1, pad_batches=False,
               breaker=_nojitter(max_unverified_rate=None))
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for)
    m = _mat(4, seed=810)
    bad = gw.take(gw.submit(m))
    assert not bad.verified  # tampered, no recovery configured
    chaos["on"] = False
    good = gw.take(gw.submit(m.copy()))
    assert good.verified and not good.cache_hit
    assert gw.stats.flushes == 2 and gw.stats.cache_hits == 0
    ws, wl = np.linalg.slogdet(m)
    assert good.det.sign == ws and np.isclose(good.det.logabs, wl,
                                              rtol=1e-10)


def test_single_flight_coalesces_concurrent_identical_submissions():
    """Identical matrices in flight together ride ONE sweep slot: the
    followers' results clone the leader's verdict, and a later identical
    submission hits the cache."""
    cfg = _cfg(buckets=(8,), max_batch=4, max_wait_us=1e9)
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, auto_flush=False)
    m = _mat(5, seed=820)
    leader = gw.submit(m)
    f1 = gw.submit(m.copy())
    f2 = gw.submit(m.copy())
    assert gw.pending == 1  # followers hold no queue slot
    assert gw.stats.coalesced == 2
    gw.drain()
    rl, r1, r2 = gw.take(leader), gw.take(f1), gw.take(f2)
    assert rl.verified and rl.batch == 1
    for r in (r1, r2):
        assert r.verified and r.flush_reason == "coalesced"
        assert r.det.logabs == rl.det.logabs and r.det.sign == rl.det.sign
    assert gw.stats.flushes == 1 and gw.stats.served == 3
    assert gw._inflight == {}
    late = gw.take(gw.submit(m.copy()))
    assert late.cache_hit


def test_single_flight_followers_fail_with_their_leader():
    """A follower must never outlive a failed leader as a hung request."""
    def faults_for(key):
        raise RuntimeError("sweep down")

    cfg = _cfg(buckets=(8,), max_batch=4, max_wait_us=1e9)
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, faults_for=faults_for,
                     auto_flush=False)
    m = _mat(5, seed=830)
    leader, follower = gw.submit(m), gw.submit(m.copy())
    gw.drain()
    for rid in (leader, follower):
        res = gw.take(rid)
        assert res is not None and "sweep down" in res.error
    assert gw.pending == 0 and gw._inflight == {}
    assert gw._admission.total_pending == 0
    assert gw.stats.failed == 2


# ------------------------------------------------- dummy cache regression


def test_dummy_cache_keyed_by_dtype_and_bounded():
    """Regression: the padding/warmup dummy cache is keyed by
    (bucket size, dtype) — an f32 bucket must never pad with the f64
    dummy — and is LRU-bounded so a diverse size/dtype mix cannot grow it
    without limit."""
    gw = SPDCGateway(_cfg(), device=CPU, clock=VirtualClock())
    d64 = gw._dummy(8, "float64")
    d32 = gw._dummy(8, "float32")
    assert d64.dtype == np.float64 and d32.dtype == np.float32
    assert gw._dummy(8, "float64") is d64  # cached per key
    for n in range(2, 2 + 2 * _DUMMY_CACHE_MAX, 2):  # flood with sizes
        gw._dummy(n, "float64")
    assert len(gw._dummies) <= _DUMMY_CACHE_MAX


def test_f32_bucket_pads_with_f32_dummies():
    """End-to-end: a partial f32 flush pads its batch, and the whole sweep
    (dummies included) runs at the bucket's dtype."""
    cfg = _cfg(buckets=(8,), max_batch=4, max_wait_us=0.0)
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock)
    # 3 requests round up to the warmed batch shape 4 → one dummy padder
    rids = [gw.submit(_mat(4, seed=840 + i), dtype="float32")
            for i in range(3)]
    clock.t = 1.0
    gw.poll()
    for rid in rids:
        res = gw.take(rid)
        assert res is not None and res.verified
    assert ("float32" in {k[1] for k in gw._dummies}
            and "float64" not in {k[1] for k in gw._dummies})


# ------------------------------------------------ property: oracle parity


@settings(max_examples=5, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    n_requests=st.integers(min_value=4, max_value=10),
    quota=st.integers(min_value=1, max_value=4),
)
# request 9 is _mat(13, seed=169509): its honest factors' Q3 residual
# was once misjudged (tests/test_torch_protocol.py::
# test_growth_run_verified_by_its_exact_q3_residual)
@example(seed=1695, n_requests=10, quota=1)
def test_random_interleavings_match_sequential_oracle(seed, n_requests, quota):
    """Property (runs under real hypothesis or the deterministic stub):
    for random tenant/size interleavings under a random quota, every
    ADMITTED request's det equals the sequential direct-call oracle, and
    every shed request is a typed rejection — never a wrong answer."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(
        buckets=(8, 16), max_batch=4, max_wait_us=1e9,
        admission=AdmissionConfig(max_pending_per_tenant=quota),
        cache=CacheConfig(enabled=False),  # oracle parity, not cache reuse
    )
    clock = VirtualClock()
    gw = SPDCGateway(cfg, device=CPU, clock=clock, auto_flush=False)
    mats = [_mat(int(rng.integers(2, 17)), seed=seed * 100 + i)
            for i in range(n_requests)]
    tenants = [f"t{int(rng.integers(0, 2))}" for _ in mats]
    admitted, shed = {}, 0
    for i, (m, tenant) in enumerate(zip(mats, tenants)):
        clock.t = float(i)
        try:
            admitted[i] = gw.submit(m, tenant=tenant)
        except (AdmissionRejected, GatewayOverloaded):
            shed += 1
        if rng.integers(0, 3) == 0:  # random flush interleaving
            gw.drain()
    gw.drain()
    assert len(admitted) + shed == n_requests
    for i, rid in admitted.items():
        res = gw.take(rid)
        assert res is not None and res.verified
        oracle = outsource_determinant(mats[i], 2, device=CPU)
        assert res.det.sign == oracle.det.sign
        assert np.isclose(res.det.logabs, oracle.det.logabs, rtol=1e-10)
    assert gw.pending == 0 and gw._admission.total_pending == 0


# --------------------------------------------- against the reference gateway


def test_overload_storm_matches_reference():
    """One seeded open-loop storm at 8× the admitted rate through the
    port's gateway and the reference's, on one virtual clock: the same
    requests admitted and shed (by type), the same flush reasons, batch
    sizes and latencies, equal stats and equal /metrics and /healthz."""
    def run(gw_cls, cfg_cls, spdc_cls, adm_cls, brk_cls, shed_types):
        cfg = cfg_cls(
            name="test-gw", buckets=(8,), max_batch=4, max_wait_us=5000.0,
            max_pending=6, spdc=spdc_cls(num_servers=2),
            admission=adm_cls(rate_per_sec=50.0, burst=5.0,
                              max_pending_per_tenant=4),
            breaker=brk_cls(probe_jitter=0.0),
        )
        clock = VirtualClock()
        kw = {"device": CPU} if gw_cls is SPDCGateway else {}
        gw = gw_cls(cfg, clock=clock, **kw)
        rng = np.random.default_rng(7)
        outcome = []
        for i in range(60):
            clock.t += rng.exponential(1.0 / 400.0)
            gw.poll()
            try:
                outcome.append(gw.submit(_mat(4 + i % 5, seed=1200 + i),
                                         tenant=f"t{i % 2}"))
            except shed_types as e:
                outcome.append(f"{type(e).__name__}:"
                               f"{getattr(e, 'reason', '')}")
        for _ in range(50):
            clock.t += 1e-3
            gw.poll()
        results = [gw.take(o) if isinstance(o, int) else o for o in outcome]
        return results, gw.stats.as_dict(), gw.render_metrics(), gw.healthz()

    want = run(RGateway, RGatewayConfig, RSPDCConfig, RAdmissionConfig,
               RBreakerConfig, (RAdmissionRejected, RGatewayOverloaded))
    got = run(SPDCGateway, SPDCGatewayConfig, SPDCConfig, AdmissionConfig,
              BreakerConfig, (AdmissionRejected, GatewayOverloaded))
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert want[1]["rejected_admission"] > 0 and want[1]["served"] > 0
    for g, w in zip(got[0], want[0]):
        if isinstance(w, str):
            assert g == w
            continue
        for field in ("rid", "verified", "n", "batch", "flush_reason",
                      "tenant", "submitted_at", "completed_at", "error"):
            assert getattr(g, field) == getattr(w, field), field
        assert g.det.sign == w.det.sign
        assert np.isclose(g.det.logabs, w.det.logabs, rtol=1e-10)
