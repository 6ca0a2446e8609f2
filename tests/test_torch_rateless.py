"""The port's rateless straggler-adaptive dispatch and fleet health on the
CPU, against the JAX reference. Mirrors tests/test_rateless.py (all of
it but the gateway case, which tests/test_torch_gateway.py mirrors, and
the slow chaos matrix).

Includes the acceptance end to end: N = 4 edge workers, one
Pareto-delayed and one tampering, no straggler_deadline — the session
completes, the determinant matches the honest run at rtol 1e-10, the
streamed factors pass Q2 and Q3, the slow worker completed fewer strips
than the healthy ones, and the tamperer ends the session quarantined.

Against the reference, on the same seeded numpy inputs: the secret strip
probes bit-equal; FleetHealth's EWMA, backoff, jitter, quarantine and
assignment order equal under the same observations; the streamed factors
within rtol 1e-10 of the reference's `run_rateless` (the ciphertexts are
bit-equal: n divides over F, so there is no border), and for a single
matrix bit-equal to the port's own `lu_nserver(x_aug, F)`; verdicts,
culprits and quarantines the same.
"""
import dataclasses
import hashlib
import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as r_api
from repro.configs import RatelessConfig as RRatelessConfig
from repro.core import ServerFault as RServerFault
from repro.core import outsource_determinant as r_outsource
from repro.distrib import rateless as r_rateless
from repro_torch import ServerFault, outsource_determinant
from repro_torch.api import InlineTransport, SPDCClient, ThreadPoolTransport
from repro_torch.configs import RATELESS_DEFAULT, RatelessConfig
from repro_torch.core.decipher import Determinant
from repro_torch.core.lu import lu_nserver
from repro_torch.core.verify import authenticate
from repro_torch.distrib.rateless import FleetHealth, _probe_vector, run_rateless

N = 4
CPU = "cpu"


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    if batch is None:
        return rng.standard_normal((n, n)) + n * np.eye(n)
    return rng.standard_normal((batch, n, n)) + n * np.eye(n)


def _logabs(res):
    if hasattr(res, "dets"):
        return np.asarray([d.logabs for d in res.dets])
    return np.asarray(res.det.logabs)


def _pool():
    return ThreadPoolTransport(device=CPU)


# ------------------------------------------------------------- acceptance
def test_rateless_acceptance_straggler_and_tamperer():
    """Acceptance: one Pareto-heavy-tail straggler + one tamperer, no
    deadline anywhere — verified det matches honest at rtol 1e-10, Q2 and
    Q3 both pass on the streamed factors, the slow worker did less, and
    the tamperer is quarantined."""
    B, n = 5, 32
    m = _wellcond(n, seed=7, batch=B)
    honest = outsource_determinant(m, N, rateless=True, device=CPU)
    assert np.asarray(honest.verified).all()

    cfg = RatelessConfig(
        request_timeout_s=0.35,
        probation_cooldown_s=60.0,  # no probes inside this short session
    )
    plan = (
        ServerFault(server=1, kind="delay", delay_s=0.25,
                    delay_dist="pareto", delay_alpha=2.5),
        ServerFault(server=2, kind="tamper", mode="block", magnitude=0.5),
    )
    client = SPDCClient(rateless=cfg, recover=True, device=CPU)
    assert client.straggler_deadline is None  # nothing to tune
    session = client.open_session(m, N, faults=plan)
    assert session.partitions == cfg.overdecompose * N

    with _pool() as tp:
        l, u, rpt = run_rateless(
            session, tp, client.rateless, client.fleet, faults=session.plan
        )
        assert isinstance(l, np.ndarray) and isinstance(u, np.ndarray)
        # the streamed factors pass BOTH Q2 and Q3 — per-strip probes
        # caught the tampered strips before any downstream strip consumed
        # them, so no localize→heal cascade is even needed
        lt, ut = torch.from_numpy(l), torch.from_numpy(u)
        for method in ("q2", "q3"):
            v = authenticate(lt, ut, session.x_aug,
                             num_servers=session.partitions, method=method)
            assert bool(np.all(v.ok)), (method, v.residual)
        session.fleet_report = rpt
        out = session.collect((lt, ut), transport=tp)

    assert np.asarray(out.verified).all()
    np.testing.assert_allclose(_logabs(out), _logabs(honest), rtol=1e-10)

    workers = rpt.workers
    tamperer = workers[2]
    assert tamperer["quarantined"] and tamperer["tampers"] >= 1
    assert tamperer["completed"] == 0  # nothing it produced was accepted
    honest_completed = [workers[w]["completed"] for w in (0, 3)]
    # rateless redistribution: the straggler pulled fewer strips than the
    # healthy workers absorbed on its behalf
    assert workers[1]["completed"] < max(honest_completed)
    total = rpt.num_strips * rpt.lanes
    assert sum(w["completed"] for w in workers.values()) \
        + rpt.inline_strips == total


def test_rateless_honest_matches_numpy_single_and_batch():
    m = _wellcond(24, seed=11)
    res = outsource_determinant(m, N, rateless=True, device=CPU)
    ws, wl = np.linalg.slogdet(m)
    assert res.verified and res.det.sign == ws
    np.testing.assert_allclose(res.det.logabs, wl, rtol=1e-8)
    assert res.num_servers == N  # fleet size, not strip count
    assert res.report.fleet.num_strips == RATELESS_DEFAULT.overdecompose * N
    assert res.report.fleet.inline_strips == 0 and res.report.fleet.retries == 0

    stack = _wellcond(16, seed=13, batch=3)
    bres = outsource_determinant(stack, N, rateless=True,
                                 transport="threadpool", device=CPU)
    assert np.asarray(bres.verified).all()
    for i in range(3):
        ws, wl = np.linalg.slogdet(stack[i])
        assert bres.dets[i].sign == ws
        np.testing.assert_allclose(bres.dets[i].logabs, wl, rtol=1e-8)
    assert bres.report.fleet.lanes == 3  # one lane per batch slice


def test_rateless_ignores_round_deadline():
    """A rateless session has no rounds deadline: a delay_rounds fault far
    past any classic deadline is NOT converted to a dropout (while the
    classic path drops it and rejects without recovery)."""
    m = _wellcond(16, seed=17)
    fault = ServerFault(server=0, kind="delay", delay_rounds=99)
    classic = outsource_determinant(m, N, faults=fault, straggler_deadline=1,
                                    device=CPU)
    assert not classic.verified
    res = outsource_determinant(
        m, N, faults=fault, straggler_deadline=1, rateless=True, device=CPU
    )
    assert res.verified and res.report.recovery is None


def test_rateless_config_resolution_and_validation():
    assert SPDCClient(device=CPU).fleet is None
    c = SPDCClient(rateless=True, device=CPU)
    assert c.rateless == RATELESS_DEFAULT
    assert isinstance(c.fleet, FleetHealth)
    with pytest.raises(ValueError, match="rateless"):
        SPDCClient(rateless="yes", device=CPU)
    with pytest.raises(ValueError, match="overdecompose"):
        RatelessConfig(overdecompose=0)
    with pytest.raises(ValueError, match="ewma_alpha"):
        RatelessConfig(ewma_alpha=1.5)
    # the copy keeps the reference's defaults field for field
    assert dataclasses.asdict(RATELESS_DEFAULT) == dataclasses.asdict(
        RRatelessConfig())


def test_fleet_health_outlives_sessions():
    """What one session learned rides into the next: the client's
    FleetHealth keeps its observations across open_session calls."""
    client = SPDCClient(
        rateless=RatelessConfig(probation_cooldown_s=60.0), recover=True,
        device=CPU,
    )
    m = _wellcond(16, seed=19)
    fault = ServerFault(server=1, kind="tamper", mode="sign_flip")
    with _pool() as tp:
        out1 = client.open_session(m, N, faults=fault).run(tp)
        assert out1.verified
        assert client.fleet.worker(1).quarantined
        out2 = client.open_session(m, N).run(tp)
        assert out2.verified
    # second session never dispatched to the quarantined worker
    assert out2.report.fleet.workers[1]["completed"] == 0


# ------------------------------------------------- fleet-health unit pieces
def test_fleet_ewma_and_assignable_ordering():
    fh = FleetHealth(RatelessConfig(ewma_alpha=0.5))
    fh.observe_success(0, 1.0)
    fh.observe_success(0, 0.5)
    assert fh.worker(0).ewma_latency_s == pytest.approx(0.75)
    fh.observe_success(1, 0.1)
    # unknown worker 2 ranks FIRST (optimism), then fastest EWMA
    assert fh.assignable((0, 1, 2), set(), now=0.0) == [2, 1, 0]
    # busy workers drop out of the assignable view
    assert fh.assignable((0, 1, 2), {2}, now=0.0) == [1, 0]


def test_fleet_backoff_is_exponential_capped_and_deterministic():
    cfg = RatelessConfig(backoff_base_s=0.1, backoff_max_s=0.4,
                         backoff_jitter=0.25, quarantine_after=99)
    fh = FleetHealth(cfg)
    pauses = []
    for _ in range(4):
        fh.observe_failure(3, now=0.0)
        pauses.append(fh.worker(3).next_ok_at)
    for pause, nominal in zip(pauses, (0.1, 0.2, 0.4, 0.4)):
        assert nominal * 0.75 <= pause <= nominal * 1.25
    # deterministic: a fresh tracker replays the identical jitter
    fh2 = FleetHealth(cfg)
    for k in range(4):
        fh2.observe_failure(3, now=0.0)
        assert fh2.worker(3).next_ok_at == pauses[k]
    # a worker inside its backoff window is not assignable, then is again
    assert fh.assignable((3,), set(), now=0.0) == []
    assert fh.assignable((3,), set(), now=1.0) == [3]


def test_fleet_quarantine_paths_and_probation():
    cfg = RatelessConfig(quarantine_after=2, probation_cooldown_s=10.0)
    fh = FleetHealth(cfg)
    # path 1: consecutive failures
    fh.observe_failure(0, now=0.0)
    assert not fh.worker(0).quarantined
    fh.observe_failure(0, now=1.0)
    assert fh.worker(0).quarantined
    # path 2: ONE tamper is enough
    fh.observe_tamper(1, now=1.0)
    assert fh.worker(1).quarantined and fh.worker(1).tampers == 1
    assert fh.live((0, 1, 2)) == [2]
    # probation respects the cooldown and the busy set
    assert fh.probation_due((0, 1, 2), set(), now=5.0) == []
    assert fh.probation_due((0, 1, 2), set(), now=12.0) == [0, 1]
    assert fh.probation_due((0, 1, 2), {0}, now=12.0) == [1]
    # a passed probe re-admits and resets the failure streak
    fh.readmit(0, now=12.0, latency_s=0.2)
    w = fh.worker(0)
    assert not w.quarantined and w.consecutive_failures == 0
    assert w.probes_passed == 1 and w.quarantine_count == 1
    # success resets the streak without touching quarantine bookkeeping
    fh.observe_failure(2, now=0.0)
    fh.observe_success(2, 0.1)
    assert fh.worker(2).consecutive_failures == 0


def test_fleet_next_wakeup_bounds_the_stall_sleep():
    cfg = RatelessConfig(backoff_base_s=0.2, backoff_jitter=0.0,
                         probation_cooldown_s=1.0, quarantine_after=99)
    fh = FleetHealth(cfg)
    assert fh.next_wakeup((0, 1), now=0.0) is None  # nothing benched
    fh.observe_failure(0, now=0.0)  # backoff expires at 0.2
    fh.observe_tamper(1, now=0.0)  # probation due at 1.0
    assert fh.next_wakeup((0, 1), now=0.0) == pytest.approx(0.2)
    assert fh.next_wakeup((0, 1), now=0.5) == pytest.approx(0.5)
    assert fh.next_wakeup((0, 1), now=2.0) == 0.0


# --------------------------------------------------- degradation + probation
def test_degradation_ladder_completes_inline_when_fleet_is_dark():
    """Every worker quarantined before the session starts → the client
    computes every strip itself, on the session's device; the answer is
    still verified."""
    client = SPDCClient(rateless=RatelessConfig(probation_cooldown_s=60.0),
                        device=CPU)
    for wid in range(N):
        client.fleet.observe_tamper(wid, now=time.monotonic())
    m = _wellcond(16, seed=23)
    with _pool() as tp:
        out = client.open_session(m, N).run(tp)
    assert out.verified
    assert out.report.fleet.inline_strips == out.report.fleet.num_strips
    assert out.report.fleet.dispatches == 0
    ws, wl = np.linalg.slogdet(m)
    assert out.det.sign == ws
    np.testing.assert_allclose(out.det.logabs, wl, rtol=1e-8)


def test_degradation_ladder_when_every_worker_tampers():
    """All N workers tamper: per-strip probes burn through max_attempts,
    the whole fleet lands in quarantine, and the ladder's last rung
    (inline completion) still produces a verified determinant."""
    cfg = RatelessConfig(max_attempts=2, probation_cooldown_s=60.0)
    plan = tuple(
        ServerFault(server=s, kind="tamper", mode="block", magnitude=0.5)
        for s in range(N)
    )
    client = SPDCClient(rateless=cfg, recover=True, device=CPU)
    m = _wellcond(16, seed=29)
    with _pool() as tp:
        out = client.open_session(m, N, faults=plan).run(tp)
    assert out.verified
    assert out.report.fleet.inline_strips > 0
    assert out.report.fleet.tampered_strips >= 1
    assert all(w["quarantined"] for w in out.report.fleet.workers.values())


def test_probation_probe_readmits_transient_offender():
    """A worker benched by stale health state earns its way back through
    the probation probe (a re-issue of an already-verified strip) and is
    then assigned real work again."""
    cfg = RatelessConfig(probation_cooldown_s=0.0)
    client = SPDCClient(rateless=cfg, device=CPU)
    # bench worker 3 with PRE-SESSION state (transient flake, now healthy)
    client.fleet.observe_tamper(3, now=time.monotonic() - 1.0)
    m = _wellcond(24, seed=31, batch=4)
    with _pool() as tp:
        out = client.open_session(m, N).run(tp)
    assert np.asarray(out.verified).all()
    assert out.report.fleet.probes >= 1
    w3 = out.report.fleet.workers[3]
    assert not w3["quarantined"] and w3["probes_passed"] >= 1


def test_probation_probe_keeps_persistent_tamperer_benched():
    """The probe rides the wire as attempt 0, so a persistently tampering
    worker corrupts the probe too and stays quarantined (cooldown 0 makes
    the probe deterministic, as in the reference)."""
    cfg = RatelessConfig(probation_cooldown_s=0.0)
    plan = ServerFault(server=1, kind="tamper", mode="single", target="u",
                       magnitude=100.0)
    client = SPDCClient(rateless=cfg, recover=True, device=CPU)
    m = _wellcond(24, seed=37, batch=4)
    with _pool() as tp:
        out = client.open_session(m, N, faults=plan).run(tp)
    assert np.asarray(out.verified).all()
    w1 = out.report.fleet.workers[1]
    assert w1["quarantined"] and w1["probes_passed"] == 0
    assert w1["tampers"] >= 2  # the original strike plus failed probe(s)


def test_rateless_recovery_reroutes_to_live_worker():
    """collect()-level healing on a rateless session re-streams the strip
    to a healthy worker chosen by fleet health (tamper=... corrupts the
    factors AFTER the scheduler, so only recovery can heal them)."""
    m = _wellcond(16, seed=41)
    client = SPDCClient(rateless=True, recover=True, device=CPU)
    client.fleet.observe_tamper(0, now=time.monotonic())

    def corrupt(l, u):
        u = u.clone()
        u[3, 3] += 50.0
        return l, u

    with _pool() as tp:
        session = client.open_session(m, N, tamper=corrupt)
        out = session.run(tp)
    assert out.verified and out.report.recovery is not None
    assert out.report.recovery.ok
    # row 3 lies in partition 3 // (16 / F) of the F = 8 strips; its
    # re-issue went to a live worker, never the quarantined worker 0
    events = out.report.recovery.events
    assert {e.server for e in events} == {1}
    assert all(e.replacement != 0 for e in events)
    ws, wl = np.linalg.slogdet(m)
    np.testing.assert_allclose(out.det.logabs, wl, rtol=1e-8)


# ------------------------------------------------ parity with the reference
@pytest.mark.parametrize("lane,strip,attempt,n,dtype", [
    (0, 0, 0, 32, np.float64), (3, 7, 2, 64, np.float64),
    (-2, 0, 1001, 16, np.float32),
])
def test_probe_vector_bit_equal_to_reference(lane, strip, attempt, n, dtype):
    digest = hashlib.sha256(struct.pack(">q", lane + 17)).digest()
    got = _probe_vector(digest, lane, strip, attempt, n, dtype)
    want = r_rateless._probe_vector(digest, lane, strip, attempt, n, dtype)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_fleet_health_replays_reference_observations():
    """The same observations give the same backoff, jitter, quarantine,
    assignment order and wake-up in both packages, number for number."""
    kw = dict(backoff_base_s=0.05, backoff_max_s=0.3, backoff_jitter=0.25,
              quarantine_after=3, probation_cooldown_s=0.7, ewma_alpha=0.4)
    got, want = FleetHealth(RatelessConfig(**kw)), \
        r_rateless.FleetHealth(RRatelessConfig(**kw))
    fleet = tuple(range(5))
    rng = np.random.default_rng(3)
    for step in range(60):
        wid, kind = int(rng.integers(5)), int(rng.integers(4))
        now = step * 0.05
        for fh in (got, want):
            if kind == 0:
                fh.observe_success(wid, float(step % 7) / 10)
            elif kind == 1:
                fh.observe_failure(wid, now)
            elif kind == 2 and step % 11 == 0:
                fh.observe_tamper(wid, now)
            elif kind == 3 and fh.worker(wid).quarantined:
                fh.readmit(wid, now, 0.3)
        busy = {int(rng.integers(5))}
        assert got.assignable(fleet, busy, now) == want.assignable(fleet, busy, now)
        assert got.probation_due(fleet, busy, now) == \
            want.probation_due(fleet, busy, now)
        assert got.next_wakeup(fleet, now) == want.next_wakeup(fleet, now)
    assert got.report() == want.report()
    for wid in fleet:
        assert got.worker(wid).next_ok_at == want.worker(wid).next_ok_at


def _sessions(m, **kw):
    """(port session, reference session) of the same rateless client."""
    port = SPDCClient(rateless=True, device=CPU, **kw)
    ref = r_api.SPDCClient(rateless=True, **kw)
    return port, port.open_session(m, N), ref, ref.open_session(m, N)


@pytest.mark.parametrize("shape", [(32,), (3, 32)], ids=["single", "batch3"])
def test_rateless_factors_match_reference_and_lu_nserver(shape):
    """Honest rateless factors: within rtol 1e-10 of the reference's
    run_rateless on the bit-equal ciphertext, and — one lane, strips in
    the "nserver" order over the accepted U rows — bit-equal to the
    port's lu_nserver(x_aug, F) on the same device."""
    m = _wellcond(shape[-1], seed=43, batch=shape[0] if len(shape) == 2 else None)
    port, ps, ref, rs = _sessions(m)
    F = ps.partitions
    assert F == rs.partitions == 8 and ps.padding == rs.padding == 0
    np.testing.assert_array_equal(ps.x_aug.numpy(), np.asarray(rs.x_aug))
    with InlineTransport(device=CPU) as pt, r_api.InlineTransport() as rt:
        l, u, rpt = run_rateless(ps, pt, port.rateless, port.fleet)
        rl, ru, rrpt = r_rateless.run_rateless(rs, rt, ref.rateless, ref.fleet)
    np.testing.assert_allclose(l, rl, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(u, ru, rtol=1e-10, atol=1e-12)
    assert (rpt.num_strips, rpt.lanes, rpt.inline_strips) == \
        (rrpt.num_strips, rrpt.lanes, rrpt.inline_strips)
    if len(shape) == 1:
        wl, wu, _ = lu_nserver(ps.x_aug, F)
        assert torch.equal(torch.from_numpy(l), wl)
        assert torch.equal(torch.from_numpy(u), wu)


def test_rateless_tamper_quarantine_matches_reference():
    """A block tamperer on a single matrix: the first four strips go to
    the four (unknown, so equally fast) workers in id order in both
    packages, worker 2's strip fails its probe, worker 2 is quarantined
    and the strip re-streams; both verify with equal determinants."""
    m = _wellcond(32, seed=47)
    cfg = dict(probation_cooldown_s=60.0)
    port = SPDCClient(rateless=RatelessConfig(**cfg), device=CPU)
    ref = r_api.SPDCClient(rateless=RRatelessConfig(**cfg))
    got = port.open_session(
        m, N, faults=ServerFault(server=2, mode="block", magnitude=0.5)).run()
    want = ref.open_session(
        m, N, faults=RServerFault(server=2, mode="block", magnitude=0.5)).run()
    assert got.verified and want.verified
    assert Determinant(**dataclasses.asdict(want.det)).allclose(got.det)
    for key in ("tampered_strips", "inline_strips"):
        assert getattr(got.report.fleet, key) == getattr(want.report.fleet, key)
    quarantined = [
        sorted(w for w, h in rep.report.fleet.workers.items() if h["quarantined"])
        for rep in (got, want)
    ]
    assert quarantined[0] == quarantined[1] == [2]


def test_rateless_verdict_and_culprit_match_reference():
    """A tamper after the scheduler (no recovery): both packages reject
    with the same culprit, counted in the F = 8 partitions."""
    m = _wellcond(32, seed=53)

    def port_tamper(l, u):
        u = u.clone()
        u[13, 20] += 5.0
        return l, u

    def ref_tamper(l, u):
        return l, jnp.asarray(u).at[13, 20].add(5.0)

    got = outsource_determinant(m, N, rateless=True, tamper=port_tamper,
                                device=CPU)
    want = r_outsource(m, N, rateless=True, tamper=ref_tamper)
    assert not got.verified and not want.verified
    assert got.report.verdict.culprit == want.report.verdict.culprit == 13 // 4
