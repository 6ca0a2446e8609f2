"""The port's SPDC gateway and its mixed-size coalesced sweep on the CPU,
against the JAX reference. Mirrors tests/test_gateway.py, the gateway
cases of tests/test_precision.py and tests/test_api.py, and
tests/test_rateless.py's gateway case.

Against the reference, on the same seeded numpy inputs: the mixed stack
bit-equal to the reference's `Session.x_aug` in f64 and f32 (the port
ciphers each matrix with its CED path and draws each border from the
same per-matrix numpy generator); L and U at rtol 1e-10; determinants,
signs, verdicts and culprits equal in f64 and f32; one request stream
through both gateways on a virtual clock: equal flush reasons, batch
sizes, verdicts, recovery rounds and stats, and equal /metrics text.
Elsewhere each answer is held against numpy's slogdet at rtol 1e-10 (f64)
or |Δlog|det|| ≤ 1e-3 (f32), the reference tests' bounds.
"""
import asyncio
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import repro.api as r_api
from repro.configs import SPDCConfig as RSPDCConfig
from repro.configs import SPDCGatewayConfig as RGatewayConfig
from repro.core import ServerFault as RServerFault
from repro.core import lu as r_lu
from repro.core import outsource_determinant_mixed as r_mixed
from repro.serve import SPDCGateway as RGateway
from repro_torch import ServerFault, outsource_determinant
from repro_torch.api import SPDCClient
from repro_torch.configs import SPDC_EDGE_RATELESS, SPDCConfig, SPDCGatewayConfig
from repro_torch.core import lu as t_lu
from repro_torch.core import outsource_determinant_mixed
from repro_torch.core.decipher import Determinant
from repro_torch.linalg import LinalgSession
from repro_torch.serve import (
    AsyncSPDCGateway,
    BucketKey,
    GatewayOverloaded,
    NoBucketFits,
    SPDCGateway,
    bucket_size_for,
)
from repro_torch.serve.spdc_gateway import GatewayResult, allowed_batch_sizes

CPU = "cpu"
#: the reference's f32 bound on |Δlog|det|| (tests/test_precision.py)
F32_DLOG = 1e-3


def _mat(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _cfg(cls=SPDCGatewayConfig, spdc_cls=SPDCConfig, **kw):
    kw.setdefault("buckets", (8, 16))
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_us", 1000.0)
    kw.setdefault("spdc", spdc_cls(num_servers=2))
    return cls(name="test-gw", **kw)


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _gw(cfg=None, **kw):
    kw.setdefault("clock", VirtualClock())
    return SPDCGateway(cfg or _cfg(), device=CPU, **kw)


def _matches_numpy(det, m, rtol=1e-10):
    ws, wl = np.linalg.slogdet(m)
    return det.sign == ws and np.isclose(det.logabs, wl, rtol=rtol)


def _same_det(got, want):
    """A port Determinant against a reference one (other class)."""
    return Determinant(**dataclasses.asdict(want)).allclose(got) \
        and got.sign == want.sign and got.dtype == want.dtype


# ------------------------------------------- the mixed sweep vs the reference

MIXED_SIZES = (3, 7, 8, 5, 6, 2)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mixed_stack_bit_equal_to_reference(dtype):
    """One CED pass per request on its own size, equilibration (on by
    default in f32) and the post-cipher border from the reference's
    per-matrix generator: the (B, n', n') stack is the reference's
    Session.x_aug bit for bit, with the same paddings, exponents and
    rotations."""
    ms = [_mat(n, seed=n) for n in MIXED_SIZES]
    ref = r_api.SPDCClient(dtype=dtype).open_session(ms, 2, pad_to=8)
    port = SPDCClient(dtype=dtype, device=CPU).open_session(ms, 2, pad_to=8)
    assert port.kind == ref.kind == "mixed"
    assert port.x_aug.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(port.x_aug.numpy(), np.asarray(ref.x_aug))
    assert port.paddings == ref.paddings == [5, 1, 0, 3, 2, 6]
    assert port.pad_to == ref.pad_to == 8 and port.padding == ref.padding == 0
    np.testing.assert_array_equal(port.log2_scale, np.asarray(ref.log2_scale))
    assert [m.rotate_k for m in port.metas] == [m.rotate_k for m in ref.metas]
    assert [m.flipped for m in port.metas] == [m.flipped for m in ref.metas]
    assert port.digest == ref.digest
    if dtype == "float32":
        assert np.any(port.log2_scale != 0)  # equilibrated by default


def test_mixed_factors_match_reference():
    ms = [_mat(n, seed=10 + n) for n in (13, 16, 9, 4)]
    ref = r_api.SPDCClient().open_session(ms, 4)
    port = SPDCClient(device=CPU).open_session(ms, 4)
    assert port.pad_to == ref.pad_to == 16
    lr, ur, _ = r_lu.lu_nserver(ref.x_aug, 4)
    lt, ut, _ = t_lu.lu_nserver(port.x_aug, 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ut.numpy(), np.asarray(ur), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mixed_results_match_reference(dtype):
    """Determinants, signs and verdicts equal to the reference's, honest
    and with one tampered matrix in the stack (the same culprit)."""
    ms = [_mat(n, seed=20 + n) for n in (4, 6, 5)]
    fault = dict(server=1, matrices=(1,))
    for kw in ({}, {"fault": fault}):
        got = outsource_determinant_mixed(
            ms, 2, pad_to=8, dtype=dtype, device=CPU,
            faults=ServerFault(**fault) if kw else None)
        want = r_mixed(ms, 2, pad_to=8, dtype=dtype,
                       faults=RServerFault(**fault) if kw else None)
        np.testing.assert_array_equal(got.verified, np.asarray(want.verified))
        np.testing.assert_array_equal(
            got.report.verdict.culprit, np.asarray(want.report.verdict.culprit))
        assert got.paddings == want.paddings and got.pad_to == want.pad_to
        for i, (g, w) in enumerate(zip(got.dets, want.dets)):
            if bool(got.verified[i]):
                assert _same_det(g, w)
    assert list(got.verified) == [True, False, True]
    assert got.report.verdict.culprit[1] == 1


def test_mixed_recovery_heals_with_the_stack_rows():
    """A mixed session's padding is 0 and its borders sit in x_aug: the
    repair task carries the padded stack's rows, so a healed inline run's
    factors are bit-equal to the honest sweep's (no border re-drawn)."""
    ms = [_mat(n, seed=30 + n) for n in (5, 8, 7)]
    client = SPDCClient(recover=True, standby=1, device=CPU)
    session = client.open_session(ms, 2,
                                  faults=ServerFault(server=0, mode="block",
                                                     magnitude=0.3))
    out = session.run()
    assert out.verified.all() and out.report.recovery.ok
    assert 0 in out.report.recovery.servers_replaced
    l, u = out.report.recovery.factors
    hl, hu, _ = t_lu.lu_nserver(session.x_aug, 2)
    assert torch.equal(l, hl) and torch.equal(u, hu)
    for m, det in zip(ms, out.dets):
        assert _matches_numpy(det, m)


def test_gateway_stream_matches_reference_on_virtual_clock():
    """One request stream — full and timeout flushes, padding to a warm
    batch shape, an f32 and a q2 override, an oversize direct call, a
    cache hit, a single-flight follower, slogdet, and a tampered bucket
    that heals — through both gateways on a virtual clock: per-request
    flush reasons, batch sizes, verdicts and recovery, equal stats and
    equal /metrics text."""
    def tampered(key):
        return (RServerFault if gw_cls is RGateway else ServerFault)(
            server=1, mode="block", magnitude=0.3) \
            if key.pad_to == 16 and key.method == "q3" else None

    repeat = _mat(6, seed=7)
    stream = [  # (virtual time, matrix, submit kwargs)
        (0.0000, _mat(5, 1), {}),
        (0.0001, _mat(12, 2), {}),
        (0.0002, repeat, {}),
        (0.0003, _mat(7, 3), {"dtype": "float32"}),
        (0.0004, repeat, {}),                       # single-flight follower
        (0.0005, _mat(8, 4), {}),
        (0.0006, _mat(3, 5), {}),                    # bucket 8 fills
        (0.0007, _mat(20, 6), {}),                   # oversize: direct
        (0.0008, _mat(14, 8), {"method": "q2"}),
        (0.0030, repeat, {}),                       # cache hit
        (0.0031, _mat(16, 9), {}),
        (0.0032, _mat(6, 10), {"op": "slogdet"}),
    ]
    runs = {}
    for gw_cls, cfg_cls, spdc_cls in ((RGateway, RGatewayConfig, RSPDCConfig),
                                      (SPDCGateway, SPDCGatewayConfig,
                                       SPDCConfig)):
        clock = VirtualClock()
        cfg = _cfg(cfg_cls, spdc_cls,
                   spdc=spdc_cls(num_servers=2, recover=True, standby=1))
        kw = {} if gw_cls is RGateway else {"device": CPU}
        gw = gw_cls(cfg, clock=clock, faults_for=tampered, **kw)
        rids = []
        for t, m, sub in stream:
            clock.t = t
            gw.poll()
            rids.append(gw.submit(m, **sub))
        clock.t = 1.0
        gw.poll()
        results = [gw.take(r) for r in rids]
        runs[gw_cls] = (results, gw.stats.as_dict(), gw.render_metrics())
    (want, want_stats, want_text), (got, got_stats, got_text) = (
        runs[RGateway], runs[SPDCGateway])
    assert got_stats == want_stats
    assert got_text == want_text
    assert want_stats["recovered_flushes"] == 2 and want_stats["direct"] == 1
    assert want_stats["cache_hits"] == 1 and want_stats["coalesced"] == 1
    for g, w, (_, m, sub) in zip(got, want, stream):
        for field in ("rid", "verified", "n", "pad_to", "batch",
                      "flush_reason", "cache_hit", "op", "tenant", "error",
                      "submitted_at", "completed_at"):
            assert getattr(g, field) == getattr(w, field), field
        assert _same_det(g.det, w.det)
        assert (g.recovery is None) == (w.recovery is None)
        if g.recovery is not None:
            assert g.recovery.factors is None  # freed with the flush
            assert g.recovery.rounds == w.recovery.rounds
            assert g.recovery.servers_replaced == w.recovery.servers_replaced
        if sub.get("op") == "slogdet":
            assert (g.sign, g.logabs) == (g.det.sign, g.det.logabs)
        rtol = 1e-10 if sub.get("dtype") != "float32" else None
        if rtol is not None:
            assert _matches_numpy(g.det, m, rtol)


# ---------------------------------------------------------------- bucketing


def test_bucket_size_for_picks_smallest_legal():
    assert bucket_size_for(5, (8, 16), 2) == 8
    assert bucket_size_for(8, (8, 16), 2) == 8
    assert bucket_size_for(9, (8, 16), 2) == 16
    # 8 is not servable by N=8 (8/8 == 1 block); falls through to 16
    assert bucket_size_for(5, (8, 16), 8) == 16
    with pytest.raises(NoBucketFits):
        bucket_size_for(17, (8, 16), 2)


def test_gateway_rejects_unservable_bucket_config():
    """A server count no bucket divides must fail at construction."""
    with pytest.raises(ValueError, match="servable"):
        _gw(_cfg(spdc=SPDCConfig(num_servers=3)))


def test_gateway_rejects_unservable_preset_bucket():
    """Construction-time validation names the offending bucket."""
    with pytest.raises(ValueError, match="129"):
        _gw(SPDCGatewayConfig(name="t-bad", buckets=(64, 129),
                              spdc=SPDCConfig(num_servers=4)))


def test_allowed_batch_sizes_bounded():
    assert allowed_batch_sizes(32) == (1, 2, 4, 8, 16, 32)
    assert allowed_batch_sizes(6) == (1, 2, 4, 6)
    assert allowed_batch_sizes(1) == (1,)


def test_config_kwargs_are_protocol_parameters():
    """Every key the configs emit stays a real keyword of the function
    it feeds: SPDCConfig → outsource_determinant, BucketKey →
    outsource_determinant_mixed and LinalgSession."""
    det = set(inspect.signature(outsource_determinant).parameters)
    assert set(SPDCConfig().protocol_kwargs()) <= det
    key = BucketKey(pad_to=64, num_servers=4, lambda1=256, lambda2=192)
    kwargs = key.protocol_kwargs()
    assert kwargs["lambda1"] == 256 and kwargs["lambda2"] == 192
    assert set(SPDCConfig().protocol_kwargs()) <= set(kwargs) | {"pad_to"}
    mixed = set(inspect.signature(outsource_determinant_mixed).parameters)
    assert set(kwargs) <= mixed
    assert set(key.linalg_kwargs()) <= set(
        inspect.signature(LinalgSession).parameters)


# ------------------------------------------------- mixed-size protocol sweep


def test_mixed_sweep_matches_direct_calls():
    """Per request, the coalesced sweep's determinant is the one the
    client's own direct call gives (rtol 1e-10)."""
    ms = [_mat(n, seed=n) for n in MIXED_SIZES]
    res = outsource_determinant_mixed(ms, 2, pad_to=8, device=CPU)
    assert res.verified.all()
    assert res.pad_to == 8 and res.padding == 0
    assert res.paddings == [5, 1, 0, 3, 2, 6]
    for m, det in zip(ms, res.dets):
        direct = outsource_determinant(m, 2, device=CPU)
        assert direct.verified
        assert det.sign == direct.det.sign
        assert np.isclose(det.logabs, direct.det.logabs, rtol=1e-10)


def test_mixed_sweep_rejects_bad_pad_to():
    with pytest.raises(ValueError):
        outsource_determinant_mixed([_mat(4)], 2, pad_to=7, device=CPU)
    with pytest.raises(ValueError):
        outsource_determinant_mixed([_mat(9)], 2, pad_to=8, device=CPU)
    with pytest.raises(ValueError):
        outsource_determinant_mixed([], 2, device=CPU)
    with pytest.raises(ValueError, match="square"):
        outsource_determinant_mixed([np.ones((3, 4))], 2, device=CPU)


def test_pad_to_applies_to_lists_only():
    """The port has no Pallas CED switch to refuse on lists (the
    reference's use_kernel); what it refuses is pad_to on an array."""
    with pytest.raises(ValueError, match="mixed-size lists only"):
        SPDCClient(device=CPU).open_session(_mat(4), 2, pad_to=8)


def test_outsource_determinant_routes_lists():
    ms = [_mat(3, seed=1), _mat(6, seed=2)]
    for seq in (ms, tuple(ms)):
        res = outsource_determinant(seq, 2, device=CPU)
        assert res.batch == 2 and res.verified.all() and res.pad_to == 6
        for m, det in zip(ms, res.dets):
            assert _matches_numpy(det, m)


def test_mixed_sweep_flags_single_tampered_matrix():
    ms = [_mat(n, seed=10 + n) for n in (4, 6, 5)]
    res = outsource_determinant_mixed(
        ms, 2, pad_to=8, faults=ServerFault(server=1, matrices=(1,)),
        device=CPU,
    )
    assert bool(res.verified[0]) and bool(res.verified[2])
    assert not bool(res.verified[1])


def test_f32_mixed_sizes_one_sweep():
    mats = [_mat(n, seed=n) for n in (24, 33, 48)]
    res = outsource_determinant(mats, 4, dtype="float32", device=CPU)
    assert bool(np.all(res.verified)) and res.pad_to == 48
    for det, m in zip(res.dets, mats):
        ws, wl = np.linalg.slogdet(m)
        assert det.dtype == "float32" and det.sign == ws
        assert abs(det.logabs - wl) <= F32_DLOG


def test_mixed_sweep_on_message_transports_and_rateless():
    """The mixed stack rides the thread pool (ShardTasks, each strip
    screened against every request's plaintext) and the rateless
    scheduler, with the inline sweep's determinants."""
    ms = [_mat(n, seed=40 + n) for n in (9, 16, 12)]
    inline = outsource_determinant_mixed(ms, 2, device=CPU)
    pool = outsource_determinant_mixed(ms, 2, transport="threadpool",
                                       device=CPU)
    assert pool.verified.all()
    assert [d.logabs for d in pool.dets] == [d.logabs for d in inline.dets]
    rl = outsource_determinant_mixed(ms, 2, rateless=True,
                                     transport="threadpool", device=CPU)
    assert rl.verified.all() and rl.report.fleet.num_strips == 4
    assert rl.pad_to == 16
    for m, det in zip(ms, rl.dets):
        assert _matches_numpy(det, m)


def test_boundary_screen_reads_every_plaintext():
    """A mixed session's tasks are screened against all its requests'
    plaintexts: a strip carrying matrix 1's entries verbatim is caught."""
    from repro_torch.api.client import BoundaryViolation

    ms = [_mat(n, seed=50 + n) for n in (5, 8)]
    session = SPDCClient(device=CPU).open_session(ms, 2)
    assert len(session._m_hosts) == 2 and session._m_host is None
    tasks = session.tasks(check_boundary=True)
    tasks[0].x_row[1, 2, :8] = ms[1][0]
    with pytest.raises(BoundaryViolation, match="plaintext"):
        session._assert_boundary(tasks, True)


# --------------------------------------------------------- gateway semantics


def test_gateway_mixed_interleaved_matches_direct():
    gw = _gw()
    sizes = (3, 12, 5, 16, 8, 9, 4, 14)
    mats = [_mat(n, seed=20 + n) for n in sizes]
    rids = [gw.submit(m) for m in mats]
    gw.drain()
    for m, rid in zip(mats, rids):
        r = gw.take(rid)
        assert r is not None and r.verified
        direct = outsource_determinant(m, 2, device=CPU)
        assert r.det.sign == direct.det.sign
        assert np.isclose(r.det.logabs, direct.det.logabs, rtol=1e-10)
    assert gw.stats.served == len(sizes)
    assert gw.stats.flushes >= 2


def test_gateway_accepts_tensors():
    gw = _gw(_cfg(max_batch=1))
    m = _mat(6, seed=3)
    r = gw.take(gw.submit(torch.from_numpy(m)))
    assert r.verified and _matches_numpy(r.det, m)


def test_gateway_full_bucket_flushes_on_submit():
    gw = _gw(_cfg(max_batch=2))
    r0 = gw.submit(_mat(5, seed=1))
    assert gw.take(r0) is None and gw.pending == 1
    r1 = gw.submit(_mat(6, seed=2))
    res0, res1 = gw.take(r0), gw.take(r1)
    assert res0 is not None and res1 is not None
    assert res0.flush_reason == "full" and res0.batch == 2
    assert gw.pending == 0 and gw.stats.flushes_full == 1


def test_gateway_timeout_flushes_partial_bucket():
    clock = VirtualClock()
    gw = _gw(_cfg(max_wait_us=1000.0), clock=clock)
    rid = gw.submit(_mat(5, seed=3))
    clock.t = 0.0009
    assert gw.poll() == [] and gw.take(rid) is None
    clock.t = 0.0011
    out = gw.poll()
    assert [r.rid for r in out] == [rid]
    res = gw.take(rid)
    assert res.flush_reason == "timeout" and res.batch == 1 and res.verified
    assert gw.stats.flushes_timeout == 1


def test_gateway_backpressure_rejects_at_submit():
    gw = _gw(_cfg(max_batch=100, max_wait_us=1e9, max_pending=3))
    rids = [gw.submit(_mat(5, seed=30 + i)) for i in range(3)]
    with pytest.raises(GatewayOverloaded):
        gw.submit(_mat(5, seed=99))
    assert gw.stats.rejected == 1 and gw.stats.submitted == 3
    assert gw.pending == 3
    gw.drain()
    for rid in rids:
        assert gw.take(rid).verified


def test_gateway_oversize_runs_direct():
    gw = _gw()
    rid = gw.submit(_mat(20, seed=4))
    res = gw.take(rid)
    assert res is not None and res.verified
    assert res.flush_reason == "direct" and res.batch == 1
    assert res.pad_to == 20
    assert gw.stats.direct == 1 and gw.stats.flushes == 0
    assert _matches_numpy(res.det, _mat(20, seed=4))


def test_gateway_security_config_overrides_open_buckets():
    gw = _gw(_cfg(max_batch=2, max_wait_us=1e9))
    a = gw.submit(_mat(5, seed=5))
    b = gw.submit(_mat(5, seed=6), method="q2")
    c = gw.submit(_mat(5, seed=7), lambda1=64)
    assert gw.take(a) is None and gw.take(b) is None and gw.pending == 3
    gw.drain()
    ra, rb, rc = gw.take(a), gw.take(b), gw.take(c)
    assert ra.verified and rb.verified and rc.verified
    assert gw.stats.flushes == 3


def test_gateway_dtype_override_opens_separate_bucket():
    gw = _gw(SPDCGatewayConfig(name="t-mixdt", buckets=(32,), max_batch=8,
                               spdc=SPDCConfig(num_servers=4)))
    m = _mat(24, seed=3)
    r64 = gw.submit(m)
    r32 = gw.submit(m, dtype="float32")
    r32b = gw.submit(_mat(20, seed=4), dtype=torch.float32)  # same bucket
    gw.drain()
    a, b = gw.take(r64), gw.take(r32)
    assert a.det.dtype == "float64" and b.det.dtype == "float32"
    assert a.batch == 1 and b.batch == 2 and gw.take(r32b).verified
    assert a.verified and b.verified
    ws, wl = np.linalg.slogdet(m)
    assert abs(a.det.logabs - wl) <= 1e-8
    assert abs(b.det.logabs - wl) <= F32_DLOG
    assert gw.stats.flushes == 2


def test_f32_gateway_bucket_serves_verified():
    gw = _gw(SPDCGatewayConfig(name="t-f32", buckets=(64,), max_batch=4,
                               spdc=SPDCConfig(num_servers=4,
                                               dtype="float32")))
    mats = [_mat(48 + 3 * i, seed=40 + i) for i in range(4)]
    rids = [gw.submit(m) for m in mats]
    for m, rid in zip(mats, rids):
        r = gw.take(rid)
        ws, wl = np.linalg.slogdet(m)
        assert r is not None and r.verified and r.flush_reason == "full"
        assert r.det.dtype == "float32" and r.det.sign == ws
        assert abs(r.det.logabs - wl) <= F32_DLOG
        assert r.batch == 4


def test_gateway_submit_override_rides_synthesized_bucket():
    gw = _gw(SPDCGatewayConfig(name="t-n3", buckets=(64,), max_batch=2,
                               spdc=SPDCConfig(num_servers=4,
                                               dtype="float32")))
    rids = [gw.submit(_mat(20, seed=i), num_servers=3) for i in range(2)]
    results = [gw.take(r) for r in rids]
    assert all(r is not None and r.verified for r in results)
    assert results[0].batch == 2
    assert results[0].pad_to == 48
    assert gw.stats.direct == 0


def test_gateway_burst_flushes_in_max_batch_chunks():
    gw = _gw(_cfg(max_batch=2, max_wait_us=1e9), auto_flush=False)
    rids = [gw.submit(_mat(5, seed=40 + i)) for i in range(5)]
    gw.poll()
    assert gw.stats.flushes == 2 and gw.pending == 1
    gw.drain()
    assert gw.pending == 0
    assert sorted(gw.take(r).batch for r in rids) == [1, 2, 2, 2, 2]


def test_gateway_rejects_bad_submissions_loudly():
    gw = _gw()
    with pytest.raises(TypeError, match="unknown submit"):
        gw.submit(_mat(5), recovery=True)
    with pytest.raises(ValueError, match="square"):
        gw.submit(np.ones((3, 4)))
    with pytest.raises(ValueError, match="at least 2x2"):
        gw.submit(np.ones((1, 1)))
    with pytest.raises(ValueError, match="non-finite"):
        gw.submit(np.full((4, 4), np.nan))
    with pytest.raises(ValueError, match="unknown op"):
        gw.submit(_mat(5), op="inverse")
    with pytest.raises(ValueError, match="needs an rhs"):
        gw.submit(_mat(5), op="solve")
    with pytest.raises(ValueError, match="takes no rhs"):
        gw.submit(_mat(5), rhs=np.ones(5))
    assert gw.pending == 0


def test_gateway_op_buckets_slogdet_and_solve():
    """op="slogdet" answers the overflow-safe pair from the det sweep;
    op="solve" runs a verified LinalgSession per request; each op keys
    its own bucket."""
    gw = _gw(_cfg(max_batch=2, max_wait_us=1e9))
    m1, m2 = _mat(6, seed=61), _mat(7, seed=62)
    b = np.random.default_rng(63).standard_normal((7, 2))
    s = gw.submit(m1, op="slogdet")
    d = gw.submit(m1)
    x = gw.submit(m2, op="solve", rhs=b)
    gw.drain()
    rs, rd, rx = gw.take(s), gw.take(d), gw.take(x)
    assert gw.stats.flushes == 3
    assert rs.op == "slogdet" and (rs.sign, rs.logabs) == (rd.det.sign,
                                                           rd.det.logabs)
    assert _matches_numpy(rs.det, m1)
    assert rx.op == "solve" and rx.verified and rx.det is None
    y = np.asarray(torch.as_tensor(rx.solution))
    np.testing.assert_allclose(y, np.linalg.solve(m2, b), rtol=1e-9,
                               atol=1e-12)


def test_gateway_sweep_failure_fails_requests_not_service():
    gw = _gw(_cfg(max_batch=2),
             faults_for=lambda key: (_ for _ in ()).throw(
                 RuntimeError("injected sweep failure")))
    r0 = gw.submit(_mat(5, seed=1))
    r1 = gw.submit(_mat(6, seed=2))
    res0, res1 = gw.take(r0), gw.take(r1)
    assert res0 is not None and res1 is not None
    assert not res0.verified and "injected sweep failure" in res0.error
    assert res0.det is None and res1.det is None
    assert gw.stats.failed == 2 and gw.pending == 0
    gw._faults_for = None
    r2 = gw.submit(_mat(5, seed=3))
    r3 = gw.submit(_mat(6, seed=4))
    assert gw.take(r2).verified and gw.take(r3).verified


def test_gateway_threadpool_transport():
    gw = _gw(SPDCGatewayConfig(
        name="gw-tp-test", buckets=(16,), max_batch=4, pad_batches=False,
        spdc=SPDCConfig(num_servers=2, transport="threadpool")))
    mats = [_mat(k, seed=100 + k) for k in (8, 12, 16, 10)]
    rids = [gw.submit(m) for m in mats]
    gw.drain()
    for rid, m in zip(rids, mats):
        r = gw.take(rid)
        assert r is not None and r.verified and _matches_numpy(r.det, m)


def test_gateway_coalesces_rateless_sweeps():
    cfg = SPDCGatewayConfig(name="gw-rateless-test", buckets=(32, 64),
                            max_batch=4, pad_batches=False,
                            spdc=SPDC_EDGE_RATELESS)
    gw = _gw(cfg)
    mats = [_mat(k, seed=200 + k) for k in (20, 30, 32, 25)]
    rids = [gw.submit(m) for m in mats]
    gw.drain()
    for rid, m in zip(rids, mats):
        r = gw.take(rid)
        assert r is not None and r.verified
        assert _matches_numpy(r.det, m, rtol=1e-8)
    key = gw._key_for(30, {})
    assert key.rateless and key.pad_to == 32
    assert key != gw._key_for(30, {"rateless": False})
    with pytest.raises(ValueError, match="rateless"):
        _gw(SPDCGatewayConfig(buckets=(12,), spdc=SPDC_EDGE_RATELESS))
    assert "rateless" in BucketKey(pad_to=64, num_servers=4).protocol_kwargs()


# ----------------------------------------------------------- fault isolation


def test_tampered_bucket_pays_recovery_alone():
    """A tampering server poisons one bucket's sweep; recovery heals that
    bucket and the co-batched clean bucket never pays for it."""
    cfg = _cfg(max_batch=3, max_wait_us=1e9,
               spdc=SPDCConfig(num_servers=2, recover=True, standby=1))

    def faults_for(key):
        return ServerFault(server=1) if key.pad_to == 8 else None

    gw = _gw(cfg, faults_for=faults_for)
    small = [_mat(n, seed=50 + n) for n in (4, 6, 7)]
    big = [_mat(n, seed=60 + n) for n in (10, 14, 16)]
    rids_s = [gw.submit(m) for m in small]
    rids_b = [gw.submit(m) for m in big]
    rs = [gw.take(r) for r in rids_s]
    rb = [gw.take(r) for r in rids_b]
    for m, r in zip(small, rs):
        assert r.verified and r.recovery is not None and r.recovery.ok
        assert r.recovery.factors is None
        assert _matches_numpy(r.det, m)
    for m, r in zip(big, rb):
        assert r.verified and r.recovery is None
        assert _matches_numpy(r.det, m)
    assert gw.stats.recovered_flushes == 1
    assert gw.stats.flushes == 2


# ------------------------------------------------------------- async surface


def test_async_gateway_serves_concurrent_clients():
    cfg = _cfg(max_batch=4, max_wait_us=3000.0)
    mats = [_mat(n, seed=70 + n) for n in (3, 12, 5, 16, 8, 9, 4, 14)]

    async def main():
        async with AsyncSPDCGateway(cfg, device=CPU) as gw:
            return await asyncio.gather(*(gw.submit(m) for m in mats))

    results = asyncio.run(main())
    assert len(results) == len(mats)
    for m, r in zip(mats, results):
        assert r.verified and _matches_numpy(r.det, m)


def test_async_gateway_backpressure_raises():
    cfg = _cfg(max_batch=100, max_wait_us=1e9, max_pending=2)

    async def main():
        async with AsyncSPDCGateway(cfg, device=CPU) as gw:
            t1 = asyncio.ensure_future(gw.submit(_mat(5, seed=1)))
            t2 = asyncio.ensure_future(gw.submit(_mat(5, seed=2)))
            while gw.pending < 2:
                await asyncio.sleep(0.001)
            with pytest.raises(GatewayOverloaded):
                await gw.submit(_mat(5, seed=3))
        return await asyncio.gather(t1, t2)

    r1, r2 = asyncio.run(main())
    assert r1.verified and r2.verified


# ------------------------------------------------------------- lock assertions


def test_assert_owns_lock_semantics():
    import threading

    from repro_torch.serve.locking import assert_owns_lock

    rl = threading.RLock()
    with pytest.raises(AssertionError, match="without holding"):
        assert_owns_lock(rl, "thing")
    with rl:
        assert_owns_lock(rl, "thing")
    pl = threading.Lock()
    with pytest.raises(AssertionError):
        assert_owns_lock(pl)
    with pl:
        assert_owns_lock(pl)
    assert not pl.locked()


def test_gateway_deliver_requires_lock_at_runtime():
    gw = _gw()
    gres = GatewayResult(
        rid=1, det=None, verified=False, residual=0.0, n=8, pad_to=8,
        batch=1, flush_reason="direct", submitted_at=0.0, completed_at=0.0,
        error="x",
    )
    with pytest.raises(AssertionError, match="gateway results"):
        gw._deliver(gres, "b8")
    with gw._lock:
        gw._deliver(gres, "b8")
    assert gw.take(1) is gres
