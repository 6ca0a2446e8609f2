"""Verification-driven recovery of the port against the JAX reference, on
the CPU: localize → re-dispatch one shard → splice.

Mirrors tests/test_recovery.py and the recovery cases of
tests/test_api.py (thread pool; worker processes at n = 16, one
method). Both packages get the same numpy inputs, sized so the border is
absent (p = 0) and the ciphertexts are bit-equal. Bars: the port's
RecoveryReport equals the reference's in rounds, servers, replacements,
comm_elements, sub-seed hex, spliced matrices and standby_used, with
residuals within 1e-8 relative; the healed determinant equals the
honest one at rtol 1e-10; on the inline transport the healed L and U are
bit-equal to the honest run's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import ServerFault as RServerFault
from repro.core import lu_block_row as r_lu_block_row
from repro.core import lu_nserver as r_lu_nserver
from repro.core import outsource_determinant as r_outsource
from repro.distrib import recovery as r_recovery
from repro_torch import ServerFault
from repro_torch.api import (InlineTransport, MultiprocessTransport,
                             SPDCClient)
from repro_torch.core.augment import augment, border_rng
from repro_torch.core.lu import lu_block_row, lu_nserver
from repro_torch.core.verify import authenticate
from repro_torch.distrib.recovery import (
    RecoveryReport, ServerPool, dispatch_subseed, recover_lu,
    recovery_comm_elements, rederive_shard, trisolve_subseed,
)

N = 4
CPU = "cpu"


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    if batch is None:
        return rng.standard_normal((n, n)) + n * np.eye(n)
    return rng.standard_normal((batch, n, n)) + n * np.eye(n)


def _r_fault(f):
    """The reference's ServerFault with the port's fields."""
    return RServerFault(**dataclasses.asdict(f))


def _port(m, faults=None, **kw):
    return repro_torch.outsource_determinant(m, N, device=CPU, faults=faults,
                                             **kw)


def _ref(m, faults=None, **kw):
    plan = None
    if faults is not None:
        plan = (tuple(_r_fault(f) for f in faults)
                if isinstance(faults, tuple) else _r_fault(faults))
    return r_outsource(m, N, faults=plan, **kw)


def _same_report(got, want):
    assert isinstance(got, RecoveryReport)
    assert (got.ok, got.rounds, got.standby_used) == \
        (want.ok, want.rounds, want.standby_used)
    assert len(got.events) == len(want.events)
    for g, w in zip(got.events, want.events):
        assert (g.round, g.server, g.replacement, g.comm_elements, g.subseed,
                g.matrices) == (w.round, w.server, w.replacement,
                                w.comm_elements, w.subseed, w.matrices)
        assert abs(g.residual - w.residual) <= 1e-8 * abs(w.residual)


def _healed_factors(m, fault, standby):
    """(healed, honest) factor pairs of one inline run: the healed pair
    as Session.collect spliced it and Decipher read it
    (RecoveryReport.factors), the honest pair the sweep of the same
    session's augmented ciphertext."""
    client = SPDCClient(device=CPU, recover=True, standby=standby)
    session = client.open_session(m, N, faults=fault)
    res = session.run(InlineTransport(device=CPU))
    rep = res.report.recovery
    assert res.verified and rep.ok and rep.rounds >= 1
    honest = lu_nserver(session.x_aug, N)[:2]
    return rep.factors, honest, session.x_aug


SINGLE_SERVER_FAULTS = [
    ServerFault(server=s, kind=kind, mode=mode, target=target)
    for s in range(N)
    for kind, mode, target in [
        ("tamper", "single", "u"),
        ("tamper", "sign_flip", "l"),
        ("tamper", "block", "lu"),
        ("dropout", "single", "u"),
    ]
]


# ------------------------------------------------------------- acceptance
@pytest.mark.parametrize(
    "fault", SINGLE_SERVER_FAULTS,
    ids=[f"s{f.server}-{f.kind}-{f.mode}-{f.target}"
         for f in SINGLE_SERVER_FAULTS],
)
def test_recovery_end_to_end_single_matrix(fault):
    """Any single server tampering or dropping out: localized, one shard
    re-dispatched to the standby, the reference's report, Q2 and Q3
    pass, det == honest at rtol 1e-10, healed factors bit-equal."""
    n = 32
    m = _wellcond(n, seed=fault.server + 7)
    honest = _port(m)
    res = _port(m, fault, recover=True, standby=1)
    assert res.verified
    rep = res.report.recovery
    assert rep.ok and rep.rounds == 1
    assert rep.servers_replaced == (fault.server,)
    assert rep.standby_used == 1 and rep.events[0].replacement == N
    _same_report(rep, _ref(m, fault, recover=True, standby=1).report.recovery)

    (l2, u2), (lh, uh), x_aug = _healed_factors(m, fault, standby=1)
    assert torch.equal(l2, lh) and torch.equal(u2, uh)
    for method in ("q2", "q3"):
        v = authenticate(l2, u2, x_aug, num_servers=N, method=method)
        assert v.ok, (method, v.residual)
    assert res.report.verdict.ok and res.report.verdict.method == "q3"
    assert res.det.sign == honest.det.sign
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)
    want_s, want_la = np.linalg.slogdet(m)
    assert res.det.sign == want_s
    np.testing.assert_allclose(res.det.logabs, want_la, rtol=1e-10)


@pytest.mark.parametrize("kind", ["tamper", "dropout"])
def test_recovery_end_to_end_batched(kind):
    """Per-matrix faults on different servers heal in one pass; every det
    matches the honest one at rtol 1e-10; Q2 heals the same batch."""
    m = _wellcond(32, seed=11, batch=5)
    honest = _port(m)
    plan = (ServerFault(server=1, kind=kind, matrices=(0,)),
            ServerFault(server=3, kind=kind, matrices=(2, 4)))
    res = _port(m, plan, recover=True, standby=2)
    assert res.verified.all() and res.report.recovery.ok
    assert res.report.recovery.servers_replaced == (1, 3)
    spliced = {e.server: e.matrices for e in res.report.recovery.events}
    assert spliced[1] == (0,) and spliced[3] == (2, 4)
    _same_report(res.report.recovery,
                 _ref(m, plan, recover=True, standby=2).report.recovery)
    res_q2 = _port(m, plan, method="q2", recover=True, standby=2)
    assert res_q2.verified.all() and res_q2.report.recovery.ok
    for got, want in zip(res.dets, honest.dets):
        assert got.sign == want.sign
        np.testing.assert_allclose(got.logabs, want.logabs, rtol=1e-10)


def test_recovery_distributed_pipeline():
    """Faults injected on the pipeline (distributed=True, ROADMAP A12)
    heal the same way, repaired in the pipeline's operation order: the
    first re-dispatch targets the faulty server with the reference's
    event, within N rounds, and the determinant equals the honest one
    at rtol 1e-10."""
    m = _wellcond(32, seed=13)
    honest = _port(m)
    fault = ServerFault(server=2, kind="dropout")
    res = _port(m, fault, distributed=True, recover=True, standby=1)
    want = _ref(m, fault, distributed=True, recover=True, standby=1)
    rep = res.report.recovery
    assert res.verified and rep.ok and want.verified
    assert rep.events[0].server == 2 and rep.rounds <= N
    _same_report(rep, want.report.recovery)
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)


def test_recovery_in_band_cascade():
    """Relay poisoning: the tampered U row was consumed downstream, so the
    loop heals one block row per round — the reference's rounds and
    events — and the healed factors are bit-equal to the honest run's."""
    m = _wellcond(32, seed=17)
    honest = _port(m)
    fault = ServerFault(server=1, in_band=True, mode="block", magnitude=0.3)
    res = _port(m, fault, recover=True, standby=N)
    assert res.verified and res.report.recovery.ok
    assert 2 <= res.report.recovery.rounds <= N
    assert 1 in res.report.recovery.servers_replaced
    _same_report(res.report.recovery,
                 _ref(m, fault, recover=True, standby=N).report.recovery)
    (l2, u2), (lh, uh), _ = _healed_factors(m, fault, standby=N)
    assert torch.equal(l2, lh) and torch.equal(u2, uh)
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)


def test_recovery_straggler_redispatch():
    """A server slower than the deadline counts as dropped and its shard
    is re-dispatched; within the deadline the client just waits."""
    m = _wellcond(32, seed=19)
    fault = ServerFault(server=2, kind="delay", delay_rounds=6)
    late = _port(m, fault, straggler_deadline=3, recover=True, standby=1)
    assert late.verified and late.report.recovery.servers_replaced == (2,)
    _same_report(late.report.recovery,
                 _ref(m, fault, straggler_deadline=3, recover=True,
                      standby=1).report.recovery)
    ontime = _port(m, fault, straggler_deadline=10)
    assert ontime.verified and ontime.report.recovery is None


def test_recovery_without_standby_uses_healthy_neighbor():
    m = _wellcond(32, seed=23)
    res = _port(m, ServerFault(server=1), recover=True, standby=0)
    assert res.verified
    assert res.report.recovery.standby_used == 0
    assert res.report.recovery.events[0].replacement == 2
    _same_report(res.report.recovery,
                 _ref(m, ServerFault(server=1), recover=True,
                      standby=0).report.recovery)


def test_recovery_cost_is_one_shard_not_full_restart():
    n = 64
    m = _wellcond(n, seed=29)
    res = _port(m, ServerFault(server=0), recover=True, standby=1)
    for e in res.report.recovery.events:
        assert e.comm_elements < n * n
    for s in range(N):
        assert recovery_comm_elements(n, N, s) == \
            r_recovery.recovery_comm_elements(n, N, s)
    assert recovery_comm_elements(n, N, 0) == 3 * (n // N) * n


# ------------------------------------------------------------- unit pieces
def test_lu_block_row_matches_honest_rows():
    a = _wellcond(24, seed=31)
    l, u, _ = lu_nserver(torch.from_numpy(a), N)
    _, r_u, _ = r_lu_nserver(jnp.asarray(a), N)
    b = 24 // N
    for s in range(N):
        lr, ur = lu_block_row(torch.from_numpy(a), u, s, N)
        assert torch.equal(lr, l[s * b : (s + 1) * b])
        assert torch.equal(ur, u[s * b : (s + 1) * b])
        w_l, w_u = r_lu_block_row(jnp.asarray(a), r_u, s, N)
        np.testing.assert_allclose(lr.numpy(), np.asarray(w_l), atol=1e-10)
        np.testing.assert_allclose(ur.numpy(), np.asarray(w_u), atol=1e-10)


def test_lu_block_row_ignores_corrupted_own_and_downstream_rows():
    a = torch.from_numpy(_wellcond(24, seed=37))
    _, u, _ = lu_nserver(a, N)
    b = 24 // N
    u_bad = u.clone()
    u_bad[2 * b :, :] = 999.0
    _, ur = lu_block_row(a, u_bad, 2, N)
    assert torch.equal(ur, u[2 * b : 3 * b])


def test_recover_lu_direct_api():
    a = _wellcond(24, seed=41)
    plan = (ServerFault(server=3, kind="dropout"),)
    l, u, _ = lu_nserver(torch.from_numpy(a), N, faults=plan)
    l2, u2, verdict, report = recover_lu(
        l, u, torch.from_numpy(a), num_servers=N, standby=1, digest=b"t")
    assert verdict.ok and report.ok and report.servers_replaced == (3,)
    assert report.factors[0] is l2 and report.factors[1] is u2
    np.testing.assert_allclose((l2 @ u2).numpy(), a, atol=1e-8)
    r_l, r_u, _ = r_lu_nserver(jnp.asarray(a), N,
                               faults=(_r_fault(plan[0]),))
    *_, r_report = r_recovery.recover_lu(r_l, r_u, jnp.asarray(a),
                                         num_servers=N, standby=1,
                                         digest=b"t")
    _same_report(report, r_report)


def test_server_pool_standby_then_neighbor():
    for pool in (ServerPool(num_servers=4, standby=2),
                 r_recovery.ServerPool(num_servers=4, standby=2)):
        p1, pool = pool.replacement_for(1)
        p2, pool = pool.replacement_for(2)
        p3, pool = pool.replacement_for(3)
        assert (p1, p2, p3) == (4, 5, 0)
        assert pool.spares_used == 2 and pool.retired == (1, 2, 3)


def test_server_pool_standby_exhaustion_batched():
    """More culprits than spares: both standbys, then healthy neighbours;
    every matrix heals and every re-dispatch has a fresh sub-seed."""
    m = _wellcond(32, seed=61, batch=4)
    honest = _port(m)
    plan = (ServerFault(server=0, kind="tamper", matrices=(0,)),
            ServerFault(server=1, kind="dropout", matrices=(1,)),
            ServerFault(server=2, kind="tamper", mode="sign_flip",
                        matrices=(2,)),
            ServerFault(server=3, kind="dropout", matrices=(3,)))
    res = _port(m, plan, recover=True, standby=2)
    assert np.asarray(res.verified).all()
    rep = res.report.recovery
    assert rep.ok and rep.standby_used == 2
    assert rep.servers_replaced == (0, 1, 2, 3)
    repl = [e.replacement for e in rep.events]
    assert repl[:2] == [N, N + 1] and all(r < N for r in repl[2:])
    assert all(e.replacement != e.server for e in rep.events)
    assert len({e.subseed for e in rep.events}) == len(rep.events)
    _same_report(rep, _ref(m, plan, recover=True, standby=2).report.recovery)
    for got, want in zip(res.dets, honest.dets):
        assert got.sign == want.sign
        np.testing.assert_allclose(got.logabs, want.logabs, rtol=1e-10)


def test_standby_exhaustion_cascade_fresh_subseed_per_attempt():
    m = _wellcond(32, seed=67)
    honest = _port(m)
    fault = ServerFault(server=1, in_band=True, mode="block", magnitude=0.3)
    res = _port(m, fault, recover=True, standby=1)
    rep = res.report.recovery
    assert res.verified and rep.ok and rep.rounds >= 2
    assert rep.standby_used == 1
    repl = [e.replacement for e in rep.events]
    assert repl[0] == N and any(r < N for r in repl[1:])
    assert len({e.subseed for e in rep.events}) == len(rep.events)
    _same_report(rep, _ref(m, fault, recover=True, standby=1).report.recovery)
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)


def test_dispatch_and_trisolve_subseeds_match_reference():
    d = b"\x01" * 32
    seeds = {dispatch_subseed(d, 2, 1), dispatch_subseed(d, 2, 2),
             dispatch_subseed(d, 3, 1)}
    assert len(seeds) == 3
    for server, attempt in ((2, 1), (3, 0), (0, 7)):
        assert dispatch_subseed(d, server, attempt) == \
            r_recovery.dispatch_subseed(d, server, attempt)
    assert trisolve_subseed(d, 1, 2, 3) == r_recovery.trisolve_subseed(d, 1, 2, 3)
    assert trisolve_subseed(d, 1, 2, 3) not in seeds


@pytest.mark.parametrize("batch", [None, 3])
def test_rederive_shard_matches_full_augmentation(batch):
    """The shard replays the port's own numpy R draw (ROADMAP §C): bit
    for bit the slice of the full augmentation."""
    shape = (10, 10) if batch is None else (batch, 10, 10)
    x = torch.from_numpy(np.random.default_rng(43).standard_normal(shape))
    digest = bytes(range(32))
    p = 2  # 10 + 2 = 12 = 4 · 3
    x_aug = augment(x, p, rng=border_rng(digest))
    b = x_aug.shape[-1] // N
    for s in range(N):
        shard = rederive_shard(x, padding=p, server=s, num_servers=N,
                               rng=border_rng(digest))
        assert torch.equal(shard, x_aug[..., s * b : (s + 1) * b, :])
    with pytest.raises(ValueError, match="partitioned"):
        rederive_shard(x, padding=1, server=0, num_servers=N)


def test_hardened_config_profile_drives_recovery():
    """SPDC_EDGE_HARDENED's standby/recover/straggler fields map onto the
    protocol signature, with the reference's recovery report."""
    from repro.configs import SPDC_EDGE_HARDENED as r_cfg
    from repro_torch.configs import SPDC_EDGE_HARDENED as cfg

    assert cfg == type(cfg)(**dataclasses.asdict(r_cfg))
    assert cfg.recover and cfg.standby == 2
    m = _wellcond(32, seed=53)
    got = _port(m, ServerFault(server=1), **cfg.protocol_kwargs())
    want = _ref(m, ServerFault(server=1), **r_cfg.protocol_kwargs())
    assert got.verified and got.report.recovery.ok
    assert got.report.recovery.events[0].replacement == N
    assert got.report.recovery.servers_replaced \
        == want.report.recovery.servers_replaced


def test_server_pool_never_returns_culprit_when_avoidable():
    for pool in (ServerPool(num_servers=2, standby=0),
                 r_recovery.ServerPool(num_servers=2, standby=0)):
        p0, pool = pool.replacement_for(0)
        p1, pool = pool.replacement_for(1)
        assert (p0, p1) == (1, 0)


def test_recover_lu_stops_once_verdict_accepts():
    a = torch.from_numpy(_wellcond(24, seed=59))
    l, u, _ = lu_nserver(a, N)
    v0 = authenticate(l, u, a, num_servers=N)
    l2, u2, v, rep = recover_lu(l, u, a, num_servers=N, standby=1, verdict=v0)
    assert rep.ok and rep.rounds == 0 and rep.events == []
    assert l2 is l and u2 is u
    assert rep.factors[0] is l and rep.factors[1] is u


def test_unrecoverable_without_recover_flag():
    m = _wellcond(24, seed=47)
    res = _port(m, ServerFault(server=1))
    assert not res.verified
    assert res.report.recovery is None
    assert res.report.verdict.culprit == 1


# ------------------------------------------------------ message transports
def test_threadpool_recovery_emits_fresh_shard_tasks():
    """Over the thread pool the relay forwarded the tampered row, so
    healing cascades one row per round, each re-issue under a fresh
    sub-seed; the healed det matches the honest one at rtol 1e-10."""
    m = _wellcond(16, seed=29)
    honest = _port(m)
    fault = ServerFault(server=1, mode="block")
    res = _port(m, fault, method="q2", recover=True, standby=1,
                transport="threadpool")
    rep = res.report.recovery
    assert res.verified and rep.ok and 1 in rep.servers_replaced
    assert 2 <= rep.rounds <= N
    assert len({e.subseed for e in rep.events}) == len(rep.events)
    _same_report(rep, _ref(m, fault, method="q2", recover=True, standby=1,
                           transport="threadpool").report.recovery)
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)


def test_multiprocess_acceptance_tamper_recovery():
    """Four worker processes, worker 1 tampers in band; the client
    localizes it and heals through re-dispatched ShardTasks on a standby
    process; the det matches the honest run and numpy at rtol 1e-10."""
    m = _wellcond(16, seed=37)
    honest = _port(m)
    fault = ServerFault(server=1, mode="block", magnitude=0.3)
    with MultiprocessTransport(device=CPU) as mp:
        res = _port(m, fault, recover=True, standby=1, transport=mp)
        assert N in mp.workers  # the standby ran in a process of its own
    rep = res.report.recovery
    assert res.verified and rep.ok
    assert rep.events[0].server == 1 and 1 in rep.servers_replaced
    assert res.det.sign == honest.det.sign
    np.testing.assert_allclose(res.det.logabs, honest.det.logabs, rtol=1e-10)
    ws, wl = np.linalg.slogdet(m)
    assert res.det.sign == ws
    np.testing.assert_allclose(res.det.logabs, wl, rtol=1e-10)
