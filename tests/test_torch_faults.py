"""The port's fault models (core/faults.py) and faulted `lu_nserver`
against the JAX reference, on the CPU.

Positions, delays and plan handling are host arithmetic and must be
equal to the reference's. Report-level corruption applied to the same
factors must be bit-equal. Faulted sweeps — report-level and in-band —
must give the reference's verdicts and culprits on the same inputs.
These mirror the non-recovery cases of tests/test_faults.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as r_faults
from repro.core import lu as r_lu
from repro.core import verify as r_verify
from repro_torch.core import faults as t_faults
from repro_torch.core import lu as t_lu
from repro_torch.core import verify as t_verify

N = 4
B_N = 16  # matrix size for most cases (b = 4 per server)


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.standard_normal(shape) + n * np.eye(n)


def _pair(**fields):
    """The same ServerFault in both packages."""
    return r_faults.ServerFault(**fields), t_faults.ServerFault(**fields)


PLANS = [
    dict(server=0),
    dict(server=1, mode="sign_flip", seed=3),
    dict(server=2, mode="block", target="lu", magnitude=0.3),
    dict(server=3, target="l", seed=7),
    dict(server=0, target="l", seed=11),
    dict(server=2, kind="dropout"),
    dict(server=1, kind="dropout", matrices=(0, 2)),
    dict(server=3, mode="single", matrices=(1,), seed=5),
    dict(server=2, in_band=True),
    dict(server=1, kind="delay", delay_rounds=5),
    dict(server=1, kind="delay", delay_s=0.25, delay_dist="exponential", seed=2),
    dict(server=3, kind="delay", delay_s=0.5, delay_dist="pareto", seed=9),
]


@pytest.fixture(scope="module")
def honest():
    """Honest factors of one matrix and of a 3-stack, from the reference."""
    out = {}
    for batch in (None, 3):
        a = _wellcond(B_N, seed=1, batch=batch)
        l, u, _ = r_lu.lu_nserver(jnp.asarray(a), N)
        out[batch] = (a, np.asarray(l), np.asarray(u))
    return out


# ----------------------------------------------------------- plan handling
def test_fault_plan_normalization_and_validation():
    f = t_faults.ServerFault(server=1)
    assert t_faults.normalize_plan(None) == ()
    assert t_faults.normalize_plan(f) == (f,)
    assert t_faults.normalize_plan([f, f]) == (f, f)
    for bad, match in ((dict(kind="gremlin"), "unknown fault kind"),
                       (dict(mode="subtle"), "unknown tamper mode"),
                       (dict(kind="dropout", in_band=True), "in_band"),
                       (dict(target="x"), "target"),
                       (dict(delay_dist="pareto", delay_alpha=1.0), "pareto")):
        with pytest.raises(ValueError, match=match):
            t_faults.ServerFault(server=0, **bad)
    with pytest.raises(TypeError):
        t_faults.normalize_plan(["not a fault"])


@pytest.mark.parametrize("deadline", [None, 3, 8])
def test_resolve_delays_and_split_plan_match_reference(deadline):
    pairs = [_pair(**p) for p in PLANS]
    want = r_faults.resolve_delays([r for r, _ in pairs], deadline)
    got = t_faults.resolve_delays([t for _, t in pairs], deadline)
    assert [vars(f) for f in got] == [vars(f) for f in want]
    r_in, r_rep = r_faults.split_plan([r for r, _ in pairs])
    t_in, t_rep = t_faults.split_plan([t for _, t in pairs])
    assert [vars(f) for f in t_in] == [vars(f) for f in r_in]
    assert [vars(f) for f in t_rep] == [vars(f) for f in r_rep]


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_sample_delay_equals_reference(plan):
    r, t = _pair(**plan)
    for token in (b"", b"\x05" * 32):
        assert t_faults.sample_delay(t, token) == r_faults.sample_delay(r, token)


@pytest.mark.parametrize("factor", ["l", "u"])
@pytest.mark.parametrize("block,n", [(4, 16), (8, 32), (1024, 4096)])
def test_tamper_positions_equal_reference(factor, block, n):
    for server in range(n // block):
        for seed in range(6):
            r, t = _pair(server=server, seed=seed)
            kw = dict(block=block, n=n, factor=factor)
            assert t_faults._tamper_position(t, **kw) \
                == r_faults._tamper_position(r, **kw)


# ------------------------------------------------------ corrupting factors
@pytest.mark.parametrize("plan", PLANS[:8], ids=range(8))
@pytest.mark.parametrize("batch", [None, 3])
def test_corrupt_strip_and_apply_faults_equal_reference(honest, plan, batch):
    a, l, u = honest[batch]
    r, t = _pair(**plan)
    b = B_N // N
    rows = slice(r.server * b, (r.server + 1) * b)
    for factor, full in (("l", l), ("u", u)):
        want = r_faults.corrupt_strip(jnp.asarray(full[..., rows, :]), r,
                                      n=B_N, factor=factor)
        strip = torch.from_numpy(full[..., rows, :].copy())
        got = t_faults.corrupt_strip(strip, t, n=B_N, factor=factor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_l, want_u = r_faults.apply_faults(jnp.asarray(l), jnp.asarray(u),
                                           (r,), num_servers=N)
    lt, ut = torch.from_numpy(l.copy()), torch.from_numpy(u.copy())
    got_l, got_u = t_faults.apply_faults(lt, ut, (t,), num_servers=N)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    # the inputs are left as they were: corruption returns new tensors
    assert np.array_equal(lt.numpy(), l) and np.array_equal(ut.numpy(), u)


def test_apply_faults_rejects_a_server_outside_the_fleet(honest):
    _, l, u = honest[None]
    bad = t_faults.ServerFault(server=N)
    with pytest.raises(ValueError, match="server"):
        t_faults.apply_faults(torch.tensor(l), torch.tensor(u), (bad,),
                              num_servers=N)


@pytest.mark.parametrize("mode", ["single", "sign_flip", "block"])
@pytest.mark.parametrize("target", ["l", "u"])
def test_report_faults_touch_only_owner_strip(honest, mode, target):
    a, l, u = honest[None]
    b = B_N // N
    l, u = torch.tensor(l), torch.tensor(u)
    for s in range(N):
        f = t_faults.ServerFault(server=s, mode=mode, target=target)
        lf, uf = t_faults.apply_faults(l, u, (f,), num_servers=N)
        changed, same = (lf, uf) if target == "l" else (uf, lf)
        orig, other = (l, u) if target == "l" else (u, l)
        rows = slice(s * b, (s + 1) * b)
        assert not torch.allclose(changed[rows], orig[rows])
        mask = torch.ones(B_N, dtype=torch.bool)
        mask[rows] = False
        assert torch.equal(changed[mask], orig[mask])
        assert torch.equal(same, other)


# ------------------------------------------- faulted sweeps and verdicts
FAULTED_SWEEPS = [
    ("report single u", dict(server=1), None),
    ("report block lu", dict(server=2, mode="block", target="lu"), None),
    ("report dropout", dict(server=3, kind="dropout"), None),
    ("report sign_flip l", dict(server=2, mode="sign_flip", target="l"), None),
    ("in-band single u", dict(server=1, in_band=True), None),
    ("in-band block u", dict(server=2, mode="block", in_band=True), None),
    ("in-band single lu", dict(server=0, target="lu", in_band=True), None),
    ("batch in-band", dict(server=2, in_band=True, matrices=(1,)), 3),
    ("batch dropout", dict(server=1, kind="dropout", matrices=(0, 2)), 3),
]


@pytest.fixture(scope="module")
def faulted():
    """Both packages' faulted sweeps per case, computed once and held
    against each other at rtol 1e-10."""
    cache = {}

    def get(label, plan, batch):
        if label not in cache:
            a = _wellcond(B_N, seed=2, batch=batch)
            r, t = _pair(**plan)
            l_r, u_r, _ = r_lu.lu_nserver(jnp.asarray(a), N, faults=(r,))
            l_t, u_t, _ = t_lu.lu_nserver(torch.from_numpy(a), N, faults=(t,))
            np.testing.assert_allclose(l_t.numpy(), np.asarray(l_r),
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(u_t.numpy(), np.asarray(u_r),
                                       rtol=1e-10, atol=1e-12)
            cache[label] = (a, l_r, u_r, l_t, u_t)
        return cache[label]

    return get


@pytest.mark.parametrize("method", ["q1", "q2", "q3"])
@pytest.mark.parametrize("label,plan,batch", FAULTED_SWEEPS,
                         ids=[c[0] for c in FAULTED_SWEEPS])
def test_faulted_sweep_verdicts_match_reference(faulted, label, plan, batch,
                                                method):
    a, l_r, u_r, l_t, u_t = faulted(label, plan, batch)
    want = r_verify.authenticate(l_r, u_r, jnp.asarray(a), num_servers=N,
                                 method=method, rng=np.random.default_rng(5))
    got = t_verify.authenticate(l_t, u_t, torch.from_numpy(a), num_servers=N,
                                method=method, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(want.ok))
    np.testing.assert_array_equal(np.asarray(got.culprit),
                                  np.asarray(want.culprit))
    if method != "q3":
        # the probed checks see every entry; Q3 sees only the diagonal of
        # L·U, which an in-band tamper past the server's own diagonal
        # block leaves consistent — there the verdicts agree either way
        assert not np.all(got.ok)


def test_in_band_fault_poisons_downstream_only():
    a = torch.from_numpy(_wellcond(B_N, seed=2))
    l, u, _ = t_lu.lu_nserver(a, N)
    b = B_N // N
    li, ui, _ = t_lu.lu_nserver(
        a, N, faults=(t_faults.ServerFault(server=1, in_band=True),))
    assert torch.equal(li[:b], l[:b]) and torch.equal(ui[:b], u[:b])
    assert not torch.allclose(ui[b : 2 * b], u[b : 2 * b])
    assert not torch.allclose(li[2 * b :], l[2 * b :])


def test_batch_targeted_fault_hits_only_named_matrices():
    ab = torch.from_numpy(_wellcond(B_N, seed=3, batch=4))
    lh, uh, _ = t_lu.lu_nserver(ab, N)
    plan = (t_faults.ServerFault(server=2, kind="dropout", matrices=(1, 3)),)
    lf, uf, _ = t_lu.lu_nserver(ab, N, faults=plan)
    b = B_N // N
    for i in (1, 3):
        assert torch.all(uf[i, 2 * b : 3 * b] == 0)
    for i in (0, 2):
        assert torch.equal(uf[i], uh[i]) and torch.equal(lf[i], lh[i])


def test_dropout_never_accepted():
    for method in ("q1", "q2", "q3"):
        for s in range(N):
            a = torch.from_numpy(_wellcond(B_N, seed=400 + s))
            plan = (t_faults.ServerFault(server=s, kind="dropout"),)
            l, u, _ = t_lu.lu_nserver(a, N, faults=plan)
            v = t_verify.authenticate(l, u, a, num_servers=N, method=method)
            assert not v.ok and v.culprit == s
