"""The port's protocol end to end against the JAX reference, on the CPU.

Both packages get the same numpy inputs. Agreement means: ciphertexts
bit-equal (no border, p = 0), LU factors at rtol 1e-10 / atol 1e-12 in
f64 (the bound DESIGN.md §1.2 uses between LU implementations),
determinants by `Determinant.allclose` defaults, and the same verdicts,
honest and tampered. With a border (p > 0) the R block differs by design
(ROADMAP A2), so only determinants and verdicts are compared.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as r_api
import repro_torch
from repro.core import lu as r_lu
from repro.core import protocol as r_protocol
from repro_torch import interop
from repro_torch.api import SPDCClient
from repro_torch.core.faults import ServerFault
from repro_torch.core import lu as t_lu
from repro_torch.core.decipher import Determinant, decipher, decipher_batch
from repro_torch.core.verify import authenticate

CPU = "cpu"


def _matrix(n, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.standard_normal(shape) + n * np.eye(n)


def _same_det(got, want):
    """A port Determinant against a reference one (other class)."""
    return Determinant(**dataclasses.asdict(want)).allclose(got) \
        and got.dtype == want.dtype


#: (n, N, batch, growth_safe): b = 16 takes lu_unblocked, b = 64 the
#: blocked panel. n128_N2's seed gives k = 1: the rotation moves the
#: dominant diagonal onto the anti-diagonal and the no-pivot elimination
#: grows elements ~1300-fold; growth_safe keeps the diagonal in place.
CASES = {
    "n64_N4": (64, 4, None, False),
    "n128_N2": (128, 2, None, False),
    "n128_N2_growth_safe": (128, 2, None, True),
    "batch3_n64_N4": (64, 4, 3, False),
}
#: cases whose ciphertext the no-pivot LU factors without growth
GROWTH_FREE = ["n64_N4", "n128_N2_growth_safe", "batch3_n64_N4"]


@pytest.fixture(scope="module")
def pair():
    """Memoized (reference session, port session) per case."""
    cache = {}

    def get(case):
        if case not in cache:
            n, N, batch, gs = CASES[case]
            m = _matrix(n, n + N, batch)
            cache[case] = (
                r_api.SPDCClient(growth_safe=gs).open_session(m, N),
                SPDCClient(growth_safe=gs, device=CPU).open_session(m, N),
            )
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_ciphertext_bit_equal(pair, case):
    ref, port = pair(case)
    assert port.padding == ref.padding == 0
    np.testing.assert_array_equal(port.x_aug.numpy(), np.asarray(ref.x_aug))


@pytest.mark.parametrize("case", GROWTH_FREE)
def test_factors_agree(pair, case):
    ref, port = pair(case)
    N = CASES[case][1]
    l_r, u_r, log_r = r_lu.lu_nserver(ref.x_aug, N)
    x_before = port.x_aug.clone()
    l_t, u_t, log_t = t_lu.lu_nserver(port.x_aug, N)
    # the factorization must not touch the ciphertext Authenticate reads
    assert torch.equal(port.x_aug, x_before)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_r), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_r), rtol=1e-10, atol=1e-12)
    assert log_t.messages == log_r.messages


def test_factors_within_reference_spread_under_growth(pair):
    """With ~1300-fold element growth no two LU implementations agree to
    rtol 1e-10 — the reference's own lu_nserver and lu_unblocked differ
    by ~1.4e-9 relative here. The port must stay within that spread."""
    ref, port = pair("n128_N2")
    assert ref.metas[0].rotate_k % 2 == 1
    l_r, u_r, _ = r_lu.lu_nserver(ref.x_aug, 2)
    l_o, u_o = r_lu.lu_unblocked(ref.x_aug)
    l_t, u_t, _ = t_lu.lu_nserver(port.x_aug, 2)
    for got, want, other in ((l_t, l_r, l_o), (u_t, u_r, u_o)):
        spread = np.abs(np.asarray(other) - np.asarray(want)).max()
        assert np.abs(got.numpy() - np.asarray(want)).max() <= spread


@pytest.mark.parametrize("case", list(CASES))
def test_protocol_agrees(pair, case):
    ref, port = pair(case)
    want, got = ref.run(), port.run()
    if CASES[case][2] is None:
        assert got.verified is want.verified is True
        assert _same_det(got.det, want.det)
        assert dataclasses.astuple(got.meta) == dataclasses.astuple(want.meta)
    else:
        np.testing.assert_array_equal(got.verified, want.verified)
        assert got.verified.all() and got.batch == want.batch
        assert all(_same_det(g, w) for g, w in zip(got.dets, want.dets))
    np.testing.assert_allclose(got.report.verdict.eps, want.report.verdict.eps,
                               rtol=1e-8)
    assert got.comm.messages == want.comm.messages


@pytest.mark.parametrize("batch", [None, 2])
def test_padded_determinants_agree(batch):
    """n = 62, N = 4 borders with p = 2: R differs by design."""
    m = _matrix(62, 5, batch)
    want = r_protocol.outsource_determinant(m, 4)
    got = repro_torch.outsource_determinant(m, 4, device=CPU)
    assert got.padding == want.padding == 2
    sign, logabs = np.linalg.slogdet(m)
    if batch is None:
        assert got.verified and want.verified
        assert _same_det(got.det, want.det)
        assert got.det.allclose(Determinant(float(sign), float(logabs)))
    else:
        assert got.verified.all() and want.verified.all()
        assert all(_same_det(g, w) for g, w in zip(got.dets, want.dets))


@pytest.mark.parametrize("method", ["q1", "q2", "q3", "q3_literal"])
def test_methods_agree(method):
    m = _matrix(64, 1)
    want = r_protocol.outsource_determinant(m, 4, method=method)
    got = repro_torch.outsource_determinant(m, 4, method=method, device=CPU)
    assert got.verified is want.verified is True
    assert got.report.verdict.method == method
    np.testing.assert_allclose(got.report.verdict.eps, want.report.verdict.eps,
                               rtol=1e-8)
    assert _same_det(got.det, want.det)


def _tamper_pair(row, delta, matrix=None):
    """The same tamper for both packages: add delta to U[row, row] (of
    one matrix of a stack)."""
    idx = (row, row) if matrix is None else (matrix, row, row)

    def ref_tamper(l, u):
        return l, u.at[idx].add(delta)

    def port_tamper(l, u):
        u = u.clone()
        u[idx] += delta
        return l, u

    return ref_tamper, port_tamper


@pytest.mark.parametrize("method", ["q1", "q2", "q3"])
def test_tampered_run_rejected_by_both(method):
    """A tamper in server 2's diagonal block: both packages reject and
    blame server 2."""
    m = _matrix(64, 2)
    ref_t, port_t = _tamper_pair(2 * 16 + 5, 0.5)
    want = r_protocol.outsource_determinant(m, 4, method=method, tamper=ref_t)
    got = repro_torch.outsource_determinant(m, 4, method=method, tamper=port_t,
                                            device=CPU)
    assert got.verified is want.verified is False
    assert got.report.verdict.culprit == want.report.verdict.culprit == 2


def test_tampered_matrix_in_batch_rejected_alone():
    m = _matrix(64, 3, batch=3)
    ref_t, port_t = _tamper_pair(40, 0.5, matrix=1)
    want = r_protocol.outsource_determinant(m, 4, tamper=ref_t)
    got = repro_torch.outsource_determinant(m, 4, tamper=port_t, device=CPU)
    np.testing.assert_array_equal(got.verified, [True, False, True])
    np.testing.assert_array_equal(got.verified, want.verified)
    np.testing.assert_array_equal(got.report.verdict.culprit,
                                  want.report.verdict.culprit)


@pytest.mark.parametrize("case", ["n64_N4", "batch3_n64_N4"])
def test_reference_state_through_interop(pair, case):
    """The reference's seeds, cipher records and factors, carried over
    with interop, give the reference's verdict and determinant."""
    ref, _ = pair(case)
    N = CASES[case][1]
    l_r, u_r, _ = r_lu.lu_nserver(ref.x_aug, N)
    seeds = [interop.seed_from_numpy(s.psi, s.mu, s.m_max, s.digest)
             for s in ref.seeds]
    metas = [interop.meta_from_fields(**dataclasses.asdict(mt))
             for mt in ref.metas]
    l, u = interop.factors_from_numpy(l_r, u_r, device=CPU)
    x = torch.tensor(np.asarray(ref.x_aug))
    rng_r, rng_t = (r_protocol._probe_rng(ref.digest) for _ in range(2))
    want_v = r_api.client.authenticate(l_r, u_r, ref.x_aug, num_servers=N,
                                       method="q1", rng=rng_r)
    got_v = authenticate(l, u, x, num_servers=N, method="q1", rng=rng_t)
    # the residuals are rounding noise, comparable only through eps
    np.testing.assert_array_equal(got_v.ok, want_v.ok)
    assert np.all(got_v.ok)
    np.testing.assert_allclose(got_v.eps, want_v.eps, rtol=1e-8)
    if CASES[case][2] is None:
        want = r_api.client.decipher(ref.seeds[0], ref.metas[0], l_r, u_r)
        assert _same_det(decipher(seeds[0], metas[0], l, u), want)
    else:
        want = r_api.client.decipher_batch(ref.seeds, ref.metas, l_r, u_r)
        got = decipher_batch(seeds, metas, l, u)
        assert all(_same_det(g, w) for g, w in zip(got, want))


def test_keygen_from_interop_seed_matches_reference_key(pair):
    ref, port = pair("n64_N4")
    s = ref.seeds[0]
    seed = interop.seed_from_numpy(s.psi, s.mu, s.m_max, s.digest)
    from repro.core.keygen import keygen as r_keygen
    from repro_torch.core.keygen import keygen as t_keygen

    np.testing.assert_array_equal(t_keygen(128, seed, 64).v,
                                  r_keygen(128, s, 64).v)
    key = interop.key_from_numpy(r_keygen(128, s, 64).v)
    assert key.n == 64


def test_float32_protocol_verifies():
    """dtype="float32" turns the growth controls on, as in the reference."""
    m = _matrix(64, 4)
    got = repro_torch.outsource_determinant(m, 4, dtype="float32", device=CPU)
    sign, logabs = np.linalg.slogdet(m)
    assert got.verified and got.det.dtype == "float32"
    assert got.det.allclose(Determinant(float(sign), float(logabs)))


@pytest.mark.parametrize("kwargs,replaced", [
    ({"recover": True}, ()),
    ({"faults": ServerFault(server=1), "recover": True}, (1,)),
], ids=["honest", "tampered"])
def test_recover_flag_runs_recovery(kwargs, replaced):
    """recover=True (ROADMAP A8, ported): an honest run needs no
    re-dispatch and reports none; a tampering server's shard is
    re-dispatched and the result verifies."""
    m = _matrix(8, 0)
    got = repro_torch.outsource_determinant(m, 2, device=CPU, **kwargs)
    assert got.verified
    if replaced:
        assert got.report.recovery.ok
        assert got.report.recovery.servers_replaced == replaced
    else:
        assert got.report.recovery is None
    sign, logabs = np.linalg.slogdet(m)
    assert got.det.allclose(Determinant(float(sign), float(logabs)))


@pytest.mark.parametrize("kwargs", [
    {"transport": "shardmap"},
    {"distributed": True},
], ids=["shardmap", "distributed"])
def test_unported_features_raise(kwargs):
    """transport="shardmap" and distributed=True (ROADMAP A12, ported;
    they raised before): verified, the determinant and the verdict the
    reference's distributed run gives on the same input, no comm log
    (the pipeline's relay is the hop log of its mesh)."""
    m = _matrix(8, 0)
    got = repro_torch.outsource_determinant(m, 2, device=CPU, **kwargs)
    want = r_protocol.outsource_determinant(m, 2, **kwargs)
    assert got.verified and want.verified
    assert _same_det(got.det, want.det)
    assert got.comm is None and want.comm is None


@pytest.mark.parametrize("kwargs", [
    {"rateless": True},
    {"transport": "socket"},
], ids=["rateless", "socket"])
def test_a9_features_match_reference(kwargs):
    """rateless= and the bare "socket" transport (ROADMAP A9, ported; they
    raised before): N = 4 verified, the determinant the reference gives
    on the same input. The socket case self-hosts one daemon process per
    worker on the CPU and closes them."""
    m = _matrix(16, 0)
    # the reference's own determinant does not depend on its transport
    want = r_protocol.outsource_determinant(
        m, 4, rateless=kwargs.get("rateless", False))
    try:
        got = repro_torch.outsource_determinant(m, 4, device=CPU, **kwargs)
    finally:
        if "transport" in kwargs:
            from repro_torch.api import resolve_transport

            resolve_transport(kwargs["transport"], device=CPU).close()
    assert got.verified and want.verified
    assert _same_det(got.det, want.det)
    if "rateless" in kwargs:
        assert got.report.fleet.num_strips == want.report.fleet.num_strips == 8
        assert got.report.fleet.inline_strips == 0


def test_mixed_size_list_raises():
    """Mixed-size lists run (ROADMAP A11, ported; they raised before):
    verified, with the reference's determinants and paddings, inline and
    with distributed= (ROADMAP A12, ported). What still raises is a list
    the schedule cannot serve."""
    ms = [_matrix(8, 0), _matrix(6, 1)]
    got = repro_torch.outsource_determinant(ms, 2, device=CPU)
    want = r_protocol.outsource_determinant(ms, 2)
    assert got.verified.all() and np.asarray(want.verified).all()
    assert got.paddings == want.paddings == [0, 2]
    assert got.pad_to == want.pad_to == 8
    assert all(_same_det(g, w) for g, w in zip(got.dets, want.dets))
    with pytest.raises(ValueError, match="pad_to"):
        repro_torch.outsource_determinant_mixed(ms, 2, pad_to=7, device=CPU)
    got = repro_torch.outsource_determinant(ms, 2, distributed=True,
                                            device=CPU)
    want = r_protocol.outsource_determinant(ms, 2, distributed=True)
    assert got.verified.all() and np.asarray(want.verified).all()
    assert got.paddings == want.paddings == [0, 2]
    assert all(_same_det(g, w) for g, w in zip(got.dets, want.dets))


def test_lu_nserver_rejects_fault_plan_and_bad_partition():
    x = torch.from_numpy(_matrix(8, 0))
    with pytest.raises(TypeError, match="ServerFault"):
        t_lu.lu_nserver(x, 2, faults=("plan",))
    with pytest.raises(ValueError):
        t_lu.lu_nserver(x, 3)


def test_slogdet_pair_matches_reference():
    rng = np.random.default_rng(0)
    l = np.tril(rng.standard_normal((2, 40, 40)), -1) + np.eye(40)
    u = np.triu(rng.standard_normal((2, 40, 40)))
    want = r_lu.slogdet_pair_from_lu(jnp.asarray(l), jnp.asarray(u))
    got = t_lu.slogdet_pair_from_lu(torch.from_numpy(l), torch.from_numpy(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_det_from_lu_and_diagnostic_residuals_match_reference(pair):
    ref, port = pair("batch3_n64_N4")
    l_r, u_r, _ = r_lu.lu_nserver(ref.x_aug, 4)
    l_t, u_t, _ = t_lu.lu_nserver(port.x_aug, 4)
    np.testing.assert_allclose(t_lu.det_from_lu(l_t, u_t),
                               np.asarray(r_lu.det_from_lu(l_r, u_r)), rtol=1e-10)
    sign, logabs = t_lu.slogdet_from_lu(l_t, u_t)
    want_sign, want_logabs = np.linalg.slogdet(np.asarray(ref.x_aug))
    np.testing.assert_array_equal(sign, want_sign)
    np.testing.assert_allclose(logabs, want_logabs, rtol=1e-12)
    from repro.core.verify import per_server_residuals as r_psr
    from repro_torch.core.verify import per_server_residuals as t_psr

    got = t_psr(l_t, u_t, port.x_aug, num_servers=4, method="q3")
    want = r_psr(l_r, u_r, ref.x_aug, num_servers=4, method="q3")
    assert got.shape == want.shape == (3, 4)
    assert np.all(got <= 1e-9) and np.all(np.asarray(want) <= 1e-9)


def _exact_q3(l, u, x) -> float:
    """Σ_i |Σ_{j≤i} L_ij U_ji − x_ii| of one matrix, in rational arithmetic."""
    from fractions import Fraction

    l, u, x = (np.asarray(a, dtype=np.float64) for a in (l, u, x))
    total = Fraction(0)
    for i in range(x.shape[-1]):
        s = sum((Fraction(l[i, j]) * Fraction(u[j, i]) for j in range(i + 1)),
                Fraction(0))
        total += abs(s - Fraction(x[i, i]))
    return float(total)


def test_growth_run_verified_by_its_exact_q3_residual():
    """_mat(13, seed=169509) of the overload tests: its k = 1 ciphertext
    grows 3.1e5-fold, and the terms of its diagonal sums cancel by many
    orders of magnitude. Summed in the working precision, the port's Q3
    read 1.01e-8 against ε 7.17e-9 and rejected this honest run. It is
    now the exact residual of the port's factors, 2.19e-9, below the
    3.38e-9 of the reference's own factors, and the verdict is the
    reference's (q3_growth_scan.py --reference prints all five)."""
    m = np.random.default_rng(169509).standard_normal((13, 13)) + 13 * np.eye(13)
    got = repro_torch.outsource_determinant(m, 2, device=CPU)
    want = r_protocol.outsource_determinant(m, 2)
    assert got.verified is want.verified is True
    assert _same_det(got.det, want.det)
    port = SPDCClient(device=CPU).open_session(m, 2)
    l, u, _ = t_lu.lu_nserver(port.x_aug, 2)
    exact = _exact_q3(l, u, port.x_aug)
    assert got.residual == pytest.approx(exact, rel=1e-12)
    assert got.residual <= got.report.verdict.eps
    ref = r_api.SPDCClient().open_session(m, 2)
    l_r, u_r, _ = r_lu.lu_nserver(ref.x_aug, 2)
    assert exact <= _exact_q3(l_r, u_r, ref.x_aug)


#: (seed, n, padded size) of growth runs (3e5-7e5-fold) whose diagonal
#: sums cancel by many orders of magnitude: the overload tests' requests
#: 1695/9, 8118/3 and 8955/5 at their gateway buckets
GROWTH_RUNS = [(169509, 13, 16), (811803, 8, 8), (895505, 6, 8)]


@pytest.mark.parametrize("method", ["q3", "q3_literal"])
@pytest.mark.parametrize("seed,n,pad_to", GROWTH_RUNS)
def test_q3_is_the_exact_residual_under_growth(seed, n, pad_to, method):
    """Authenticate's Q3 forms are the exact residuals of the factors
    they are given, to a relative 1e-12, the reference's factors too."""
    m = np.random.default_rng(seed).standard_normal((n, n)) + n * np.eye(n)
    ref = r_api.SPDCClient().open_session([m], 2, pad_to=pad_to)
    l_r, u_r, _ = r_lu.lu_nserver(ref.x_aug, 2)
    x = np.asarray(ref.x_aug)[0]
    l, u = np.asarray(l_r)[0], np.asarray(u_r)[0]
    got = authenticate(*map(torch.from_numpy, (l, u, x)), num_servers=2,
                       method=method)
    if method == "q3":
        want = _exact_q3(l, u, x)
    else:
        from fractions import Fraction

        want = float(abs(sum(
            (sum((Fraction(l[i, j]) * Fraction(u[j, i]) for j in range(i + 1)),
                 Fraction(0)) - Fraction(x[i, i]) for i in range(pad_to)),
            Fraction(0))))
    assert got.residual == pytest.approx(want, rel=1e-12, abs=1e-300)


def test_inline_transport_lifecycle():
    from repro_torch.api import InlineTransport, TransportError, resolve_transport

    with InlineTransport() as transport:
        assert resolve_transport(transport) is transport
        assert transport.fused and not transport.closed
    assert transport.closed
    with pytest.raises(TransportError):
        transport.sweep(torch.from_numpy(_matrix(8, 0)), 2)
    with pytest.raises(ValueError):
        resolve_transport("carrier-pigeon")
