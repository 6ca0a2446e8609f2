"""repro_torch.linalg against the JAX reference, on the CPU: the shared-LU
op plan (`LinalgSession`: slogdet, solve and inv on one verified
factorization), the differentiable `secure_*` ops, the TriSolve wire
layer and server leg, the trust-boundary invariants (blinding, secret
probe lanes) and tamper / heal through recovery.

Mirrors tests/test_linalg.py case for case; each case gives both packages
the same numpy inputs from a seed (n <= 24, sized so the border is absent
and the ciphertexts are bit-equal). Bars, the reference's own: results
within 1e-9 in f64 and 2e-3 in f32 of numpy and of the reference; the
masks and probes of the secret lanes bit-equal; TriSolve frames
byte-identical, and each package's EdgeServer answers the other's chunk
within 1e-12 of max|y|; gradients within 1e-6 of max|grad| of the
reference's `jax.grad` and of plaintext torch autograd.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.linalg as r_linalg
from repro.api import server as r_server
from repro.api.messages import TriSolveResult as RTriSolveResult
from repro.api.messages import TriSolveTask as RTriSolveTask
from repro.api.socket_transport import SocketTransport as RSocketTransport
from repro.api.socket_transport import WorkerDaemon as RWorkerDaemon
from repro.core.faults import ServerFault as RServerFault
from repro.linalg import session as r_session
from repro_torch.api import (EdgeServer, InlineTransport, MultiprocessTransport,
                             ThreadPoolTransport)
from repro_torch.api.messages import TriSolveResult, TriSolveTask
from repro_torch.api.socket_transport import SocketTransport, WorkerDaemon
from repro_torch.core.faults import ServerFault
from repro_torch.kernels import ref
from repro_torch.linalg import (
    LinalgSession,
    LinalgVerificationError,
    SecureLinalg,
    blind_rhs,
    outsource_solve,
    secure_inv,
    secure_slogdet,
    secure_solve,
)
from repro_torch.linalg import session as p_session

CPU = "cpu"
#: op-plan acceptance against numpy and the reference, by compute dtype
TOL = {"float64": 1e-9, "float32": 2e-3}
N_SERVERS = 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _wellcond(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _spd(n, seed=0, cond=50.0):
    """RBF-like SPD matrix — the GP workload's shape."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    k = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    return k + (np.trace(k) / (n * cond)) * np.eye(n)


def _session(m, **kw):
    return LinalgSession(m, N_SERVERS, device=CPU, **kw)


def _close(got, want, tol=TOL["float64"]):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


# ------------------------------------------------------------ the op plan


def test_session_one_factorization_many_ops():
    """slogdet + solve + adjoint solve + inv on one factorization, each
    op verified, and each equal to the reference's."""
    m = _wellcond(12, seed=3)
    b = np.arange(12, dtype=float)
    s, r = _session(m), r_linalg.LinalgSession(m, N_SERVERS)
    got = (s.slogdet(), s.solve(b), s.solve(b, transpose=True), s.inv())
    want = (r.slogdet(), r.solve(b), r.solve(b, transpose=True), r.inv())
    assert s.factorizations == r.factorizations == 1
    ws, wl = np.linalg.slogdet(m)
    assert got[0][0] == want[0][0] == ws
    assert np.isclose(got[0][1], wl, rtol=1e-9)
    assert np.isclose(got[0][1], want[0][1], rtol=1e-12)
    for g, w, np_want in zip(got[1:], want[1:],
                             (np.linalg.solve(m, b), np.linalg.solve(m.T, b),
                              np.linalg.inv(m))):
        _close(g, np_want)
        _close(g, w)
    ops = [o.op for o in s.report.ops]
    assert ops == [o.op for o in r.report.ops] == \
        ["factor", "slogdet", "solve", "solve_t", "inv"]
    assert all(o.verified for o in s.report.ops)
    # inv is cached: asking again (either orientation) adds no round
    s.inv(transpose=True)
    assert len(s.report.ops) == len(ops) and s.factorizations == 1


@pytest.mark.parametrize("mode", ["ewd", "ewm"])
@pytest.mark.parametrize("growth_safe", [True, False])
def test_solve_inv_match_numpy_across_cipher_variants(mode, growth_safe):
    """(mode, growth_safe) × seeds: the case table of B⁻¹ recoveries
    holds for every rotation degree the seeds land on, and the rotation
    plan is the reference's (checked against it on two seeds)."""
    seen_k = set()
    for seed in range(6):
        m = _wellcond(9, seed=seed)
        b = np.linspace(-1, 1, 9)
        s = _session(m, mode=mode, growth_safe=growth_safe)
        y, inv = s.solve(b), s.inv()
        _close(y, np.linalg.solve(m, b))
        _close(inv, np.linalg.inv(m))
        seen_k.add(s._meta.rotate_k % 4)
        if seed < 2:
            r = r_linalg.LinalgSession(m, N_SERVERS, mode=mode,
                                       growth_safe=growth_safe)
            assert (s._meta.rotate_k, s._meta.flipped) == \
                (r._meta.rotate_k, r._meta.flipped)
            _close(y, r.solve(b))
            _close(inv, r.inv())
    assert len(seen_k) >= 2, "seeds never varied the rotation degree"


def test_solve_matrix_rhs_and_transpose():
    m = _wellcond(10, seed=7)
    b = np.random.default_rng(7).standard_normal((10, 3))
    s, r = _session(m), r_linalg.LinalgSession(m, N_SERVERS)
    _close(s.solve(b), np.linalg.solve(m, b))
    _close(s.solve(b, transpose=True), np.linalg.solve(m.T, b))
    _close(s.solve(b), r.solve(b))
    _close(s.solve(b, transpose=True), r.solve(b, transpose=True))
    assert s.factorizations == 1


def test_growth_safe_default_survives_spd_kernels():
    """The growth_safe default keeps the GP workload's matrices solvable
    (rot90 of an SPD kernel matrix is a catastrophic no-pivot input)."""
    m = _spd(24, seed=0, cond=500.0)
    s = _session(m)  # growth_safe unspecified -> ON
    inv = _np(s.inv())
    err = np.linalg.norm(inv @ m - np.eye(24)) / np.linalg.norm(inv)
    assert err < 1e-8
    _close(inv, r_linalg.LinalgSession(m, N_SERVERS).inv(), 1e-9)


def test_session_rejects_nonsquare_and_bad_rhs():
    with pytest.raises(ValueError, match="square"):
        _session(np.ones((3, 4)))
    s = _session(_wellcond(6))
    with pytest.raises(ValueError, match="does not match"):
        s.solve(np.ones(7))
    with pytest.raises(ValueError, match="square"):
        r_linalg.LinalgSession(np.ones((3, 4)), N_SERVERS)


def test_outsource_solve_facade():
    m = _wellcond(8, seed=11)
    b = np.ones(8)
    y, s = outsource_solve(m, b, N_SERVERS, device=CPU)
    _close(y, np.linalg.solve(m, b))
    assert s.factorizations == 1
    yt, _ = outsource_solve(m, b, N_SERVERS, transpose=True, device=CPU)
    _close(yt, np.linalg.solve(m.T, b))
    _close(yt, r_linalg.outsource_solve(m, b, N_SERVERS, transpose=True)[0])


@pytest.mark.parametrize("op", ["solve", "inv"])
def test_float32_ops_within_the_reference_bar(op):
    """The f32 op plan (growth-safe, the f32 panel and solve routes)
    within the reference's f32 bar of numpy and of the reference."""
    m = _wellcond(12, seed=13).astype(np.float32)
    b = np.random.default_rng(13).standard_normal(12).astype(np.float32)
    s = _session(m)
    r = r_linalg.LinalgSession(m, N_SERVERS)
    got = s.solve(b) if op == "solve" else s.inv()
    want = r.solve(b) if op == "solve" else r.inv()
    assert got.dtype == torch.float32
    m64 = m.astype(np.float64)
    exact = np.linalg.solve(m64, b) if op == "solve" else np.linalg.inv(m64)
    _close(got, exact, TOL["float32"])
    _close(got, want, TOL["float32"])
    assert all(o.verified for o in s.report.ops)


# ------------------------------------------------- trust boundary invariants


class _RecordingTransport(InlineTransport):
    """Captures every TriSolveTask the session ships."""

    def __init__(self):
        super().__init__(device=CPU)
        self.shipped = []

    def solve_shards(self, tasks, faults=(), timeout=None):
        self.shipped.extend(tasks)
        return super().solve_shards(tasks, faults=faults, timeout=timeout)


def test_secret_rhs_never_crosses_in_the_clear():
    """Masked rounds ship rhs + X'·C, never the plaintext right-hand side
    (nor b/v); inverse rounds ship only permutation columns."""
    m = _wellcond(10, seed=5)
    b = np.random.default_rng(5).standard_normal(10)
    t = _RecordingTransport()
    s = _session(m, transport=t)
    s.solve(b)
    s.inv()
    n = 10
    narrow = [np.asarray(tk.rhs) for tk in t.shipped
              if np.asarray(tk.rhs).shape[1] <= 2]
    assert narrow, "no masked solve-round tasks captured"
    masked = np.concatenate(narrow, axis=1)
    v = _np(s._v)
    for cand in (b, b / v):
        assert not np.any(
            np.isclose(masked[:n, 0], cand, rtol=1e-3, atol=1e-9)
        ), "plaintext RHS entries visible on the wire"
    wide = [np.asarray(tk.rhs) for tk in t.shipped
            if np.asarray(tk.rhs).shape[1] >= n // 2]
    assert wide and all(
        set(np.unique(w.round(12))) <= {0.0, 1.0} for w in wide
    ), "inverse rounds must ship only permutation columns"


def test_blind_rhs_roundtrip_freshness_and_reference_masks():
    """The pad unmasks, is fresh per round, and is the reference's mask
    bit for bit (the same lane, scale and draw)."""
    rng = np.random.default_rng(0)
    x_aug = rng.standard_normal((12, 12))
    rhs = rng.standard_normal((12, 2))
    digest = b"\x07" * 32
    xt, rt = torch.from_numpy(x_aug), torch.from_numpy(rhs)
    for rnd, transpose in ((0, 0), (1, 1), (1, 0)):
        shipped, c = blind_rhs(rt, xt, digest, rnd, transpose)
        a = x_aug.T if transpose else x_aug
        np.testing.assert_allclose(_np(shipped) - a @ _np(c), rhs, atol=1e-12)
        r_shipped, r_c = r_session.blind_rhs(rhs, x_aug, digest, rnd,
                                             transpose)
        np.testing.assert_array_equal(_np(c), r_c)
        np.testing.assert_allclose(_np(shipped), r_shipped, rtol=0,
                                   atol=1e-12)
    c0 = blind_rhs(rt, xt, digest, 0, 0)[1]
    c1 = blind_rhs(rt, xt, digest, 1, 0)[1]
    assert not torch.allclose(c0, c1)  # no two-time pad


def test_probe_lanes_are_domain_separated_and_bit_equal():
    d = b"\x01" * 32
    lane = p_session._lane_rng
    a = lane(d, b"trisolve-probe", 0, 0, 0).standard_normal(8)
    b = lane(d, b"trisolve-mask", 0, 0, 0).standard_normal(8)
    c = lane(d, b"trisolve-probe", 0, 0, 1).standard_normal(8)
    again = lane(d, b"trisolve-probe", 0, 0, 0).standard_normal(8)
    assert not np.allclose(a, b) and not np.allclose(a, c)
    np.testing.assert_array_equal(a, again)
    for tag, idx in ((b"trisolve-probe", (3, 1, 2)),
                     (b"trisolve-mask", (5,)), (b"inverse-probe", (0,))):
        np.testing.assert_array_equal(
            lane(d, tag, *idx).standard_normal(16),
            r_session._lane_rng(d, tag, *idx).standard_normal(16))


# ------------------------------------------------------------- tamper / heal


def _corrupting(cls):
    """Transport subclass that tampers the first solve chunk of every
    initial dispatch — the factorization stays honest, so the heal under
    test is the trisolve one."""
    class Corrupting(cls):
        def solve_shards(self, tasks, faults=(), timeout=None):
            out = super().solve_shards(tasks, faults=faults,
                                       timeout=timeout)
            if tasks and tasks[0].attempt == 0:
                out[0] = dataclasses.replace(out[0],
                                             y=np.asarray(out[0].y) * 3.0)
            return out

    return Corrupting


@pytest.mark.parametrize("transport_cls", [InlineTransport,
                                           ThreadPoolTransport,
                                           MultiprocessTransport])
def test_trisolve_tamper_localizes_and_heals(transport_cls):
    """A tampered chunk is localized and re-solved on every transport;
    the healed answer is bit-equal to an honest inline round's."""
    m = _wellcond(12, seed=9)
    b = np.random.default_rng(9).standard_normal(12)
    with _corrupting(transport_cls)(device=CPU) as t:
        s = _session(m, transport=t)
        y = s.solve(b)
        if transport_cls is MultiprocessTransport:
            assert t.workers  # the chunks crossed to worker processes
    _close(y, np.linalg.solve(m, b))
    assert torch.equal(y, _session(m).solve(b))
    solve_ops = [o for o in s.report.ops if o.op.startswith("solve")]
    assert solve_ops and solve_ops[0].healed >= 1
    assert all(o.verified for o in s.report.ops)


def test_fault_plan_tamper_heals_factorization_and_round():
    """The `faults=` plan corrupts the named server's LU strip and its
    solve chunks; both layers localize and heal, in both packages."""
    m = _wellcond(12, seed=9)
    b = np.random.default_rng(9).standard_normal(12)
    s = _session(m, faults=ServerFault(server=0, magnitude=50.0))
    r = r_linalg.LinalgSession(m, N_SERVERS,
                               faults=RServerFault(server=0, magnitude=50.0))
    y = s.solve(b)
    _close(y, np.linalg.solve(m, b))
    _close(y, r.solve(b))
    assert all(o.verified for o in s.report.ops)
    assert [o.healed for o in s.report.ops] == [o.healed for o in r.report.ops]
    assert any(o.healed >= 1 for o in s.report.ops)


def test_trisolve_dropout_heals():
    m = _wellcond(10, seed=4)
    s = _session(m, faults=ServerFault(server=1, kind="dropout"))
    inv = s.inv()
    _close(inv, np.linalg.inv(m))
    assert any(o.healed >= 1 for o in s.report.ops)


def test_trisolve_tamper_recover_false_raises():
    """Corrupt only the solve round (the factorization stays honest, so
    the failure is the trisolve check, not Authenticate)."""
    class _Tamper(InlineTransport):
        def solve_shards(self, tasks, faults=(), timeout=None):
            out = super().solve_shards(tasks, faults=faults,
                                       timeout=timeout)
            out[0] = dataclasses.replace(out[0], y=np.asarray(out[0].y) * 3.0)
            return out

    m = _wellcond(10, seed=2)
    with _Tamper(device=CPU) as t:
        s = _session(m, transport=t, recover=False)
        with pytest.raises(LinalgVerificationError, match="recover=False"):
            s.solve(np.ones(10))


def test_stale_echo_rejected():
    """A replayed chunk from another dispatch fails the echo binding
    before any math — and heals."""
    class _Replay(InlineTransport):
        def solve_shards(self, tasks, faults=(), timeout=None):
            out = super().solve_shards(tasks, faults=faults,
                                       timeout=timeout)
            if tasks and tasks[0].attempt == 0:
                out[0] = dataclasses.replace(out[0], subseed=b"\x00" * 16)
            return out

    m = _wellcond(10, seed=6)
    with _Replay(device=CPU) as t:
        s = _session(m, transport=t)
        y = s.solve(np.ones(10))
    _close(y, np.linalg.solve(m, np.ones(10)))
    assert any(o.healed >= 1 for o in s.report.ops)


# ----------------------------------------------------------------- wire layer


def _chunk(seed=1, n=6, cols=2, transpose=1):
    rng = np.random.default_rng(seed)
    l = np.tril(rng.standard_normal((n, n)), -1) / n + np.eye(n)
    u = np.triu(rng.standard_normal((n, n))) + n * np.eye(n)
    kw = dict(server=1, num_servers=3, l=l, u=u,
              rhs=rng.standard_normal((n, cols)), subseed=b"\xaa" * 16,
              transpose=transpose, col0=2, attempt=1, session_id="sess-1")
    return TriSolveTask(**kw), RTriSolveTask(**kw)


def test_trisolve_wire_roundtrip_byte_identical_to_reference():
    task, rtask = _chunk()
    assert task.to_bytes() == rtask.to_bytes()
    back = TriSolveTask.from_bytes(rtask.to_bytes())
    assert (back.server, back.num_servers, back.subseed, back.transpose,
            back.col0, back.attempt, back.session_id) == \
        (1, 3, b"\xaa" * 16, 1, 2, 1, "sess-1")
    for name in ("l", "u", "rhs"):
        np.testing.assert_array_equal(getattr(back, name), getattr(task, name))
    assert back.n == 6 and back.cols == 2
    y = np.random.default_rng(2).standard_normal((6, 2))
    kw = dict(server=1, y=y, subseed=b"\xbb" * 16, transpose=1, col0=2,
              attempt=1, session_id="sess-1")
    res = TriSolveResult(**kw)
    assert res.to_bytes() == RTriSolveResult(**kw).to_bytes()
    rback = TriSolveResult.from_bytes(res.to_bytes())
    np.testing.assert_array_equal(rback.y, y)
    assert rback.subseed == b"\xbb" * 16 and rback.col0 == 2


@pytest.mark.parametrize("transpose", [0, 1])
def test_edge_servers_answer_each_others_chunks(transpose):
    """Each package's EdgeServer answers the other's decoded chunk: the
    solution of X' y = rhs (X'ᵀ y = rhs), within 1e-12 of max|y| of the
    other's, with the echo fields intact."""
    task, rtask = _chunk(seed=3, n=20, cols=5, transpose=transpose)
    port = EdgeServer(1, device=CPU).run(
        TriSolveTask.from_bytes(rtask.to_bytes()))
    ref_res = r_server.EdgeServer(1).run(
        RTriSolveTask.from_bytes(task.to_bytes()))
    x = task.l @ task.u
    a = x.T if transpose else x
    want = np.linalg.solve(a, task.rhs)
    for res in (port, ref_res):
        assert (res.subseed, res.col0, res.transpose, res.attempt) == \
            (task.subseed, 2, transpose, 1)
    scale = np.abs(want).max()
    assert np.abs(port.y - np.asarray(ref_res.y)).max() <= 1e-12 * scale
    assert np.abs(port.y - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("mode", ["single", "sign_flip", "block"])
def test_chunk_tamper_hits_the_reference_element(mode):
    """A tampering server corrupts the element the reference's hash
    picks, by the reference's rule."""
    task, rtask = _chunk(seed=4, n=12, cols=3, transpose=0)
    task = dataclasses.replace(task, attempt=0)
    rtask = dataclasses.replace(rtask, attempt=0)
    fault = dict(server=1, mode=mode, magnitude=0.5, seed=7)
    bad = EdgeServer(1, device=CPU).run(task, faults=ServerFault(**fault))
    rbad = r_server.EdgeServer(1).run(rtask, faults=RServerFault(**fault))
    honest = EdgeServer(1, device=CPU).run(task)
    np.testing.assert_allclose(bad.y, np.asarray(rbad.y), rtol=1e-12)
    changed = np.argwhere(bad.y != honest.y)
    assert len(changed) == (honest.y.size if mode == "block" else 1)


def test_left_solve_plain_versions_against_solve_triangular():
    """The four legs' plain versions against torch.linalg.solve_triangular
    on strided operands (a column-major T, every other column of B) and
    reversed ones (T and B flipped, the upper legs as lower solves)."""
    rng = np.random.default_rng(8)
    n = 17
    l = torch.from_numpy(np.tril(rng.standard_normal((n, n)), -1) / n
                         + np.eye(n))
    u = torch.from_numpy(np.triu(rng.standard_normal((n, n))) + n * np.eye(n))
    b = torch.from_numpy(rng.standard_normal((n, 10)))[:, ::2]
    legs = {"l": (l, False, False), "u": (u, True, False),
            "ut": (u, True, True), "lt": (l, False, True)}
    for leg, (t, upper, trans) in legs.items():
        op_t = t.T if trans else t
        want = torch.linalg.solve_triangular(op_t, b, upper=upper != trans)
        tcm = t.T.contiguous().T  # column-major
        got = ref.trsm_left_ref(tcm, b, upper=upper, transpose_t=trans)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
        # the reversed problem: J op(T) J (J x) = J b, a solve of the
        # other triangle
        flipped = ref.trsm_left_ref(op_t.flip(0, 1), b.flip(0),
                                    upper=upper == trans)
        torch.testing.assert_close(flipped.flip(0), want, rtol=0, atol=1e-12)


# ------------------------------------------------------- differentiable ops


def test_secure_ops_forward_match():
    m = _wellcond(10, seed=8)
    b = np.random.default_rng(8).standard_normal(10)
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    mt, bt = torch.from_numpy(m), torch.from_numpy(b)
    sign, logabs = secure_slogdet(mt, linalg=ctx)
    y = secure_solve(mt, bt, linalg=ctx)
    inv = secure_inv(mt, linalg=ctx)
    ws, wl = np.linalg.slogdet(m)
    assert float(sign) == ws and np.isclose(float(logabs), wl, rtol=1e-9)
    _close(y, np.linalg.solve(m, b))
    _close(inv, np.linalg.inv(m))
    rctx = r_linalg.SecureLinalg(N_SERVERS)
    _close(y, r_linalg.secure_solve(m, b, linalg=rctx))
    _close(inv, r_linalg.secure_inv(m, linalg=rctx))
    assert len(ctx._sessions) == 1
    assert sum(s.factorizations for s in ctx._sessions.values()) == 1


def test_secure_ops_validate_shapes():
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    with pytest.raises(ValueError, match="square"):
        secure_slogdet(torch.ones((2, 3)), linalg=ctx)
    with pytest.raises(ValueError, match="square"):
        secure_inv(torch.ones((2, 3)), linalg=ctx)
    with pytest.raises(ValueError, match="rhs shape"):
        secure_solve(torch.eye(3), torch.ones(4), linalg=ctx)


def _gp_problem(n):
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3, 3, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    theta = np.asarray([np.log(0.8), 0.0, np.log(0.2)])
    return x, y, theta


def _torch_nll(x, y, slogdet, solve):
    """The GP objective 0.5·(log|Σ(θ)| + yᵀΣ(θ)⁻¹y) over torch ops."""
    n = x.shape[0]

    def nll(theta):
        d2 = (x[:, None] - x[None, :]) ** 2
        k = torch.exp(2 * theta[1]) * torch.exp(-0.5 * d2
                                                / torch.exp(2 * theta[0]))
        cov = k + torch.exp(2 * theta[2]) * torch.eye(n, dtype=x.dtype)
        _, logdet = slogdet(cov)
        return 0.5 * (logdet + y @ solve(cov, y))

    return nll


def test_gp_loglik_grad_matches_reference_and_plaintext():
    """The acceptance bar: the gradient of the GP negative log-likelihood
    through secure_slogdet + secure_solve matches the reference's
    jax.grad and plaintext torch autograd to 1e-6 of max|grad|, the value
    at rtol 1e-9, with verified ops and one factorization."""
    n = 24
    xs, ys, theta0 = _gp_problem(n)
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    nll = _torch_nll(x, y, lambda c: secure_slogdet(c, linalg=ctx),
                     lambda c, v: secure_solve(c, v, linalg=ctx))
    plain = _torch_nll(x, y, torch.linalg.slogdet, torch.linalg.solve)
    theta = torch.tensor(theta0, requires_grad=True)
    val = nll(theta)
    val.backward()
    grad = theta.grad.clone()
    theta.grad = None
    pval = plain(theta)
    pval.backward()
    pgrad = theta.grad

    rctx = r_linalg.SecureLinalg(N_SERVERS)
    xj, yj = jnp.asarray(xs), jnp.asarray(ys)

    def r_nll(th):
        d2 = (xj[:, None] - xj[None, :]) ** 2
        k = jnp.exp(2 * th[1]) * jnp.exp(-0.5 * d2 / jnp.exp(2 * th[0]))
        c = k + jnp.exp(2 * th[2]) * jnp.eye(n)
        _, logdet = r_linalg.secure_slogdet(c, linalg=rctx)
        return 0.5 * (logdet + yj @ r_linalg.secure_solve(c, yj, linalg=rctx))

    rval, rgrad = jax.value_and_grad(r_nll)(jnp.asarray(theta0))
    for want_val, want_grad in ((float(rval), np.asarray(rgrad)),
                                (float(pval.detach()), _np(pgrad))):
        assert np.isclose(float(val.detach()), want_val, rtol=1e-9)
        gerr = np.abs(_np(grad) - want_grad).max() / np.abs(want_grad).max()
        assert gerr < 1e-6, gerr
    sessions = list(ctx._sessions.values())
    assert len(sessions) == 1 and sessions[0].factorizations == 1
    assert all(o.verified for o in sessions[0].report.ops)


def test_slogdet_grad_is_inverse_transpose():
    m = _wellcond(8, seed=10)
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    a = torch.tensor(m, requires_grad=True)
    secure_slogdet(a, linalg=ctx)[1].backward()
    _close(a.grad, np.linalg.inv(m).T, 1e-8)
    rgrad = jax.grad(lambda z: r_linalg.secure_slogdet(
        z, linalg=r_linalg.SecureLinalg(N_SERVERS))[1])(jnp.asarray(m))
    _close(a.grad, rgrad, 1e-8)
    assert sum(s.factorizations for s in ctx._sessions.values()) == 1


def test_solve_vjp_adjoint_round():
    """b̄ = M⁻ᵀz̄ comes back through the same session; ā = −b̄zᵀ."""
    m = _wellcond(8, seed=12)
    b = np.random.default_rng(12).standard_normal(8)
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    a, bt = torch.tensor(m, requires_grad=True), torch.tensor(b,
                                                              requires_grad=True)
    (secure_solve(a, bt, linalg=ctx) ** 2).sum().backward()
    z = np.linalg.solve(m, b)
    gbar = np.linalg.solve(m.T, 2 * z)
    _close(bt.grad, gbar, 1e-8)
    _close(a.grad, -np.outer(gbar, z), 1e-8)
    session = next(iter(ctx._sessions.values()))
    assert session.factorizations == 1
    assert [o.op for o in session.report.ops][-2:] == ["solve", "solve_t"]


def test_inv_vjp_client_side():
    """Ā = −Yᵀ Ȳ Yᵀ with no extra round, as torch's own inverse gives."""
    m = _wellcond(7, seed=14)
    w = torch.from_numpy(np.random.default_rng(14).standard_normal((7, 7)))
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    a = torch.tensor(m, requires_grad=True)
    (secure_inv(a, linalg=ctx) * w).sum().backward()
    ap = torch.tensor(m, requires_grad=True)
    (torch.linalg.inv(ap) * w).sum().backward()
    _close(a.grad, ap.grad, 1e-8)
    session = next(iter(ctx._sessions.values()))
    assert [o.op for o in session.report.ops] == ["factor", "inv"]


def test_session_cache_shared_across_threads(monkeypatch):
    """Autograd runs CUDA backward passes on its own thread, so the cache
    is shared: threads racing on the same matrices (more threads than
    cores, a short switch interval, a session that takes 20 ms to open)
    each get the one session per matrix."""
    import sys
    import threading
    import time

    import repro_torch.linalg.ops as p_ops

    class SlowSession(LinalgSession):
        def __init__(self, *args, **kwargs):
            time.sleep(0.02)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(p_ops, "LinalgSession", SlowSession)
    ctx = SecureLinalg(N_SERVERS, device=CPU)
    mats = [_wellcond(4, seed=seed) for seed in range(3)]
    seen = [[] for _ in mats]
    interval = sys.getswitchinterval()
    start = threading.Barrier(16)

    def work():
        start.wait(timeout=60)
        for _ in range(10):
            for i, m in enumerate(mats):
                seen[i].append(ctx.session_for(m))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(ctx._sessions) == len(mats)
    for sessions in seen:
        assert len(sessions) == 160 and len({id(s) for s in sessions}) == 1


def test_session_cache_eviction():
    ctx = SecureLinalg(N_SERVERS, max_sessions=2, device=CPU)
    for seed in range(3):
        ctx.session_for(_wellcond(6, seed=seed))
    assert len(ctx._sessions) == 2
    ctx.clear()
    assert not ctx._sessions


# ----------------------------------------------------------- across daemons


def test_daemons_serve_each_others_rounds(tmp_path):
    """A port daemon serves a reference LinalgSession's rounds and a
    reference daemon a port session's: same results, same verdicts, and
    a server tamper healed on either (daemons in this process)."""
    m = _wellcond(12, seed=15)
    b = np.random.default_rng(15).standard_normal(12)
    pd = WorkerDaemon(f"unix://{tmp_path}/p.sock", device=CPU)
    rd = RWorkerDaemon(f"unix://{tmp_path}/r.sock")
    pd.start()
    rd.start()
    fault = dict(server=1, mode="block", magnitude=0.3)
    try:
        with RSocketTransport((pd.address,)) as rt, \
                SocketTransport((rd.address,)) as pt:
            r = r_linalg.LinalgSession(m, N_SERVERS, transport=rt)
            s = _session(m, transport=pt)
            r_bad = r_linalg.LinalgSession(m, N_SERVERS, transport=rt,
                                           faults=RServerFault(**fault))
            s_bad = _session(m, transport=pt, faults=ServerFault(**fault))
            got = [s.solve(b), s.inv(), s_bad.inv()]
            want = [r.solve(b), r.inv(), r_bad.inv()]
    finally:
        pd.close()
        rd.close()
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[1], np.linalg.inv(m))
    for sess in (s, r, s_bad, r_bad):
        assert all(o.verified for o in sess.report.ops)
    assert [o.healed for o in s_bad.report.ops] == \
        [o.healed for o in r_bad.report.ops]
    assert any(o.healed for o in s_bad.report.ops)
