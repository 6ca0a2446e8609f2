"""The port's float32 protocol against the JAX reference, on the CPU.

Mirrors the cases of tests/test_precision.py that need no gateway, no
mixed-size list and no shard_map: the growth controls, equilibration,
the compensated log-det, f32 roundtrips, f32 verification power, f32
recovery, and the Determinant comparison rules. Each case runs the
reference and the port on the same numpy inputs.

Bars: |Δlog|det|| <= 1e-4 against numpy's f64 slogdet and between the
two packages, exact signs, equal verdicts (and culprits where a fault
is played); f64 pairs at Determinant.allclose's 1e-8. Ciphertexts are
bit-equal where no equilibration runs; with equilibration on (the f32
default) the reference's exp2 is inexact (ROADMAP §C), so the cases
compare determinants and verdicts there, and equilibration itself
through its exponents.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import Determinant as RDeterminant
from repro.core import ServerFault as RServerFault
from repro.core import cipher as r_cipher
from repro.core import equilibrate as r_equilibrate
from repro.core import keygen as r_keygen
from repro.core import outsource_determinant as r_outsource
from repro.core import seedgen as r_seedgen
from repro.core import slogdet_pair_from_lu as r_slogdet_pair
from repro.core.lu import lu_nserver as r_lu_nserver
from repro.core.verify import growth_estimate as r_growth
from repro_torch import ServerFault
from repro_torch.core.cipher import cipher, equilibrate
from repro_torch.core.decipher import Determinant
from repro_torch.core.keygen import keygen
from repro_torch.core.lu import lu_nserver, slogdet_pair_from_lu
from repro_torch.core.prt import growth_safe_sign, rotate_degree
from repro_torch.core.seed import seedgen
from repro_torch.core.verify import growth_estimate

N = 4
CPU = "cpu"
#: acceptance bar: f32 log|det| error against f64 references
F32_DLOG = 1e-4


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    if batch is None:
        return rng.standard_normal((n, n)) + n * np.eye(n)
    return rng.standard_normal((batch, n, n)) + n * np.eye(n)


def _port(m, **kw):
    return repro_torch.outsource_determinant(m, kw.pop("servers", N),
                                             device=CPU, **kw)


def _ref(m, **kw):
    return r_outsource(m, kw.pop("servers", N), **kw)


def _dets(res):
    return res.dets if hasattr(res, "dets") else [res.det]


def _agree(got, want, m):
    """Same verdicts; every det within F32_DLOG of numpy's f64 slogdet
    and of the reference's, signs exact."""
    assert np.array_equal(np.atleast_1d(got.verified),
                          np.atleast_1d(want.verified))
    stack = m if m.ndim == 3 else m[None]
    for g, w, x in zip(_dets(got), _dets(want), stack):
        sign, logabs = np.linalg.slogdet(x)
        assert g.sign == w.sign == sign
        assert abs(g.logabs - logabs) <= F32_DLOG
        assert abs(g.logabs - w.logabs) <= F32_DLOG


# ------------------------------------------------------- growth control
def test_growth_safe_cipher_det_relation():
    """det(X) = s · det(M) / Ψ with s = growth_safe_sign, for every
    rotation degree, and the ciphertext bit-equal to the reference's."""
    seen = set()
    for t in range(24):
        n = 8
        m = _wellcond(n, seed=t)
        seed = seedgen(128, m)
        x, meta = cipher(torch.from_numpy(m), keygen(128, seed, n), seed,
                         growth_safe=True)
        r_s = r_seedgen(128, m)
        want, r_meta = r_cipher(jnp.asarray(m), r_keygen(128, r_s, n), r_s,
                                growth_safe=True)
        np.testing.assert_array_equal(x.numpy(), np.asarray(want))
        assert dataclasses.astuple(meta) == dataclasses.astuple(r_meta)
        seen.add(meta.rotate_k)
        s = growth_safe_sign(n, meta.rotate_k)
        np.testing.assert_allclose(np.linalg.det(x.numpy()),
                                   s * np.linalg.det(m) / seed.psi, rtol=1e-5)
        assert meta.flipped == (meta.rotate_k % 2 == 1)
    assert seen == {1, 2, 3}


def test_growth_safe_kernel_matches_jnp():
    """The port's CED (its plain version here) with the growth-safe flip
    against the reference's Pallas cipher: bit-equal."""
    n = 16
    m = _wellcond(n, seed=3)
    seed = seedgen(11, m)
    x, meta = cipher(torch.from_numpy(m), keygen(13, seed, n), seed,
                     growth_safe=True)
    r_s = r_seedgen(11, m)
    want, r_meta = r_cipher(jnp.asarray(m), r_keygen(13, r_s, n), r_s,
                            growth_safe=True, use_kernel=True)
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    assert dataclasses.astuple(meta) == dataclasses.astuple(r_meta)


def test_growth_safe_tames_element_growth():
    """An odd rotation of a diagonally dominant matrix is anti-diagonally
    dominant and the no-pivot LU's growth explodes; the flip-composed
    relayout pins it near 1. The port's growth estimates equal the
    reference's to rtol 1e-8 (the reference's un-jitted sweep takes
    seconds, so it runs on the first odd seed only)."""
    n = 64
    hit = False
    for t in range(12):
        m = _wellcond(n, seed=100 + t)
        seed = seedgen(128, m)
        if rotate_degree(seed.psi) % 2 == 0:
            continue
        key = keygen(128, seed, n)
        r_s = r_seedgen(128, m)
        r_key = r_keygen(128, r_s, n)
        growth = {}
        for safe in (False, True):
            x, _ = cipher(torch.from_numpy(m), key, seed, growth_safe=safe)
            xe, _ = equilibrate(x)
            growth[safe] = growth_estimate(lu_nserver(xe, N)[1], xe)
            if not hit:
                rx, _ = r_cipher(jnp.asarray(m), r_key, r_s, growth_safe=safe)
                rxe, _ = r_equilibrate(rx)
                want = r_growth(r_lu_nserver(rxe, N)[1], rxe)
                np.testing.assert_allclose(growth[safe], float(want),
                                           rtol=1e-8)
        hit = True
        assert growth[True] < 4.0, growth
        assert growth[False] > 4 * growth[True], growth
    assert hit, "no odd rotation drawn in 12 seeds"


def test_equilibrate_exact_and_det_tracked():
    """Power-of-two scales are lossless and their integer exponents,
    equal to the reference's, recover log|det| exactly."""
    x = _wellcond(24, seed=7)
    x_eq, log2_scale = equilibrate(torch.from_numpy(x))
    _, r_scale = r_equilibrate(jnp.asarray(x))
    assert not torch.is_floating_point(log2_scale)
    assert int(log2_scale) == int(r_scale)
    assert float(x_eq.abs().max()) <= np.sqrt(2.0) + 1e-9
    s0, l0 = np.linalg.slogdet(x)
    s1, l1 = np.linalg.slogdet(x_eq.numpy())
    assert s0 == s1
    np.testing.assert_allclose(l0, l1 - float(log2_scale) * np.log(2.0),
                               rtol=1e-12)
    z_eq, z_scale = equilibrate(torch.zeros(5, 5, dtype=torch.float64))
    assert int(z_scale) == 0 and not torch.isnan(z_eq).any()


def test_compensated_slogdet_pair():
    """Alternating ±10 logs over n = 4096 in f32: the (hi, lo) pair lands
    within 2e-4 of the exact sum, as the reference's does."""
    n = 4096
    logs = np.where(np.arange(n) % 2 == 0, 10.0, -10.0)
    logs[-1] = 0.125
    d = np.exp(logs).astype(np.float32)
    want = float(np.sum(np.log(np.abs(d.astype(np.float64)))))
    sign, hi, lo = slogdet_pair_from_lu(torch.eye(n, dtype=torch.float32),
                                        torch.diag(torch.from_numpy(d)))
    r_sign, r_hi, r_lo = r_slogdet_pair(jnp.eye(n, dtype=jnp.float32),
                                        jnp.diag(jnp.asarray(d)))
    got = float(hi) + float(lo)
    assert abs(got - want) <= 2e-4, (got, want)
    assert abs(got - (float(r_hi) + float(r_lo))) <= 2e-4
    assert float(sign) == float(r_sign) == 1.0


# ------------------------------------------------- f32 protocol end-to-end
@pytest.mark.parametrize("n,servers", [(12, 3), (64, 4), (256, 4)])
def test_f32_roundtrip_matches_f64_reference(n, servers):
    m = _wellcond(n, seed=n)
    got = _port(m, servers=servers, dtype="float32")
    want = _ref(m, servers=servers, dtype="float32")
    assert got.verified, got.residual
    assert got.det.dtype == want.det.dtype == "float32"
    _agree(got, want, m)


def test_f32_batched_roundtrip():
    stack = _wellcond(64, seed=1, batch=4)
    got = _port(stack, dtype="float32")
    want = _ref(jnp.asarray(stack), dtype="float32")
    assert bool(np.all(got.verified))
    _agree(got, want, stack)


def test_f32_agrees_with_f64_protocol_run():
    """The same matrices through both compute dtypes give Determinants
    that allclose() at the f32 default tolerance; the f64 runs agree with
    the reference's at 1e-8."""
    for n in (12, 40):
        m = _wellcond(n, seed=n * 3)
        d64, d32 = _port(m).det, _port(m, dtype="float32").det
        assert d32.allclose(d64)
        assert not d32.allclose(Determinant(d64.sign, d64.logabs + 0.01,
                                            d64.dtype))
        r64 = _ref(m).det
        assert d64.allclose(Determinant(**dataclasses.asdict(r64)), rtol=1e-8)
    stack = _wellcond(32, seed=5, batch=3)
    r64, r32 = _port(stack), _port(stack, dtype="float32")
    w64 = _ref(jnp.asarray(stack))
    for a, b, w in zip(r32.dets, r64.dets, w64.dets):
        assert a.allclose(b)
        assert b.allclose(Determinant(**dataclasses.asdict(w)), rtol=1e-8)


def test_f32_growth_controls_are_defaults_and_overridable():
    m = _wellcond(16, seed=9)
    got = _port(m, dtype="float32", growth_safe=False, equilibrate=False)
    want = _ref(m, dtype="float32", growth_safe=False, equilibrate=False)
    assert got.det.dtype == "float32"
    assert got.verified == want.verified
    assert abs(got.det.logabs - want.det.logabs) <= F32_DLOG
    want_s, want_la = np.linalg.slogdet(m)
    got = _port(m, dtype="float64", growth_safe=True, equilibrate=True)
    assert got.verified and got.det.sign == want_s
    np.testing.assert_allclose(got.det.logabs, want_la, rtol=1e-9)
    with pytest.raises(ValueError, match="faithful_sign"):
        _port(m, dtype="float32", faithful_sign=True)


def test_f32_batched_n1024_roundtrip():
    """The acceptance shape of the f32 stack: 2 × 1024 stays verified
    within the 1e-4 log budget. The reference runs this case only in its
    slow tier, so the port is held to numpy's f64 slogdet alone."""
    stack = _wellcond(1024, seed=10, batch=2)
    got = _port(stack, dtype="float32")
    assert bool(np.all(got.verified))
    for det, x in zip(got.dets, stack):
        sign, logabs = np.linalg.slogdet(x)
        assert det.sign == sign and abs(det.logabs - logabs) <= F32_DLOG


def test_half_precision_protocol_refused_at_open_session():
    """float16/bfloat16 are not verified protocol dtypes (the panel and
    triangular-solve kernels take half precision only as mixed routes):
    the client refuses them before any server work."""
    from repro_torch.api import SPDCClient

    for dtype in ("float16", "bfloat16"):
        client = SPDCClient(dtype=dtype, device=CPU)
        with pytest.raises(ValueError, match="not a verified protocol dtype"):
            client.open_session(_wellcond(16, seed=2), N)


# --------------------------------------------------- f32 verification power
def test_f32_false_reject_rate_is_zero():
    """Honest f32 runs are never rejected (20 trials, mixed rotations);
    the reference runs the first 5 beside the port."""
    for t in range(20):
        m = _wellcond(32, seed=500 + t)
        got = _port(m, dtype="float32")
        assert got.verified, (t, got.residual, got.report.verdict.eps)
        if t < 5:
            want = _ref(m, dtype="float32")
            assert want.verified
            assert abs(got.det.logabs - want.det.logabs) <= F32_DLOG


@pytest.mark.parametrize("kind,kw", [
    ("dropout", dict(kind="dropout")),
    ("block", dict(mode="block", magnitude=0.5)),
    ("sign_flip_diag", dict(mode="single", magnitude=1.0)),
])
def test_f32_tampered_results_rejected(kind, kw):
    """Structurally significant tampers are rejected for every server,
    with the reference's culprit."""
    m = _wellcond(32, seed=77)
    for s in range(N):
        got = _port(m, dtype="float32", faults=ServerFault(server=s, **kw))
        want = _ref(m, dtype="float32", faults=RServerFault(server=s, **kw))
        assert not got.verified and not want.verified, (kind, s)
        assert got.report.verdict.culprit == want.report.verdict.culprit == s


def test_f32_accepted_results_are_det_accurate():
    """Any accepted verdict, honest or carrying a sub-threshold tamper,
    yields a determinant within 1e-3 of the true log|det|; the two
    packages accept the same runs (the reference runs seed 0 of each
    server beside the port)."""
    m = _wellcond(32, seed=88)
    want_s, want_la = np.linalg.slogdet(m)
    accepted = 0
    for s in range(N):
        for t in range(4):
            got = _port(m, dtype="float32",
                        faults=ServerFault(server=s, magnitude=1e-4, seed=t))
            if t == 0:
                want = _ref(m, dtype="float32",
                            faults=RServerFault(server=s, magnitude=1e-4,
                                                seed=t))
                assert got.verified == want.verified, (s, t)
            if got.verified:
                accepted += 1
                assert got.det.sign == want_s
                assert abs(got.det.logabs - want_la) <= 1e-3
    assert accepted > 0


# ------------------------------------------------------------ f32 recovery
@pytest.mark.parametrize("fault_kw", [dict(kind="dropout"),
                                      dict(mode="block", magnitude=0.5)],
                         ids=["dropout", "block"])
def test_f32_recovery_under_every_single_server_fault(fault_kw):
    m = _wellcond(64, seed=4)
    for s in range(N):
        got = _port(m, dtype="float32", faults=ServerFault(server=s, **fault_kw),
                    recover=True, standby=1)
        want = _ref(m, dtype="float32",
                    faults=RServerFault(server=s, **fault_kw),
                    recover=True, standby=1)
        assert got.verified and got.report.recovery.ok, (s, fault_kw)
        assert (got.report.recovery.servers_replaced
                == want.report.recovery.servers_replaced)
        _agree(got, want, m)


def test_f32_batched_recovery_splices_one_matrix():
    stack = _wellcond(32, seed=6, batch=4)
    got = _port(stack, dtype="float32",
                faults=ServerFault(server=2, kind="dropout", matrices=(1,)),
                recover=True, standby=1)
    want = _ref(jnp.asarray(stack), dtype="float32",
                faults=RServerFault(server=2, kind="dropout", matrices=(1,)),
                recover=True, standby=1)
    assert bool(np.all(got.verified)) and got.report.recovery.ok
    assert [e.matrices for e in got.report.recovery.events] == [(1,)]
    assert ([e.matrices for e in got.report.recovery.events]
            == [e.matrices for e in want.report.recovery.events])
    _agree(got, want, stack)


# ------------------------------------------------- Determinant comparisons
def _both(sign, logabs, dtype="float64"):
    return Determinant(sign, logabs, dtype), RDeterminant(sign, logabs, dtype)


def test_determinant_allclose_is_relative_det_error():
    """rtol bounds the relative det error |Δlog|, not logabs itself; the
    port's Determinant decides as the reference's does."""
    cases = [((1.0, 1000.0), (1.0, 1000.5), dict(rtol=1e-3), False),
             ((1.0, 0.0), (1.0, 0.5), dict(rtol=1e-3), False),
             ((1.0, 1000.0), (1.0, 1000.0 + 1e-9), dict(rtol=1e-8), True)]
    for a, b, kw, want in cases:
        (pa, ra), (pb, rb) = _both(*a), _both(*b)
        assert pa.allclose(pb, **kw) == ra.allclose(rb, **kw) == want
    (c, rc), (d, rd), (e, re) = (_both(1.0, 100.0, "float32"),
                                 _both(1.0, 100.00005, "float32"),
                                 _both(1.0, 100.001, "float32"))
    assert c.allclose(d) and rc.allclose(rd)
    assert not c.allclose(e) and not rc.allclose(re)


def test_determinant_allclose_zero_and_sign_cases():
    (zp, rzp), (zn, rzn), (z0, rz0) = (_both(1.0, float("-inf")),
                                       _both(-1.0, float("-inf")),
                                       _both(0.0, float("-inf")))
    one, r_one = _both(1.0, 0.0)
    for port, ref in ((zp, rzp), (zn, rzn), (z0, rz0), (one, r_one)):
        for port2, ref2 in ((zp, rzp), (zn, rzn), (z0, rz0), (one, r_one)):
            assert port.allclose(port2) == ref.allclose(ref2)
    assert zp.allclose(zn) and zp.allclose(z0) and z0.allclose(zn)
    assert not zp.allclose(one) and not one.allclose(zn)
    minus, _ = _both(-1.0, 0.0)
    assert not one.allclose(minus)
    (tp, rtp), (tn, rtn) = _both(1.0, -700.0), _both(-1.0, -700.5)
    assert not tp.allclose(tn) and not rtp.allclose(rtn)
    assert tp.allclose(tn, zero_logabs=-600.0)
    assert rtp.allclose(rtn, zero_logabs=-600.0)


def test_determinant_value_raises_instead_of_inf():
    ok, r_ok = _both(-1.0, 10.0)
    np.testing.assert_allclose(ok.value, -np.exp(10.0))
    assert ok.value == r_ok.value
    big, r_big = _both(1.0, 800.0)
    for det in (big, r_big):
        with pytest.raises(OverflowError, match="logabs"):
            _ = det.value


# --------------------------------------------------------------- dtypes
def test_float64_request_resolves_to_float64():
    """torch has no x64 switch: "float64" is always torch.float64, and the
    default protocol run computes in it, as the reference's does with x64
    on."""
    assert repro_torch.resolve_dtype("float64") is torch.float64
    m = _wellcond(16, seed=2)
    got, want = _port(m), _ref(m)
    assert got.verified and want.verified
    assert got.det.dtype == want.det.dtype == "float64"
    assert got.det.allclose(Determinant(**dataclasses.asdict(want.det)))
