"""repro_torch.core.inverse against the JAX reference, on the CPU: the
facade over the shared-LU op plan — one verified factorization, one wide
public-RHS round, the final Freivalds re-check with a secret probe lane.

Mirrors tests/test_inverse.py case for case, each case giving both
packages the same numpy inputs from a seed (n <= 12, no border): the
inverses within the reference's bars (1e-9 in f64, 2e-3 in f32) of numpy
and of the reference's, the same verdicts, heal counts and op records,
the final probe drawn from the reference's lane bit for bit, the
adaptive-attack regression and the deprecated fields.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import ServerFault as RServerFault
from repro.core import outsource_inverse as r_outsource_inverse
from repro_torch import outsource_determinant, outsource_inverse
from repro_torch.core.faults import ServerFault
from repro_torch.linalg import LinalgSession

CPU = "cpu"


def _wellcond(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    if batch is None:
        return rng.standard_normal((n, n)) + n * np.eye(n)
    return rng.standard_normal((batch, n, n)) + n * np.eye(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("dtype,tol", [
    ("float64", 1e-9),
    ("float32", 2e-3),
])
def test_honest_roundtrip(dtype, tol):
    m = _wellcond(10, seed=1)
    res = outsource_inverse(m, 2, dtype=dtype, device=CPU)
    want = r_outsource_inverse(m, 2, dtype=dtype)
    assert res.verified and want.verified
    assert res.inverse.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(res.inverse), np.linalg.inv(m), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(_np(res.inverse), _np(want.inverse), rtol=0,
                               atol=tol)
    assert res.residual < tol
    ops = [o.op for o in res.report.ops]
    assert ops == [o.op for o in want.report.ops]
    assert "factor" in ops and "inv" in ops
    assert all(o.verified for o in res.report.ops)


def test_tampered_server_localizes_and_heals():
    """A server's tamper heals through the session's per-chunk checks,
    with the reference's heal counts, and the facade verifies."""
    m = _wellcond(12, seed=2)
    res = outsource_inverse(m, 2, faults=ServerFault(server=0, magnitude=50.0),
                            recover=True, device=CPU)
    want = r_outsource_inverse(m, 2, recover=True,
                               faults=RServerFault(server=0, magnitude=50.0))
    assert res.verified and want.verified
    np.testing.assert_allclose(_np(res.inverse), np.linalg.inv(m), rtol=0,
                               atol=1e-9)
    assert [o.healed for o in res.report.ops] == \
        [o.healed for o in want.report.ops]
    assert any(o.healed >= 1 for o in res.report.ops)


def test_final_tamper_is_caught():
    """`tamper=` alters the reported inverse after recovery; only the
    facade's final projection catches it, in both packages."""
    m = _wellcond(10, seed=3)

    def bump(iv):
        iv[3, 4] += 0.01
        return iv

    res = outsource_inverse(m, 2, tamper=bump, device=CPU)
    want = r_outsource_inverse(m, 2, tamper=lambda iv: iv.at[3, 4].add(0.01))
    assert not res.verified and not want.verified
    assert res.residual > 1e-6
    assert np.isclose(res.residual, want.residual, rtol=1e-6)


def test_batched_path():
    ms = _wellcond(8, seed=4, batch=3)
    res = outsource_inverse(ms, 2, device=CPU)
    assert res.verified
    assert tuple(res.inverse.shape) == (3, 8, 8)
    for i in range(3):
        np.testing.assert_allclose(_np(res.inverse[i]), np.linalg.inv(ms[i]),
                                   rtol=0, atol=1e-9)
    # one factorization per matrix in the stack, reports concatenated
    assert sum(1 for o in res.report.ops if o.op == "factor") == 3


def test_factors_bit_equal_to_fresh_outsourcing():
    """Deterministic in the matrix bytes: two sessions' factors are
    bit-equal, the digest is the reference's, and the session's slogdet
    is the standalone entry point's at the session's configuration."""
    from repro.linalg import LinalgSession as RLinalgSession

    m = _wellcond(10, seed=5)
    s1 = LinalgSession(m, 2, device=CPU)
    s1._ensure_factors()
    s2 = LinalgSession(m, 2, device=CPU)
    s2._ensure_factors()
    for f1, f2 in zip(s1._factors, s2._factors):
        assert torch.equal(f1, f2)
    assert s1.digest == s2.digest == RLinalgSession(m, 2).digest
    det = outsource_determinant(m, 2, method="q2", recover=True,
                                growth_safe=True, equilibrate=False,
                                device=CPU)
    sign, logabs = s1.slogdet()
    assert float(det.det.sign) == sign
    assert np.isclose(float(det.det.logabs), logabs, rtol=0, atol=1e-12)


def test_adaptive_attack_on_fixed_probe_is_caught():
    """A tamper orthogonal to the fixed-seed probe the facade replaced
    (seeded from a digest slice an adaptive server could learn) leaves
    that probe's residual untouched; the secret-lane probe rejects it,
    with the reference's residual."""
    m = _wellcond(10, seed=6)
    digest = LinalgSession(m, 2, device=CPU).digest
    r0 = np.random.default_rng(
        int.from_bytes(digest[:4], "big")
    ).standard_normal(10)
    z = np.arange(1.0, 11.0)
    w = np.random.default_rng(7).standard_normal(10)
    w -= (w @ r0) / (r0 @ r0) * r0
    attack = np.outer(z, w / np.linalg.norm(w))

    res = outsource_inverse(
        m, 2, device=CPU,
        tamper=lambda iv: iv + torch.from_numpy(attack).to(iv))
    want = r_outsource_inverse(
        m, 2, tamper=lambda iv: iv + np.asarray(attack, dtype=iv.dtype))
    old_resid = float(np.linalg.norm(m @ (_np(res.inverse) @ r0) - r0)
                      / np.linalg.norm(r0))
    assert old_resid < 1e-6, "attack must be orthogonal to the old probe"
    assert not res.verified and not want.verified
    assert res.residual > 1e-3
    assert np.isclose(res.residual, want.residual, rtol=1e-9)


def test_deprecated_protocol_fields_warn_and_error_policy():
    """`result.seed` / `result.meta` still answer but warn; with warnings
    as errors the access raises."""
    m = _wellcond(8, seed=8)
    res = outsource_inverse(m, 2, device=CPU)
    with pytest.warns(DeprecationWarning, match="session-internal"):
        seed = res.seed
    assert seed is not None
    with pytest.warns(DeprecationWarning, match="report.ops"):
        meta = res.meta
    assert meta is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        with pytest.raises(DeprecationWarning):
            _ = res.seed
