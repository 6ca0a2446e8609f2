"""Public names of the JAX package that the port carries too, each held
to the JAX package's value on the CPU: the paper's Table I cost models
(cipher_flops, decipher_flops, verification_flops), augment_for_servers,
sign_preserved, Session.batch and Transport.factor_async."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as r_api
import repro.core as r_core
from repro.core.verify import verification_flops as r_verification_flops
from repro_torch import core
from repro_torch.api import SPDCClient, ThreadPoolTransport
from repro_torch.core.verify import verification_flops

CPU = "cpu"


def _wellcond(n, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return rng.standard_normal(shape) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 7, 64, 1001])
def test_table_one_cost_models_match_reference(n):
    assert core.cipher_flops(n) == r_core.cipher_flops(n)
    assert core.decipher_flops(n) == r_core.decipher_flops(n)
    for method in ("q1", "q2", "q3", "q3_literal"):
        assert verification_flops(n, method) == r_verification_flops(n, method)


def test_verification_flops_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        verification_flops(8, "q4")
    with pytest.raises(ValueError):
        r_verification_flops(8, "q4")


@pytest.mark.parametrize("n", range(1, 13))
def test_sign_preserved_matches_reference(n):
    for k in range(8):
        assert core.sign_preserved(n, k) == r_core.sign_preserved(n, k)


@pytest.mark.parametrize("n,servers", [(16, 4), (17, 4), (5, 4), (9, 2),
                                       (3, 8)])
def test_augment_for_servers_matches_reference(n, servers):
    """Without a border generator both pad with R = 0, bit for bit; with
    one, the determinant is kept."""
    a = _wellcond(n, seed=n)
    got, p = core.augment_for_servers(torch.from_numpy(a), servers)
    want, p0 = r_core.augment_for_servers(jnp.asarray(a), servers)
    assert p == p0 and (n + p) % servers == 0 and (n + p) // servers > 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bordered, _ = core.augment_for_servers(torch.from_numpy(a), servers,
                                           rng=np.random.default_rng(1))
    sign, logabs = np.linalg.slogdet(bordered.numpy())
    sign0, logabs0 = np.linalg.slogdet(a)
    assert sign == sign0
    np.testing.assert_allclose(logabs, logabs0, rtol=1e-12)


@pytest.mark.parametrize("batch", [None, 3])
def test_session_batch_matches_reference(batch):
    m = _wellcond(12, seed=5, batch=batch)
    ours = SPDCClient(device=CPU).open_session(m, 4)
    theirs = r_api.SPDCClient().open_session(m, 4)
    assert ours.batch == theirs.batch == batch


def test_factor_async_matches_factor_and_reference():
    """The sweep as a Future on the transport's driver threads: the
    factors of `factor`, bit for bit, and the reference's factor_async
    factors of the same session within rtol 1e-12."""
    m = _wellcond(16, seed=9)
    ours = SPDCClient(device=CPU).open_session(m, 4)
    with ThreadPoolTransport(device=CPU) as tp:
        future = tp.factor_async(ours.tasks())
        l, u = ours._assemble(future.result(timeout=120))
        l0, u0 = ours._assemble(tp.factor(ours.tasks()))
    assert torch.equal(l, l0) and torch.equal(u, u0)
    theirs = r_api.SPDCClient().open_session(m, 4)
    with r_api.ThreadPoolTransport() as rtp:
        rl, ru = theirs._assemble(
            rtp.factor_async(theirs.tasks()).result(timeout=120))
    np.testing.assert_allclose(l.numpy(), np.asarray(rl), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(u.numpy(), np.asarray(ru), rtol=1e-12, atol=1e-13)
