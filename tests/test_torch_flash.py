"""The port's flash attention (its plain version, which the CPU runs)
against the reference's Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, and against the reference's jnp oracle.

Tolerances: f32 within 3e-5 and bf16 within 2e-2, absolute on standard
normal inputs, the bounds tests/test_kernels.py holds the Pallas kernel
to: both sides accumulate in f32 and differ in summation order (bf16
also in where P and the output are rounded). The CUDA kernel is held
against the same plain version in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops

TOL = {np.float32: 3e-5, "bfloat16": 2e-2}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _pallas(q, k, v, dtype=np.float32, **kw):
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" \
        else jnp.asarray
    out = r_ops.flash_attention(cast(q), cast(k), cast(v), bq=16, bk=16,
                                interpret=True, **kw)
    return np.asarray(out, dtype=np.float32)


def _port(q, k, v, dtype=np.float32, **kw):
    cast = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if dtype == "bfloat16" else torch.from_numpy
    ops.reset_launches()
    out = ops.flash_attention(cast(q), cast(k), cast(v), **kw)
    assert ops.LAUNCHES["flash_attention"] == 0  # the plain version
    return out.float().numpy()


def _oracle(q, k, v, **kw):
    return np.asarray(r_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_pallas_and_oracle(hq, hkv, causal):
    q, k, v = _inputs(2, hq, hkv, 32, 32, 16, seed=hq + hkv)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=causal), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=causal), atol=3e-5)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_sliding_window_matches_pallas(window):
    q, k, v = _inputs(1, 2, 2, 48, 48, 16, seed=window)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(
        got, _pallas(q, k, v, causal=True, window=window), atol=3e-5)
    np.testing.assert_allclose(
        got, _oracle(q, k, v, causal=True, window=window), atol=3e-5)


@pytest.mark.parametrize("sq", [1, 4])
def test_decode_right_aligned_matches_pallas(sq):
    """sq < sk: the queries are the last sq positions (decode)."""
    q, k, v = _inputs(2, 4, 2, sq, 48, 16, seed=sq)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)


def test_ragged_lengths_match_pallas():
    """50 queries over 77 keys: the Pallas wrapper halves its tiles until
    they divide; the port has no tiles to halve."""
    q, k, v = _inputs(1, 2, 1, 50, 77, 8, seed=5)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=True), atol=3e-5)


def test_fully_masked_rows_equal_pallas_mean_of_v():
    """Causal with Sq > Sk: rows 0..Sq−Sk−1 see no key. The Pallas kernel
    gives them the mean of V over the Sk keys (its masked scores are
    −1e30, not −inf, so every exp(s − m) is 1), despite its comment that
    such rows are zero; the reference's jnp oracle gives NaN there. The
    port gives the kernel's value."""
    q, k, v = _inputs(1, 2, 1, 8, 4, 8, seed=6)
    got = _port(q, k, v, causal=True)
    want = _pallas(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=3e-5)
    mean = np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 2, 4, 8))
    np.testing.assert_allclose(got[:, :, :4], mean, atol=1e-6)
    assert np.isnan(_oracle(q, k, v, causal=True)[:, :, :4]).all()
    np.testing.assert_allclose(got[:, :, 4:],
                               _oracle(q, k, v, causal=True)[:, :, 4:],
                               atol=3e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dtypes_match_pallas(dtype):
    q, k, v = _inputs(1, 2, 2, 32, 32, 8, seed=7)
    got = _port(q, k, v, dtype, causal=True)
    want = _pallas(q, k, v, dtype, causal=True)
    np.testing.assert_allclose(got, want, atol=TOL[dtype])


def test_strided_model_views_match_pallas():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views."""
    rng = np.random.default_rng(8)
    qs, ks, vs = (rng.standard_normal((2, 32, h, 16)).astype(np.float32)
                  for h in (4, 2, 2))
    got = ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (qs, ks, vs)), causal=True)
    want = _pallas(*(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                     for x in (qs, ks, vs)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("kwargs,exc", [
    ({"window": 0}, ValueError),
    ({"sk": 0}, ValueError),
    ({"hkv": 3}, ValueError),
    ({"d": 12}, ValueError),
    ({"dtype": torch.float64}, TypeError),
])
def test_refuses_what_the_kernel_does_not_take(kwargs, exc):
    sk, hkv, d = kwargs.get("sk", 8), kwargs.get("hkv", 2), kwargs.get("d", 16)
    dtype = kwargs.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 8, d, dtype=dtype)
    k = torch.zeros(1, hkv, sk, d, dtype=dtype)
    with pytest.raises(exc):
        ops.flash_attention(q, k, k.clone(), window=kwargs.get("window"))
