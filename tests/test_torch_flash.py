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


# --- the packed split decode (Sq <= 16), emulated in plain PyTorch -----------

def _split_decode(q, k, v, *, causal=True, window=None, split=None):
    """The split decode's arithmetic, as the CUDA kernels do it and only
    the tests use it: scores in base 2 (scale · log2 e), masked ones the
    −1e30 sentinel; per chunk of keys (flash_attn.decode_split(Sk), or
    `split`) its max m, sum l and unnormalised acc; then
    flash_combine_kernel's merge, the chunks weighted by exp2(m_c − M) in
    chunk order, divided by the weighted l. q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), f32 tensors."""
    from repro_torch.kernels import flash_attn

    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    chunk, n = split or flash_attn.decode_split(sk)
    kk = k.repeat_interleave(hq // hkv, dim=1)
    vv = v.repeat_interleave(hq // hkv, dim=1)
    s = q @ kk.transpose(-1, -2) * (d ** -0.5 * np.log2(np.e))
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    parts = []
    for c in range(n):
        sc = s[..., c * chunk:(c + 1) * chunk]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      p @ vv[:, :, c * chunk:(c + 1) * chunk]))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(l_c * torch.exp2(m - top) for m, l_c, _ in parts)
    acc = sum(a * torch.exp2(m - top) for m, _, a in parts)
    return (acc / l).numpy()


@pytest.mark.parametrize("sk", [333, 40, 65])
@pytest.mark.parametrize("sq", [1, 4])
def test_split_decode_matches_pallas_and_oracle(sk, sq):
    """f32 at a GQA group of 8 over ragged key counts: three chunks with
    a partial last one, one chunk shorter than a tile, one tile and a
    key."""
    q, k, v = _inputs(2, 16, 2, sq, sk, 16, seed=sk + sq)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _port(q, k, v, causal=True), atol=3e-5)


@pytest.mark.parametrize("sq,window", [(1, 40), (4, 8)])
def test_split_decode_window_inside_the_last_chunk(sq, window):
    """The window covers keys of the last chunk only: the earlier chunks'
    m is the sentinel, and they weigh nothing in the merge."""
    q, k, v = _inputs(1, 8, 1, sq, 333, 16, seed=window)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)), window=window)
    kw = {"causal": True, "window": window}
    np.testing.assert_allclose(got, _pallas(q, k, v, **kw), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, **kw), atol=3e-5)


def test_split_decode_fully_masked_rows_are_mean_of_v():
    """Sq 8 > Sk 5 in chunks of 2 keys: the first three rows see no key,
    every chunk's m is the sentinel, so the merge weighs the chunks by l
    alone and gives the mean of V over all 5 keys, as the Pallas kernel
    does."""
    q, k, v = _inputs(1, 8, 1, 8, 5, 16, seed=11)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)), split=(2, 3))
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    mean = np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 8, 3, 16))
    np.testing.assert_allclose(got[:, :, :3], mean, atol=1e-6)
    np.testing.assert_allclose(got[:, :, 3:],
                               _oracle(q, k, v, causal=True)[:, :, 3:],
                               atol=3e-5)
