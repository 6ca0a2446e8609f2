"""The port's host key material against the JAX reference: seeds, keys,
rotation degrees and signs, padding, border and equilibration.

Everything here is deterministic host arithmetic or an exact relayout,
so the port must agree BIT FOR BIT. Inputs are made from a seed with
numpy and handed to both packages.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import augment as t_augment
from repro_torch.core import cipher as t_cipher
from repro_torch.core import keygen as t_keygen
from repro_torch.core import prt as t_prt
from repro_torch.core import seed as t_seed
from repro_torch.core.protocol import resolve_dtype

# repro.core re-exports functions under its submodules' names
# (repro.core.augment is the function), so bind the modules themselves
r_augment, r_cipher, r_keygen, r_prt, r_seed = (
    importlib.import_module(f"repro.core.{name}")
    for name in ("augment", "cipher", "keygen", "prt", "seed")
)


def _matrix(n, seed, batch=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    return (rng.standard_normal(shape) * 3.0 + 0.25).astype(dtype)


@pytest.mark.parametrize("n,seed", [(2, 0), (7, 1), (64, 2), (129, 3)])
@pytest.mark.parametrize("lambda1", [128, 256])
def test_seedgen_bit_equal(n, seed, lambda1):
    m = _matrix(n, seed)
    want = r_seed.seedgen(lambda1, m)
    got = t_seed.seedgen(lambda1, m)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_seedgen_float32_host_copy_bit_equal():
    """A float32 protocol hashes the float32-cast plaintext: both
    packages must hash the same bytes."""
    m = _matrix(33, 4, dtype=np.float32)
    assert dataclasses.astuple(t_seed.seedgen(128, m)) \
        == dataclasses.astuple(r_seed.seedgen(128, m))


def test_seedgen_batch_bit_equal():
    m = _matrix(16, 5, batch=4)
    got = [dataclasses.astuple(s) for s in t_seed.seedgen_batch(128, m)]
    want = [dataclasses.astuple(s) for s in r_seed.seedgen_batch(128, m)]
    assert got == want
    with pytest.raises(ValueError):
        t_seed.seedgen_batch(128, m[0])


@pytest.mark.parametrize("count", [1, 4, 5, 33])
def test_csprng_bit_equal(count):
    digest = bytes(range(32))
    np.testing.assert_array_equal(
        t_keygen._csprng(digest, 128, count),
        r_keygen._csprng(digest, 128, count),
    )


@pytest.mark.parametrize("n", [2, 3, 64, 257])
@pytest.mark.parametrize("lambda2", [128, 7])
def test_keygen_bit_equal(n, lambda2):
    seed = r_seed.seedgen(128, _matrix(n, n))
    want = r_keygen.keygen(lambda2, seed, n)
    got = t_keygen.keygen(lambda2, t_seed.seedgen(128, _matrix(n, n)), n)
    np.testing.assert_array_equal(got.v, want.v)
    assert got.n == want.n


def test_keygen_batch_bit_equal():
    m = _matrix(24, 9, batch=3)
    seeds_r = r_seed.seedgen_batch(128, m)
    seeds_t = t_seed.seedgen_batch(128, m)
    np.testing.assert_array_equal(
        t_keygen.keygen_batch(128, seeds_t, 24),
        r_keygen.keygen_batch(128, seeds_r, 24),
    )


def test_keygen_rejects_n1():
    with pytest.raises(ValueError):
        t_keygen.keygen(128, t_seed.seedgen(128, _matrix(2, 0)), 1)


@pytest.mark.parametrize("method", ["floor", "ceil", "round", "trunc"])
def test_rotation_degree_and_quantize_equal(method):
    for psi in np.linspace(1 / 16, 16, 97):
        assert t_prt.quantize_seed(psi, method) == r_prt.quantize_seed(psi, method)
        assert t_prt.rotate_degree(psi, method) == r_prt.rotate_degree(psi, method)


def test_sign_laws_equal():
    for n in range(1, 18):
        assert t_prt.flip_sign(n) == r_prt.flip_sign(n)
        for k in range(0, 6):
            assert t_prt.rotation_sign(n, k) == r_prt.rotation_sign(n, k)
            assert t_prt.growth_safe_sign(n, k) == r_prt.growth_safe_sign(n, k)
            assert t_prt.rotation_sign_paper(k) == r_prt.rotation_sign_paper(k)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("n", [4, 7])
def test_rot90_cw_bit_equal(k, n):
    x = _matrix(n, k)
    want = np.asarray(r_prt.rot90_cw(jnp.asarray(x), k))
    got = t_prt.rot90_cw(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_rot90_cw_batched_turns_last_two_axes():
    x = _matrix(5, 1, batch=2)
    got = t_prt.rot90_cw(torch.from_numpy(x), 1).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.rot90(x[i], -1))


def test_padding_equal():
    for n in range(1, 40):
        assert t_augment.padding_to_even(n) == r_augment.padding_to_even(n)
        for N in range(1, 9):
            assert t_augment.padding_for_servers(n, N) \
                == r_augment.padding_for_servers(n, N)
    with pytest.raises(ValueError):
        t_augment.padding_for_servers(8, 0)


def test_augment_p0_is_identity():
    x = torch.from_numpy(_matrix(8, 2))
    assert t_augment.augment(x, 0, rng=np.random.default_rng(0)) is x


@pytest.mark.parametrize("batch", [None, 3])
def test_augment_border_structure_and_det(batch):
    n, p = 6, 2
    x = torch.from_numpy(_matrix(n, 3, batch=batch))
    digest = bytes(range(32))
    aug = t_augment.augment(x, p, rng=t_augment.border_rng(digest))
    assert aug.shape[-2:] == (n + p, n + p)
    torch.testing.assert_close(aug[..., :n, :n], x, rtol=0, atol=0)
    assert torch.count_nonzero(aug[..., :n, n:]) == 0
    eye = torch.eye(p, dtype=x.dtype).expand(*aug.shape[:-2], p, p)
    torch.testing.assert_close(aug[..., n:, n:], eye, rtol=0, atol=0)
    r = aug[..., n:, :n]
    assert bool(((r >= -1.0) & (r < 1.0)).all()) and bool((r != 0).any())
    # the draw replays from the digest
    again = t_augment.augment(x, p, rng=t_augment.border_rng(digest))
    assert torch.equal(aug, again)
    # det-preserving: the reference's own border of the same x has the
    # same determinant (its R differs by design)
    ref = np.asarray(r_augment.augment(jnp.asarray(x.numpy()), p))
    np.testing.assert_allclose(np.linalg.det(aug.numpy()), np.linalg.det(ref),
                               rtol=1e-12)
    np.testing.assert_allclose(np.linalg.det(aug.numpy()),
                               np.linalg.det(x.numpy()), rtol=1e-12)


def _equilibrate_exact(x):
    """Power-of-two row then column scaling with np.ldexp, exact by
    construction."""
    def pow2_exp(maxabs):
        return np.round(np.log2(np.where(maxabs > 0, maxabs, 1.0))).astype(int)

    e_r = pow2_exp(np.abs(x).max(axis=-1))
    x = np.ldexp(x, -e_r[..., :, None])
    e_c = pow2_exp(np.abs(x).max(axis=-2))
    return np.ldexp(x, -e_c[..., None, :]), -(e_r.sum(-1) + e_c.sum(-1))


@pytest.mark.parametrize("batch", [None, 2])
def test_equilibrate_exact_and_matches_reference(batch):
    """The port's scaling is exact and its exponents are the reference's.
    The reference's own scaled matrix may be an ulp off per scaling:
    jnp.exp2 of an integer is not exact on the CPU backend (ROADMAP C)."""
    x = _matrix(9, 11, batch=batch)
    x[..., 3, :] = 0.0  # an all-zero row scales by 1
    exact_x, exact_s = _equilibrate_exact(x)
    got_x, got_s = t_cipher.equilibrate(torch.from_numpy(x))
    want_x, want_s = r_cipher.equilibrate(jnp.asarray(x))
    np.testing.assert_array_equal(got_x.numpy(), exact_x)
    np.testing.assert_array_equal(got_s.numpy(), exact_s)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # two scalings, each at most one ulp off in the reference
    np.testing.assert_array_max_ulp(got_x.numpy(), np.asarray(want_x), maxulp=2)


@pytest.mark.parametrize("spec,want", [
    ("float64", torch.float64), ("float32", torch.float32),
    (np.float64, torch.float64), (torch.float32, torch.float32),
    ("torch.float64", torch.float64),
])
def test_resolve_dtype(spec, want):
    assert resolve_dtype(spec) is want
