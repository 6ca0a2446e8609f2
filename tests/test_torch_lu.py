"""The Schur update, the sequential blocked LU and one server's block row
of the port against the JAX reference, on the CPU.

Both sides get the same numpy inputs. The reference's Pallas Schur kernel
runs in interpret mode, as tests/test_kernels.py runs it. Tolerances:
`schur_update` within tol · (max|C| + K·max|A|·max|B|), the scale of the
K products both sides sum in different orders — tol 1e-12 in f64, 1e-5 in
f32; in bf16 and f16 within 2e-2 · max|want|, since both sides sum in f32
and differ by where they round the stored output. LU factors at rtol 1e-10 / atol 1e-12 on diagonally
dominant inputs (the bound DESIGN.md §1.2 uses between LU
implementations). The port's "nserver" strips are held bit-equal to its
own `lu_nserver` rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lu as r_lu
from repro.kernels import ops as r_ops
from repro_torch.core import lu as t_lu
from repro_torch.kernels import ops, ref

TOL = {np.float64: 1e-12, np.float32: 1e-5, "bfloat16": 2e-2, np.float16: 2e-2}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _dominant(shape, seed):
    n = shape[-1]
    return _rand(shape, seed) + n * np.eye(n)


def _scale(c, a, b):
    return float(np.abs(c).max() + a.shape[-1] * np.abs(a).max() * np.abs(b).max())


def _operands(lead, m, k, n, seed):
    return (_rand((*lead, m, n), seed), _rand((*lead, m, k), seed + 1),
            _rand((*lead, k, n), seed + 2))


# ------------------------------------------------------------- schur_update
@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, "bfloat16", np.float16])
def test_schur_update_plain_matches_pallas(lead, dtype):
    c, a, b = _operands(lead, 64, 48, 96, seed=len(lead))
    if dtype == "bfloat16":
        ts = [torch.from_numpy(x).to(torch.bfloat16) for x in (c, a, b)]
        js = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in ts]
    else:
        ts = [torch.from_numpy(x.astype(dtype)) for x in (c, a, b)]
        js = [jnp.asarray(x.astype(dtype)) for x in (c, a, b)]
    got = ops.schur_update(*ts).to(torch.float64).numpy()
    want = np.asarray(r_ops.schur_update(*js, bm=32, bn=32, bk=16),
                      dtype=np.float64)
    assert got.shape == want.shape
    scale = (np.abs(want).max() if dtype in ("bfloat16", np.float16)
             else _scale(c, a, b))
    assert np.abs(got - want).max() <= TOL[dtype] * scale


def test_schur_update_reads_views_and_leaves_operands():
    """lu_blocked hands the update strided blocks of the n×n matrix; the
    result is fresh and equals C − A·B."""
    x = torch.from_numpy(_rand((96, 96), 7))
    before = x.clone()
    c, a, b = x[32:64, 64:96], x[32:64, :32], x[:32, 64:96]
    got = ops.schur_update(c, a, b)
    assert torch.equal(x, before)
    assert got.is_contiguous() and got.data_ptr() != c.data_ptr()
    c, a, b = c.numpy(), a.numpy(), b.numpy()
    np.testing.assert_allclose(got.numpy(), c - a @ b, rtol=0,
                               atol=1e-12 * _scale(c, a, b))


def test_schur_update_on_cpu_is_the_plain_version():
    c, a, b = (torch.from_numpy(x) for x in _operands((), 16, 8, 12, 3))
    ops.reset_launches()
    assert torch.equal(ops.schur_update(c, a, b), ref.schur_update_ref(c, a, b))
    assert ops.LAUNCHES["schur_update"] == 0


def test_schur_update_refuses_other_devices():
    meta = torch.empty(4, 4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.schur_update(meta, meta, meta)
    cpu = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.schur_update(cpu, cpu, meta)


def test_schur_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.schur import schur_update_cuda

    cpu = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        schur_update_cuda(cpu, cpu, cpu)


# ----------------------------------------------------------------- lu_blocked
@pytest.mark.parametrize("n,block", [(64, 16), (64, 32), (96, 16), (96, 32)])
@pytest.mark.parametrize("batch", [None, 3])
def test_lu_blocked_matches_reference(n, block, batch):
    shape = (n, n) if batch is None else (batch, n, n)
    a = _dominant(shape, n + block)
    l, u = t_lu.lu_blocked(torch.from_numpy(a), block)
    for use_kernels in (False, True):
        l_r, u_r = r_lu.lu_blocked(jnp.asarray(a), block,
                                   use_kernels=use_kernels)
        np.testing.assert_allclose(l.numpy(), np.asarray(l_r), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_r), rtol=1e-10,
                                   atol=1e-12)


def test_lu_blocked_leaves_input_and_refuses_what_it_lacks():
    x = torch.from_numpy(_dominant((32, 32), 5))
    before = x.clone()
    l, u = t_lu.lu_blocked(x, 8)
    assert torch.equal(x, before)
    np.testing.assert_allclose((l @ u).numpy(), x.numpy(), atol=1e-12)
    with pytest.raises(ValueError, match="divisible"):
        t_lu.lu_blocked(x, 12)
    # the mixed variant: f32 in, f32 out, the input untouched; a pair
    # with no route (f64 storage, f32 arithmetic) is refused
    x32 = x.float()
    before32 = x32.clone()
    l32, u32 = t_lu.lu_blocked(x32, 8, acc_dtype=torch.float64)
    assert torch.equal(x32, before32)
    assert l32.dtype == u32.dtype == torch.float32
    with pytest.raises(TypeError, match="not a route"):
        t_lu.lu_blocked(x, 8, acc_dtype=torch.float32)


# ------------------------------------------------- lu_blocked, mixed variant
#: f32 factors of the two mixed routes: within 8 f32 ulps of max|factor|
MIXED_TOL = 8 * 2.0**-24


def _mixed_factors(x):
    """(port mixed, reference mixed, port plain f32, f64) factor pairs of
    lu_blocked(x as f32, 32): the reference's kernel route in interpret
    mode, which factors each 32-wide diagonal tile in one wide launch, as
    the port's block-32 tiles are one Doolittle tile too."""
    x32 = x.astype(np.float32)
    port = t_lu.lu_blocked(torch.from_numpy(x32), 32, acc_dtype=torch.float64)
    want = r_lu.lu_blocked(jnp.asarray(x32), 32, use_kernels=True,
                           interpret=True, acc_dtype=jnp.float64)
    plain = t_lu.lu_blocked(torch.from_numpy(x32), 32)
    f64 = t_lu.lu_blocked(torch.from_numpy(x32.astype(np.float64)), 32)
    as_np = lambda pair: tuple(np.asarray(f, dtype=np.float64) for f in pair)
    return (as_np([f.numpy() for f in port]), as_np(want),
            as_np([f.numpy() for f in plain]), as_np([f.numpy() for f in f64]))


@pytest.mark.parametrize("shape", [(64, 64), (2, 64, 64)], ids=["2d", "batched"])
def test_lu_blocked_mixed_matches_reference_and_beats_plain_f32(shape):
    port, want, plain, f64 = _mixed_factors(_dominant(shape, 64))
    for got, ref_f in zip(port, want):
        assert np.abs(got - ref_f).max() <= MIXED_TOL * np.abs(ref_f).max()

    def dist(pair):
        return max(np.abs(a - b).max() / np.abs(b).max()
                   for a, b in zip(pair, f64))

    assert dist(port) <= 2 * dist(want)
    assert dist(port) < dist(plain)


def test_lu_blocked_mixed_blocked_tiles_round_between_inner_steps():
    """Above 64 rows a diagonal tile is factored blocked, its entries
    rounded to f32 between 32-wide steps; still nearer the f64
    factorization than the plain f32 route."""
    x = _dominant((128, 128), 3).astype(np.float32)
    f64 = t_lu.lu_blocked(torch.from_numpy(x).double(), 128)
    mixed = t_lu.lu_blocked(torch.from_numpy(x), 128, acc_dtype=torch.float64)
    plain = t_lu.lu_blocked(torch.from_numpy(x), 128)

    def dist(pair):
        return max(float((a.double() - b).abs().max() / b.abs().max())
                   for a, b in zip(pair, f64))

    assert dist(mixed) < dist(plain)


# --------------------------------------------------------------- lu_block_row
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("style", ["nserver", "pipeline"])
def test_lu_block_row_matches_reference(batch, style):
    n, N = 64, 4
    shape = (n, n) if batch is None else (batch, n, n)
    x = _dominant(shape, 11)
    _, u_r, _ = r_lu.lu_nserver(jnp.asarray(x), N)
    u = np.asarray(u_r)
    for server in range(N):
        want = r_lu.lu_block_row(jnp.asarray(x), jnp.asarray(u), server, N,
                                 style=style)
        got = t_lu.lu_block_row(torch.from_numpy(x), torch.tensor(u),
                                server, N, style=style)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       atol=1e-12)


@pytest.mark.parametrize("n,N", [(64, 4), (128, 2)])
@pytest.mark.parametrize("batch", [None, 2])
def test_nserver_strips_bit_equal_to_lu_nserver(n, N, batch):
    """Every server's strips equal the fused sweep's rows bit for bit,
    when only the rows above it are given (what the relay delivers)."""
    shape = (n, n) if batch is None else (batch, n, n)
    x = torch.from_numpy(_dominant(shape, n + N))
    l, u, _ = t_lu.lu_nserver(x, N)
    b = n // N
    for server in range(N):
        rows = slice(server * b, (server + 1) * b)
        upstream = torch.zeros_like(u)
        upstream[..., : server * b, :] = u[..., : server * b, :]
        l_row, u_row = t_lu.lu_block_row(x, upstream, server, N)
        assert torch.equal(l_row, l[..., rows, :]), server
        assert torch.equal(u_row, u[..., rows, :]), server


def test_lu_block_row_masks_rows_at_and_below_the_server():
    x = torch.from_numpy(_dominant((32, 32), 13))
    _, u, _ = t_lu.lu_nserver(x, 4)
    poisoned = u.clone()
    poisoned[16:] = 1e6
    for style in ("nserver", "pipeline"):
        got = t_lu.lu_block_row(x, poisoned, 2, 4, style=style)
        want = t_lu.lu_block_row(x, u, 2, 4, style=style)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="style"):
        t_lu.lu_block_row(x, u, 0, 4, style="other")
    with pytest.raises(ValueError, match="range"):
        t_lu.lu_block_row(x, u, 4, 4)
