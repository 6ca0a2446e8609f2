"""The half-precision routes of the panel, triangular-solve and Schur
kernels (bfloat16 and float16 storage, with float32 or float64
arithmetic or, for the panel and the solves, in the half type itself),
and lu_blocked on them, against the reference's Pallas kernels in
interpret mode and its lu_blocked(use_kernels=True). Inputs are
numpy-seeded, rounded to the storage type once and handed to both
packages. The CUDA kernels are held
against these plain versions in tests/test_torch_cuda.py.

Tolerances, u the storage type's unit roundoff (eps / 2):
  * f32 and f64 arithmetic (panel, solves): 4 storage ulps of
    max|want|. Both sides round once to the storage type from wide values
    that differ in summation order only (in f64 on this CPU they agree
    bit for bit).
  * Narrow arithmetic: the port rounds every operation to the half type;
    the reference's interpret mode rounds per XLA fusion, keeping some
    intermediates in f32 (bfloat16 agrees bit for bit here, float16 does
    not). The panel is held elementwise to 2b·u·(|L|·|U|) and the solves
    to 2n·u·(|B| + |T|·|X|), b or n the elimination steps: the first-order
    bound of two roundings a step, with growth factor 1 (|L|·|U| and
    |T|·|X| from the reference's own result; the tiles are diagonally
    dominant and the triangles well conditioned, so nothing grows).
  * Schur f64: (2⌈K/128⌉ + 1)·u·(|C| + |A|·|B|), the existing mixed
    rule: Pallas rounds each 128-deep chunk to the storage type, the port
    rounds once.
  * lu_blocked: 4 storage ulps of max|factor| on both routes (measured
    here: at most 1 ulp, float16's narrow route at n = 128, whose 64-wide
    diagonal tiles the port factors blocked in 32-wide panels where the
    reference runs one panel kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lu as r_lu
from repro.kernels import ops as r_ops
from repro_torch.core import lu as t_lu
from repro_torch.kernels import ops, ref, routes

HALVES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
#: (port acc_dtype, reference acc_dtype) of the arithmetic routes
ARITH = {"narrow": (None, None), "f32": (torch.float32, jnp.float32),
         "f64": (torch.float64, jnp.float64)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _dominant(shape, seed):
    b = shape[-1]
    return _rand(shape, seed) + b * np.eye(b)


def _pair(x, half):
    """x rounded to the storage type: a port tensor and a reference array
    of the same values."""
    st, jst = HALVES[half]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(st)
    return t, jnp.asarray(t.float().numpy(), dtype=jst)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, dtype=np.float64)


def _u(half):
    return torch.finfo(HALVES[half][0]).eps / 2


def _within_ulps(got, want, half, ulps=4):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ulps * 2 * _u(half) * np.abs(want).max()


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("arith", list(ARITH))
@pytest.mark.parametrize("shape", [(32, 32), (48, 48), (3, 32, 32)],
                         ids=["32", "48", "batched"])
def test_lu_panel_half_matches_pallas(half, arith, shape):
    acc, jacc = ARITH[arith]
    t, j = _pair(_dominant(shape, shape[-1] + 1), half)
    got = ops.lu_panel(t, acc_dtype=acc)
    assert got.dtype == HALVES[half][0]
    want = _f64(r_ops._lu_panel_compact(j, interpret=True, acc_dtype=jacc))
    if arith != "narrow":
        _within_ulps(got, want, half)
        return
    b = shape[-1]
    lo = np.tril(want, -1) + np.eye(b)
    up = np.triu(want)
    bound = 2 * b * _u(half) * (np.abs(lo) @ np.abs(up))
    assert np.all(np.abs(_f64(got) - want) <= bound)


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("arith", list(ARITH))
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "batched"])
def test_trsm_half_match_pallas(half, arith, lead):
    acc, jacc = ARITH[arith]
    n, m = 48, 64
    l = np.tril(_rand((*lead, n, n), 1), -1) / n + np.eye(n)
    u = np.triu(_rand((*lead, n, n), 2)) + n * np.eye(n)
    (tl, jl), (tu, ju) = _pair(l, half), _pair(u, half)
    (tb, jb), (tb2, jb2) = _pair(_rand((*lead, n, m), 3), half), \
        _pair(_rand((*lead, m, n), 4), half)
    x1 = ops.trsm_lower(tl, tb, acc_dtype=acc)
    x2 = ops.trsm_upper_right(tu, tb2, acc_dtype=acc)
    w1 = _f64(r_ops.trsm_lower(jl, jb, interpret=True, acc_dtype=jacc))
    w2 = _f64(r_ops.trsm_upper_right(ju, jb2, interpret=True, acc_dtype=jacc))
    if arith != "narrow":
        _within_ulps(x1, w1, half)
        _within_ulps(x2, w2, half)
        return
    un = 2 * n * _u(half)
    lf, uf = np.tril(_f64(tl), -1), np.triu(_f64(tu))
    bound1 = un * (np.abs(_f64(tb)) + np.abs(lf) @ np.abs(w1))
    bound2 = un * (np.abs(_f64(tb2)) + np.abs(w2) @ np.abs(uf))
    assert np.all(np.abs(_f64(x1) - w1) <= bound1)
    assert np.all(np.abs(_f64(x2) - w2) <= bound2)


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("lead,m,k,n", [((), 64, 256, 96), ((2,), 32, 48, 64),
                                        ((), 96, 32, 96)],
                         ids=["2d-K256", "batched", "inner-K32"])
def test_schur_half_to_f64_matches_pallas(half, lead, m, k, n):
    (tc, jc), (ta, ja), (tb, jb) = (_pair(_rand((*lead, *s), i), half)
                                    for i, s in enumerate([(m, n), (m, k),
                                                           (k, n)]))
    got = ops.schur_update(tc, ta, tb, acc_dtype=torch.float64)
    assert got.dtype == HALVES[half][0]
    want = _f64(r_ops.schur_update(jc, ja, jb, acc_dtype=jnp.float64))
    c, a, b = (_f64(x) for x in (tc, ta, tb))
    bound = (2 * -(-k // 128) + 1) * _u(half) * (np.abs(c) + np.abs(a) @ np.abs(b))
    assert np.all(np.abs(_f64(got) - want) <= bound)


@pytest.mark.parametrize("half", list(HALVES))
def test_schur_half_to_f64_rounds_once(half):
    """The port's half → f64 Schur is C − A·B in f64 rounded to the
    storage type once, to nearest even (not twice, through f32)."""
    (tc, _), (ta, _), (tb, _) = (_pair(_rand(s, i), half)
                                 for i, s in enumerate([(64, 64), (64, 512),
                                                        (512, 64)]))
    got = ops.schur_update(tc, ta, tb, acc_dtype=torch.float64)
    exact = tc.double() - ta.double() @ tb.double()
    assert torch.equal(got, ref.narrow(exact, HALVES[half][0]))


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("arith", list(ARITH))
@pytest.mark.parametrize("n,block,batch", [(64, 32, None), (128, 64, None),
                                           (64, 32, 2)],
                         ids=["64-b32", "128-b64", "batched"])
def test_lu_blocked_half_matches_reference(half, arith, n, block, batch):
    """lu_blocked on a bf16/f16 matrix, narrow and with acc_dtype=f32 or
    f64, against the reference's kernel route (every Pallas kernel in
    interpret mode): factors of the storage type within 4 storage ulps
    of max|factor|."""
    acc, jacc = ARITH[arith]
    shape = (n, n) if batch is None else (batch, n, n)
    t, j = _pair(_dominant(shape, n + block), half)
    l, u = t_lu.lu_blocked(t, block, acc_dtype=acc)
    assert l.dtype == u.dtype == HALVES[half][0]
    l_r, u_r = r_lu.lu_blocked(j, block, use_kernels=True, interpret=True,
                               acc_dtype=jacc)
    _within_ulps(l, l_r, half)
    _within_ulps(u, u_r, half)


@pytest.mark.parametrize("half", list(HALVES))
def test_lu_blocked_f64_arithmetic_nearer_the_f64_factors(half):
    """The wide route stores the f64 factors rounded once per tile; the
    narrow route rounds every step: its residual ||L·U − X||_F / ||X||_F
    and its distance ||F − F64||_F / ||F64||_F from the f64 factorization
    are the larger. (Elementwise maxima do not tell them apart: both are
    set by the rounding of U's largest entries to the storage type.)"""
    t, _ = _pair(_dominant((256, 256), 7), half)
    x = t.double()
    l64, u64 = t_lu.lu_blocked(x, 64)
    resid, dist = {}, {}
    for arith, (acc, _) in ARITH.items():
        l, u = t_lu.lu_blocked(t, 64, acc_dtype=acc)
        resid[arith] = float(torch.linalg.norm(l.double() @ u.double() - x)
                             / torch.linalg.norm(x))
        dist[arith] = max(float(torch.linalg.norm(f.double() - g)
                                / torch.linalg.norm(g))
                          for f, g in ((l, l64), (u, u64)))
    assert resid["f64"] < resid["narrow"]
    assert dist["f64"] < dist["narrow"]


def test_every_half_pair_is_a_route():
    """routes.accumulator accepts every half-precision pair of the
    reference's kernels, and each resolves to a CUDA entry point."""
    for kernel in ("lu_panel", "trsm_lower", "trsm_upper_right",
                   "schur_update"):
        for st in (torch.bfloat16, torch.float16):
            assert routes.accumulator(kernel, st, torch.float64) == torch.float64
            assert routes.suffix(kernel, st, torch.float64).endswith("_f64")
            assert routes.accumulator(kernel, st, None) is None
            routes.suffix(kernel, st, None)


def test_narrow_rounds_once_where_torch_and_xla_round_twice():
    """A float64 → bfloat16 store rounds once, as the kernels'
    __double2bfloat16 does. torch's cast rounds through float32, and so
    does XLA's CPU convert to bfloat16 (not to float16): on 1 + 2^-8 +
    2^-30, just above a bfloat16 midpoint, they give 1.0, the nearest
    value 1 + 2^-7."""
    x = torch.tensor([1 + 2**-8 + 2**-30], dtype=torch.float64)
    assert float(ref.narrow(x, torch.bfloat16)) == 1 + 2**-7
    assert float(x.to(torch.bfloat16)) == 1.0
    xla = jnp.asarray(x.numpy()).astype(jnp.bfloat16)
    assert float(xla[0]) == 1.0
    y = torch.tensor([1 + 2**-11 + 2**-35], dtype=torch.float64)
    assert float(ref.narrow(y, torch.float16)) == 1 + 2**-10
    assert float(jnp.asarray(y.numpy()).astype(jnp.float16)[0]) == 1 + 2**-10
    # the other narrowing casts are torch's own
    z = torch.from_numpy(_rand(1000, 0))
    assert torch.equal(ref.narrow(z, torch.float32), z.float())
    assert torch.equal(ref.narrow(z.float(), torch.bfloat16), z.float().bfloat16())


def test_narrow_is_the_nearest_value():
    """ref.narrow against a brute-force nearest bfloat16/float16 over
    values spread across many binades, specials included."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 6, 20000)
    v = np.concatenate([v, [0.0, -0.0, np.inf, -np.inf, 1e39, -1e39, 1e-50]])
    x = torch.from_numpy(v)
    for st, step in ((torch.bfloat16, 0x10000), (torch.float16, None)):
        got = ref.narrow(x, st).double()
        finite = torch.isfinite(got) & torch.isfinite(x)
        g, xv = got[finite], x[finite]
        if step is not None:
            bits = g.float().view(torch.int32)
            up = (bits + step).view(torch.float32).double()
            dn = (bits - step).view(torch.float32).double()
        else:
            bits = g.to(st).view(torch.int16).to(torch.int32)
            up = (bits + 1).to(torch.int16).view(st).double()
            dn = (bits - 1).to(torch.int16).view(st).double()
        err = (g - xv).abs()
        ok = lambda nb: torch.where(torch.isfinite(nb), (nb - xv).abs() >= err,
                                    torch.ones_like(err, dtype=torch.bool))
        assert bool(ok(up).all() and ok(dn).all())
    assert torch.isnan(ref.narrow(torch.tensor([float("nan")], dtype=torch.float64),
                                  torch.bfloat16)).all()
