"""B6's gradient on the CPU: the plain version of the gradient kernels
(ref.flash_attention_backward_ref, from the forward's output and base-2
lse, ref.flash_attention_lse_ref) against autograd through the plain
forward and against jax.vjp of the JAX package's attention, and the
kernels' blocking emulated in plain PyTorch.

The JAX package trains through `_sdpa`, `_blockwise` and `_local`
(src/repro/models/attention.py), with K and V repeated to the query
heads (`jnp.repeat`), so their vjp sums dk and dv over each kv head's
group as the kernels do. Inputs come from numpy seeds, (B, S, H, D) as
the models hold them; the port takes their (B, H, S, D) views.

Tolerances, leaf by leaf on its max|g|: f32 1e-5 (sums in another order,
exp2 of base-2 scores against exp); bf16 every element within 2 eps
max|g| and the whole within eps ||want|| (each side rounds the output
once; the kernels round P and dS to bf16 before their products, the
oracle keeps the unnormalised exp(s − max) and dS in f32). The blocking
emulated in f32 changes the order of f32 sums and nothing else: within
1e-6 of max|g|, and skipping the tiles the kernels skip changes no bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attention
from repro_torch.kernels import flash_attn, flash_bwd, flash_grad, ref

#: (B, Hq, Hkv, Sq, Sk, D, flash keyword arguments)
CASES = {
    "gqa causal": (2, 4, 2, 24, 24, 16, {"causal": True}),
    "window": (1, 4, 1, 30, 30, 16, {"causal": True, "window": 5}),
    "non-causal": (2, 2, 2, 20, 20, 8, {"causal": False}),
    "scale": (1, 4, 2, 16, 16, 16, {"causal": True, "scale": 0.3}),
    "right-aligned rows": (1, 4, 2, 6, 20, 16, {"causal": True}),
    "fully masked rows": (1, 4, 2, 20, 6, 16, {"causal": True}),
    "non-causal window": (1, 2, 1, 12, 30, 8, {"causal": False, "window": 7}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU products: one intra-op thread runs them faster than a
    pool contended by the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(b, hq, hkv, sq, sk, d, seed):
    """numpy q, dO (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), f32."""
    rng = np.random.default_rng(seed)

    def draw(s, h):
        return rng.standard_normal((b, s, h, d)).astype(np.float32)

    return draw(sq, hq), draw(sk, hkv), draw(sk, hkv), draw(sq, hq)


def _views(arrays, dtype=torch.float32):
    """The port's (B, H, S, D) views of (B, S, H, D) arrays."""
    return [torch.from_numpy(a).to(dtype).transpose(1, 2) for a in arrays]


def _plain_grads(q, k, v, g, kw):
    """The gradient kernels' plain version on the plain forward's output
    and lse."""
    o, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    return ref.flash_attention_backward_ref(q, k, v, o, lse, g, **kw)


def _within(got, want, dtype=torch.float32, f32_tol=1e-5):
    for a, c in zip(got, want):
        assert a.shape == c.shape
        a, c = a.float(), c.float()
        top = float(c.abs().max())
        err = (a - c).abs()
        assert top > 0
        if dtype == torch.float32:
            assert float(err.max()) <= f32_tol * top, float(err.max()) / top
            continue
        eps = torch.finfo(dtype).eps
        assert float(err.max()) <= 2 * eps * top, float(err.max()) / top
        assert float(err.norm()) <= eps * float(c.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd_oracle(case, dtype):
    """ref.flash_attention_backward_ref against autograd through
    ref.flash_attention_ref, the same inputs (model views)."""
    *shape, kw = CASES[case]
    q, k, v, g = _views(_draw(*shape, seed=3), dtype)
    want = flash_grad.flash_attention_backward(
        q, k, v, g, kw.get("causal", True), kw.get("window"), kw.get("scale"))
    got = _plain_grads(q, k, v, g, kw)
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
    _within(got, want, dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_lse_is_base2_logsumexp_of_the_seen_scores(case):
    """m + log2 Σ exp2(s − m) over each row's seen keys equals log2 of
    Σ exp(q·k·scale) (natural scores) within f32 rounding; a row that
    sees no key gets the −1e30 sentinel."""
    *shape, kw = CASES[case]
    q, k, v, _ = _views(_draw(*shape, seed=4))
    _, lse = ref.flash_attention_lse_ref(q, k, v, **kw)
    s, mask = ref._scores(q, k, kw.get("scale") or shape[5] ** -0.5,
                          kw.get("causal", True), kw.get("window"))
    seen = mask.any(dim=-1)
    want = torch.logsumexp(s.double().masked_fill(~mask, -torch.inf),
                           dim=-1) / np.log(2)
    assert torch.allclose(lse.double()[..., seen], want[..., seen],
                          rtol=1e-6, atol=1e-5)
    assert bool((lse[..., ~seen] == ref.NEG_INF).all())


# --- against jax.vjp of the JAX package's attention -------------------------

def _reference_grads(fn, q, k, v, g, group):
    """jax.vjp of fn(q, repeat(k), repeat(v)) at (B, S, H, D) arrays, K and
    V repeated to the query heads as the reference repeats them (so the
    vjp sums dk and dv over each group); grads as the port's views."""
    def f(qq, kk, vv):
        return fn(qq, jnp.repeat(kk, group, axis=2), jnp.repeat(vv, group, axis=2))

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [torch.from_numpy(np.asarray(x, dtype=np.float32)).transpose(1, 2)
            for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", ["gqa causal", "window", "non-causal",
                                  "right-aligned rows", "fully masked rows",
                                  "non-causal window"])
def test_plain_backward_matches_reference_sdpa_vjp(case):
    """_sdpa with its position mask: query row i at i + Sk − Sq."""
    b, hq, hkv, sq, sk, d, kw = CASES[case]
    arrays = _draw(b, hq, hkv, sq, sk, d, seed=5)
    qpos = jnp.broadcast_to(jnp.arange(sq) + sk - sq, (b, sq))
    kpos = jnp.arange(sk)

    def sdpa(q, k, v):
        return r_attention._sdpa(q, k, v, qpos, kpos,
                                 causal=kw.get("causal", True),
                                 window=kw.get("window"), chunk=None,
                                 scale=d ** -0.5)

    want = _reference_grads(sdpa, *arrays[:3], arrays[3], hq // hkv)
    got = _plain_grads(*_views(arrays), kw)
    _within(got, want)


@pytest.mark.parametrize("causal,sq", [(True, 24), (False, 24), (True, 10)])
def test_plain_backward_matches_reference_blockwise_vjp(causal, sq):
    """_blockwise scanning 8-key blocks over 24 keys (every row sees a
    key: its padded keys would join a dead row's mean)."""
    b, hq, hkv, sk, d = 2, 4, 2, 24, 16
    arrays = _draw(b, hq, hkv, sq, sk, d, seed=6)
    qpos = jnp.broadcast_to(jnp.arange(sq) + sk - sq, (b, sq))

    def blockwise(q, k, v):
        return r_attention._blockwise(q, k, v, qpos, jnp.arange(sk),
                                      causal=causal, window=None, chunk=None,
                                      scale=d ** -0.5, block=8)

    want = _reference_grads(blockwise, *arrays[:3], arrays[3], hq // hkv)
    got = _plain_grads(*_views(arrays), {"causal": causal})
    _within(got, want)


@pytest.mark.parametrize("kind", ["sliding", "chunked"])
def test_plain_backward_matches_reference_local_vjp(kind):
    """_local over 24 rows with window 8: sliding is the causal window
    of 8 keys; chunked attends causally within each 8-row chunk, which
    the port runs with the chunks folded into the batch."""
    b, hq, hkv, s, d, w = 2, 4, 2, 24, 16, 8
    arrays = _draw(b, hq, hkv, s, s, d, seed=7)
    qpos = jnp.broadcast_to(jnp.arange(s), (b, s))

    def local(q, k, v):
        return r_attention._local(q, k, v, qpos, kind=kind, window=w,
                                  scale=d ** -0.5)

    want = _reference_grads(local, *arrays[:3], arrays[3], hq // hkv)
    if kind == "sliding":
        got = _plain_grads(*_views(arrays), {"causal": True, "window": w})
    else:
        folded = [a.reshape(b * s // w, w, *a.shape[2:]) for a in arrays]
        got = [x.transpose(1, 2).reshape(b, s, -1, d).transpose(1, 2)
               for x in _plain_grads(*_views(folded), {"causal": True})]
    _within(got, want)


# --- the kernels' blocking, emulated ----------------------------------------

def _seen(qpos, kpos, causal, window):
    mask = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _unmasked(i0, rows, j0, keys, sq, sk, causal, window):
    """The kernels' test for a tile that takes no mask (csrc/flash_bwd.cu:
    rows i0 .. i0 + rows all below sq, keys j0 .. j0 + keys all below sk,
    and every such row sees every such key)."""
    p0, p1 = i0 + sk - sq, min(i0 + rows, sq) - 1 + sk - sq
    return not (i0 + rows > sq or j0 + keys > sk
                or (causal and j0 + keys - 1 > p0)
                or (window is not None and j0 <= p1 - window))


def _pair_grads(q, k, v, g, lse, delta, i0, j0, sq, sk, causal, window,
                scale, dtype, tile):
    """P (rounded to dtype) and dS (rounded to dtype) of query rows i0.. of
    q against keys j0.. of k, v, by the kernels' per-pair rule (grad_pair
    in csrc/flash_bwd.cu); where the kernels' tile (rows, keys) at i0, j0
    takes no mask, every pair of it must be seen."""
    qpos = torch.arange(i0, i0 + q.shape[-2])[:, None] + (sk - sq)
    kpos = torch.arange(j0, j0 + k.shape[-2])[None, :]
    seen = _seen(qpos, kpos, causal, window)
    dead = (qpos < 0) & causal
    if _unmasked(i0, tile[0], j0, tile[1], sq, sk, causal, window):
        assert bool(seen.all()) and not bool(dead.any())
    s = q @ k.transpose(-1, -2) * (scale * ref.LOG2E)
    p = torch.where(seen, torch.exp2(s - lse[..., None]), 0.0)
    p = torch.where(dead, 1.0 / sk, p)
    ds = torch.where(seen & ~dead, p * (g @ v.transpose(-1, -2) - delta[..., None]),
                     0.0)
    return p.to(dtype).float(), ds.to(dtype).float()


def _tiled_backward(q, k, v, o, lse, g, *, causal, window, dtype, skip=True):
    """The gradient kernels' blocking in plain PyTorch, f32 tensors holding
    values of `dtype`: dK and dV by blocks of the route's keys (DKDV_TILES)
    of each kv head, each walking the query tiles of every query head of
    its group in order, a tile skipped (with `skip`) only where every
    pair is masked and every row sees a key; dQ by blocks of query rows
    (DQ_TILES), each walking the key tiles that hold a key a row sees. A
    tile the kernels take without a mask is checked to need none.
    Every tile's products are f32 sums added to the block's f32
    accumulator; the gradients are rounded to `dtype` at the end."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group, off, scale = hq // hkv, sk - sq, d ** -0.5
    route = "f32" if dtype == torch.float32 else "half"
    dt = flash_attn.head_tile(d)
    keys, rows = flash_bwd.DKDV_TILES[route][dt]
    delta = (g * o).sum(dim=-1)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j0 in range(0, sk, keys):
        j1 = min(j0 + keys, sk)
        for h in range(hq):
            kvh = h // group
            for i0 in range(0, sq, rows):
                i1 = min(i0 + rows, sq)
                p0, p1 = i0 + off, i1 - 1 + off
                if skip and not (causal and p0 < 0) and (
                        (causal and j0 > p1)
                        or (window is not None and j1 - 1 <= p0 - window)):
                    continue
                p, ds = _pair_grads(q[:, h, i0:i1], k[:, kvh, j0:j1],
                                    v[:, kvh, j0:j1], g[:, h, i0:i1],
                                    lse[:, h, i0:i1], delta[:, h, i0:i1], i0,
                                    j0, sq, sk, causal, window, scale, dtype,
                                    (rows, keys))
                dv[:, kvh, j0:j1] += p.transpose(-1, -2) @ g[:, h, i0:i1]
                dk[:, kvh, j0:j1] += ds.transpose(-1, -2) @ q[:, h, i0:i1]
    rows, keys = flash_bwd.DQ_TILES[route][dt]
    dq = torch.zeros_like(q)
    for i0 in range(0, sq, rows):
        i1 = min(i0 + rows, sq)
        p0, p1 = i0 + off, i1 - 1 + off
        kt0, kt1 = 0, -(-sk // keys)
        if skip and causal:
            kt1 = 0 if p1 < 0 else min(kt1, p1 // keys + 1)
        if skip and window is not None and p0 - window + 1 > 0:
            kt0 = (p0 - window + 1) // keys
        for kt in range(kt0, kt1):
            j0, j1 = kt * keys, min(kt * keys + keys, sk)
            for h in range(hq):
                _, ds = _pair_grads(q[:, h, i0:i1], k[:, h // group, j0:j1],
                                    v[:, h // group, j0:j1], g[:, h, i0:i1],
                                    lse[:, h, i0:i1], delta[:, h, i0:i1], i0,
                                    j0, sq, sk, causal, window, scale, dtype,
                                    (rows, keys))
                dq[:, h, i0:i1] += ds @ k[:, h // group, j0:j1]
    return [(x * f).to(dtype).float() for x, f in ((dq, scale), (dk, scale),
                                                   (dv, 1.0))]


#: (B, Hq, Hkv, Sq, Sk, D, causal, window): several tiles on each side,
#: the last ragged; skipped tiles under causal and window masks; rows
#: that see no key (Sq > Sk); D = 80 and 256 (other tiles)
TILED_CASES = {
    "gqa causal": (1, 4, 2, 150, 150, 16, True, None),
    "window": (1, 2, 1, 200, 200, 16, True, 40),
    "non-causal": (1, 2, 2, 100, 130, 16, False, None),
    "sq < sk": (1, 4, 2, 70, 200, 16, True, None),
    "fully masked": (1, 2, 1, 150, 60, 16, True, None),
    "d80": (1, 2, 1, 90, 90, 80, True, None),
    "d256 window": (1, 2, 1, 100, 100, 256, True, 30),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_backward_changes_only_summation_order(case, dtype):
    """The kernels' blocking against their plain version on the same
    inputs and the plain forward's output and lse: only the order of f32
    sums differs (within 1e-6 of max|g| in f32; within GRAD's bf16 rule
    where a P or dS rounds the other way), and the skipped tiles add
    exactly nothing."""
    b, hq, hkv, sq, sk, d, causal, window = TILED_CASES[case]
    q, k, v, g = _views(_draw(b, hq, hkv, sq, sk, d, seed=8), dtype)
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_backward_ref(q, k, v, o, lse, g, causal=causal,
                                            window=window)
    wide = [x.float() for x in (q, k, v, o)]
    got = _tiled_backward(*wide, lse, g.float(), causal=causal, window=window,
                          dtype=dtype)
    _within(got, want, dtype, f32_tol=1e-6)
    every = _tiled_backward(*wide, lse, g.float(), causal=causal,
                            window=window, dtype=dtype, skip=False)
    assert all(torch.equal(a, c) for a, c in zip(got, every))
