"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. The file imports neither jax nor the reference package, so it
runs on a machine that has only PyTorch; there, without the JAX-side
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: CED bit for bit; the panel LU and the triangular solves within
1e-12 of max|plain| (the same arithmetic, another FMA contraction and
summation order); the Schur update within tol · (max|C| + K·max|A|·max|B|),
tol 1e-12 in f64, 1e-4 in f32 and 1e-2 in bf16/f16 (K products summed in
another order, and the narrow types round the stored output); flash
attention within 1e-5 · max|v| in f32, and in bf16/f16, with eps the
type's machine epsilon, every element within 2 eps |want| (two ulps of
the output's rounding) + eps/8 · max|v| (P's rounding: the kernel rounds
exp(s − m) against each key tile's running max, the plain version against
the row's final max) and the whole within ||err|| <= eps ||want||, so an
error in a large share of the outputs fails even where each is small
(both sides accumulate in f32; chip_smoke.py's bf16 prefill read max|err|
0.0039, one ulp of an output in [0.5, 1)).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lu_panel, ops, ref

RTOL = 1e-12
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _dominant(shape, seed):
    b = shape[-1]
    return _rand(shape, seed) + b * np.eye(b)


def _triangles(lead, n, seed):
    """Well-conditioned unit-lower and upper triangles, as LU gives them."""
    l = np.tril(_rand((*lead, n, n), seed), -1) / n + np.eye(n)
    u = np.triu(_rand((*lead, n, n), seed + 1)) + n * np.eye(n)
    return l, u


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol · max|want| elementwise."""
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-300)
    assert float((got - want).abs().max()) <= rtol * scale


@pytest.mark.parametrize("shape", [(4096, 4096), (16, 1024, 1024), (37, 37),
                                   (3, 33, 33)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ced_kernel_bit_equal_to_plain(cuda, shape, dtype):
    m = torch.from_numpy(_rand(shape, 0)).to(cuda, dtype)
    v = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 2.0, shape[:-1]))
    v = v.to(cuda, dtype)
    for k in range(4):
        for mode in ("ewd", "ewm"):
            for gs in (False, True):
                got = ops.ced(m, v, k, mode=mode, growth_safe=gs)
                want = ref.ced_ref(m, v, k, mode=mode, growth_safe=gs)
                assert torch.equal(got, want), (k, mode, gs)


def test_ced_kernel_counts_its_launches(cuda):
    m = torch.ones(8, 8, dtype=torch.float64, device=cuda)
    ops.reset_launches()
    ops.ced(m, torch.ones(8, dtype=torch.float64, device=cuda), 1)
    assert ops.LAUNCHES["ced"] == 1


def test_ced_kernel_refuses_non_contiguous(cuda):
    m = torch.ones(8, 8, dtype=torch.float64, device=cuda).t()[:, :4]
    with pytest.raises(ValueError):
        ops.ced(m, torch.ones(8, dtype=torch.float64, device=cuda), 1)


@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (48, 48), (63, 63),
                                   (64, 32, 32), (160, 160)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lu_panel_kernel_matches_plain(cuda, shape, dtype):
    a = torch.from_numpy(_dominant(shape, 1)).to(cuda, dtype)
    rtol = RTOL if dtype == torch.float64 else 1e-5
    _close(ops.lu_panel(a), ref.lu_panel_ref(a), rtol)


def test_lu_panel_kernel_reads_strided_views_and_keeps_input(cuda):
    a = torch.from_numpy(_dominant((3, 96, 96), 2)).to(cuda)
    before = a.clone()
    view = a[:, 32:64, 32:64]
    _close(ops.lu_panel(view), ref.lu_panel_ref(view))
    assert torch.equal(a, before)


def test_lu_panel_kernel_refuses_oversized_tile(cuda):
    b = lu_panel.max_tile(torch.float64) + 1
    with pytest.raises(ValueError):
        ops.lu_panel(torch.eye(b, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("n,m,batch", [(1024, 1024, None), (32, 992, None),
                                        (256, 256, 16), (45, 70, 3)])
def test_trsm_kernels_match_plain(cuda, n, m, batch):
    lead = () if batch is None else (batch,)
    l, u = (torch.from_numpy(t).to(cuda) for t in _triangles(lead, n, 1))
    b = torch.from_numpy(_rand((*lead, n, m), 3)).to(cuda)
    b2 = torch.from_numpy(_rand((*lead, m, n), 4)).to(cuda)
    _close(ops.trsm_lower(l, b), ref.trsm_lower_ref(l, b))
    _close(ops.trsm_upper_right(u, b2), ref.trsm_upper_right_ref(u, b2))


def test_trsm_kernels_take_strided_views(cuda):
    a = torch.from_numpy(_dominant((2, 64, 64), 9)).to(cuda)
    tri, strip, col = a[:, :32, :32], a[:, :32, 32:], a[:, 32:, :32]
    _close(ops.trsm_lower(tri, strip), ref.trsm_lower_ref(tri, strip))
    _close(ops.trsm_upper_right(tri, col), ref.trsm_upper_right_ref(tri, col))


def test_protocol_on_card_matches_cpu(cuda):
    """The whole path on the card against the plain path on the CPU."""
    import repro_torch

    m = _dominant((256, 256), 5)
    ops.reset_launches()
    got = repro_torch.outsource_determinant(m, 4)
    path = ("ced", "lu_panel", "trsm_lower", "trsm_upper_right")
    assert all(ops.LAUNCHES[name] > 0 for name in path), ops.LAUNCHES
    want = repro_torch.outsource_determinant(m, 4, device="cpu")
    assert got.verified and want.verified
    assert got.det.allclose(want.det)


#: f64/f32 on the scale max|C| + K·max|A|·max|B| of the K products both
#: sides sum in different orders; bf16/f16 on max|want|, because both
#: sides sum in f32 and differ by the stored output's rounding
SCHUR_TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 2e-2,
             torch.float16: 2e-2}


def _schur_close(got, want, c, a, b, dtype):
    if dtype in (torch.bfloat16, torch.float16):
        scale = float(want.double().abs().max())
    else:
        scale = (float(c.abs().max()) + a.shape[-1] * float(a.abs().max())
                 * float(b.abs().max()))
    err = float((got.double() - want.double()).abs().max())
    assert err <= SCHUR_TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("m,k,n,batch", [(1024, 1024, 1024, None),
                                          (256, 256, 256, 16),
                                          (77, 45, 13, 3), (1, 1, 1, None)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16, torch.float16])
def test_schur_kernel_matches_plain_and_library(cuda, m, k, n, batch, dtype):
    lead = () if batch is None else (batch,)
    c, a, b = (torch.from_numpy(_rand((*lead, *s), seed)).to(cuda, dtype)
               for s, seed in (((m, n), 1), ((m, k), 2), ((k, n), 3)))
    ops.reset_launches()
    got = ops.schur_update(c, a, b)
    assert ops.LAUNCHES["schur_update"] == 1
    _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, dtype)
    library = (torch.addmm(c, a, b, alpha=-1) if batch is None
               else torch.baddbmm(c, a, b, alpha=-1))
    _schur_close(got, library, c, a, b, dtype)


def test_schur_kernel_reads_strided_views_and_keeps_operands(cuda):
    x = torch.from_numpy(_rand((512, 512), 8)).to(cuda)
    before = x.clone()
    c, a, b = x[128:256, 256:512], x[128:256, :128], x[:128, 256:512]
    got = ops.schur_update(c, a, b)
    _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, torch.float64)
    at = x[:128, 128:256].t()  # a column-major operand
    _schur_close(ops.schur_update(c, at, b), ref.schur_update_ref(c, at, b),
                 c, at, b, torch.float64)
    assert torch.equal(x, before)


def test_lu_blocked_on_card_runs_the_schur_kernel(cuda):
    from repro_torch.core.lu import lu_blocked

    x = _dominant((256, 256), 6)
    ops.reset_launches()
    l, u = lu_blocked(torch.from_numpy(x).to(cuda), 64)
    # 9 + 4 + 1 trailing updates, and one inner update in each of the four
    # 64-wide diagonal tiles (two 32-wide panels each)
    assert ops.LAUNCHES["schur_update"] == 9 + 4 + 1 + 4
    l_cpu, u_cpu = lu_blocked(torch.from_numpy(x), 64)
    _close(l.cpu(), l_cpu, 1e-10)
    _close(u.cpu(), u_cpu, 1e-10)


def test_threadpool_session_on_card_bit_equal_to_inline(cuda):
    """Role split on the card: the thread pool's strips equal the fused
    sweep's bit for bit, and the session verifies."""
    from repro_torch.api import InlineTransport, SPDCClient, ThreadPoolTransport

    m = _dominant((512, 512), 7)
    session = SPDCClient().open_session(m, 4)
    with ThreadPoolTransport() as tp:
        l, u = session._assemble(tp.factor(session.tasks()))
        result = session.run(tp)
    l_inline, u_inline = InlineTransport().sweep(session.x_aug, 4)
    assert torch.equal(l, l_inline) and torch.equal(u, u_inline)
    assert result.verified


#: flash attention in f32: tolerance on max|v| (see the module docstring;
#: bf16/f16 are held to their machine epsilon there)
FLASH_TOL = {torch.float32: 1e-5}


def _qkv(cuda, b, hq, hkv, sq, sk, d, dtype, seed=0, layout="bhsd"):
    """q (b, hq, sq, d), k and v (b, hkv, sk, d); with layout "bshd" each
    is the (B, H, S, D) view of a (B, S, H, D) tensor, as the model
    passes its projections."""
    rng = np.random.default_rng(seed)

    def draw(h, s):
        if layout == "bshd":
            x = torch.from_numpy(rng.standard_normal((b, s, h, d)))
            return x.to(cuda, dtype).transpose(1, 2)
        return torch.from_numpy(rng.standard_normal((b, h, s, d))).to(cuda, dtype)

    return draw(hq, sq), draw(hkv, sk), draw(hkv, sk)


def _flash_close(q, k, v, **kw):
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == q.dtype
    err = (got.float() - want.float()).abs()
    max_v = float(v.float().abs().max())
    if q.dtype == torch.float32:
        assert float(err.max()) <= FLASH_TOL[q.dtype] * max_v, float(err.max())
        return got
    eps = torch.finfo(q.dtype).eps
    bound = 2 * eps * want.float().abs() + eps / 8 * max_v
    assert bool((err <= bound).all()), float((err / bound).max())
    rel = float(err.norm() / want.float().norm())
    assert rel <= eps, rel
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", [
    (2, 8, 2, 300, 300, 64, True, None),
    (1, 4, 4, 128, 128, 64, False, None),
    (1, 4, 1, 200, 200, 128, True, 40),
    (2, 2, 2, 50, 77, 80, True, None),
    (1, 2, 1, 77, 50, 16, True, None),
    (1, 2, 2, 65, 65, 256, False, 24),
    (2, 32, 4, 1, 333, 64, True, None),
    (1, 4, 2, 9, 100, 8, True, 8),
], ids=["gqa-causal", "non-causal", "window", "ragged", "fully-masked",
        "d256-window", "decode", "d8-short"])
def test_flash_kernel_matches_plain(cuda, dtype, b, hq, hkv, sq, sk, d,
                                    causal, window):
    q, k, v = _qkv(cuda, b, hq, hkv, sq, sk, d, dtype, seed=sq + d)
    _flash_close(q, k, v, causal=causal, window=window)


def test_flash_kernel_fully_masked_rows_are_mean_of_v(cuda):
    """Causal with Sq > Sk: the first Sq − Sk rows see no key, and the
    Pallas kernel gives them the mean of V."""
    q, k, v = _qkv(cuda, 1, 2, 1, 8, 4, 16, torch.float32, seed=4)
    got = _flash_close(q, k, v, causal=True)
    mean = v.float().mean(dim=2, keepdim=True).expand(1, 2, 4, 16)
    assert torch.allclose(got[:, :, :4], mean, atol=1e-6)


def test_flash_kernel_takes_model_views_and_cache_prefix(cuda):
    """(B, S, H, D) projections as (B, H, S, D) views, and decode over a
    prefix of a (B, L, Hkv, D) cache, with no copy; the operands stay."""
    q, k, v = _qkv(cuda, 2, 8, 2, 96, 96, 64, torch.bfloat16, layout="bshd")
    before = [t.clone() for t in (q, k, v)]
    out = _flash_close(q, k, v, causal=True)
    assert out.transpose(1, 2).is_contiguous()  # laid out as q is
    assert all(torch.equal(a, t) for a, t in zip(before, (q, k, v)))
    cache = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, 2, 64))).to(cuda, torch.bfloat16)
    qd = q[:, :, :1]
    _flash_close(qd, cache[:, :70].transpose(1, 2),
                 cache[:, :70].transpose(1, 2).flip(-1).contiguous(),
                 causal=True)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 1, 8, 8, 16, torch.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.transpose(2, 3), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), v)


def test_serve_path_on_card_matches_cpu(cuda):
    """Prefill and greedy generation of the smoke tinyllama on the card,
    against the plain path on the CPU with the same weights, in f32."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.steps import build_prefill_step, greedy_generate

    cfg = smoke_config("tinyllama-1.1b")
    model = init_lm(cfg, 0, device=cuda)
    cpu_model = init_lm(cfg, 0, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    ops.reset_launches()
    got = build_prefill_step(cfg)(model, {"tokens": toks.to(cuda)})
    assert ops.LAUNCHES["flash_attention"] == cfg.num_layers
    want = build_prefill_step(cfg)(cpu_model, {"tokens": toks})
    got, want = got.cpu()[:, :cfg.vocab_size], want[:, :cfg.vocab_size]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    out = greedy_generate(cfg, model, toks[:, :8].to(cuda), 8)
    assert torch.equal(out.cpu(), greedy_generate(cfg, cpu_model, toks[:, :8], 8))
