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
0.0039, one ulp of an output in [0.5, 1)). The mixed acc_dtype routes
within 4 storage ulps of max|plain|: both round once to the storage type
from wide values that differ in summation order only. The narrow
bfloat16/float16 routes of the panel and the solves bit for bit: both
round every operation to the half type, in the same order.
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
    return _flash_within(got, want, v)


def _flash_within(got, want, v):
    """got against the plain version's want by the module docstring's
    rule for v's dtype; returns got."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    max_v = float(v.float().abs().max())
    if v.dtype == torch.float32:
        assert float(err.max()) <= FLASH_TOL[v.dtype] * max_v, float(err.max())
        return got
    eps = torch.finfo(v.dtype).eps
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
    (2, 8, 2, 17, 17, 64, True, None),
    (1, 4, 1, 300, 2048, 64, True, None),
    (1, 4, 2, 40, 100, 8, True, None),
], ids=["gqa-causal", "non-causal", "window", "ragged", "fully-masked",
        "d256-window", "decode", "d8-short", "sq17", "chunk-over-prefix",
        "d8-prefill"])
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


# --- the tensor-core flash kernel's decode path and the blocked TRSM ------

def _bf16_close_to_mean(got, v, rows, group):
    """The first `rows` query rows against the mean of V over its keys,
    per query head's kv head, within bf16's rounding of the output."""
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(group, dim=1)
    err = (got[:, :, :rows].float() - mean).abs()
    eps = torch.finfo(got.dtype).eps
    assert bool((err <= 2 * eps * mean.abs() + eps / 8
                 * float(v.float().abs().max())).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk", [
    (4, 32, 4, 1, 2048),
    (2, 8, 8, 1, 500),
    (2, 16, 2, 16, 700),
], ids=["group8-full-width", "group1", "group8-16-rows"])
def test_flash_decode_packs_gqa_groups(cuda, dtype, b, hq, hkv, sq, sk):
    """Split keys: one launch in bf16/f16 (the chunks' cluster merges
    them), two in f32 (the chunks, then the merge)."""
    from repro_torch.kernels import flash_attn

    q, k, v = _qkv(cuda, b, hq, hkv, sq, sk, 64, dtype, seed=sk,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)
    assert flash_attn.cuda_launches(q, k) == (2 if dtype == torch.float32
                                              else 1)


#: bf16/f16 decodes of flash_decode_kernel's edges: 64 chunks, eight a
#: block of the 8-block cluster (Sk 8192); one chunk (no cluster, no
#: merge); ragged last chunks whose warps 1-3 or 2-3 hold no key; gemma3's
#: ring, (4, 4, 1, 256) over 1024 slots; nemotron's D = 192 with a group
#: of 12; tinyllama's 16-token prompt, 128 packed rows in 8 row blocks,
#: alone and over a 700-key cache
DECODE_EDGES = {
    "sk8192": ((4, 32, 4, 1, 8192, 64), {"causal": True}),
    "one-chunk": ((2, 32, 4, 1, 100, 64), {"causal": True}),
    "ragged-one-warp": ((2, 8, 2, 1, 3 * 128 + 20, 64), {"causal": True}),
    "ragged-two-warps": ((2, 8, 2, 1, 128 + 40, 128), {"causal": True}),
    "gemma3-ring": ((4, 4, 1, 1, 1024, 256), {"causal": True}),
    "nemotron-d192": ((2, 24, 2, 1, 700, 192), {"causal": True}),
    "prompt-16": ((4, 32, 4, 16, 16, 64), {"causal": True}),
    "rows-128-split": ((4, 32, 4, 16, 700, 64), {"causal": True}),
}


@pytest.mark.parametrize("case", sorted(DECODE_EDGES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_decode_edges_run_one_decode_kernel(cuda, case, dtype):
    """Each edge within the flash tolerance of the plain version, and one
    device kernel a call, named as device_kernel says (the decode kernel,
    never flash_tc_kernel's two launches)."""
    from repro_torch.kernels import flash_attn

    shape, kw = DECODE_EDGES[case]
    q, k, v = _qkv(cuda, *shape, dtype, seed=len(case), layout="bshd")
    _flash_close(q, k, v, **kw)
    call = lambda: ops.flash_attention(q, k, v, **kw)
    assert flash_attn.cuda_launches(q, k) == 1
    assert _profiled_launches(call) == 1
    names = _profiled_kernel_names(call)
    flash = [n for n in names if "flash" in n]
    assert flash and all(flash_attn.device_kernel(q) in n for n in flash), names
    assert not any("flash_tc_kernel" in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sk", [333, 40, 64, 65], ids=[
    "ragged-chunks", "under-one-chunk", "one-tile", "one-tile-and-one-key"])
def test_flash_decode_ragged_key_chunks(cuda, sk, dtype):
    q, k, v = _qkv(cuda, 2, 8, 2, 1, sk, 64, dtype, seed=sk)
    _flash_close(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_split_fully_masked_rows_are_mean_of_v(cuda, monkeypatch,
                                                            dtype):
    """Sq 8 > Sk 5: the first three rows see no key. Forced into chunks
    of 2 keys, every chunk of such a row has m = -1e30, so the merge
    weighs the chunks by their l and returns the mean over all 5 keys."""
    from repro_torch.kernels import flash_attn

    monkeypatch.setattr(flash_attn, "decode_split", lambda *a: (2, 3))
    q, k, v = _qkv(cuda, 1, 4, 2, 8, 5, 16, dtype, seed=11)
    got = _flash_close(q, k, v, causal=True)
    if dtype == torch.float32:
        mean = v.mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
        assert torch.allclose(got[:, :, :3], mean.expand(1, 4, 3, 16), atol=1e-6)
    else:
        _bf16_close_to_mean(got, v, 3, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,window", [(1, 40), (4, 8), (16, 100)])
def test_flash_decode_window_inside_one_chunk(cuda, sq, window, dtype):
    """The window covers keys of the last chunk only: every earlier chunk
    visits no tile and must weigh nothing in the merge."""
    q, k, v = _qkv(cuda, 2, 8, 2, sq, 2048, 64, dtype, seed=sq)
    _flash_close(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_prefill_bf16_head_dims(cuda, d):
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 300, d, torch.bfloat16, seed=d,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (False, None)],
                         ids=["causal", "window", "non-causal"])
def test_flash_f32_prefill_head_dims(cuda, d, causal, window):
    """The f32 FMA kernel's three tile configurations (128 query rows a
    block at D = 64, 64 at 128 and 256 with 32-key tiles), on the model's
    strided (B, S, H, D) views, with a row count that leaves a ragged
    last block and a window that skips whole key tiles."""
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 300, d, torch.float32, seed=d,
                   layout="bshd")
    _flash_close(q, k, v, causal=causal, window=window)


def test_flash_f32_full_width_within_tolerance(cuda):
    """f32 stays exact f32 (no TF32): the serving shapes within
    1e-5 · max|v|."""
    q, k, v = _qkv(cuda, 4, 32, 4, 2048, 2048, 64, torch.float32, seed=3,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)
    _flash_close(q[:, :, -1:], k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_decode_same_bits_run_to_run(cuda, dtype):
    """The chunks merge in a fixed order: two calls give the same bits."""
    q, k, v = _qkv(cuda, 4, 32, 4, 1, 2048, 64, dtype, seed=9,
                   layout="bshd")
    first = ops.flash_attention(q, k, v, causal=True)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(q, k, v, causal=True), first)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_decode_rows_same_bits_at_any_batch(cuda, dtype):
    """The key chunks depend on Sk alone: a batch element's decode rows
    have the same bits alone as in a batch of four."""
    q, k, v = _qkv(cuda, 4, 32, 4, 1, 2048, 64, dtype, seed=10,
                   layout="bshd")
    whole = ops.flash_attention(q, k, v, causal=True)
    for i in (0, 3):
        one = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)
        assert torch.equal(one, whole[i:i + 1])


def _profiled_launches(fn, reps=4):
    """Device events (kernels and copies) one call of fn puts on the
    card, counted by torch.profiler over `reps` calls. Started cold, the
    profiler misses a window's first launches, so the window opens with
    64 one-element fills and a pause, and only the events whose launch
    (the CUDA runtime or driver call of the same correlation id) the host
    made after the timed range opened, less half the pause, count: host
    times on both sides, so the card's clock, whose offset from the
    host's jumps by milliseconds between windows, moves no event out (as
    chip_smoke.py's device_events). A window that lost the device event
    of a launch it recorded is profiled again, up to three windows."""
    import re
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    cuda_type = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        pad = torch.empty(1, device="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(0.01)
            with record_function("timed"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        host = [e for e in prof.events() if e.device_type != cuda_type]
        opened = min(e.time_range.start for e in host if e.name == "timed")
        launched = {e.id for e in host
                    if re.match(r"cu(da)?(Launch|Memcpy|Memset)", e.name)
                    and e.time_range.start >= opened - 5000}
        events = [e for e in prof.events() if e.device_type == cuda_type
                  and e.name != "timed" and e.id in launched]
        if events and len({e.id for e in events}) == len(launched):
            break
    assert len(events) % reps == 0, len(events)
    return len(events) // reps


@pytest.mark.parametrize("case", ["trsm-strip", "trsm-1024", "trsm-ragged",
                                  "flash-prefill", "flash-decode-split",
                                  "flash-decode-one-chunk", "flash-f32-decode",
                                  "flash-f32-prefill"])
def test_launch_formulas_match_profiled_kernels(cuda, case):
    """trsm.cuda_launches and flash_attn.cuda_launches, which the
    wrappers' docstrings state, against the launches the profiler
    counts."""
    from repro_torch.kernels import flash_attn, trsm

    if case.startswith("trsm"):
        n, m = {"trsm-strip": (32, 992), "trsm-1024": (1024, 1024),
                "trsm-ragged": (130, 50)}[case]
        l, u = (torch.from_numpy(t).to(cuda) for t in _triangles((), n, 4))
        b = torch.from_numpy(_rand((n, m), 5)).to(cuda)
        assert _profiled_launches(lambda: ops.trsm_lower(l, b)) == trsm.cuda_launches(n)
        assert (_profiled_launches(lambda: ops.trsm_upper_right(u, b.t()))
                == trsm.cuda_launches(n))
        return
    sq, sk, dtype = {"flash-prefill": (300, 300, torch.bfloat16),
                     "flash-decode-split": (1, 2048, torch.bfloat16),
                     "flash-decode-one-chunk": (4, 100, torch.bfloat16),
                     "flash-f32-decode": (1, 2048, torch.float32),
                     "flash-f32-prefill": (300, 300, torch.float32)}[case]
    q, k, v = _qkv(cuda, 2, 8, 2, sq, sk, 64, dtype, seed=sk)
    got = _profiled_launches(lambda: ops.flash_attention(q, k, v, causal=True))
    assert got == flash_attn.cuda_launches(q, k)


# --- the split decode's halves over key ranges (decode under a mesh) -----

#: cuts of a 2048-key decode into ranges laid end to end, as a mesh's
#: model ranks hold the cache's slots: two and four ranges on multiples
#: of the 128-key chunk, two ragged ones, and three of which the last
#: holds no key
RANGE_CUTS = {"aligned-2": (0, 1024, 2048),
              "aligned-4": (0, 512, 1024, 1536, 2048),
              "ragged": (0, 700, 2048), "empty": (0, 1024, 2048, 2048)}


def _range_partials(partial, q, k, v, cuts):
    """`partial` (the wrapper or its plain version) over each range of
    `cuts`, every range given as many 128-key chunks as the widest
    needs, laid end to end along the chunks."""
    chunks = max(-(-(b - a) // 128) for a, b in zip(cuts, cuts[1:]))
    return torch.cat([partial(q, k[:, :, a:b], v[:, :, a:b], chunks=chunks)
                      for a, b in zip(cuts, cuts[1:])])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("cuts", sorted(RANGE_CUTS))
def test_decode_partial_and_combine_match_plain(cuda, dtype, cuts):
    """The partial kernel over each range and the merge kernel over their
    chunks, at tinyllama's decode shape, against the plain versions and
    the plain whole decode; on ranges that start on multiples of the
    chunk, bit-equal to the kernel's own unsplit decode (the same
    chunks, merged in the same order). One launch a range with keys and
    one for the merge."""
    bounds = RANGE_CUTS[cuts]
    q, k, v = _qkv(cuda, 4, 32, 4, 1, 2048, 64, dtype, seed=len(bounds),
                   layout="bshd")
    ops.reset_launches()
    got = ops.flash_combine(
        _range_partials(ops.flash_decode_partial, q, k, v, bounds), dtype)
    with_keys = sum(b > a for a, b in zip(bounds, bounds[1:]))
    assert ops.LAUNCHES["flash_decode_partial"] == with_keys
    assert ops.LAUNCHES["flash_combine"] == 1
    plain = ref.flash_combine_ref(
        _range_partials(ref.flash_decode_partial_ref, q, k, v, bounds), dtype)
    _flash_within(got, plain, v)
    _flash_within(got, ref.flash_attention_ref(q, k, v, causal=True), v)
    if all(a % 128 == 0 for a in bounds):
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_decode_partial_of_an_empty_range(cuda, dtype):
    """A range with no key launches no kernel and gives the empty
    partial (acc = l = 0, m = −1e30); merged beside a range with keys it
    changes no bit; a partial's chunks past its keys are the same."""
    q, k, v = _qkv(cuda, 2, 8, 2, 1, 300, 64, dtype, seed=3)
    ops.reset_launches()
    empty = ops.flash_decode_partial(q, k[:, :, :0], v[:, :, :0], chunks=3)
    assert ops.LAUNCHES["flash_decode_partial"] == 0
    assert (empty[..., :64] == 0).all() and (empty[..., 65] == 0).all()
    assert (empty[..., 64] == -1e30).all()
    full = ops.flash_decode_partial(q, k, v)
    padded = ops.flash_decode_partial(q, k, v, chunks=6)
    assert torch.equal(padded[:3], full) and torch.equal(padded[3:], empty)
    want = ops.flash_combine(full, dtype)
    assert torch.equal(want, ops.flash_attention(q, k, v, causal=True))
    for parts in ((full, empty), (empty, full), (padded,)):
        assert torch.equal(ops.flash_combine(torch.cat(parts), dtype), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_decode_halves_launch_one_kernel_each(cuda, dtype):
    """The profiler sees one device kernel a partial (keys present) and
    one a merge."""
    q, k, v = _qkv(cuda, 2, 8, 2, 1, 2048, 64, dtype, seed=9)
    part = ops.flash_decode_partial(q, k, v)
    assert _profiled_launches(lambda: ops.flash_decode_partial(q, k, v)) == 1
    assert _profiled_launches(lambda: ops.flash_combine(part, dtype)) == 1


def test_decode_partial_entry_refuses_more_than_one_row(cuda):
    """The C partial entry itself refuses two query rows (and no key)
    with cudaErrorInvalidValue, before any launch."""
    from repro_torch.kernels import build, flash_attn

    q, k, v = _qkv(cuda, 1, 8, 2, 2, 256, 64, torch.bfloat16, seed=5)
    part = torch.empty(2 * 8 * 2 * 66, dtype=torch.float32, device=cuda)
    lib = build.library("flash_attn", flash_attn._SIGNATURES)
    for sq, sk in ((2, 256), (1, 0)):
        code = lib.flash_bf16_partial(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], 1, 8, 2, sq, sk, 64, 0.125,
            part.data_ptr(), 2, 1, torch.cuda.current_stream().cuda_stream)
        assert code == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("n,m", [(256, 300), (1024, 1024), (100, 77)])
def test_trsm_columns_bit_equal_across_splits_and_strides(cuda, n, m):
    """Each column's (each row's, for Z = B·U⁻¹) arithmetic depends on
    neither m, nor its offset, nor the strides: one call equals the
    concatenation of calls over column blocks, and a column-major copy."""
    l, u = (torch.from_numpy(t).to(cuda) for t in _triangles((), n, 2))
    b = torch.from_numpy(_rand((n, m), 5)).to(cuda)
    cuts = [0, 1, m // 3, m // 3 + 64, m]
    whole = ops.trsm_lower(l, b)
    parts = [ops.trsm_lower(l, b[:, c0:c1]) for c0, c1 in zip(cuts, cuts[1:])]
    assert torch.equal(whole, torch.cat(parts, dim=1))
    assert torch.equal(whole, ops.trsm_lower(l.t().contiguous().t(),
                                             b.t().contiguous().t()))
    bt = b.t().contiguous()  # (m, n) for the right solve
    whole = ops.trsm_upper_right(u, bt)
    parts = [ops.trsm_upper_right(u, bt[c0:c1]) for c0, c1 in zip(cuts, cuts[1:])]
    assert torch.equal(whole, torch.cat(parts, dim=0))
    assert torch.equal(whole, ops.trsm_upper_right(u.t().contiguous().t(),
                                                   b.t()))
    wide = torch.from_numpy(_rand((n + 7, 2 * m), 6)).to(cuda)[3:n + 3, 1::2]
    assert torch.equal(ops.trsm_lower(l, wide),
                       ops.trsm_lower(l, wide.contiguous()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,m,batch", [(100, 50, None), (200, 130, 3),
                                        (65, 64, 2), (129, 1, 4)])
def test_trsm_ragged_leaves_and_batches(cuda, n, m, batch, dtype):
    """n not a multiple of the leaf's rows, and stacks of several
    matrices; f32 products run on the FMA pipes, in f32."""
    lead = () if batch is None else (batch,)
    l, u = (torch.from_numpy(t).to(cuda, dtype) for t in _triangles(lead, n, 7))
    b = torch.from_numpy(_rand((*lead, n, m), 8)).to(cuda, dtype)
    b2 = torch.from_numpy(_rand((*lead, m, n), 9)).to(cuda, dtype)
    rtol = RTOL if dtype == torch.float64 else 1e-5
    _close(ops.trsm_lower(l, b), ref.trsm_lower_ref(l, b), rtol)
    _close(ops.trsm_upper_right(u, b2), ref.trsm_upper_right_ref(u, b2), rtol)
    if batch:
        one = ops.trsm_lower(l[1], b[1])
        assert torch.equal(ops.trsm_lower(l, b)[1], one)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [63, 64, 65, 127, 128, 129, 1000, 1025])
def test_trsm_recursion_edges_match_plain(cuda, n, dtype):
    """The recursive solve around its leaves and splits: the edges of the
    64- and 128-row leaf kernels (63, 64, 65), one leaf short of and past
    a split (127, 128, 129, the last ending on a one-row leaf), three and
    four levels of products (1000, 1025); B3 and B4 against their plain
    versions."""
    m = 150
    l, u = (torch.from_numpy(t).to(cuda, dtype) for t in _triangles((), n, 31))
    b = torch.from_numpy(_rand((n, m), 32)).to(cuda, dtype)
    b2 = torch.from_numpy(_rand((m, n), 33)).to(cuda, dtype)
    rtol = RTOL if dtype == torch.float64 else 1e-5
    _close(ops.trsm_lower(l, b), ref.trsm_lower_ref(l, b), rtol)
    _close(ops.trsm_upper_right(u, b2), ref.trsm_upper_right_ref(u, b2), rtol)


def test_trsm_block_row_solve_bit_equal_to_its_column_blocks(cuda):
    """The pipeline's block-row solve, L 1024² against a (1024, 4096) row:
    one call equals four (1024, 1024) calls over its column blocks, bit for
    bit, and its plain version within RTOL."""
    l, _ = (torch.from_numpy(t).to(cuda) for t in _triangles((), 1024, 34))
    row = torch.from_numpy(_rand((1024, 4096), 35)).to(cuda)
    whole = ops.trsm_lower(l, row)
    parts = [ops.trsm_lower(l, row[:, c:c + 1024]) for c in range(0, 4096, 1024)]
    assert torch.equal(whole, torch.cat(parts, dim=1))
    _close(whole, ref.trsm_lower_ref(l, row))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trsm_batch_of_three_bit_equal_to_each_alone(cuda, dtype):
    """A stack of three on grid z: each matrix's solve is the one it gets
    alone, bit for bit, at a ragged n five levels deep."""
    n, m = 1025, 130
    l, u = (torch.from_numpy(t).to(cuda, dtype) for t in _triangles((3,), n, 36))
    b = torch.from_numpy(_rand((3, n, m), 37)).to(cuda, dtype)
    b2 = torch.from_numpy(_rand((3, m, n), 38)).to(cuda, dtype)
    lower, upper = ops.trsm_lower(l, b), ops.trsm_upper_right(u, b2)
    for i in range(3):
        assert torch.equal(lower[i], ops.trsm_lower(l[i], b[i]))
        assert torch.equal(upper[i], ops.trsm_upper_right(u[i], b2[i]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,d", [(40, 64), (300, 80), (300, 256)])
def test_flash_kernel_rows_off_16_bytes(cuda, dtype, sq, d):
    """Operands whose rows do not start on 16 bytes (an odd element
    offset and odd strides) copy element by element (the bf16 prefill's
    producer threads into the TMA route's tiles; the decode's and f32's
    copies element by element or 4 bytes at a time) instead of 16 bytes
    at a time, with the same result: prefills over three 128-row blocks at
    D = 80 and 256 as well as one short block, and a decode."""
    rng = np.random.default_rng(12)

    def odd(b, h, s, d):
        flat = torch.from_numpy(rng.standard_normal(b * h * s * (d + 1) + 1))
        flat = flat.to(cuda, dtype)
        return flat[1:].view(b, h, s, d + 1)[..., :d]

    q, k, v = odd(2, 8, sq, d), odd(2, 2, sq + 50, d), odd(2, 2, sq + 50, d)
    _flash_close(q, k, v, causal=True)
    _flash_close(q[:, :, :1], k, v, causal=True)


# --- the bf16/f16 prefill kernel (flash_wgmma_kernel) ---------------------

#: the prefill routes of the model families, at small sizes: causal GQA
#: (tinyllama), the window at D = 256 (gemma3), the chunk fold at D = 128
#: (llama4, chunks as the batch) and non-causal at D = 80 (hubert)
PREFILL_ROUTES = {
    "causal": ((2, 8, 2, 300, 300, 64), {"causal": True}),
    "window": ((2, 4, 1, 600, 600, 256), {"causal": True, "window": 256}),
    "chunk-fold": ((2, 5, 1, 512, 512, 128), {"causal": True}),
    "non-causal": ((2, 4, 4, 300, 300, 80), {"causal": False}),
}


def _profiled_kernel_names(fn) -> set:
    """Names of the device kernels two calls of fn put on the card, by
    torch.profiler, after 64 one-element fills that the profiler's cold
    start may miss instead of fn's launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.fill_(0.0)
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    return {e.name for e in prof.events() if e.device_type == cuda_type}


@pytest.mark.parametrize("route", sorted(PREFILL_ROUTES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_prefill_routes_run_the_wgmma_kernel(cuda, route, dtype):
    """Every bf16/f16 prefill route is one launch of flash_wgmma_kernel,
    within the flash tolerance of the plain version; the decode kernel
    (flash_decode_kernel) never runs a prefill."""
    from repro_torch.kernels import flash_attn

    shape, kw = PREFILL_ROUTES[route]
    q, k, v = _qkv(cuda, *shape, dtype, seed=len(route), layout="bshd")
    _flash_close(q, k, v, **kw)
    call = lambda: ops.flash_attention(q, k, v, **kw)
    assert _profiled_launches(call) == 1
    names = _profiled_kernel_names(call)
    assert any(flash_attn.device_kernel(q) in n for n in names), names
    assert not any("flash_decode_kernel" in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_flash_prefill_tma_and_copy_routes_bit_equal(cuda, dtype, d):
    """Aligned operands go in by TMA; the same values one element off
    alignment are copied by the kernel's producer threads into the same
    swizzled tiles, and give the same bits."""
    from repro_torch.kernels import flash_attn

    q, k, v = _qkv(cuda, 2, 4, 2, 300, 333, d, dtype, seed=d)
    assert flash_attn.tma_operands(q, k, v) == (True, True, True)
    odd = [torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
           .view(t.shape).copy_(t) for t in (q, k, v)]
    assert flash_attn.tma_operands(*odd) == (False, False, False)
    for kw in ({"causal": True}, {"causal": False}, {"window": 100}):
        got = _flash_close(q, k, v, **kw)
        assert torch.equal(got, ops.flash_attention(*odd, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 64, 80, 192, 256])
def test_flash_decode_tma_and_copy_routes_bit_equal(cuda, dtype, d):
    """The decode kernel loads aligned K and V by TMA; the same values
    one element off alignment its producer's lanes copy into the same
    swizzled rows, with the same bits: the decode over 333 keys (a ragged
    last chunk), its 16-row form and the partial."""
    from repro_torch.kernels import flash_attn

    q, k, v = _qkv(cuda, 2, 8, 2, 16, 333, d, dtype, seed=d)
    assert flash_attn.tma_operands(q, k, v) == (True, True, True)
    odd = [torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
           .view(t.shape).copy_(t) for t in (q, k, v)]
    assert flash_attn.tma_operands(*odd) == (False, False, False)
    for rows in (1, 16):
        got = _flash_close(q[:, :, :rows], k, v, causal=True)
        assert torch.equal(got, ops.flash_attention(odd[0][:, :, :rows],
                                                    *odd[1:], causal=True))
    assert torch.equal(ops.flash_decode_partial(q[:, :, :1], k, v),
                       ops.flash_decode_partial(odd[0][:, :, :1], *odd[1:]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_prefill_same_bits_run_to_run(cuda, dtype):
    """No split keys and no atomics: a prefill's bits are the same on
    every call."""
    q, k, v = _qkv(cuda, 4, 32, 4, 2048, 2048, 64, dtype, seed=13,
                   layout="bshd")
    first = ops.flash_attention(q, k, v, causal=True)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(q, k, v, causal=True), first)


# --------------------------------------- the panel kernels' two routes
@pytest.mark.parametrize("b", [1, 2, 31, 32, 33, 48, 160])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lu_panel_kernel_both_routes(cuda, b, dtype):
    """One warp a tile up to 32 wide, one block a tile above."""
    a = torch.from_numpy(_dominant((3, b, b), b)).to(cuda, dtype)
    rtol = RTOL if dtype == torch.float64 else 1e-5
    _close(ops.lu_panel(a), ref.lu_panel_ref(a), rtol)
    _close(ops.lu_panel(a[1]), ref.lu_panel_ref(a[1]), rtol)


def test_lu_panel_warp_route_reads_views_and_keeps_input(cuda):
    """Strided, transposed and odd-offset views of warp-route tiles."""
    a = torch.from_numpy(_dominant((3, 96, 96), 12)).to(cuda)
    before = a.clone()
    for view in (a[:, 32:64, 32:64], a[:, 32:64, 32:64].transpose(-1, -2),
                 a[1, 5:36, 5:36]):
        _close(ops.lu_panel(view), ref.lu_panel_ref(view))
        assert torch.equal(ops.lu_panel(view), ops.lu_panel(view.contiguous()))
    assert torch.equal(a, before)


@pytest.mark.parametrize("batch", [3, 64])
def test_lu_panel_tile_bits_same_alone_and_in_stack(cuda, batch):
    """A 32 x 32 tile's arithmetic depends on b and the dtype alone, not on
    the batch or the tile's place in it."""
    stack = torch.from_numpy(_dominant((batch, 32, 32), batch)).to(cuda)
    whole = ops.lu_panel(stack)
    for i in sorted({0, 1, batch // 2, batch - 1}):
        assert torch.equal(whole[i], ops.lu_panel(stack[i]))
        assert torch.equal(whole[i], ops.lu_panel(stack[i:i + 1])[0])


# ------------------------- Schur on the DMMA, wgmma and FMA device kernels
SCHUR_DTYPES = [torch.float64, torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("m,k,n,batch", [(130, 1, 70, None), (130, 1, 70, 2),
                                          (129, 3, 65, None),
                                          (129, 65, 17, None), (129, 65, 17, 2),
                                          (127, 200, 63, None),
                                          (127, 200, 63, 2),
                                          (200, 45, 131, None), (257, 45, 1, 2),
                                          (5, 100, 300, 3)])
@pytest.mark.parametrize("dtype", SCHUR_DTYPES)
def test_schur_kernel_ragged_shapes(cuda, m, k, n, batch, dtype):
    """M, N and K off every tile and K slice of the three kernels (128 x 64
    tiles; slices of 32 or 64), K = 1 and 3 among them, batched and not."""
    lead = () if batch is None else (batch,)
    c, a, b = (torch.from_numpy(_rand((*lead, *s), seed)).to(cuda, dtype)
               for s, seed in (((m, n), 4), ((m, k), 5), ((k, n), 6)))
    _schur_close(ops.schur_update(c, a, b), ref.schur_update_ref(c, a, b),
                 c, a, b, dtype)


@pytest.mark.parametrize("dtype", SCHUR_DTYPES)
def test_schur_views_at_odd_offsets(cuda, dtype):
    """Operands at odd element offsets and odd row strides."""
    flat = torch.from_numpy(_rand(3 * 300 * 301 + 1, 10)).to(cuda, dtype)
    x = flat[1:].view(3, 300, 301)
    c, a, b = x[0, 1:200, 3:150], x[1, 7:206, 5:50], x[2, 11:56, 1:148]
    before = flat.clone()
    got = ops.schur_update(c, a, b)
    _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, dtype)
    assert torch.equal(got, ops.schur_update(c.contiguous(), a.contiguous(),
                                             b.contiguous()))
    assert torch.equal(flat, before)


@pytest.mark.parametrize("dtype", SCHUR_DTYPES)
@pytest.mark.parametrize("which", ["a", "b", "c", "all"])
def test_schur_column_major_operands(cuda, which, dtype):
    """Column-major operands stage along their unit-stride axis into the
    same shared-memory tiles, so the result is bit-equal to row-major
    (in 2-byte types B's rows, 400 bytes, load by TMA, its transpose by
    the block's threads)."""
    m, k, n = 300, 70, 200
    rows = {name: torch.from_numpy(_rand(shape, seed)).to(cuda, dtype)
            for name, shape, seed in (("c", (m, n), 1), ("a", (m, k), 2),
                                      ("b", (k, n), 3))}
    cols = {name: t.t().contiguous().t() if which in (name, "all") else t
            for name, t in rows.items()}
    c, a, b = rows.values()
    got = ops.schur_update(cols["c"], cols["a"], cols["b"])
    _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, dtype)
    assert torch.equal(got, ops.schur_update(c, a, b))


def test_schur_f64_inner_update_shape(cuda):
    """lu_blocked's inner update: K = 32, views of a 1024² diagonal tile."""
    tile = torch.from_numpy(_dominant((1024, 1024), 11)).to(cuda)
    c, a, b = tile[32:, 32:], tile[32:, :32], tile[:32, 32:]
    _schur_close(ops.schur_update(c, a, b), ref.schur_update_ref(c, a, b),
                 c, a, b, torch.float64)


@pytest.mark.parametrize("dtype", SCHUR_DTYPES)
@pytest.mark.parametrize("k", [77, 80])
def test_schur_same_bits_run_to_run_and_across_a_batch(cuda, dtype, k):
    """No split K and no atomics: one call's bits are the same every run,
    and a matrix's bits do not depend on the stack around it. At K = 80 a
    2-byte stack's rows are whole 16-byte vectors, so the wgmma kernel
    loads A by TMA, the batch a coordinate of its map."""
    c, a, b = (torch.from_numpy(_rand(s, seed)).to(cuda, dtype)
               for s, seed in (((4, 300, 170), 7), ((4, 300, k), 8),
                               ((4, k, 170), 9)))
    got = ops.schur_update(c, a, b)
    _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, dtype)
    assert torch.equal(got[2], ops.schur_update(c[2], a[2], b[2]))
    big = [torch.from_numpy(_rand((1024, 1024), s)).to(cuda, dtype)
           for s in (1, 2, 3)]
    first = ops.schur_update(*big)
    for _ in range(3):
        assert torch.equal(first, ops.schur_update(*big))


@pytest.mark.parametrize("case", ["panel-warp", "panel-block", "panel-stack",
                                  "schur-f64", "schur-f64-inner", "schur-f32",
                                  "schur-bf16", "schur-f16"])
def test_panel_and_schur_launch_once_per_call(cuda, case):
    """One CUDA launch a wrapper call, as chip_smoke.py holds them."""
    if case.startswith("panel"):
        shape = {"panel-warp": (32, 32), "panel-block": (48, 48),
                 "panel-stack": (16, 32, 32)}[case]
        a = torch.from_numpy(_dominant(shape, 3)).to(cuda)
        assert _profiled_launches(lambda: ops.lu_panel(a)) == 1
        return
    dtype = {"schur-f32": torch.float32, "schur-bf16": torch.bfloat16,
             "schur-f16": torch.float16}.get(case, torch.float64)
    x = torch.from_numpy(_rand((1024, 1024), 4)).to(cuda, dtype)
    c, a, b = x, x, x
    if case == "schur-f64-inner":
        c, a, b = x[32:, 32:], x[32:, :32], x[:32, 32:]
    assert _profiled_launches(lambda: ops.schur_update(c, a, b)) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_schur_half_loads_lu_blocked_operands_by_tma(cuda, dtype):
    """The 2-byte routes load A and B by TMA at lu_blocked's shapes: views
    of the matrix (a trailing update) and the inner update's fresh
    992 x 32 and 32 x 992 strips beside a view of the diagonal tile. The
    same values one element off alignment are copied by the block's
    threads into the same swizzled tiles, and give the same bits."""
    from repro_torch.kernels import schur

    x = torch.from_numpy(_rand((2048, 2048), 12)).to(cuda, dtype)
    strip = lambda shape, seed: torch.from_numpy(_rand(shape, seed)).to(
        cuda, dtype)
    for c, a, b in ((x[1024:, 1024:], x[1024:, :1024], x[:1024, 1024:]),
                    (x[32:1024, 32:1024], strip((992, 32), 13),
                     strip((32, 992), 14))):
        assert schur.tma_operands(a, b) == (True, True)
        odd = [torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
               .view(t.shape).copy_(t) for t in (a, b)]
        assert schur.tma_operands(*odd) == (False, False)
        got = ops.schur_update(c, a, b)
        _schur_close(got, ref.schur_update_ref(c, a, b), c, a, b, dtype)
        assert torch.equal(got, ops.schur_update(c, *odd))


# --------------------------------------------------- mixed acc_dtype routes
#: (storage, arithmetic) of the mixed routes; a route and its plain
#: version round once to the storage type from wide values that differ in
#: summation order only: within 4 storage ulps of max|plain|
MIXED = [(torch.float32, torch.float64), (torch.bfloat16, torch.float32),
         (torch.float16, torch.float32), (torch.bfloat16, torch.float64),
         (torch.float16, torch.float64)]
MIXED_IDS = ["f32-f64", "bf16-f32", "f16-f32", "bf16-f64", "f16-f64"]
#: the Schur update's mixed routes (bf16/f16 -> f32 is its default route)
SCHUR_MIXED = [MIXED[0], *MIXED[3:]]
SCHUR_MIXED_IDS = [MIXED_IDS[0], *MIXED_IDS[3:]]
HALVES = [torch.bfloat16, torch.float16]


def _close_ulps(got, want, dtype, ulps=4):
    assert got.dtype == want.dtype == dtype
    _close(got.double(), want.double(), ulps * torch.finfo(dtype).eps)


@pytest.mark.parametrize("st,acc", MIXED, ids=MIXED_IDS)
@pytest.mark.parametrize("shape", [(32, 32), (16, 32, 32), (48, 48), (100, 100)])
def test_lu_panel_mixed_matches_plain(cuda, st, acc, shape):
    a = torch.from_numpy(_dominant(shape, 3)).to(cuda, st)
    _close_ulps(ops.lu_panel(a, acc_dtype=acc), ref.lu_panel_ref(a, acc), st)


@pytest.mark.parametrize("st,acc", MIXED, ids=MIXED_IDS)
@pytest.mark.parametrize("n,m,batch", [(1024, 1024, None), (32, 992, None),
                                        (100, 70, 3)])
def test_trsm_mixed_match_plain(cuda, st, acc, n, m, batch):
    lead = () if batch is None else (batch,)
    l, u = (torch.from_numpy(t).to(cuda, st) for t in _triangles(lead, n, 5))
    b = torch.from_numpy(_rand((*lead, n, m), 6)).to(cuda, st)
    b2 = torch.from_numpy(_rand((*lead, m, n), 7)).to(cuda, st)
    _close_ulps(ops.trsm_lower(l, b, acc_dtype=acc),
                ref.trsm_lower_ref(l, b, acc), st)
    _close_ulps(ops.trsm_upper_right(u, b2, acc_dtype=acc),
                ref.trsm_upper_right_ref(u, b2, acc), st)


@pytest.mark.parametrize("st,acc", MIXED, ids=MIXED_IDS)
def test_trsm_mixed_three_levels_deep(cuda, st, acc):
    """Every mixed route at n = 333 (six leaves, products three levels
    deep, a 13-row last leaf), a batch of two, against its plain version
    within 4 storage ulps."""
    n, m = 333, 100
    l, u = (torch.from_numpy(t).to(cuda, st) for t in _triangles((2,), n, 39))
    b = torch.from_numpy(_rand((2, n, m), 40)).to(cuda, st)
    b2 = torch.from_numpy(_rand((2, m, n), 41)).to(cuda, st)
    _close_ulps(ops.trsm_lower(l, b, acc_dtype=acc),
                ref.trsm_lower_ref(l, b, acc), st)
    _close_ulps(ops.trsm_upper_right(u, b2, acc_dtype=acc),
                ref.trsm_upper_right_ref(u, b2, acc), st)


def test_trsm_mixed_columns_bit_equal_across_splits(cuda):
    """The mixed route keeps the split property: a call over m columns
    equals calls over its halves, bit for bit."""
    l, u = (torch.from_numpy(t).to(cuda, torch.float32)
            for t in _triangles((), 300, 8))
    b = torch.from_numpy(_rand((300, 200), 9)).to(cuda, torch.float32)
    whole = ops.trsm_lower(l, b, acc_dtype=torch.float64)
    halves = torch.cat([ops.trsm_lower(l, b[:, :77], acc_dtype=torch.float64),
                        ops.trsm_lower(l, b[:, 77:], acc_dtype=torch.float64)],
                       dim=1)
    assert torch.equal(whole, halves)


@pytest.mark.parametrize("st,acc", SCHUR_MIXED, ids=SCHUR_MIXED_IDS)
@pytest.mark.parametrize("m,k,n,batch", [(1024, 1024, 1024, None),
                                         (992, 32, 992, None),
                                         (130, 37, 70, 3)])
def test_schur_mixed_matches_plain(cuda, st, acc, m, k, n, batch):
    lead = () if batch is None else (batch,)
    c, a, b = (torch.from_numpy(_rand((*lead, *s), i)).to(cuda, st)
               for i, s in enumerate([(m, n), (m, k), (k, n)]))
    got = ops.schur_update(c, a, b, acc_dtype=acc)
    _close_ulps(got, ref.schur_update_ref(c, a, b, acc), st)


@pytest.mark.parametrize("which", ["a", "b", "c", "all"])
def test_schur_mixed_column_major_and_odd_offsets(cuda, which):
    """The mixed route stages f32 tiles four elements a copy where rows
    allow, one element otherwise: transposed views and views at odd
    offsets take the element path."""
    big = torch.from_numpy(_rand((3, 301, 301), 13)).to(cuda, torch.float32)
    c, a, b = big[0, 1:201, 3:131], big[1, 5:205, 7:71], big[2, 2:66, 1:129]
    if which in ("a", "all"):
        a = big[1, 5:69, 7:207].t()
    if which in ("b", "all"):
        b = big[2, 2:130, 1:65].t()
    if which in ("c", "all"):
        c = big[0, 1:129, 3:203].t()
    got = ops.schur_update(c, a, b, acc_dtype=torch.float64)
    _close_ulps(got, ref.schur_update_ref(c, a, b, torch.float64),
                torch.float32)


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("which", ["a", "b", "all"])
def test_schur_half_to_f64_element_path(cuda, dtype, which):
    """bf16/f16 -> f64 stages 2-byte tiles eight elements a copy where
    rows allow; transposed views and odd offsets take the element path,
    a plain load and store (cp.async has no 2-byte copy)."""
    big = torch.from_numpy(_rand((3, 301, 301), 14)).to(cuda, dtype)
    c, a, b = big[0, 1:201, 3:131], big[1, 5:205, 7:71], big[2, 2:66, 1:129]
    if which in ("a", "all"):
        a = big[1, 5:69, 7:207].t()
    if which in ("b", "all"):
        b = big[2, 2:130, 1:65].t()
    got = ops.schur_update(c, a, b, acc_dtype=torch.float64)
    _close_ulps(got, ref.schur_update_ref(c, a, b, torch.float64), dtype)


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(32, 32), (16, 32, 32), (48, 48),
                                   (100, 100)])
def test_lu_panel_narrow_bit_equal_to_plain(cuda, dtype, shape):
    a = torch.from_numpy(_dominant(shape, 3)).to(cuda, dtype)
    got = ops.lu_panel(a)
    assert got.dtype == dtype
    assert torch.equal(got, ref.lu_panel_ref(a))


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("n,m,batch", [(1024, 1024, None), (32, 992, None),
                                        (100, 70, 3), (1000, 300, None)])
def test_trsm_narrow_bit_equal_to_plain(cuda, dtype, n, m, batch):
    lead = () if batch is None else (batch,)
    l, u = (torch.from_numpy(t).to(cuda, dtype) for t in _triangles(lead, n, 5))
    b = torch.from_numpy(_rand((*lead, n, m), 6)).to(cuda, dtype)
    b2 = torch.from_numpy(_rand((*lead, m, n), 7)).to(cuda, dtype)
    assert torch.equal(ops.trsm_lower(l, b), ref.trsm_lower_ref(l, b))
    assert torch.equal(ops.trsm_upper_right(u, b2),
                       ref.trsm_upper_right_ref(u, b2))


@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("acc", [None, torch.float32, torch.float64],
                         ids=["narrow", "f32", "f64"])
def test_lu_blocked_half_on_card_matches_cpu(cuda, dtype, acc):
    """bf16/f16 lu_blocked on the card against the CPU's plain path,
    within 8 storage ulps of max|factor|: the panels and strips agree bit
    for bit (narrow) or within 4 ulps (f32, f64), and the updates' sums
    differ in order, by at most one rounding of a stored value each, which
    the later steps carry along."""
    from repro_torch.core.lu import lu_blocked

    x = torch.from_numpy(_dominant((256, 256), 10)).to(dtype)
    ops.reset_launches()
    got = lu_blocked(x.to(cuda), 64, acc_dtype=acc)
    assert ops.LAUNCHES["lu_panel"] == 8
    assert ops.LAUNCHES["schur_update"] == 9 + 4 + 1 + 4
    want = lu_blocked(x, 64, acc_dtype=acc)
    for g, w in zip(got, want):
        _close_ulps(g.cpu(), w, dtype, ulps=8)


def test_mixed_panel_block_route_holds_wide_tiles(cuda):
    """An f32 tile computed in f64 is held at f64 in shared memory: 170
    wide at most, where the f32 route takes 241."""
    a = torch.eye(171, dtype=torch.float32, device=cuda)
    assert torch.equal(ops.lu_panel(a), a)
    with pytest.raises(ValueError, match="blocked"):
        ops.lu_panel(a, acc_dtype=torch.float64)


def test_lu_blocked_mixed_on_card_matches_cpu(cuda):
    from repro_torch.core.lu import lu_blocked

    x = _dominant((256, 256), 10).astype(np.float32)
    got = lu_blocked(torch.from_numpy(x).to(cuda), 64, acc_dtype=torch.float64)
    want = lu_blocked(torch.from_numpy(x), 64, acc_dtype=torch.float64)
    for g, w in zip(got, want):
        _close_ulps(g.cpu(), w, torch.float32)


def test_recovery_on_card_heals_to_honest_factors(cuda):
    """A block tamper by server 2 in the inline sweep, healed on the
    card: the determinant of the honest run, bit for bit."""
    import repro_torch

    m = _dominant((256, 256), 11)
    honest = repro_torch.outsource_determinant(m, 4)
    res = repro_torch.outsource_determinant(
        m, 4, faults=repro_torch.ServerFault(server=2, mode="block",
                                            magnitude=0.3),
        recover=True, standby=1)
    assert res.verified and res.report.recovery.servers_replaced == (2,)
    assert res.det == honest.det


def test_f32_protocol_on_card(cuda):
    import repro_torch

    m = _dominant((512, 512), 12)
    res = repro_torch.outsource_determinant(m, 4, dtype="float32")
    sign, logabs = np.linalg.slogdet(m)
    assert res.verified and res.det.sign == sign
    assert abs(res.det.logabs - logabs) <= 1e-4


def test_socket_daemon_on_card_answers_session(cuda, tmp_path):
    """A port WorkerDaemon computing on the card answers a socket
    session: the strips equal the fused sweep's bit for bit, the session
    verifies, and a second client finds the same warm daemon."""
    from repro_torch.api import InlineTransport, SPDCClient
    from repro_torch.api.socket_transport import SocketTransport, WorkerDaemon

    m = _dominant((512, 512), 13)
    session = SPDCClient().open_session(m, 4)
    with WorkerDaemon(f"unix://{tmp_path}/w.sock", device="cuda") as daemon:
        with SocketTransport((daemon.address,), timeout=120.0) as t:
            l, u = session._assemble(t.factor(session.tasks()))
            first = t.hello(0)
        with SocketTransport((daemon.address,), timeout=120.0) as t:
            result = session.run(t)
            second = t.hello(0)
    l_inline, u_inline = InlineTransport().sweep(session.x_aug, 4)
    assert torch.equal(l, l_inline) and torch.equal(u, u_inline)
    assert result.verified
    assert second["connections"] > first["connections"]
    assert second["frames_served"] > 0


def test_rateless_on_card_bit_equal_to_lu_nserver(cuda):
    """Rateless on the card: F = 8 strips streamed to four workers, each
    lu_block_row's "nserver" order over the accepted U rows, give the
    factors of lu_nserver(x_aug, F) bit for bit; the session verifies."""
    from repro_torch.api import SPDCClient, ThreadPoolTransport
    from repro_torch.core.lu import lu_nserver
    from repro_torch.distrib.rateless import run_rateless

    m = _dominant((512, 512), 14)
    client = SPDCClient(rateless=True)
    session = client.open_session(m, 4)
    with ThreadPoolTransport() as tp:
        l, u, rpt = run_rateless(session, tp, client.rateless, client.fleet)
        result = client.open_session(m, 4).run(tp)
    assert session.partitions == 8 and rpt.inline_strips == 0
    wl, wu, _ = lu_nserver(session.x_aug, session.partitions)
    assert torch.equal(torch.from_numpy(l).to(cuda), wl)
    assert torch.equal(torch.from_numpy(u).to(cuda), wu)
    assert result.verified and result.report.fleet.num_strips == 8


#: the four left solves of a trisolve chunk, (upper, transpose_t) by leg:
#: L a = b, U y = a, Uᵀ a = b, Lᵀ y = a
LEGS = {"l": (False, False), "u": (True, False), "ut": (True, True),
        "lt": (False, True)}


def _leg_operands(cuda, n, m, seed, dtype=torch.float64):
    """The factors of a leg (L with its stored unit diagonal, as the LU
    gives it) and a right-hand side."""
    l, u = (torch.from_numpy(t).to(cuda, dtype) for t in _triangles((), n, seed))
    b = torch.from_numpy(_rand((n, m), seed + 2)).to(cuda, dtype)
    return l, u, b


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("n,m", [(4096, 1024), (130, 50), (64, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_trsm_left_legs_match_plain(cuda, leg, n, m, dtype):
    """Each leg at the n = 4096 inverse round's chunk shape and at ragged
    ones, against its plain substitution; the L legs divide by L's
    stored diagonal (unit=False), as the reference's server does."""
    upper, trans = LEGS[leg]
    l, u, b = _leg_operands(cuda, n, m, 20, dtype)
    t = u if upper else l
    got = ops.trsm_left(t, b, upper=upper, transpose_t=trans)
    want = ref.trsm_left_ref(t, b, upper=upper, transpose_t=trans)
    _close(got, want, RTOL if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("leg", list(LEGS))
def test_trsm_left_reversed_strides_bit_equal_to_flipped_copy(cuda, leg):
    """An upper op(T) reaches the lower solver as J·op(T)·J with negated
    strides: the result equals, bit for bit, the lower solve of a
    flipped contiguous copy; Uᵀ as a stride swap equals Uᵀ copied."""
    upper, trans = LEGS[leg]
    l, u, b = _leg_operands(cuda, 300, 70, 21)
    t = u if upper else l
    got = ops.trsm_left(t, b, upper=upper, transpose_t=trans)
    op_t = (t.t() if trans else t).contiguous()
    if upper != trans:
        flipped = ops.trsm_left(op_t.flip(0, 1).contiguous(),
                                b.flip(0).contiguous(), upper=False)
        assert torch.equal(got, flipped.flip(0))
    else:
        assert torch.equal(got, ops.trsm_left(op_t, b, upper=False))
    # strided views of T and B: a column-major T, every other column of B
    wide = torch.from_numpy(_rand((300, 140), 22)).to(cuda)[:, 1::2]
    assert torch.equal(
        ops.trsm_left(t.t().contiguous().t(), wide, upper=upper,
                      transpose_t=trans),
        ops.trsm_left(t, wide.contiguous(), upper=upper, transpose_t=trans))


@pytest.mark.parametrize("leg", list(LEGS))
@pytest.mark.parametrize("n,m", [(1024, 1024), (256, 300)])
def test_trsm_left_columns_bit_equal_across_splits(cuda, leg, n, m):
    """The split property the chunked rounds rely on: one call over m
    columns equals the concatenation of calls over any split of them."""
    upper, trans = LEGS[leg]
    l, u, b = _leg_operands(cuda, n, m, 23)
    t = u if upper else l
    whole = ops.trsm_left(t, b, upper=upper, transpose_t=trans)
    for cuts in ([0, 1, m // 3, m // 3 + 64, m],
                 [0, m // 4, m // 2, 3 * m // 4, m]):
        parts = [ops.trsm_left(t, b[:, c0:c1], upper=upper, transpose_t=trans)
                 for c0, c1 in zip(cuts, cuts[1:])]
        assert torch.equal(whole, torch.cat(parts, dim=1))


@pytest.mark.parametrize("leg", list(LEGS))
def test_trsm_left_leg_shape_bit_equal_split_and_reversed(cuda, leg):
    """At the inverse round's chunk shape, 4096² against 4096 × 1024: one
    call equals four calls over column quarters, and the reversed legs
    the lower solve of flipped contiguous copies, bit for bit."""
    upper, trans = LEGS[leg]
    l, u, b = _leg_operands(cuda, 4096, 1024, 42)
    t = u if upper else l
    whole = ops.trsm_left(t, b, upper=upper, transpose_t=trans)
    parts = [ops.trsm_left(t, b[:, c:c + 256], upper=upper, transpose_t=trans)
             for c in range(0, 1024, 256)]
    assert torch.equal(whole, torch.cat(parts, dim=1))
    op_t = (t.t() if trans else t).contiguous()
    if upper != trans:
        flipped = ops.trsm_left(op_t.flip(0, 1).contiguous(),
                                b.flip(0).contiguous(), upper=False)
        assert torch.equal(whole, flipped.flip(0))
    else:
        assert torch.equal(whole, ops.trsm_left(op_t, b, upper=False))


def test_trsm_left_counts_legs_and_launches(cuda):
    """One wrapper call is one count, under its leg, and puts
    trsm.cuda_launches(n) kernels on the stream, whichever leg."""
    from repro_torch.kernels import trsm

    l, u, b = _leg_operands(cuda, 1000, 40, 24)
    ops.reset_launches()
    calls = dict.fromkeys(LEGS, 0)
    for leg, (upper, trans) in LEGS.items():
        t = u if upper else l

        def call():
            calls[leg] += 1
            ops.trsm_left(t, b, upper=upper, transpose_t=trans)

        assert _profiled_launches(call) == trsm.cuda_launches(1000), leg
    # a window's warm-up call and its four timed calls, each leg, and as
    # many again for a window profiled again because it lost an event
    assert all(c % 5 == 0 for c in calls.values()), calls
    assert ops.TRSM_LEFT_LEGS == calls
    assert ops.LAUNCHES["trsm_left"] == sum(calls.values())


def test_linalg_session_on_card_runs_the_legs(cuda):
    """A LinalgSession on the card: solve, adjoint solve and inverse
    against torch.linalg, one factorization, every round's chunk solved
    by trsm_left (both legs of its direction) and not by a plain path."""
    from repro_torch.linalg import LinalgSession

    m = _dominant((256, 256), 25)
    b = _rand((256, 8), 26)
    md, bd = (torch.from_numpy(a).to(cuda) for a in (m, b))
    ops.reset_launches()
    s = LinalgSession(m, 4)
    y, yt, inv = s.solve(b), s.solve(b, transpose=True), s.inv()
    _close(y, torch.linalg.solve(md, bd), 1e-10)
    _close(yt, torch.linalg.solve(md.T, bd), 1e-10)
    _close(inv, torch.linalg.inv(md), 1e-10)
    assert s.factorizations == 1
    assert all(o.verified for o in s.report.ops)
    assert ops.LAUNCHES["trsm_left"] == 3 * 2 * 4
    assert all(ops.TRSM_LEFT_LEGS[leg] > 0 for leg in LEGS)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mixed_stack_on_card_bit_equal_to_cpu(cuda, dtype):
    """The mixed-size PMOP on the card: one CED launch per request, and
    the (B, n', n') stack (cipher, equilibration, border) bit-equal to
    the CPU's plain path."""
    from repro_torch.api import SPDCClient

    ms = [_dominant((n, n), 30 + n) for n in (200, 256, 131, 97)]
    ops.reset_launches()
    got = SPDCClient(dtype=dtype).open_session(ms, 4)
    assert ops.LAUNCHES["ced"] == len(ms)
    want = SPDCClient(dtype=dtype, device="cpu").open_session(ms, 4)
    assert got.pad_to == want.pad_to == 256
    assert torch.equal(got.x_aug.cpu(), want.x_aug)
    np.testing.assert_array_equal(got.log2_scale, want.log2_scale)


def test_gateway_on_card_runs_the_kernels(cuda):
    """A gateway on the card (no device= given): one bucket flush of
    mixed sizes runs CED per request and the panel and both TRSM kernels
    on the stack; every determinant within rtol 1e-10 of
    torch.linalg.slogdet in f64; a tampered bucket heals alone."""
    from repro_torch import ServerFault, SPDCGateway
    from repro_torch.configs import SPDCConfig, SPDCGatewayConfig

    cfg = SPDCGatewayConfig(name="card", buckets=(256, 512), max_batch=4,
                            max_wait_us=1e9,
                            spdc=SPDCConfig(num_servers=4, recover=True,
                                            standby=1))
    gw = SPDCGateway(cfg, faults_for=lambda key: ServerFault(
        server=2, mode="block", magnitude=0.3) if key.pad_to == 512 else None)
    assert gw.device.type == "cuda"
    mats = [_dominant((n, n), 40 + i)
            for i, n in enumerate((200, 256, 131, 300, 480, 512))]
    ops.reset_launches()
    rids = [gw.submit(m) for m in mats]
    gw.drain()
    for name in ("ced", "lu_panel", "trsm_lower", "trsm_upper_right"):
        assert ops.LAUNCHES[name] > 0, name
    assert ops.LAUNCHES["ced"] >= len(mats)
    for m, rid in zip(mats, rids):
        r = gw.take(rid)
        assert r.verified and r.error is None
        assert (r.recovery is not None) == (r.pad_to == 512)
        want = torch.linalg.slogdet(torch.from_numpy(m).to(cuda))
        assert r.det.sign == float(want.sign)
        assert np.isclose(r.det.logabs, float(want.logabsdet), rtol=1e-10)
    assert gw.stats.recovered_flushes == 1 and gw.stats.failed == 0


def test_async_gateway_on_card_sweeps_off_the_loop(cuda):
    """AsyncSPDCGateway on the card: each sweep runs on a worker thread
    inside the gateway's device scope; the answers verify."""
    import asyncio

    from repro_torch import AsyncSPDCGateway
    from repro_torch.configs import SPDCConfig, SPDCGatewayConfig

    cfg = SPDCGatewayConfig(name="card-async", buckets=(128,), max_batch=4,
                            max_wait_us=2000.0, spdc=SPDCConfig(num_servers=4))
    mats = [_dominant((n, n), 50 + n) for n in (100, 128, 64, 90, 77)]

    async def main():
        async with AsyncSPDCGateway(cfg) as gw:
            await gw.warmup((4,))
            return await asyncio.gather(*(gw.submit(m) for m in mats))

    for m, r in zip(mats, asyncio.run(main())):
        sign, logabs = np.linalg.slogdet(m)
        assert r.verified and r.det.sign == sign
        assert np.isclose(r.det.logabs, logabs, rtol=1e-10)


def test_kernel_libraries_load_once_across_threads(cuda):
    """Threads racing to a kernel's first use get one loaded library."""
    import threading

    from repro_torch.kernels import build

    saved = dict(build._LIBS)
    build._LIBS.clear()
    got = []
    try:
        threads = [threading.Thread(target=lambda: got.append(
            build.library("lu_panel", lu_panel._SIGNATURES)))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 8 and all(lib is got[0] for lib in got)
    finally:
        build._LIBS.clear()
        build._LIBS.update(saved)


def test_serve_spdc_smoke_on_card(cuda, capsys):
    from repro_torch.launch import serve_spdc

    assert serve_spdc.main(["--smoke", "--no-warmup"]) == 0
    out = capsys.readouterr().out
    assert "device=cuda" in out and "check: all" in out


@pytest.mark.parametrize("program", ["baseline", "exact", "stream"])
@pytest.mark.parametrize("shape", [(1024, 1024), (3, 512, 512)])
def test_pipeline_slot_streams_bit_equal_to_one_stream(cuda, program, shape):
    """The pipeline on four slots, each with a stream of its own, gives
    the factors of the same sweep with every slot on the current stream,
    bit for bit (the events order the relay exactly as one stream
    would); both within 1e-12 of max|F| of the plain path on the CPU, and
    one hop a slot a relay round in the log."""
    from repro_torch.distrib.spdc_pipeline import ServerMesh, lu_nserver_shardmap

    x = torch.from_numpy(_dominant(shape, 21))
    own = ServerMesh(4, cuda)
    got = lu_nserver_shardmap(x.to(cuda), 4, mesh=own, program=program)
    one = lu_nserver_shardmap(x.to(cuda), 4, program=program,
                              mesh=ServerMesh(4, cuda, streams=False))
    plain = lu_nserver_shardmap(x, 4, program=program, device="cpu")
    torch.cuda.synchronize()
    assert len({slot.stream for slot in own.slots}) == 4
    for g, o, p in zip(got, one, plain):
        assert torch.equal(g, o)
        _close(g.cpu(), p)
    rounds = 4 if program == "baseline" else 3
    assert len(own.hops) == 4 * rounds


def test_pipeline_protocol_on_card_runs_the_kernels(cuda):
    """distributed=True on the card: verified, the determinant of
    torch.linalg.slogdet, and the panel and both solves launched at the
    pipeline's counts (b = 256: eight panels a server, a block-row solve
    each, N(N-1)/2 L blocks)."""
    import repro_torch

    m = _dominant((1024, 1024), 22)
    ops.reset_launches()
    res = repro_torch.outsource_determinant(m, 4, distributed=True)
    torch.cuda.synchronize()
    assert res.verified and res.comm is None
    sign, logabs = np.linalg.slogdet(m)
    assert res.det.sign == sign
    np.testing.assert_allclose(res.det.logabs, logabs, rtol=1e-10)
    assert ops.LAUNCHES["lu_panel"] == 32
    assert ops.LAUNCHES["trsm_lower"] == 4 * 7 + 4
    assert ops.LAUNCHES["trsm_upper_right"] == 4 * 7 + 6


# --- local attention at gemma3-1b's full width: chunks folded into the
# batch, and decode over a wrapped ring ---------------------------------

#: gemma3-1b's local layers: 4 query heads over 1 kv head of 256, window
#: 1024; S past the window with a ragged last chunk
LOCAL_HEADS, LOCAL_WINDOW, LOCAL_LEN = (4, 1, 256), 1024, 2500


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["sliding", "chunked"])
def test_local_prefill_on_card_matches_plain(cuda, dtype, kind):
    """The local prefill at gemma3's shapes, one launch: the sliding
    window route, or the chunks folded into the batch and run causal,
    against the plain version of the same attention (a chunk at a time
    for chunked)."""
    from repro_torch.models.attention import _local

    (hq, hkv, d), w, s = LOCAL_HEADS, LOCAL_WINDOW, LOCAL_LEN
    q, k, v = _qkv(cuda, 2, hq, hkv, s, s, d, dtype, seed=31, layout="bshd")
    scale = d ** -0.5
    ops.reset_launches()
    got = _local(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 kind=kind, window=w, scale=scale)
    assert ops.LAUNCHES["flash_attention"] == 1
    if kind == "sliding":
        want = ref.flash_attention_ref(q, k, v, causal=True, window=w,
                                       scale=scale)
    else:
        want = torch.cat([ref.flash_attention_ref(
            q[:, :, c:c + w], k[:, :, c:c + w], v[:, :, c:c + w],
            causal=True, scale=scale) for c in range(0, s, w)], dim=2)
    _flash_within(got, want, v)


@pytest.mark.parametrize("kind", ["sliding", "chunked"])
def test_ring_decode_on_card_matches_prefill_and_plain(cuda, kind):
    """A full-width gemma3 attention layer in f32 over 1100 tokens: the
    card's local prefill, then all 1100 decoded through a ring of 1024
    slots, which wraps; every wrapped step equals the prefill's row, and
    the last step's kernel call equals the plain version over the same
    ring prefix."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.attention import _decode_keys, attention, init_attention
    from repro_torch.models.common import Initializer
    from repro_torch.serve.kvcache import init_layer_cache

    cfg = replace(get_config("gemma3-1b"), num_layers=1,
                  activation_dtype="float32", params_dtype="float32")
    layer = init_attention(Initializer(7, torch.float32, cuda), cfg)
    n, b = 1100, 2
    x = torch.from_numpy(_rand((b, n, cfg.d_model), 32)).to(cuda, torch.float32)
    pos = torch.arange(n, device=cuda)[None].expand(b, n)
    with torch.no_grad():
        prefill, _ = attention(layer, x, cfg, pos, kind=kind)
        cache = init_layer_cache(cfg, f"attn_{kind}", b, n, device=cuda)
        assert cache["k"].shape[1] == LOCAL_WINDOW
        scale = 1.0 / max(float(prefill.abs().max()), 1e-30)
        for t in range(n):
            out, cache = attention(layer, x[:, t:t + 1], cfg, pos[:, t:t + 1],
                                   kind=kind, cache=cache)
            if t >= LOCAL_WINDOW:
                err = float((out - prefill[:, t:t + 1]).abs().max()) * scale
                assert err <= 1e-4, (t, err)
    keys = _decode_keys(kind, n - 1, LOCAL_WINDOW, LOCAL_WINDOW)
    assert keys == (LOCAL_WINDOW if kind == "sliding" else n % LOCAL_WINDOW)
    q = torch.from_numpy(_rand((b, 4, 1, 256), 33)).to(cuda, torch.float32)
    _flash_close(q, cache["k"][:, :keys].transpose(1, 2),
                 cache["v"][:, :keys].transpose(1, 2))


# --- training: the flash kernel and its gradient kernels under autograd ---
def _grads_within(got, want):
    """Gradients against the oracle's or the plain version's, leaf by
    leaf: f32 within 1e-5 of the leaf's max|g| (summation order, exp2
    against exp); bf16/f16, eps their machine epsilon, every element
    within 2 eps max|g| (each side rounds the output once, and P and dS
    are rounded to the dtype before their products) and ||err|| <= eps
    ||want|| over the leaf."""
    for a, c in zip(got, want):
        assert a.shape == c.shape and a.dtype == c.dtype
        err = (a.float() - c.float()).abs()
        top = float(c.float().abs().max())
        assert top > 0
        if c.dtype == torch.float32:
            assert float(err.max()) <= 1e-5 * top, float(err.max()) / top
            continue
        eps = torch.finfo(c.dtype).eps
        assert float(err.max()) <= 2 * eps * top, float(err.max()) / top
        rel = float(err.norm() / c.float().norm())
        assert rel <= eps, rel


def _autograd_case(cuda, b, hq, hkv, sq, sk, d, dtype, seed):
    """q, k, v as the model's strided views, requiring grad, and a
    grad_out of the same layout."""
    q, k, v = (t.detach().requires_grad_()
               for t in _qkv(cuda, b, hq, hkv, sq, sk, d, dtype, seed=seed,
                             layout="bshd"))
    g = torch.from_numpy(_rand((b, sq, hq, d), seed + 1)).to(
        cuda, dtype).transpose(1, 2)
    return q, k, v, g


AUTOGRAD_CASES = {
    "gqa": (2, 8, 2, 300, 300, 64, {"causal": True}),
    "window": (1, 4, 1, 200, 200, 128, {"causal": True, "window": 40}),
    "non-causal": (2, 4, 4, 130, 130, 80, {"causal": False}),
    "scale": (1, 8, 2, 100, 100, 64, {"causal": True, "scale": 0.2}),
    "d256-window": (1, 4, 2, 150, 150, 256, {"causal": True, "window": 24}),
    "chunk-fold": (4, 4, 1, 128, 128, 128, {"causal": True}),
    "right-aligned": (1, 4, 2, 70, 250, 64, {"causal": True}),
    "fully-masked": (1, 4, 2, 90, 40, 64, {"causal": True}),
    "short-sq": (2, 8, 2, 9, 100, 64, {"causal": True}),
    "d8": (1, 2, 1, 33, 33, 8, {"causal": True}),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["gqa", "window", "non-causal", "scale"])
def test_flash_under_autograd_grads_equal_plain(cuda, dtype, case):
    """With grad enabled the wrapper runs the kernel under autograd: the
    forward within tolerance of the plain version, one forward and one
    backward counted, and dq, dk, dv from the gradient kernels within
    _grads_within of autograd through the plain version at the same
    inputs (the model's strided views)."""
    b, hq, hkv, sq, sk, d, kw = AUTOGRAD_CASES[case]
    q, k, v, g = _autograd_case(cuda, b, hq, hkv, sq, sk, d, dtype, 40)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.grad_fn is not None
    want = ref.flash_attention_ref(q, k, v, **kw)
    _flash_within(got.detach(), want.detach(), v.detach())
    grads = torch.autograd.grad(got, (q, k, v), g)
    assert ops.LAUNCHES["flash_attention_backward"] == 1
    _grads_within(grads, torch.autograd.grad(want, (q, k, v), g))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_flash_backward_kernels_match_plain(cuda, dtype, case):
    """The gradient kernels on every route against their plain version
    (ref.flash_attention_backward_ref on the kernel forward's own output
    and lse) and against the oracle (autograd through the plain forward);
    the forward's lse against the plain lse; the same bits on a second
    backward."""
    from repro_torch.kernels import flash_attn, flash_bwd, flash_grad

    b, hq, hkv, sq, sk, d, kw = AUTOGRAD_CASES[case]
    q, k, v, g = _autograd_case(cuda, b, hq, hkv, sq, sk, d, dtype, 50)
    with torch.no_grad():
        out, lse = flash_attn.flash_attention_lse_cuda(q, k, v, **kw)
        _, lse0 = ref.flash_attention_lse_ref(q, k, v, **kw)
        seen = lse0 > -1e29  # rows that see a key
        assert torch.equal(seen, lse > -1e29)
        assert float((lse - lse0)[seen].abs().max()) <= 1e-4 * max(
            1.0, float(lse0[seen].abs().max()))
        got = flash_bwd.flash_attention_backward_cuda(q, k, v, out, lse, g, **kw)
        again = flash_bwd.flash_attention_backward_cuda(q, k, v, out, lse, g, **kw)
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        for a, t in zip(got, (q, k, v)):
            assert a.shape == t.shape and a.stride() == t.stride()
        _grads_within(got, ref.flash_attention_backward_ref(q, k, v, out, lse,
                                                            g, **kw))
    _grads_within(got, flash_grad.flash_attention_backward(
        q, k, v, g, kw.get("causal", True), kw.get("window"), kw.get("scale")))


def test_flash_backward_takes_any_grad_layout(cuda):
    """grad_out contiguous in (B, H, S, D), as the model's strided view,
    and expanded from one row (a D stride of 0, made contiguous once):
    the same gradients, bit for bit, as from its contiguous copy."""
    from repro_torch.kernels import flash_attn, flash_bwd

    q, k, v, g = _autograd_case(cuda, 2, 8, 2, 100, 100, 64, torch.bfloat16,
                                60)
    with torch.no_grad():
        out, lse = flash_attn.flash_attention_lse_cuda(q, k, v)
        row = g[:, :, :1, :1]
        for grad in (g, row.expand_as(g)):
            got = flash_bwd.flash_attention_backward_cuda(q, k, v, out, lse, grad)
            want = flash_bwd.flash_attention_backward_cuda(
                q, k, v, out, lse, grad.contiguous())
            assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_flash_backward_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attn, flash_bwd

    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, 64, torch.bfloat16)
    out, lse = flash_attn.flash_attention_lse_cuda(q, k, v)
    with pytest.raises(ValueError):
        flash_bwd.flash_attention_backward_cuda(q, k, v, out, lse[:, :, 1:], out)
    with pytest.raises(ValueError):
        flash_bwd.flash_attention_backward_cuda(q, k, v, out.float(), lse, out)
    with pytest.raises(ValueError):
        flash_bwd.flash_attention_backward_cuda(q, k, v, out, lse.cpu(), out)


def test_flash_without_grad_is_the_direct_call(cuda):
    """Under no_grad, or with no operand requiring grad, the kernel is
    called directly (serving's path): no graph, one launch."""
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, 64, torch.bfloat16)
    for grad_on, leaf in ((False, True), (True, False)):
        qq = q.detach().requires_grad_(leaf)
        ops.reset_launches()
        with torch.set_grad_enabled(grad_on):
            out = ops.flash_attention(qq, k, v)
        assert out.grad_fn is None and ops.LAUNCHES["flash_attention"] == 1


def _smoke_train(cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import init_lm, with_parameters
    from repro_torch.train.data import SyntheticLM

    cfg = smoke_config("tinyllama-1.1b")
    cpu_model = init_lm(cfg, 0, device="cpu")
    model = with_parameters(cpu_model, {n: p.to(cuda) for n, p
                                        in cpu_model.named_parameters()})
    batch = SyntheticLM(cfg, seed=0).batch(0, 4, 64)
    return cfg, model, cpu_model, batch


@pytest.mark.parametrize("remat,per_layer", [("nothing", 2), ("dots", 2),
                                             ("none", 1)])
def test_train_step_launches_per_step(cuda, remat, per_layer):
    """A train step launches the flash kernel once a layer, and once more
    a layer in the backward where a checkpoint recomputes the period."""
    from dataclasses import replace

    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step

    cfg, model, _, batch = _smoke_train(cuda)
    cfg = replace(cfg, remat=remat)
    opt_cfg = AdamWConfig()
    step = build_train_step(cfg, opt_cfg)
    opt = init_opt_state(model, opt_cfg)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    for _ in range(2):
        ops.reset_launches()
        model, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == per_layer * cfg.num_layers


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 train step of the smoke tinyllama on the card against the
    plain path on the CPU from the same weights: the loss rtol 1e-5, each
    gradient leaf within 1e-4 of its max|g| (none zero, wq/wk/wv
    included), and the parameters after the step within 1e-5 (Adam moves
    each by about ±lr₁ = 3e-6, so a rounding-noise gradient costs at most
    6e-6)."""
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step, loss_and_grads

    cfg, model, cpu_model, batch = _smoke_train(cuda)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    loss, grads = loss_and_grads(model, card_batch, cfg)
    loss0, grads0 = loss_and_grads(cpu_model, batch, cfg)
    assert abs(float(loss) - float(loss0)) <= 1e-5 * abs(float(loss0))
    for name, g0 in grads0.items():
        scale = float(g0.abs().max())
        assert scale > 0 and float(grads[name].abs().max()) > 0, name
        assert float((grads[name].cpu() - g0).abs().max()) <= 1e-4 * scale, name
    opt_cfg = AdamWConfig()
    step = build_train_step(cfg, opt_cfg)
    new, _, m = step(model, init_opt_state(model, opt_cfg), card_batch)
    new0, _, m0 = step(cpu_model, init_opt_state(cpu_model, opt_cfg), batch)
    for (name, p), (_, p0) in zip(new.named_parameters(), new0.named_parameters()):
        assert float((p.cpu() - p0).abs().max()) <= 1e-5, name


def test_mesh_train_step_on_card_matches_unsharded(cuda):
    """A (1, 1) mesh on the card (an NCCL group of one rank): the
    parameters and moments are DTensors, the flash kernel runs through
    local_map as often as unsharded (twice a layer under remat
    "nothing"), and two steps' losses and parameters equal the
    unsharded step's within 1e-5 (another op sequence, the same sums)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distrib.sharding import full, make_rules, use_rules
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import place_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step

    cfg, model, _, batch = _smoke_train(cuda)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    opt_cfg = AdamWConfig()
    step = build_train_step(cfg, opt_cfg)
    plain, opt, losses = model, init_opt_state(model, opt_cfg), []
    for _ in range(2):
        plain, opt, m = step(plain, opt, batch)
        losses.append(float(m["loss"]))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh((1, 1), device_type="cuda")
        rules = make_rules(mesh, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads)
        with use_rules(rules):
            _, sharded, _, _ = _smoke_train(cuda)
            sharded = place_params(sharded, rules)
            opt = init_opt_state(sharded, opt_cfg)
            assert all(isinstance(p, DTensor) for p in sharded.parameters())
            for i in range(2):
                ops.reset_launches()
                sharded, opt, m = step(sharded, opt, batch)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
                assert abs(float(m["loss"]) - losses[i]) <= 1e-5 * losses[i]
            for (name, p), (_, q) in zip(sharded.named_parameters(),
                                         plain.named_parameters()):
                assert float((full(p) - q).abs().max()) <= 1e-5, name
    finally:
        dist.destroy_process_group()
