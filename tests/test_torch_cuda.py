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


# --- the tensor-core flash kernel's decode path and the blocked TRSM ------

def _bf16_close_to_mean(got, v, rows, group):
    """The first `rows` query rows against the mean of V over its keys,
    per query head's kv head, within bf16's rounding of the output."""
    mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(group, dim=1)
    err = (got[:, :, :rows].float() - mean).abs()
    eps = torch.finfo(got.dtype).eps
    assert bool((err <= 2 * eps * mean.abs() + eps / 8
                 * float(v.float().abs().max())).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,sq,sk", [
    (4, 32, 4, 1, 2048),
    (2, 8, 8, 1, 500),
    (2, 16, 2, 16, 700),
], ids=["group8-full-width", "group1", "group8-16-rows"])
def test_flash_decode_packs_gqa_groups(cuda, dtype, b, hq, hkv, sq, sk):
    from repro_torch.kernels import flash_attn

    q, k, v = _qkv(cuda, b, hq, hkv, sq, sk, 64, dtype, seed=sk,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)
    want = 1 if dtype == torch.float32 else 2  # split keys, then merge
    assert flash_attn.cuda_launches(q, k) == want


@pytest.mark.parametrize("sk", [333, 40, 64, 65], ids=[
    "ragged-chunks", "under-one-chunk", "one-tile", "one-tile-and-one-key"])
def test_flash_decode_ragged_key_chunks(cuda, sk):
    q, k, v = _qkv(cuda, 2, 8, 2, 1, sk, 64, torch.bfloat16, seed=sk)
    _flash_close(q, k, v, causal=True)


def test_flash_decode_split_fully_masked_rows_are_mean_of_v(cuda, monkeypatch):
    """Sq 8 > Sk 5: the first three rows see no key. Forced into chunks
    of 2 keys, every chunk of such a row has m = -1e30, so the merge
    weighs the chunks by their l and returns the mean over all 5 keys."""
    from repro_torch.kernels import flash_attn

    monkeypatch.setattr(flash_attn, "decode_split", lambda *a: (2, 3))
    q, k, v = _qkv(cuda, 1, 4, 2, 8, 5, 16, torch.bfloat16, seed=11)
    got = _flash_close(q, k, v, causal=True)
    _bf16_close_to_mean(got, v, 3, 2)


@pytest.mark.parametrize("sq,window", [(1, 40), (4, 8), (16, 100)])
def test_flash_decode_window_inside_one_chunk(cuda, sq, window):
    """The window covers keys of the last chunk only: every earlier chunk
    visits no tile and must weigh nothing in the merge."""
    q, k, v = _qkv(cuda, 2, 8, 2, sq, 2048, 64, torch.bfloat16, seed=sq)
    _flash_close(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_prefill_bf16_head_dims(cuda, d):
    q, k, v = _qkv(cuda, 2, 8, 2, 300, 300, d, torch.bfloat16, seed=d,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)


def test_flash_f32_full_width_within_tolerance(cuda):
    """f32 stays exact f32 (no TF32): the serving shapes within
    1e-5 · max|v|."""
    q, k, v = _qkv(cuda, 4, 32, 4, 2048, 2048, 64, torch.float32, seed=3,
                   layout="bshd")
    _flash_close(q, k, v, causal=True)
    _flash_close(q[:, :, -1:], k, v, causal=True)


def test_flash_decode_same_bits_run_to_run(cuda):
    """The chunks merge in a fixed order: two calls give the same bits."""
    q, k, v = _qkv(cuda, 4, 32, 4, 1, 2048, 64, torch.bfloat16, seed=9,
                   layout="bshd")
    first = ops.flash_attention(q, k, v, causal=True)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(q, k, v, causal=True), first)


def test_flash_decode_rows_same_bits_at_any_batch(cuda):
    """The key chunks depend on Sk alone: a batch element's decode rows
    have the same bits alone as in a batch of four."""
    q, k, v = _qkv(cuda, 4, 32, 4, 1, 2048, 64, torch.bfloat16, seed=10,
                   layout="bshd")
    whole = ops.flash_attention(q, k, v, causal=True)
    for i in (0, 3):
        one = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)
        assert torch.equal(one, whole[i:i + 1])


def _profiled_launches(fn, reps=4):
    """Device events (kernels and copies) one call of fn puts on the
    card, counted by torch.profiler over `reps` calls. Started cold, the
    profiler misses a window's first launches, so the window opens with
    64 one-element fills and a pause, and only the events after the
    timed range opens count (as chip_smoke.py's device_events)."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.fill_(0.0)
        torch.cuda.synchronize()
        time.sleep(0.01)
        with record_function("timed"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    opened = min(e.time_range.start for e in prof.events()
                 if e.name == "timed" and e.device_type != cuda_type)
    events = [e for e in prof.events() if e.device_type == cuda_type
              and e.name != "timed" and e.time_range.start >= opened - 5000]
    assert len(events) % reps == 0, len(events)
    return len(events) // reps


@pytest.mark.parametrize("case", ["trsm-strip", "trsm-1024", "trsm-ragged",
                                  "flash-prefill", "flash-decode-split",
                                  "flash-decode-one-chunk", "flash-f32-decode"])
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
                     "flash-f32-decode": (1, 2048, torch.float32)}[case]
    q, k, v = _qkv(cuda, 2, 8, 2, sq, sk, 64, dtype, seed=sk)
    got = _profiled_launches(lambda: ops.flash_attention(q, k, v, causal=True))
    assert got == flash_attn.cuda_launches(q, k)


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
    """n not a multiple of the 64-row leaf, and stacks of several
    matrices; f32 updates run on the FMA pipes, in f32."""
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


def test_flash_kernel_rows_off_16_bytes(cuda):
    """Operands whose rows do not start on 16 bytes (an odd element
    offset and odd strides) copy element by element instead of by
    cp.async, with the same result."""
    rng = np.random.default_rng(12)

    def odd(b, h, s, d):
        flat = torch.from_numpy(rng.standard_normal(b * h * s * (d + 1) + 1))
        flat = flat.to(cuda, torch.bfloat16)
        return flat[1:].view(b, h, s, d + 1)[..., :d]

    q, k, v = odd(2, 8, 40, 64), odd(2, 2, 90, 64), odd(2, 2, 90, 64)
    _flash_close(q, k, v, causal=True)
    _flash_close(q[:, :, :1], k, v, causal=True)
