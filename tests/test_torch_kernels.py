"""The port's kernels: plain versions against the reference's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them), and the
cipher against the reference bit for bit. The CUDA kernels themselves are
held against these plain versions in tests/test_torch_cuda.py.

Tolerances: CED is exact (one IEEE division or multiplication per
element, then a relayout), so it is compared bit for bit. The LU panel
and the triangular solves are compared at rtol 1e-12: the same
arithmetic summed in a different order and with different FMA
contraction.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.core import cipher as t_cipher
from repro_torch.core import keygen as t_keygen
from repro_torch.core import seed as t_seed
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.ced import ced_cuda
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.lu_panel import lu_panel_cuda, max_tile
from repro_torch.kernels.trsm import trsm_lower_cuda, trsm_upper_right_cuda

r_cipher, r_keygen, r_seed = (
    importlib.import_module(f"repro.core.{name}")
    for name in ("cipher", "keygen", "seed")
)

RTOL = 1e-12


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _dominant(shape, seed):
    """Diagonally dominant tiles: the no-pivot elimination is stable."""
    b = shape[-1]
    return _rand(shape, seed) + b * np.eye(b)


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol · max|want| elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), np.finfo(np.float64).tiny)
    assert float(np.abs(got - want).max()) <= rtol * scale


# ------------------------------------------------------------------- CED
@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["ewd", "ewm"])
@pytest.mark.parametrize("growth_safe", [False, True])
def test_ced_ref_bit_equal_to_pallas(k, mode, growth_safe):
    """Odd n = 13 takes the reference's one-element block fallback."""
    n = 13
    m = _rand((n, n), k)
    v = np.random.default_rng(100 + k).uniform(0.5, 2.0, n)
    want = r_ops.ced(jnp.asarray(m), jnp.asarray(v), k, mode=mode,
                     growth_safe=growth_safe, interpret=True)
    got = ref.ced_ref(torch.from_numpy(m), torch.from_numpy(v), k, mode=mode,
                      growth_safe=growth_safe)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3])
def test_ced_ref_batched_bit_equal_to_pallas(k):
    m = _rand((3, 12, 12), k)
    v = np.random.default_rng(7).uniform(0.5, 2.0, (3, 12))
    want = r_ops.ced(jnp.asarray(m), jnp.asarray(v), k, block=4,
                     interpret=True)
    got = ops.ced(torch.from_numpy(m), torch.from_numpy(v), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ced_ref_rejects_unknown_mode():
    m = torch.ones(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.ced(m, torch.ones(4, dtype=torch.float64), 1, mode="xor")


@pytest.mark.parametrize("n", [13, 16])
@pytest.mark.parametrize("mode", ["ewd", "ewm"])
@pytest.mark.parametrize("growth_safe", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cipher_bit_equal_to_reference(n, mode, growth_safe, dtype):
    """Seeds 0..5 cover every rotation degree."""
    for seed in range(6):
        m = _dominant((n, n), seed).astype(dtype)
        r_s, t_s = r_seed.seedgen(128, m), t_seed.seedgen(128, m)
        want_x, want_meta = r_cipher.cipher(
            jnp.asarray(m), r_keygen.keygen(128, r_s, n), r_s, mode=mode,
            growth_safe=growth_safe)
        got_x, got_meta = t_cipher.cipher(
            torch.from_numpy(m), t_keygen.keygen(128, t_s, n), t_s,
            mode=mode, growth_safe=growth_safe)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        assert dataclasses.astuple(got_meta) == dataclasses.astuple(want_meta)


@pytest.mark.parametrize("growth_safe", [False, True])
def test_cipher_batch_bit_equal_to_reference_and_kernel(growth_safe):
    """A batch of 6 mixes rotation degrees: the port groups by k, the
    reference runs one vmapped program and, with use_kernel, one Pallas
    launch per k."""
    m = _dominant((6, 12, 12), 3)
    seeds = r_seed.seedgen_batch(128, m)
    v = r_keygen.keygen_batch(128, seeds, 12)
    assert len({r_seed.seedgen(128, mi).psi // 1 % 3 for mi in m}) > 1
    want_x, want_metas = r_cipher.cipher_batch(
        jnp.asarray(m), v, seeds, growth_safe=growth_safe)
    kern_x, _ = r_cipher.cipher_batch(
        jnp.asarray(m), v, seeds, growth_safe=growth_safe, use_kernel=True)
    t_seeds = t_seed.seedgen_batch(128, m)
    got_x, got_metas = t_cipher.cipher_batch(
        torch.from_numpy(m), t_keygen.keygen_batch(128, t_seeds, 12), t_seeds,
        growth_safe=growth_safe,
    )
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(kern_x))
    assert [dataclasses.astuple(a) for a in got_metas] \
        == [dataclasses.astuple(a) for a in want_metas]


def test_cipher_batch_launches_once_per_rotation_degree(monkeypatch):
    calls = []
    real = ref.ced_ref

    def spy(m, v, k, **kw):
        calls.append(k)
        return real(m, v, k, **kw)

    monkeypatch.setattr(ref, "ced_ref", spy)
    m = _dominant((6, 8, 8), 3)
    seeds = t_seed.seedgen_batch(128, m)
    t_cipher.cipher_batch(torch.from_numpy(m),
                          t_keygen.keygen_batch(128, seeds, 8), seeds)
    ks = {t_cipher.rotate_degree(s.psi) for s in seeds}
    assert sorted(calls) == sorted(ks) and len(calls) <= 3


# --------------------------------------------------------------- LU panel
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (48, 48), (3, 32, 32)])
def test_lu_panel_ref_matches_pallas(shape):
    a = _dominant(shape, shape[-1])
    want = r_ops._lu_panel_compact(jnp.asarray(a), interpret=True)
    got = ref.lu_panel_ref(torch.from_numpy(a))
    _close(got.numpy(), want)


def test_lu_panel_ref_leaves_input_and_reads_views():
    a = torch.from_numpy(_dominant((40, 40), 1))
    before = a.clone()
    view = a[4:36, 4:36]
    got = ops.lu_panel(view)
    assert torch.equal(a, before)
    _close(got.numpy(), ref.lu_panel_ref(view.contiguous()).numpy(), rtol=0)


# ------------------------------------------------------------------- TRSM
@pytest.mark.parametrize("n,m", [(32, 96), (48, 32), (17, 5)])
def test_trsm_refs_match_pallas(n, m):
    l = np.tril(_rand((n, n), n), -1) + np.eye(n)
    u = np.triu(_rand((n, n), n + 1)) + n * np.eye(n)
    b = _rand((n, m), m)
    b2 = _rand((m, n), m + 1)
    _close(ref.trsm_lower_ref(torch.from_numpy(l), torch.from_numpy(b)).numpy(),
           r_ops.trsm_lower(jnp.asarray(l), jnp.asarray(b), interpret=True))
    _close(ref.trsm_upper_right_ref(torch.from_numpy(u),
                                    torch.from_numpy(b2)).numpy(),
           r_ops.trsm_upper_right(jnp.asarray(u), jnp.asarray(b2),
                                  interpret=True))


def test_trsm_refs_batched_match_pallas():
    l = np.tril(_rand((2, 32, 32), 1), -1) + np.eye(32)
    u = np.triu(_rand((2, 32, 32), 2)) + 32 * np.eye(32)
    b = _rand((2, 32, 64), 3)
    _close(ref.trsm_lower_ref(torch.from_numpy(l), torch.from_numpy(b)).numpy(),
           r_ops.trsm_lower(jnp.asarray(l), jnp.asarray(b), interpret=True))
    b2 = _rand((2, 64, 32), 4)
    _close(ref.trsm_upper_right_ref(torch.from_numpy(u),
                                    torch.from_numpy(b2)).numpy(),
           r_ops.trsm_upper_right(jnp.asarray(u), jnp.asarray(b2),
                                  interpret=True))


def test_trsm_refs_read_only_their_triangle():
    """The panel loop passes the compact LU tile as both triangles."""
    compact = torch.from_numpy(_dominant((24, 24), 5))
    b = torch.from_numpy(_rand((24, 8), 6))
    l = torch.tril(compact, -1) + torch.eye(24, dtype=compact.dtype)
    assert torch.equal(ops.trsm_lower(compact, b), ops.trsm_lower(l, b))
    b2 = torch.from_numpy(_rand((8, 24), 7))
    assert torch.equal(ops.trsm_upper_right(compact, b2),
                       ops.trsm_upper_right(torch.triu(compact), b2))


def test_dispatch_counts_no_launch_on_cpu():
    ops.reset_launches()
    ops.lu_panel(torch.from_numpy(_dominant((8, 8), 0)))
    q = torch.from_numpy(_rand((1, 2, 4, 8), 1)).float()
    ops.flash_attention(q, q, q)
    assert "flash_attention" in ops.LAUNCHES
    assert all(v == 0 for v in ops.LAUNCHES.values())


# ------------------------------------------------ wrappers and the build
@pytest.mark.parametrize("launch", [
    lambda t: ced_cuda(t, t[0], 1),
    lambda t: lu_panel_cuda(t),
    lambda t: trsm_lower_cuda(t, t),
    lambda t: trsm_upper_right_cuda(t, t),
    lambda t: flash_attention_cuda(*(t.float()[None, None],) * 3),
], ids=["ced", "lu_panel", "trsm_lower", "trsm_upper_right", "flash_attention"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """A wrapper launches its kernel or raises; only ops routes CPU
    tensors to the plain versions."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.eye(4, dtype=torch.float64))


def test_dispatch_refuses_mixed_and_unknown_devices():
    cpu = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.trsm_lower(cpu, torch.eye(4, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError):
        ops.lu_panel(torch.eye(4, dtype=torch.float64, device="meta"))
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError):
        ops.flash_attention(*(q.to("meta"),) * 3)


def test_max_tile_fits_shared_memory():
    for dtype, itemsize in ((torch.float64, 8), (torch.float32, 4)):
        b = max_tile(dtype)
        assert b * b * itemsize <= 232448 < (b + 1) ** 2 * itemsize
    assert max_tile(torch.float64) == 170


@pytest.mark.parametrize("b,hkv,group,sq,sk", [
    (4, 4, 8, 1, 2048), (1, 2, 2, 8, 4), (2, 4, 8, 1, 333),
    (64, 4, 8, 1, 2048), (4, 4, 8, 16, 2048), (1, 1, 32, 16, 100000),
])
def test_flash_decode_split_covers_the_keys_and_fills_the_card(
        b, hkv, group, sq, sk):
    """Whole key tiles per chunk, every key in exactly one chunk, no empty
    chunk, a split that depends on Sk alone (so a row's output does not
    depend on the batch), and a block per SM at tinyllama's decode."""
    from repro_torch.kernels import flash_attn

    chunk, n = flash_attn.decode_split(sk)
    tiles = -(-sk // flash_attn.KEY_TILE)
    assert chunk == flash_attn.CHUNK_TILES * flash_attn.KEY_TILE
    assert (n - 1) * chunk < sk <= n * chunk
    assert 1 <= n <= tiles
    blocks = b * hkv * -(-group * sq // flash_attn.BLOCK_ROWS) * n
    if b * hkv >= 16 and sk >= 2048:  # tinyllama, batch >= 4
        assert blocks >= 132


@pytest.mark.parametrize("n,launches", [(32, 1), (64, 1), (65, 3), (256, 7),
                                        (1024, 31), (0, 0)])
def test_trsm_launches_per_call(n, launches):
    """One leaf solve per 64 rows and one update between each two."""
    from repro_torch.kernels import trsm

    assert trsm.cuda_launches(n) == launches


def test_flash_launches_per_call_on_cpu_shapes():
    """f32 and prefill are one launch; a bf16 decode is two once its keys
    span more than one chunk."""
    from repro_torch.kernels import flash_attn

    q = torch.zeros(1, 4, 32, 8)
    assert flash_attn.cuda_launches(q, q[:, :2]) == 1
    assert flash_attn.cuda_launches(q[:, :, :1], q[:, :2]) == 1
    assert flash_attn.cuda_launches(q.bfloat16(), q[:, :2].bfloat16()) == 1
    kv = torch.zeros(1, 2, 129, 8, dtype=torch.bfloat16)
    assert flash_attn.cuda_launches(q[:, :, :1].bfloat16(), kv[:, :, :128]) == 1
    assert flash_attn.cuda_launches(q[:, :, :1].bfloat16(), kv) == 2


def test_build_names_libraries_by_content_and_flags():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.target(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path == build.target(name)
    assert len({build.target(n) for n in build.SOURCES}) == len(build.SOURCES)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    if (build.Path("/usr/local/cuda") / "bin" / "nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default location")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
