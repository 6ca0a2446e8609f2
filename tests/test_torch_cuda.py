"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is false. The file imports neither jax nor the reference package, so it
runs on a machine that has only PyTorch; there, without the JAX-side
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: CED bit for bit; the panel LU and the triangular solves within
1e-12 of max|plain| (the same arithmetic, another FMA contraction and
summation order).
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
    assert all(count > 0 for count in ops.LAUNCHES.values()), ops.LAUNCHES
    want = repro_torch.outsource_determinant(m, 4, device="cpu")
    assert got.verified and want.verified
    assert got.det.allclose(want.det)
