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
from repro_torch.kernels import build, ops, ref, routes, schur
from repro_torch.kernels.ced import ced_cuda
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.lu_panel import lu_panel_cuda, max_tile
from repro_torch.kernels.schur import schur_update_cuda
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
    lambda t: schur_update_cuda(t, t, t),
    lambda t: schur.tma_operands(t.bfloat16(), t.bfloat16()),
], ids=["ced", "lu_panel", "trsm_lower", "trsm_upper_right", "flash_attention",
        "schur_update", "schur_tma_operands"])
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lu_panel_route_by_width(dtype):
    """One warp a tile up to 32 wide, one block a tile up to max_tile,
    an error above; the route takes b and the dtype, never the batch."""
    import inspect

    from repro_torch.kernels import lu_panel

    assert [lu_panel.route(b, dtype) for b in (1, 2, 31, 32)] == ["warp"] * 4
    assert ([lu_panel.route(b, dtype) for b in (33, 48, 64, max_tile(dtype))]
            == ["block"] * 4)
    with pytest.raises(ValueError, match="blocked"):
        lu_panel.route(max_tile(dtype) + 1, dtype)
    assert list(inspect.signature(lu_panel.route).parameters) == ["b", "dtype"]
    assert lu_panel.WARP_MAX == 32 and max_tile(torch.float64) == 170


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16, torch.float16])
def test_schur_grid_refuses_what_the_card_would_refuse(dtype):
    """65,535 blocks at most on the grid's y axis (row tiles: 128 rows for
    every route's kernel, DMMA, wgmma and FMA) and z axis (the batch)."""
    rows = schur.rows_per_block(dtype)
    assert rows == schur.TILE_ROWS[schur.device_kernel(dtype).split("<")[0]]
    assert rows == 128
    schur.check_grid(dtype, 65535, 65535 * rows)
    for batch, m in ((1, 65535 * rows + 1), (65536, 1)):
        with pytest.raises(ValueError, match="grid"):
            schur.check_grid(dtype, batch, m)


def test_schur_device_kernels_are_the_sources_templates():
    """Every route's device kernel in schur.KERNELS is a __global__
    template of csrc/schur.cu, launched by that route's entry point with
    the table's template arguments, and its row tile is the source's
    (schur.cu's, or that of ring.cuh, the header it shares with trsm.cu):
    chip_smoke.py checks the profiler's kernel names against this table."""
    import re

    src = (build.CSRC / "schur.cu").read_text()
    src += (build.CSRC / "ring.cuh").read_text()
    assert set(schur.KERNELS) == set(routes.ROUTES["schur_update"].values())
    tile = {"schur_dmma_kernel": "DM", "schur_fma_kernel": "FM",
            "schur_wgmma_kernel": "WM"}
    assert set(tile) == set(schur.TILE_ROWS)
    for suffix, name in schur.KERNELS.items():
        base, args = re.fullmatch(r"(\w+)<(.+)>", name).groups()
        assert re.search(r"template <typename \w+>\s*__global__ void\s+"
                         rf"(__launch_bounds__\([^)]*\)\s*)?{base}\(", src), name
        entry = re.search(rf"SCHUR_ENTRY\(schur_{suffix}, [\w ]+, "
                          r"launch_(\w+)<([^>]+)>\)", src)
        assert entry, suffix
        assert (f"schur_{entry.group(1)}_kernel", entry.group(2)) == (base, args)
        rows = re.search(rf"constexpr int {tile[base]} = (\d+);", src)
        assert int(rows.group(1)) == schur.TILE_ROWS[base]


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
    """Whole warp sub-tiles per chunk, every key in exactly one chunk, no
    empty chunk, a split that depends on Sk alone (so a row's output does
    not depend on the batch), and at tinyllama's decode a block on every
    SM: the f32 FMA kernel's block a chunk (132 or more), and the bf16/f16
    decode kernel's clusters of DECODE_CLUSTER blocks, each a row block's
    share of the chunks (128 or more: the card's 132 SMs rounded down to
    whole clusters of 8), both 16 packed rows a block."""
    from repro_torch.kernels import flash_attn

    chunk, n = flash_attn.decode_split(sk)
    tiles = -(-sk // flash_attn.KEY_TILE)
    assert chunk == flash_attn.CHUNK_TILES * flash_attn.KEY_TILE
    assert (n - 1) * chunk < sk <= n * chunk
    assert 1 <= n <= tiles
    assert set(flash_attn.PACKED_ROWS.values()) == {16}
    row_blocks = b * hkv * -(-group * sq // 16)
    per_row_block = {torch.float32: n,
                     torch.bfloat16: min(n, flash_attn.DECODE_CLUSTER)}
    if b * hkv >= 16 and sk >= 2048:  # tinyllama, batch >= 4
        assert row_blocks * per_row_block[torch.float32] >= 132
        assert row_blocks * per_row_block[torch.bfloat16] >= 128


@pytest.mark.parametrize("n,launches", [(32, 1), (128, 1), (129, 3), (256, 3),
                                        (1024, 15), (0, 0)])
def test_trsm_launches_per_call(n, launches):
    """One leaf solve per 128 rows and one product between each two."""
    from repro_torch.kernels import trsm

    assert trsm.cuda_launches(n) == launches


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 333, 1000, 1025,
                               4096])
def test_trsm_plan_hands_each_row_its_terms_in_order(n):
    """csrc/trsm.cu's recursion as trsm.plan lists it: cuda_launches(n)
    launches; leaves of at most LEAF rows in row order; each product's K a
    multiple of LEAF whose rows lie just below the rows it takes; and each
    row gets every term k below its own once, in ascending k (what keeps
    the narrow routes bit-equal to the plain substitution)."""
    from repro_torch.kernels import trsm

    steps = trsm.plan(n)
    assert len(steps) == trsm.cuda_launches(n)
    solved, got = 0, [0] * n  # rows solved; the next term each row takes
    for step in steps:
        if step[0] == "leaf":
            _, r0, rows = step
            assert r0 == solved and 0 < rows <= trsm.LEAF
            assert all(got[i] == r0 for i in range(r0, r0 + rows))
            solved += rows
        else:
            _, r0, k, rows = step
            assert k % trsm.LEAF == 0 and r0 + k == solved and rows > 0
            assert all(got[i] == r0 for i in range(r0 + k, r0 + k + rows))
            got[r0 + k:r0 + k + rows] = [r0 + k] * rows
    assert solved == n


def test_trsm_plan_splits_as_the_source():
    """trsm.plan mirrors csrc/trsm.cu's Solver::solve: the same leaf rows,
    and the split at LEAF · ⌈leaves / 2⌉."""
    import re

    from repro_torch.kernels import trsm

    src = (build.CSRC / "trsm.cu").read_text()
    assert int(re.search(r"constexpr int LEAF = (\d+);", src).group(1)) == trsm.LEAF
    assert "const int n1 = LEAF * ((leaves + 1) / 2);" in src


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("unit", [True, False])
def test_trsm_plan_solves_as_the_plain_substitution(dtype, unit):
    """The plan run with PyTorch's operators, as the kernels compute it
    (a leaf's substitution; a product's sum subtracted once in f64, term
    by term in the half types, each product and difference rounded):
    bit-equal to the plain version in bfloat16 and float16, within RTOL
    in f64."""
    from repro_torch.kernels import trsm

    n, m = 333, 5
    t = torch.from_numpy(np.tril(_rand((n, n), 41), -1) / n
                         + (1.0 if unit else n) * np.eye(n)).to(dtype)
    b = torch.from_numpy(_rand((n, m), 42)).to(dtype)
    w = b.clone()
    for step in trsm.plan(n):
        if step[0] == "leaf":
            _, r0, rows = step
            for k in range(r0, r0 + rows):
                if not unit:
                    w[k] = w[k] / t[k, k]
                w[k + 1:r0 + rows] -= t[k + 1:r0 + rows, k, None] * w[k]
            continue
        _, r0, k, rows = step
        below = slice(r0 + k, r0 + k + rows)
        if dtype == torch.float64:
            w[below] -= t[below, r0:r0 + k] @ w[r0:r0 + k]
        else:
            for q in range(r0, r0 + k):
                w[below] -= t[below, q, None] * w[q]
    if unit:
        want = ref.trsm_lower_ref(t, b)
    else:
        want = ref.trsm_left_ref(t, b, upper=False)
    if dtype == torch.float64:
        scale = float(want.abs().max())
        assert float((w - want).abs().max()) <= RTOL * scale
    else:
        assert torch.equal(w, want)


def test_flash_launches_per_call_on_cpu_shapes():
    """Prefill is one launch; an f32 decode is two once its keys span
    more than one chunk (the chunks, then their merge), a bf16 or f16
    decode one at any key count (its cluster merges the chunks)."""
    from repro_torch.kernels import flash_attn

    q = torch.zeros(1, 4, 32, 8)
    assert flash_attn.cuda_launches(q, q[:, :2]) == 1
    assert flash_attn.cuda_launches(q[:, :, :1], q[:, :2]) == 1
    assert flash_attn.cuda_launches(q.bfloat16(), q[:, :2].bfloat16()) == 1
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        kv = torch.zeros(1, 2, 129, 8, dtype=dtype)
        qd = q[:, :, :1].to(dtype)
        assert flash_attn.cuda_launches(qd, kv[:, :, :128]) == 1
        assert flash_attn.cuda_launches(qd, kv) == (2 if dtype == torch.float32
                                                   else 1)
        assert flash_attn.cuda_launches(qd, torch.zeros(1, 2, 8192, 8,
                                                        dtype=dtype)) == (
            2 if dtype == torch.float32 else 1)
        assert flash_attn.cuda_launches(q[:, :, :17].to(dtype), kv) == 1


def test_build_names_libraries_by_content_and_flags():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.target(name)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path == build.target(name)
    assert len({build.target(n) for n in build.SOURCES}) == len(build.SOURCES)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_times_each_nvcc_to_its_own_exit(monkeypatch, tmp_path):
    """Every source's compiler runs at once, and each source's seconds end
    at its own compiler's exit, not when an earlier one was waited for:
    with a stand-in compiler that takes 1.5 s for the first source and
    0.1 s for the others, the others read well under the first's time;
    each library and its log appear where the loader looks."""
    import sys
    import time

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "args = sys.argv[1:]\n"
        "time.sleep(1.5 if args[-1].endswith('ced.cu') else 0.1)\n"
        "print('ptxas info    : Used 1 registers')\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    names = ("ced", "lu_panel", "trsm", "schur", "flash_attn")
    t0 = time.perf_counter()
    seconds = build._build(names)
    assert time.perf_counter() - t0 < 1.5 + 1.0  # concurrent, not in turn
    assert set(seconds) == set(names)
    assert seconds["ced"] >= 1.5
    assert all(seconds[n] < 1.0 for n in names[1:]), seconds
    for name in names:
        assert build.target(name).read_text() == "lib"
        assert "Used 1 registers" in open(f"{build.target(name)}.log").read()
    assert build._build(names) == {}  # built: nothing to compile


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    if (build.Path("/usr/local/cuda") / "bin" / "nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default location")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


# ------------------------------------------------- mixed acc_dtype routes
#: (port storage, port arithmetic, reference storage, reference arithmetic)
MIXED = {
    "f32->f64": (torch.float32, torch.float64, jnp.float32, jnp.float64),
    "bf16->f32": (torch.bfloat16, torch.float32, jnp.bfloat16, jnp.float32),
    "f16->f32": (torch.float16, torch.float32, jnp.float16, jnp.float32),
}


def _pair(x, mixed):
    """The same numpy array rounded to the pair's storage type, as a port
    tensor and a reference array (bf16 goes through torch, which numpy
    cannot hold)."""
    st, _, jst, _ = MIXED[mixed]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(st)
    return t, jnp.asarray(t.float().numpy(), dtype=jst)


def _within_ulps(got, want, dtype, ulps=4):
    """|got − want| <= ulps · eps(storage) · max|want|: both round once to
    the storage type at the same point, from wide values that differ by
    summation order only."""
    got = got.float().double().numpy()
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    eps = torch.finfo(dtype).eps
    assert np.abs(got - want).max() <= ulps * eps * np.abs(want).max()


@pytest.mark.parametrize("mixed", list(MIXED))
@pytest.mark.parametrize("shape", [(32, 32), (48, 48), (3, 32, 32)],
                         ids=["32", "48", "batched"])
def test_lu_panel_mixed_matches_pallas(mixed, shape):
    st, acc, _, jacc = MIXED[mixed]
    t, j = _pair(_dominant(shape, shape[-1] + 1), mixed)
    want = r_ops._lu_panel_compact(j, interpret=True, acc_dtype=jacc)
    got = ops.lu_panel(t, acc_dtype=acc)
    assert got.dtype == st
    _within_ulps(got, want, st)


@pytest.mark.parametrize("mixed", list(MIXED))
def test_lu_panel_mixed_reads_strided_views(mixed):
    """The panel loop passes a[..., s0:s1, s0:s1] views of its tile."""
    st, acc, _, jacc = MIXED[mixed]
    t, j = _pair(_dominant((64, 64), 9), mixed)
    view = t[16:48, 16:48]
    assert not view.is_contiguous()
    want = r_ops._lu_panel_compact(j[16:48, 16:48], interpret=True,
                                   acc_dtype=jacc)
    _within_ulps(ops.lu_panel(view, acc_dtype=acc), want, st)


@pytest.mark.parametrize("mixed", list(MIXED))
@pytest.mark.parametrize("lead", [(), (2,)], ids=["2d", "batched"])
def test_trsm_mixed_match_pallas(mixed, lead):
    st, acc, _, jacc = MIXED[mixed]
    n, m = 48, 64
    l = np.tril(_rand((*lead, n, n), 1), -1) / n + np.eye(n)
    u = np.triu(_rand((*lead, n, n), 2)) + n * np.eye(n)
    (tl, jl), (tu, ju) = _pair(l, mixed), _pair(u, mixed)
    (tb, jb), (tb2, jb2) = _pair(_rand((*lead, n, m), 3), mixed), \
        _pair(_rand((*lead, m, n), 4), mixed)
    _within_ulps(ops.trsm_lower(tl, tb, acc_dtype=acc),
                 r_ops.trsm_lower(jl, jb, interpret=True, acc_dtype=jacc), st)
    _within_ulps(ops.trsm_upper_right(tu, tb2, acc_dtype=acc),
                 r_ops.trsm_upper_right(ju, jb2, interpret=True,
                                        acc_dtype=jacc), st)


@pytest.mark.parametrize("mixed", list(MIXED))
def test_trsm_mixed_read_strided_views_of_the_compact_tile(mixed):
    """lu_panel_blocked solves against the compact tile's triangle and
    its strips, all views of one matrix."""
    st, acc, _, jacc = MIXED[mixed]
    t, j = _pair(_dominant((96, 96), 5), mixed)
    tri, right, below = t[:32, :32], t[:32, 32:], t[32:, :32]
    jtri = j[:32, :32]
    jl = jnp.tril(jtri, -1) + jnp.eye(32, dtype=jtri.dtype)
    _within_ulps(ops.trsm_lower(tri, right, acc_dtype=acc),
                 r_ops.trsm_lower(jl, j[:32, 32:], interpret=True,
                                  acc_dtype=jacc), st)
    _within_ulps(ops.trsm_upper_right(tri, below, acc_dtype=acc),
                 r_ops.trsm_upper_right(jnp.triu(jtri), j[32:, :32],
                                        interpret=True, acc_dtype=jacc), st)


@pytest.mark.parametrize("mixed", list(MIXED))
@pytest.mark.parametrize("lead,m,k,n", [((), 64, 256, 96), ((2,), 32, 48, 64),
                                        ((), 96, 32, 96)],
                         ids=["2d-K256", "batched", "inner-K32"])
def test_schur_mixed_matches_pallas(mixed, lead, m, k, n):
    """Pallas rounds each 128-deep chunk's product to the storage type
    before it subtracts; the port sums all of K wide and rounds once. So
    the bound is elementwise (2⌈K/128⌉ + 1)·u·(|C| + |A|·|B|), u the
    storage type's unit roundoff."""
    st, acc, _, jacc = MIXED[mixed]
    (tc, jc), (ta, ja), (tb, jb) = (_pair(_rand((*lead, *s), i), mixed)
                                    for i, s in enumerate([(m, n), (m, k),
                                                           (k, n)]))
    got = ops.schur_update(tc, ta, tb, acc_dtype=acc)
    assert got.dtype == st
    want = np.asarray(r_ops.schur_update(jc, ja, jb, acc_dtype=jacc),
                      dtype=np.float64)
    c, a, b = (x.float().double().numpy() for x in (tc, ta, tb))
    scale = np.abs(c) + np.abs(a) @ np.abs(b)
    u = torch.finfo(st).eps / 2
    bound = (2 * -(-k // 128) + 1) * u * scale
    assert np.all(np.abs(got.float().double().numpy() - want) <= bound)


def test_schur_mixed_f32_sums_all_of_k_wide():
    """The port's mixed Schur is C − A·B computed in f64 and rounded to
    f32 once: within half an f32 ulp of the f64 result."""
    (tc, _), (ta, _), (tb, _) = (_pair(_rand(s, i), "f32->f64")
                                 for i, s in enumerate([(64, 64), (64, 512),
                                                        (512, 64)]))
    got = ops.schur_update(tc, ta, tb, acc_dtype=torch.float64)
    exact = tc.double() - ta.double() @ tb.double()
    assert torch.equal(got, exact.float())


@pytest.mark.parametrize("kernel", ["lu_panel", "trsm_lower",
                                    "trsm_upper_right", "schur_update"])
def test_acc_dtype_pairs_default_and_refused(kernel):
    """None or the storage type is the default route; the mixed pairs
    are f32 → f64 and bf16/f16 → f32 or f64 (for schur_update bf16/f16 →
    f32 is its default); an acc_dtype narrower than the storage type
    raises TypeError."""
    f16, bf16, f32, f64 = torch.float16, torch.bfloat16, torch.float32, torch.float64
    for dtype in (f32, f64, bf16, f16):
        assert ops.accumulator(kernel, dtype, None) is None
        assert ops.accumulator(kernel, dtype, dtype) is None
    assert ops.accumulator(kernel, f32, f64) == f64
    half = None if kernel == "schur_update" else f32
    assert ops.accumulator(kernel, bf16, f32) is half
    assert ops.accumulator(kernel, f16, f32) is half
    assert ops.accumulator(kernel, bf16, f64) == f64
    assert ops.accumulator(kernel, f16, f64) == f64
    for dtype, acc in ((f64, f32), (f32, f16), (f64, bf16), (bf16, f16)):
        with pytest.raises(TypeError, match="not a route"):
            ops.accumulator(kernel, dtype, acc)
    x = torch.eye(8, dtype=f32)
    call = {"lu_panel": lambda: ops.lu_panel(x, acc_dtype=f16),
            "trsm_lower": lambda: ops.trsm_lower(x, x, acc_dtype=f16),
            "trsm_upper_right": lambda: ops.trsm_upper_right(x, x, acc_dtype=f16),
            "schur_update": lambda: ops.schur_update(x, x, x, acc_dtype=f16)}
    with pytest.raises(TypeError, match="not a route"):
        call[kernel]()


@pytest.mark.parametrize("kernel", sorted(routes.ROUTES))
def test_route_table_names_every_entry_point(kernel):
    """One table holds the routes: every (storage, arithmetic) pair of a
    kernel resolves to an entry point its wrapper binds, the default
    route of each storage type included, and the build layer knows no
    dtypes."""
    from repro_torch.kernels import lu_panel, schur, trsm

    bound = {"lu_panel": lu_panel._SIGNATURES, "trsm_lower": trsm._SIGNATURES,
             "trsm_upper_right": trsm._SIGNATURES,
             "trsm_left": trsm._SIGNATURES,
             "schur_update": schur._SIGNATURES}[kernel]
    prefix = {"lu_panel": "lu_panel_", "schur_update": "schur_"}.get(
        kernel, "trsm_")
    for (storage, arith), suffix in routes.ROUTES[kernel].items():
        assert prefix + suffix in bound
        acc = routes.accumulator(kernel, storage, arith)
        assert routes.suffix(kernel, storage, acc) == suffix
        assert routes.suffix(kernel, storage, arith) == suffix
    assert not hasattr(build, "torch")


def test_mixed_panel_route_keys_off_the_accumulator():
    """The block route holds its tile at the arithmetic type, so an f32
    tile computed in f64 fits up to 170 wide, not f32's 241."""
    from repro_torch.kernels import lu_panel

    assert max_tile(torch.float32) == 241
    assert lu_panel.route(200, torch.float32) == "block"
    with pytest.raises(ValueError, match="blocked"):
        lu_panel.route(200, torch.float64)
    for suffix in ("f32_f64", "bf16_f32", "f16_f32", "bf16_f64", "f16_f64",
                   "bf16", "f16"):
        assert suffix in routes.ROUTES["lu_panel"].values()
    # the narrow default routes of the panel; trsm_left has none
    assert routes.suffix("lu_panel", torch.float16, None) == "f16"
    assert lu_panel.route(340, torch.bfloat16) == "block"
    with pytest.raises(TypeError, match="no CUDA route"):
        routes.suffix("trsm_left", torch.float16, None)
    # the mixed Schur route runs the f64 DMMA kernel's 128-row blocks, the
    # f32 route the FMA kernel's, also 128 rows
    assert schur.device_kernel(torch.float32, torch.float64) == (
        "schur_dmma_kernel<float>")
    assert schur.rows_per_block(torch.float32, torch.float64) == 128
    assert schur.rows_per_block(torch.bfloat16, torch.float64) == 128
    assert schur.device_kernel(torch.float32) == "schur_fma_kernel<float>"
    assert schur.rows_per_block(torch.float32) == schur.TILE_ROWS[
        "schur_fma_kernel"] == 128
