"""The port's flash attention (its plain version, which the CPU runs)
against the reference's Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, and against the reference's jnp oracle.

Tolerances: f32 within 3e-5 and bf16 within 2e-2, absolute on standard
normal inputs, the bounds tests/test_kernels.py holds the Pallas kernel
to: both sides accumulate in f32 and differ in summation order (bf16
also in where P and the output are rounded). The CUDA kernel is held
against the same plain version in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops

TOL = {np.float32: 3e-5, "bfloat16": 2e-2}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _pallas(q, k, v, dtype=np.float32, **kw):
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" \
        else jnp.asarray
    out = r_ops.flash_attention(cast(q), cast(k), cast(v), bq=16, bk=16,
                                interpret=True, **kw)
    return np.asarray(out, dtype=np.float32)


def _port(q, k, v, dtype=np.float32, **kw):
    cast = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if dtype == "bfloat16" else torch.from_numpy
    ops.reset_launches()
    out = ops.flash_attention(cast(q), cast(k), cast(v), **kw)
    assert ops.LAUNCHES["flash_attention"] == 0  # the plain version
    return out.float().numpy()


def _oracle(q, k, v, **kw):
    return np.asarray(r_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_matches_pallas_and_oracle(hq, hkv, causal):
    q, k, v = _inputs(2, hq, hkv, 32, 32, 16, seed=hq + hkv)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=causal), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=causal), atol=3e-5)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_sliding_window_matches_pallas(window):
    q, k, v = _inputs(1, 2, 2, 48, 48, 16, seed=window)
    got = _port(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(
        got, _pallas(q, k, v, causal=True, window=window), atol=3e-5)
    np.testing.assert_allclose(
        got, _oracle(q, k, v, causal=True, window=window), atol=3e-5)


@pytest.mark.parametrize("sq", [1, 4])
def test_decode_right_aligned_matches_pallas(sq):
    """sq < sk: the queries are the last sq positions (decode)."""
    q, k, v = _inputs(2, 4, 2, sq, 48, 16, seed=sq)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)


def test_ragged_lengths_match_pallas():
    """50 queries over 77 keys: the Pallas wrapper halves its tiles until
    they divide; the port has no tiles to halve."""
    q, k, v = _inputs(1, 2, 1, 50, 77, 8, seed=5)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=True), atol=3e-5)


def test_fully_masked_rows_equal_pallas_mean_of_v():
    """Causal with Sq > Sk: rows 0..Sq−Sk−1 see no key. The Pallas kernel
    gives them the mean of V over the Sk keys (its masked scores are
    −1e30, not −inf, so every exp(s − m) is 1), despite its comment that
    such rows are zero; the reference's jnp oracle gives NaN there. The
    port gives the kernel's value."""
    q, k, v = _inputs(1, 2, 1, 8, 4, 8, seed=6)
    got = _port(q, k, v, causal=True)
    want = _pallas(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=3e-5)
    mean = np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 2, 4, 8))
    np.testing.assert_allclose(got[:, :, :4], mean, atol=1e-6)
    assert np.isnan(_oracle(q, k, v, causal=True)[:, :, :4]).all()
    np.testing.assert_allclose(got[:, :, 4:],
                               _oracle(q, k, v, causal=True)[:, :, 4:],
                               atol=3e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_dtypes_match_pallas(dtype):
    q, k, v = _inputs(1, 2, 2, 32, 32, 8, seed=7)
    got = _port(q, k, v, dtype, causal=True)
    want = _pallas(q, k, v, dtype, causal=True)
    np.testing.assert_allclose(got, want, atol=TOL[dtype])


def test_strided_model_views_match_pallas():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views."""
    rng = np.random.default_rng(8)
    qs, ks, vs = (rng.standard_normal((2, 32, h, 16)).astype(np.float32)
                  for h in (4, 2, 2))
    got = ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (qs, ks, vs)), causal=True)
    want = _pallas(*(np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                     for x in (qs, ks, vs)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("kwargs,exc", [
    ({"window": 0}, ValueError),
    ({"sk": 0}, ValueError),
    ({"hkv": 3}, ValueError),
    ({"d": 12}, ValueError),
    ({"dtype": torch.float64}, TypeError),
])
def test_refuses_what_the_kernel_does_not_take(kwargs, exc):
    sk, hkv, d = kwargs.get("sk", 8), kwargs.get("hkv", 2), kwargs.get("d", 16)
    dtype = kwargs.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 8, d, dtype=dtype)
    k = torch.zeros(1, hkv, sk, d, dtype=dtype)
    with pytest.raises(exc):
        ops.flash_attention(q, k, k.clone(), window=kwargs.get("window"))


# --- the packed split decode (Sq <= 16), emulated in plain PyTorch -----------

def _split_decode(q, k, v, *, causal=True, window=None, split=None):
    """The split decode's arithmetic, as the CUDA kernels do it and only
    the tests use it: scores in base 2 (scale · log2 e), masked ones the
    −1e30 sentinel; per chunk of keys (flash_attn.decode_split(Sk), or
    `split`) its max m, sum l and unnormalised acc; then
    flash_combine_kernel's merge, the chunks weighted by exp2(m_c − M) in
    chunk order, divided by the weighted l. q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D), f32 tensors."""
    from repro_torch.kernels import flash_attn

    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    chunk, n = split or flash_attn.decode_split(sk)
    kk = k.repeat_interleave(hq // hkv, dim=1)
    vv = v.repeat_interleave(hq // hkv, dim=1)
    s = q @ kk.transpose(-1, -2) * (d ** -0.5 * np.log2(np.e))
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    parts = []
    for c in range(n):
        sc = s[..., c * chunk:(c + 1) * chunk]
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      p @ vv[:, :, c * chunk:(c + 1) * chunk]))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(l_c * torch.exp2(m - top) for m, l_c, _ in parts)
    acc = sum(a * torch.exp2(m - top) for m, _, a in parts)
    return (acc / l).numpy()


@pytest.mark.parametrize("sk", [333, 40, 65])
@pytest.mark.parametrize("sq", [1, 4])
def test_split_decode_matches_pallas_and_oracle(sk, sq):
    """f32 at a GQA group of 8 over ragged key counts: three chunks with
    a partial last one, one chunk shorter than a tile, one tile and a
    key."""
    q, k, v = _inputs(2, 16, 2, sq, sk, 16, seed=sk + sq)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, causal=True), atol=3e-5)
    np.testing.assert_allclose(got, _port(q, k, v, causal=True), atol=3e-5)


@pytest.mark.parametrize("sq,window", [(1, 40), (4, 8)])
def test_split_decode_window_inside_the_last_chunk(sq, window):
    """The window covers keys of the last chunk only: the earlier chunks'
    m is the sentinel, and they weigh nothing in the merge."""
    q, k, v = _inputs(1, 8, 1, sq, 333, 16, seed=window)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)), window=window)
    kw = {"causal": True, "window": window}
    np.testing.assert_allclose(got, _pallas(q, k, v, **kw), atol=3e-5)
    np.testing.assert_allclose(got, _oracle(q, k, v, **kw), atol=3e-5)


def test_split_decode_fully_masked_rows_are_mean_of_v():
    """Sq 8 > Sk 5 in chunks of 2 keys: the first three rows see no key,
    every chunk's m is the sentinel, so the merge weighs the chunks by l
    alone and gives the mean of V over all 5 keys, as the Pallas kernel
    does."""
    q, k, v = _inputs(1, 8, 1, 8, 5, 16, seed=11)
    got = _split_decode(*map(torch.from_numpy, (q, k, v)), split=(2, 3))
    np.testing.assert_allclose(got, _pallas(q, k, v, causal=True), atol=3e-5)
    mean = np.broadcast_to(v.mean(axis=2, keepdims=True), (1, 8, 3, 16))
    np.testing.assert_allclose(got[:, :, :3], mean, atol=1e-6)
    np.testing.assert_allclose(got[:, :, 3:],
                               _oracle(q, k, v, causal=True)[:, :, 3:],
                               atol=3e-5)


# --- the split decode's halves over key ranges (decode under a mesh) --------

#: key ranges of a 333-key decode, laid end to end as the ranks of a
#: mesh hold the cache's slots: one range; two and four that start on
#: multiples of the 128-key chunk; two ragged ones; and one of four
#: ranges that holds no key
RANGES = {"one": (0, 333), "two": (0, 256, 333), "four": (0, 128, 256, 256, 333),
          "ragged": (0, 100, 333), "empty": (0, 130, 260, 333, 333)}


@pytest.fixture(scope="module")
def decode_case():
    """q (2, 16, 1, 16) over k, v (2, 2, 333, 16): GQA group 8, and the
    Pallas kernel's and the oracle's outputs in f32 and bf16."""
    q, k, v = _inputs(2, 16, 2, 1, 333, 16, seed=27)
    return (q, k, v,
            {dtype: _pallas(q, k, v, dtype, causal=True)
             for dtype in (np.float32, "bfloat16")},
            _oracle(q, k, v, causal=True))


def _partials(q, k, v, bounds, dtype):
    """Each range's partial (as many chunks as the widest range needs),
    laid end to end along the chunks, and the torch dtype of the run."""
    cast = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if dtype == "bfloat16" else torch.from_numpy
    q, k, v = cast(q), cast(k), cast(v)
    chunks = max(-(-(b - a) // 128) for a, b in zip(bounds, bounds[1:]))
    ops.reset_launches()
    parts = [ops.flash_decode_partial(q, k[:, :, a:b], v[:, :, a:b],
                                      chunks=max(chunks, 1))
             for a, b in zip(bounds, bounds[1:])]
    return torch.cat(parts), q.dtype


@pytest.mark.parametrize("ranges", sorted(RANGES))
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_decode_partials_over_ranges_merge_to_the_decode(decode_case, ranges,
                                                          dtype):
    """The plain partial over each range, then the plain merge over all
    ranges' chunks in order, against the Pallas kernel (interpret mode)
    at its bounds; in f32 also against the oracle and _split_decode (the
    same chunks where the ranges start on multiples of 128)."""
    q, k, v, pallas, oracle = decode_case
    part, torch_dtype = _partials(q, k, v, RANGES[ranges], dtype)
    got = ops.flash_combine(part, torch_dtype)
    assert ops.LAUNCHES["flash_decode_partial"] == ops.LAUNCHES["flash_combine"] == 0
    assert got.dtype == torch_dtype and got.shape == (2, 16, 1, 16)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas[dtype], atol=TOL[dtype])
    if dtype == np.float32:
        np.testing.assert_allclose(got, oracle, atol=3e-5)
        np.testing.assert_allclose(
            got, _split_decode(*map(torch.from_numpy, (q, k, v))), atol=3e-5)


def test_empty_partial_weighs_nothing(decode_case):
    """A range with no key gives acc = l = 0 and the −1e30 sentinel in
    every chunk; merged beside a range with keys it changes no bit, and
    the partial's chunks past its keys are the same empty chunks."""
    q, k, v = map(torch.from_numpy, decode_case[:3])
    empty = ops.flash_decode_partial(q, k[:, :, :0], v[:, :, :0], chunks=2)
    assert empty.shape == (2, 2, 16, 1, 18)
    assert (empty[..., :16] == 0).all() and (empty[..., 17] == 0).all()
    assert (empty[..., 16] == -1e30).all()
    full = ops.flash_decode_partial(q, k, v)
    padded = ops.flash_decode_partial(q, k, v, chunks=5)
    assert full.shape[0] == 3 and torch.equal(padded[:3], full)
    torch.testing.assert_close(padded[3:], empty, rtol=0, atol=0)
    want = ops.flash_combine(full, torch.float32)
    for parts in ((full, empty), (empty, full), (padded,)):
        assert torch.equal(ops.flash_combine(torch.cat(parts), torch.float32),
                           want)


@pytest.mark.parametrize("kwargs", [{"chunks": 2}, {"sq": 2}, {"sq": 17}])
def test_decode_partial_refuses_what_it_does_not_take(kwargs):
    """333 keys in 128-key chunks need 3 chunks; a partial takes one
    query row (rows right-aligned to one range's keys would mask keys of
    the ranges before the last, so ranges would not merge into the
    decode over their union)."""
    q = torch.zeros(1, 4, kwargs.get("sq", 1), 16)
    k = torch.zeros(1, 2, 333, 16)
    with pytest.raises(ValueError):
        ops.flash_decode_partial(q, k, k, chunks=kwargs.get("chunks"))


def test_decode_partial_chunk_is_the_decodes():
    """The C partial entry's DECODE_CHUNK is decode_split's chunk, which
    the plain partial and the unsplit decode use: ranges that start on
    its multiples give the unsplit decode's chunks."""
    import re
    from pathlib import Path

    from repro_torch.kernels import flash_attn

    src = (Path(flash_attn.__file__).parent / "csrc" / "flash_attn.cu").read_text()
    found = re.findall(r"constexpr int DECODE_CHUNK = (\d+);", src)
    assert [int(c) for c in found] == [flash_attn.decode_split(1)[0]]


# --- the bf16/f16 prefill's tiling (flash_wgmma_kernel), emulated in plain
# PyTorch -------------------------------------------------------------------

def _tiled_prefill(q, k, v, *, causal=True, window=None,
                   dtype=torch.float32):
    """The bf16/f16 prefill kernel's arithmetic, as only the tests use it:
    blocks of flash_attn.PREFILL_ROWS[DT] query rows; in each, the key tiles of
    PREFILL_KEYS[DT] keys that the kernel's tile-skip rule visits (only
    where every row of the block sees its own diagonal key); scores in
    base 2 (scale · log2 e), masked ones the −1e30 sentinel (keys past Sk
    add nothing); per tile the running max m, p = exp2(s − m) in f32, the
    row sum l of the f32 p, and P rounded to `dtype` against that tile's
    running max before P·V; at the end O / l (l = 0 read as 1), rounded to
    `dtype`. q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D): f32 tensors holding
    values of `dtype`; returns f32."""
    from repro_torch.kernels import flash_attn

    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rows = flash_attn.PREFILL_ROWS[flash_attn.head_tile(d)]
    bk = flash_attn.PREFILL_KEYS[flash_attn.head_tile(d)]
    kk = k.repeat_interleave(hq // hkv, dim=1)
    vv = v.repeat_interleave(hq // hkv, dim=1)
    scale2 = d ** -0.5 * np.log2(np.e)
    off = sk - sq
    out = torch.empty_like(q)
    for q0 in range(0, sq, rows):
        q1 = min(q0 + rows, sq)
        first, last = q0 + off, q1 - 1 + off
        kt0, kt1 = 0, -(-sk // bk)
        if causal and first >= 0:
            kt1 = min(kt1, last // bk + 1)
            if window is not None and first - window + 1 > 0:
                kt0 = max(kt0, (first - window + 1) // bk)
        qpos = torch.arange(q0, q1)[:, None] + off
        m = torch.full((*q.shape[:2], q1 - q0, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((*q.shape[:2], q1 - q0, d))
        for kt in range(kt0, kt1):
            k0, k1 = kt * bk, min(kt * bk + bk, sk)
            s = q[:, :, q0:q1] @ kk[:, :, k0:k1].transpose(-1, -2) * scale2
            kpos = torch.arange(k0, k1)[None, :]
            mask = torch.ones(q1 - q0, k1 - k0, dtype=torch.bool)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            s = s.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(dtype).float() @ vv[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / torch.where(l == 0, 1.0, l)
    return out.to(dtype).float()


#: (B, Hq, Hkv, Sq, Sk, D, causal, window) of the prefill cases: GQA
#: causal over three 128-row blocks, the last ragged; Sq 17, the
#: shortest prefill; a 300-row chunk against 700 keys; a window of 40
#: that crosses key tiles (whole tiles skipped); non-causal; D = 8 (one
#: k-step, the rest zero), 80 (5 k-steps, P·V at DT = 128) and 256 (64-key
#: tiles); causal Sq 77 over Sk 50, whose first 27 rows see no key
PREFILL_CASES = {
    "gqa-causal": (1, 4, 2, 300, 300, 16, True, None),
    "sq17": (2, 4, 2, 17, 17, 16, True, None),
    "300-over-700": (1, 2, 1, 300, 700, 16, True, None),
    "window-40": (1, 2, 1, 300, 300, 16, True, 40),
    "non-causal": (1, 2, 2, 200, 200, 16, False, None),
    "d8": (1, 2, 1, 150, 150, 8, True, None),
    "d80": (1, 2, 1, 150, 190, 80, True, None),
    "d256": (1, 2, 1, 150, 150, 256, True, None),
    "fully-masked": (1, 2, 1, 77, 50, 16, True, None),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_tiled_prefill_matches_pallas_and_plain(case, dtype):
    """The prefill kernel's tiling and rounding points, emulated, against
    the Pallas kernel in interpret mode and the port's plain version, at
    the file's tolerance for the dtype."""
    b, hq, hkv, sq, sk, d, causal, window = PREFILL_CASES[case]
    q, k, v = _inputs(b, hq, hkv, sq, sk, d, seed=sq + d)
    kw = {"causal": causal, "window": window}
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = _tiled_prefill(*(torch.from_numpy(x).to(tdtype).float()
                           for x in (q, k, v)), dtype=tdtype, **kw).numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, dtype, **kw),
                               atol=TOL[dtype])
    np.testing.assert_allclose(got, _port(q, k, v, dtype, **kw),
                               atol=TOL[dtype])
    if case == "fully-masked":
        mean = v.astype(np.float32).mean(axis=2, keepdims=True)
        mean = np.repeat(mean, hq // hkv, axis=1)
        np.testing.assert_allclose(got[:, :, :sq - sk],
                                   np.broadcast_to(mean, (b, hq, sq - sk, d)),
                                   atol=TOL[dtype])


def _constexprs(pattern):
    """The integers a regex finds in csrc/flash_attn.cu."""
    import re
    from pathlib import Path

    from repro_torch.kernels import flash_attn

    src = (Path(flash_attn.__file__).parent / "csrc" / "flash_attn.cu").read_text()
    return [tuple(int(x) for x in found) if isinstance(found, tuple)
            else int(found) for found in re.findall(pattern, src)]


def test_prefill_tile_constants_are_the_sources():
    """The wrapper's prefill constants (which _tiled_prefill emulates) are
    the kernel's: PF_ROWS query rows a block and PF_KEYS keys a tile at
    DT = 64, 128, 256."""
    from repro_torch.kernels import flash_attn

    for name, table in (("PF_ROWS", flash_attn.PREFILL_ROWS),
                        ("PF_KEYS", flash_attn.PREFILL_KEYS)):
        found = _constexprs(rf"constexpr int {name}\[3\] = "
                            r"\{(\d+), (\d+), (\d+)\};")
        assert found == [tuple(table[dt] for dt in (64, 128, 256))]
    assert [flash_attn.head_tile(d) for d in (8, 64, 72, 128, 136, 256)] == [
        64, 64, 128, 128, 256, 256]


def test_decode_constants_unchanged():
    """The decode's constants, on which its chunks and the mesh decode's
    bit-equality rest, are those of the decode kernel: 64 packed rows and
    64-key tiles, two tiles a 128-key chunk, Sq <= 16."""
    from repro_torch.kernels import flash_attn

    assert (flash_attn.BLOCK_ROWS, flash_attn.KEY_TILE, flash_attn.CHUNK_TILES,
            flash_attn.DECODE_ROWS) == (64, 64, 2, 16)
    assert flash_attn.decode_split(2048) == (128, 16)
    assert _constexprs(r"constexpr int MQ = (\d+);") == [flash_attn.BLOCK_ROWS]
    assert _constexprs(r"constexpr int NK = (\d+);") == [flash_attn.KEY_TILE]
    assert _constexprs(r"constexpr int DECODE_CHUNK = (\d+);") == [
        flash_attn.CHUNK_TILES * flash_attn.KEY_TILE]


@pytest.mark.parametrize("dtype,sq,d,want", [
    (torch.bfloat16, 2048, 64, "flash_wgmma_kernel<__nv_bfloat16, 64>"),
    (torch.float16, 17, 80, "flash_wgmma_kernel<__half, 128>"),
    (torch.bfloat16, 16, 256, "flash_tc_kernel<__nv_bfloat16, 256>"),
])
def test_device_kernel_names_the_route(dtype, sq, d, want):
    """A bf16/f16 call with Sq > 16 runs the wgmma prefill kernel, a
    shorter one the decode kernel, at D padded to 64, 128 or 256."""
    from repro_torch.kernels import flash_attn

    assert flash_attn.device_kernel(torch.zeros(1, 2, sq, d, dtype=dtype)) == want
