"""Wrapper of the flash-attention kernel (csrc/flash_attn.cu).

Port of src/repro/kernels/flash_attn.py:flash_attention: blockwise
online-softmax attention, GQA-aware, with right-aligned causal and
sliding-window masks. Each operand goes in at its own (batch, head, seq)
strides, so (B, S, H, D) projections and KV-cache prefixes need no copy;
the output is allocated in q's memory layout.

bf16 and f16 run on the tensor cores, f32 on the FMA pipes in exact f32.
A bf16 or f16 prefill (Sq > DECODE_ROWS) runs `flash_wgmma_kernel`:
blocks of PREFILL_ROWS[DT] query rows, wgmma products fed by a TMA ring
of PREFILL_KEYS[DT] keys a tile (DT the head dimension padded to 64, 128
or 256), one launch (`tma_operands` says which operands TMA loads; the
kernel copies the others into the same tiles). A call with
Sq <= DECODE_ROWS packs each kv head's GQA group into blocks of
PACKED_ROWS[dtype] rows and splits the keys into chunks
(`decode_split`), which the wrapper gives f32 scratch for. In bf16 and
f16 that is one launch of `flash_decode_kernel`: in each chunk
CHUNK_TILES consumer warps take KEY_TILE keys each, fed row by row by a
producer warp's bulk copies, and the blocks over a row block's chunks, at
most DECODE_CLUSTER of them, are one thread block cluster that merges the
chunks. In f32 the chunks and their merge are two launches.

The two halves of that decode are wrappers of their own, for keys that
lie on several ranks: `flash_decode_partial_cuda` leaves the chunks' f32
partials of one query row over one key range, (chunks, B, Hq, 1, D + 2)
with the unnormalised accumulator, then m (base 2) and l, in
`decode_split`'s chunks, and
`flash_combine_cuda` merges such a buffer, chunks in order, into the
output. A range with no key is the empty partial (acc = l = 0, m the
−1e30 sentinel) with no launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_PTR, _INT, _LL, _FLT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_SIGNATURES = {
    f"flash_{suffix}": (
        _INT,
        (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
         _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _INT, _INT, _FLT,
         _INT, _INT, _INT, _PTR, _INT, _INT, _INT, _PTR),
    )
    for suffix in _SUFFIX.values()
}
for _suffix in _SUFFIX.values():
    _SIGNATURES[f"flash_{_suffix}_partial"] = (
        _INT,
        (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
         _INT, _INT, _INT, _INT, _INT, _INT, _FLT, _PTR, _INT, _INT, _PTR),
    )
    _SIGNATURES[f"flash_{_suffix}_combine"] = (
        _INT, (_PTR, _PTR, _LL, _LL, _LL, _INT, _INT, _INT, _INT, _INT, _PTR))
_SIGNATURES["flash_prefill_tma_operands"] = (
    _INT, (_PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL,
           _INT, _INT, _INT, _INT, _INT, _INT))
_MAX_GRID_YZ = 65535
#: any window at least this wide masks nothing at a length that fits the
#: kernel's int positions, so wider ones are passed as this
_WIDE_WINDOW = 2**30
#: the largest head dimension the kernel's shared-memory tiles hold
MAX_HEAD_DIM = 256
#: packed rows a block of the bf16/f16 decode kernel (flash_decode_kernel,
#: csrc/flash_attn.cu's DC_ROWS: one m16 tile), keys of a chunk that one
#: of its consumer warps takes (DC_KEYS), and its consumer warps (DC_WARPS),
#: on which the decode's chunks rest
BLOCK_ROWS, KEY_TILE, CHUNK_TILES = 16, 32, 4
#: blocks of one bf16/f16 decode cluster at most (DECODE_CLUSTER): a
#: decode over n > 1 chunks runs min(n, DECODE_CLUSTER) blocks a row block
DECODE_CLUSTER = 8
#: query rows per block and keys per tile of the bf16/f16 prefill kernel
#: (flash_wgmma_kernel, csrc/flash_attn.cu's PF_ROWS and PF_KEYS) by the
#: padded head dimension DT
PREFILL_ROWS = {64: 128, 128: 128, 256: 64}
PREFILL_KEYS = {64: 128, 128: 64, 256: 64}
#: calls with at most this many query rows take the packed decode path
DECODE_ROWS = 16
#: packed decode rows a block: the decode kernel's 16, and the f32 FMA
#: kernel's 16 (one a thread row)
PACKED_ROWS = {torch.float32: 16, torch.bfloat16: BLOCK_ROWS,
               torch.float16: BLOCK_ROWS}


def decode_split(sk: int) -> tuple[int, int]:
    """(keys per chunk, chunks) of the packed decode: CHUNK_TILES warps'
    KEY_TILE keys a chunk, 128. The split depends on Sk alone, so a
    row's arithmetic is the same at any batch size, head count and
    card."""
    chunk = CHUNK_TILES * KEY_TILE
    return chunk, -(-sk // chunk)


def partial_chunks(q: torch.Tensor, k: torch.Tensor,
                   chunks: int | None) -> int:
    """Chunks of a decode partial over k's keys, in `decode_split`'s
    chunk: `chunks`, at least enough to hold the keys (by default just
    enough); raises on what the partial does not take.
    It takes one query row, which sees every key of its range, so that
    ranges laid end to end merge into the decode over their union."""
    if q.shape[2] != 1:
        raise ValueError(f"a decode partial takes one query row, got "
                         f"{q.shape[2]}")
    sk = k.shape[2]
    chunk = decode_split(sk)[0]
    need = max(-(-sk // chunk), 1)
    chunks = need if chunks is None else chunks
    if chunks < need:
        raise ValueError(f"a decode partial over {sk} keys in chunks of "
                         f"{chunk} needs {need} chunks, got {chunks}")
    return chunks


def empty_partial(q: torch.Tensor, chunks: int) -> torch.Tensor:
    """The partial of a key range with no key: acc = l = 0 and m the
    −1e30 sentinel in every chunk, which weighs nothing in a merge."""
    b, hq, sq, d = q.shape
    part = torch.zeros((chunks, b, hq, sq, d + 2), dtype=torch.float32,
                       device=q.device)
    part[..., d] = -1e30
    return part


def head_tile(d: int) -> int:
    """The head dimension the kernels pad D to: 64, 128 or 256."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def device_kernel(q: torch.Tensor) -> str:
    """The bf16/f16 device kernel a call on q runs, as the profiler names
    it (its template arguments are the type and the padded head dim)."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"device_kernel names the half routes, got {q.dtype}")
    name = ("flash_wgmma_kernel" if q.shape[2] > DECODE_ROWS
            else "flash_decode_kernel")
    ctype = "__nv_bfloat16" if q.dtype == torch.bfloat16 else "__half"
    return f"{name}<{ctype}, {head_tile(q.shape[3])}>"


def cuda_launches(q: torch.Tensor, k: torch.Tensor) -> int:
    """CUDA launches one call makes: two for an f32 decode whose keys are
    split (the chunks, then their merge), else one (a bf16/f16 decode
    merges its chunks in the same launch)."""
    if q.shape[2] > DECODE_ROWS or q.dtype != torch.float32:
        return 1
    return 1 + (decode_split(k.shape[2])[1] > 1)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every row of every operand starts on 16 bytes, so the bf16/f16
    decode loads Q 16 bytes a thread and the f32 kernel copies 4 elements
    as one cp.async."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
               for t in tensors)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None, *, keys_may_be_empty: bool = False
                   ) -> None:
    """Raise on what neither the kernel nor its plain version takes; a
    decode partial (keys_may_be_empty) takes a range with no key."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads")
    if sk == 0 and not keys_may_be_empty:
        raise ValueError("flash_attention needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention takes float32, bfloat16 or float16 operands of "
            f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(
            f"flash_attention: head dim {d} is not a multiple of 8 up to "
            f"{MAX_HEAD_DIM}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: int | None, keys_may_be_empty: bool = False) -> None:
    """Raise on operands the kernel does not take on the card."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"flash_attention needs CUDA operands on one device, got "
                f"{q.device}/{k.device}/{v.device}")
    check_operands(q, k, v, window, keys_may_be_empty=keys_may_be_empty)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"along D, got strides {t.stride()}")
    b, hq = q.shape[:2]
    if hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {b} or heads {hq} exceed the grid")


def _check_packed(q: torch.Tensor, k: torch.Tensor) -> None:
    hq, sq = q.shape[1], q.shape[2]
    hkv = k.shape[1]
    if hkv * -(-(hq // hkv) * sq // PACKED_ROWS[q.dtype]) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: {hkv} kv heads x "
                         f"{hq // hkv * sq} packed rows exceed the grid")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """softmax(QKᵀ·scale + mask)·V on CUDA tensors: q (B, Hq, Sq, D), k and
    v (B, Hkv, Sk, D), unit stride along D. Returns a new (B, Hq, Sq, D)
    tensor laid out in memory as q is; the operands are left as they are."""
    _check_cuda(q, k, v, window)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    chunk = nchunks = 0
    part = None
    if sq <= DECODE_ROWS:
        chunk, nchunks = decode_split(sk)
        _check_packed(q, k)
        if nchunks > 1:
            part = torch.empty(nchunks * b * hq * sq * (d + 2),
                               dtype=torch.float32, device=q.device)
    lib = build.library("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, f"flash_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
            b, hq, hkv, sq, sk, d, float(scale), int(bool(causal)),
            int(window is not None), min(int(window or 0), _WIDE_WINDOW),
            None if part is None else part.data_ptr(), chunk, nchunks,
            int(_aligned(q, k, v)), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, "flash_attention", code)
    return out


def tma_operands(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple[bool, bool, bool]:
    """Whether a bf16/f16 prefill on these operands loads q, k and v by
    TMA (a 16-byte aligned start, (batch, head, seq) strides of whole
    16-byte vectors) or has the kernel's producer threads copy each into
    the same tiles. Both give the same bits, so results cannot tell which
    ran; the card tests ask this. CUDA tensors of a 2-byte dtype."""
    _check_cuda(q, k, v, None)
    if q.element_size() != 2:
        raise ValueError("tma_operands takes bfloat16 or float16 operands")
    b, hq, sq, d = q.shape
    lib = build.library("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        mask = lib.flash_prefill_tma_operands(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], b, hq, k.shape[1], sq, k.shape[2],
            d)
    return bool(mask & 1), bool(mask & 2), bool(mask & 4)


def flash_decode_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float | None = None,
                              chunks: int | None = None) -> torch.Tensor:
    """The packed decode's chunk kernel alone for one query row over k's
    keys (Sq == 1, Sk >= 0): a new (chunks, B, Hq, 1, D + 2) f32 tensor of
    each chunk's unnormalised accumulator, m (base 2) and l, in
    decode_split's chunks, `chunks` of them (default as many as hold the
    keys; those past the keys are empty). The row sees every key. One
    launch; none for a range with no key, whose partial is
    empty_partial's."""
    _check_cuda(q, k, v, None, keys_may_be_empty=True)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    chunks = partial_chunks(q, k, chunks)
    if sk == 0 or b == 0:
        return empty_partial(q, chunks)
    _check_packed(q, k)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    part = torch.empty((chunks, b, hq, sq, d + 2), dtype=torch.float32,
                       device=q.device)
    lib = build.library("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, f"flash_{_SUFFIX[q.dtype]}_partial")(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], b, hq, hkv, sq, sk, d,
            float(scale), part.data_ptr(), chunks, int(_aligned(q, k, v)), torch.cuda.current_stream().cuda_stream,
        )
    build.check_launch(lib, "flash_attention decode partial", code)
    return part


def check_partials(part: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise on a partial buffer the merge does not take."""
    if part.ndim != 5 or part.dtype != torch.float32:
        raise ValueError("flash_combine takes (chunks, B, Hq, Sq, D + 2) f32 "
                         f"partials, got {tuple(part.shape)} {part.dtype}")
    if part.shape[0] < 1 or part.shape[4] < 3:
        raise ValueError(f"flash_combine: partials {tuple(part.shape)} hold "
                         "no chunk or no column")
    if dtype not in _SUFFIX:
        raise TypeError(f"flash_combine: no output type {dtype}")


def flash_combine_cuda(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The packed decode's merge alone: a new (B, Hq, Sq, D) tensor of
    `dtype` from (chunks, B, Hq, Sq, D + 2) f32 partials on the card,
    chunks merged in order. One launch."""
    check_partials(part, dtype)
    if part.device.type != "cuda":
        raise ValueError(f"flash_combine needs CUDA partials, got {part.device}")
    part = part.contiguous()
    chunks, b, hq, sq, d2 = part.shape
    out = torch.empty((b, hq, sq, d2 - 2), dtype=dtype, device=part.device)
    if out.numel() == 0:
        return out
    lib = build.library("flash_attn", _SIGNATURES)
    with torch.cuda.device(part.device):
        code = getattr(lib, f"flash_{_SUFFIX[dtype]}_combine")(
            part.data_ptr(), out.data_ptr(), *out.stride()[:3], b, hq, sq,
            d2 - 2, chunks, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, "flash_attention combine", code)
    return out
