"""Wrapper of the flash-attention kernel (csrc/flash_attn.cu).

Port of src/repro/kernels/flash_attn.py:flash_attention: blockwise
online-softmax attention, GQA-aware, with right-aligned causal and
sliding-window masks. Each operand goes in at its own (batch, head, seq)
strides, so (B, S, H, D) projections and KV-cache prefixes need no copy;
the output is allocated in q's memory layout.

bf16 and f16 run on the tensor cores. A call with Sq <= DECODE_ROWS packs
each kv head's GQA group into one block and splits the keys into chunks
(`decode_split`), then merges the chunks in a second launch; the wrapper
allocates the chunks' f32 partials. f32 runs the exact FMA kernel.
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
_MAX_GRID_YZ = 65535
#: any window at least this wide masks nothing at a length that fits the
#: kernel's int positions, so wider ones are passed as this
_WIDE_WINDOW = 2**30
#: the largest head dimension the kernel's shared-memory tiles hold
MAX_HEAD_DIM = 256
#: query rows per block and keys per tile of the tensor-core kernel
BLOCK_ROWS, KEY_TILE = 64, 64
#: calls with at most this many query rows take the packed decode path
DECODE_ROWS = 16
#: key tiles of one decode chunk: at tinyllama's batch 4 x 4 kv heads
#: over 2048 keys, 16 chunks a row make 256 blocks for the H100's 132 SMs
CHUNK_TILES = 2


def decode_split(sk: int) -> tuple[int, int]:
    """(keys per chunk, chunks) of the packed decode: CHUNK_TILES key
    tiles a chunk. The split depends on Sk alone, so a row's arithmetic
    is the same at any batch size, head count and card."""
    chunk = CHUNK_TILES * KEY_TILE
    return chunk, -(-sk // chunk)


def cuda_launches(q: torch.Tensor, k: torch.Tensor) -> int:
    """CUDA launches one call makes: two for a decode whose keys are
    split (the chunks, then their merge), else one."""
    if q.dtype == torch.float32 or q.shape[2] > DECODE_ROWS:
        return 1
    return 1 + (decode_split(k.shape[2])[1] > 1)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Every row of every 16-bit operand starts on 16 bytes, so 8-element
    chunks copy as one cp.async each."""
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:3])
               for t in tensors)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int | None) -> None:
    """Raise on what neither the kernel nor its plain version takes."""
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
    if sk == 0:
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """softmax(QKᵀ·scale + mask)·V on CUDA tensors: q (B, Hq, Sq, D), k and
    v (B, Hkv, Sk, D), unit stride along D. Returns a new (B, Hq, Sq, D)
    tensor laid out in memory as q is; the operands are left as they are."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"flash_attention needs CUDA operands on one device, got "
                f"{q.device}/{k.device}/{v.device}")
    check_operands(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"along D, got strides {t.stride()}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {b} or heads {hq} exceed the grid")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    if out.stride(3) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    chunk = nchunks = 0
    part = None
    if q.dtype != torch.float32 and sq <= DECODE_ROWS:
        chunk, nchunks = decode_split(sk)
        if hkv * -(-(hq // hkv) * sq // BLOCK_ROWS) > _MAX_GRID_YZ:
            raise ValueError(f"flash_attention: {hkv} kv heads x "
                             f"{hq // hkv * sq} packed rows exceed the grid")
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
