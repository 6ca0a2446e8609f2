"""Plain PyTorch versions of the port's kernels — they define correctness.

Each function computes what its CUDA kernel computes, in the kernel's
own operation order, with ordinary batched tensor ops over any leading
batch dims. `ops` runs these for tensors on the CPU; `chip_smoke.py`
holds each kernel against its plain version on the card.

The panel, triangular-solve and Schur versions take `acc_dtype`, the
mixed variant of the reference's kernels: with a wider acc_dtype they
compute in it and round to the storage dtype once, at the end
(`narrow`). Without one, bfloat16 and float16 panels and solves compute
in the half type, each operation rounded to it, as PyTorch's elementwise
operators do.
"""
from __future__ import annotations

import torch


def ced_ref(m: torch.Tensor, v: torch.Tensor, k: int, mode: str = "ewd",
            growth_safe: bool = False) -> torch.Tensor:
    """rot90_cw^k(EWO(m, v)): rows scaled by v (divide for "ewd",
    multiply for "ewm"), then k clockwise quarter-turns, then — with
    growth_safe and an odd k — the exchange flip that makes the whole a
    transpose. m is (..., n, n), v is (..., n). This is the reference's
    own jnp Cipher, op for op."""
    from ..core.cipher import _flip_rotated, ewo
    from ..core.prt import rot90_cw

    x = rot90_cw(ewo(m, v, mode), k)
    if growth_safe:
        x = _flip_rotated(x, k)
    return x.contiguous()


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` once, to nearest even, as the kernels'
    __double2bfloat16 / __double2half store a float64 result. torch's own
    float64 -> bfloat16/float16 cast goes through float32 and so rounds
    twice: 1 + 2^-8 + 2^-30 becomes 1.0, not 1 + 2^-7. Here the float32
    step rounds to odd (toward zero, the last bit set where inexact), which
    keeps the second rounding exact. Every other cast is torch's own."""
    if x.dtype != torch.float64 or dtype not in (torch.bfloat16, torch.float16):
        return x.to(dtype)
    f = x.to(torch.float32)
    back = f.to(torch.float64)
    inexact = (back != x) & torch.isfinite(x)
    bits = f.view(torch.int32)
    bits = torch.where(inexact & (back.abs() > x.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(dtype)


def _wide(t: torch.Tensor, acc_dtype) -> torch.Tensor:
    """A copy of t in the arithmetic dtype (acc_dtype, else t's own)."""
    return t.to(acc_dtype or t.dtype, copy=True)


def lu_panel_ref(a: torch.Tensor, acc_dtype=None) -> torch.Tensor:
    """No-pivot Doolittle of (..., b, b) tiles in compact form: the
    strict-lower multipliers and U in one array, eliminated in acc_dtype
    where given and stored at a's dtype. Does not modify `a`."""
    x = _wide(a, acc_dtype)
    b = x.shape[-1]
    for k in range(b - 1):
        x[..., k + 1:, k] = x[..., k + 1:, k] / x[..., k, k, None]
        x[..., k + 1:, k + 1:] -= x[..., k + 1:, k, None] * x[..., k, None, k + 1:]
    return narrow(x, a.dtype)


def trsm_lower_ref(l: torch.Tensor, b: torch.Tensor,
                   acc_dtype=None) -> torch.Tensor:
    """X = L⁻¹B by forward substitution, in acc_dtype where given, stored
    at b's dtype. Reads only the strict lower triangle of l (the unit
    diagonal is implied), so the compact LU form may be passed as is.
    l is (..., n, n), b is (..., n, m)."""
    return _left_ref(l, b, upper=False, unit=True, transpose_t=False,
                     acc_dtype=acc_dtype)


def trsm_upper_right_ref(u: torch.Tensor, b: torch.Tensor,
                         acc_dtype=None) -> torch.Tensor:
    """Z = B·U⁻¹ by substitution over the columns of B, in acc_dtype
    where given, stored at b's dtype. Reads only the upper triangle of
    u, diagonal included. u is (..., n, n), b is (..., m, n)."""
    z = _wide(b, acc_dtype)
    u = u.to(z.dtype)
    n = u.shape[-1]
    for k in range(n):
        z[..., :, k] = z[..., :, k] / u[..., k, k, None]
        z[..., :, k + 1:] -= z[..., :, k, None] * u[..., k, None, k + 1:]
    return narrow(z, b.dtype)


def _left_ref(t: torch.Tensor, b: torch.Tensor, *, upper: bool,
              unit: bool, transpose_t: bool, acc_dtype) -> torch.Tensor:
    """X = op(T)⁻¹B (op(T) = Tᵀ where transpose_t, else T) by forward
    substitution where op(T) is lower triangular and backward
    substitution where it is upper, dividing by the diagonal unless
    unit; in acc_dtype where given, stored at b's dtype. Reads only T's
    upper (upper=True) or lower triangle. t is (..., n, n), b is
    (..., n, m)."""
    x = _wide(b, acc_dtype)
    tt = t.to(x.dtype)
    if transpose_t:
        tt = tt.transpose(-1, -2)
    n = tt.shape[-1]
    steps = range(n - 1, -1, -1) if upper != transpose_t else range(n)
    for k in steps:
        if not unit:
            x[..., k, :] = x[..., k, :] / tt[..., k, k, None]
        rest = slice(None, k) if upper != transpose_t else slice(k + 1, None)
        x[..., rest, :] -= tt[..., rest, k, None] * x[..., k, None, :]
    return narrow(x, b.dtype)


def trsm_left_ref(t: torch.Tensor, b: torch.Tensor, *, upper: bool,
                  transpose_t: bool = False) -> torch.Tensor:
    """X = op(T)⁻¹B (op(T) = Tᵀ where transpose_t, else T), dividing by
    T's stored diagonal; reads only T's upper (upper=True) or lower
    triangle."""
    return _left_ref(t, b, upper=upper, unit=False, transpose_t=transpose_t,
                     acc_dtype=None)


def schur_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     acc_dtype=None) -> torch.Tensor:
    """C − A·B in the accumulation dtype: acc_dtype where given, else
    float32 for bfloat16 and float16 and the input dtype for float32 and
    float64; the whole of K is summed there and the result rounded once
    to the input dtype. c is (..., M, N), a (..., M, K), b (..., K, N);
    the result is a new tensor."""
    if acc_dtype is None and c.dtype in (torch.bfloat16, torch.float16):
        acc_dtype = torch.float32
    if acc_dtype is None or acc_dtype == c.dtype:
        return c - a @ b
    return narrow(c.to(acc_dtype) - a.to(acc_dtype) @ b.to(acc_dtype), c.dtype)


#: the masked-score sentinel of the reference's kernel (flash_attn.py:23)
NEG_INF = -1e30
#: log2(e), by which the kernels scale their scores to work in base 2
#: (csrc/flash_attn.cu, csrc/flash_bwd.cu)
LOG2E = 1.4426950408889634


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """softmax(QKᵀ·scale + mask)·V in the flash kernel's arithmetic.

    q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), any strides; the kv head of
    query head h is h // (Hq / Hkv). Query row i sits at position
    i + Sk − Sq (right-aligned, so decode works); `causal` masks keys
    after it, `window` keys at or before qpos − window. Scores are f32,
    masked ones get the −1e30 sentinel, the unnormalised probabilities
    exp(s − max) are cast to V's dtype before the f32 product with V, and
    the sum is divided by the f32 row sum, then cast to q's dtype. A row
    with every key masked (causal with Sq > Sk) therefore gets the mean of
    V over the Sk keys, as the reference's Pallas kernel gives it."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s, _ = _scores(q, k, scale, causal, window)
    vv = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).float(), vv.float())
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, factor: float, causal: bool,
            window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, Hq, Sq, Sk) f32 scores q·k·factor, masked ones the −1e30
    sentinel, and the (Sq, Sk) mask of the keys each row sees (query row i
    at position i + Sk − Sq)."""
    sq, sk = q.shape[2], k.shape[2]
    kk = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * factor
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s.masked_fill(~mask, NEG_INF), mask


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True, window: int | None = None,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward under autograd: (flash_attention_ref's output, lse),
    lse each row's base-2 log-sum-exp over its scores, (B, Hq, Sq) f32:
    m + log2 Σ exp2(s − m), s = q·k·scale·log2 e with masked scores the
    −1e30 sentinel and m the row's max. A row that sees no key has m =
    −1e30 and l = Sk, so its lse is −1e30 too."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s, _ = _scores(q, k, scale * LOG2E, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log2(torch.exp2(s - m).sum(dim=-1))
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale)
    return out, lse


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True,
                                 window: int | None = None,
                                 scale: float | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(dq, dk, dv) of ⟨do, O⟩ in the backward kernels' arithmetic
    (csrc/flash_bwd.cu), from the forward's output o and its base-2 lse:
    s = q·k·scale·log2 e in f32; P = exp2(s − lse) where the key is seen,
    0 where masked, and 1/Sk on every key of a row that sees none (causal,
    position < 0: the forward gave it the mean of V); Δ = Σ_d do·o in f32;
    dV = Pᵀ·do with P rounded to V's dtype; dS = P ∘ (do·Vᵀ − Δ) in f32,
    0 where masked and in a row that sees no key, rounded to the operands'
    dtype before dQ = scale·dS·K and dK = scale·dSᵀ·Q; every sum in f32,
    dK and dV summed over the kv head's query heads, each gradient
    rounded once to its operand's dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s, mask = _scores(q, k, scale * LOG2E, causal, window)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    dead = (qpos < 0)[:, None] if causal else torch.zeros_like(mask[:, :1])
    p = torch.where(mask, torch.exp2(s - lse[..., None]), 0.0)
    p = torch.where(dead, 1.0 / sk, p)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    vv = v.repeat_interleave(g, dim=1).float()
    dp = torch.matmul(do.float(), vv.transpose(-1, -2))
    ds = torch.where(mask & ~dead, p * (dp - delta), 0.0).to(q.dtype).float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    kk = k.repeat_interleave(g, dim=1).float()
    dq = torch.matmul(ds, kk) * scale

    def group_sum(x):
        return x.view(b, hkv, g, sk, d).sum(dim=2)

    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def flash_decode_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, scale: float | None = None,
                             chunks: int) -> torch.Tensor:
    """The split decode's first half in its kernel's arithmetic, for one
    query row (Sq == 1) that sees every key: per chunk of
    flash_attn.decode_split's keys (`chunks` of them, those past Sk
    empty), the unnormalised accumulator, then m and l, as (chunks, B,
    Hq, 1, D + 2) f32. Scores are f32 in base 2 (scale · log2 e); m is
    the chunk's max with the −1e30 sentinel (an empty chunk keeps it,
    with acc = l = 0), p = exp2(s − m), l the sum of the f32 p, and acc
    the f32 product of p cast to V's dtype with V."""
    from .flash_attn import decode_split

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    part = torch.zeros((chunks, b, hq, sq, d + 2), dtype=torch.float32,
                       device=q.device)
    part[..., d] = NEG_INF
    if sk == 0:
        return part
    g = hq // hkv
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * (scale * LOG2E)
    chunk, need = decode_split(sk)
    for c in range(need):
        keys = slice(c * chunk, (c + 1) * chunk)
        sc = s[..., keys]
        m = sc.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
        p = torch.exp2(sc - m)
        part[c, ..., :d] = torch.matmul(p.to(v.dtype).float(),
                                        vv[:, :, keys].float())
        part[c, ..., d] = m[..., 0]
        part[c, ..., d + 1] = p.sum(dim=-1)
    return part


def flash_combine_ref(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The split decode's merge in its kernel's arithmetic: (chunks, B,
    Hq, Sq, D + 2) f32 partials to (B, Hq, Sq, D) of `dtype`. M is the
    chunks' largest m, chunk c weighs exp2(m_c − M), and the weighted
    sums of l and of acc run over the chunks in order; the output is the
    accumulator times 1 / l (1 / 1 where l is 0), cast to `dtype`."""
    d = part.shape[-1] - 2
    m = part[..., d:d + 1]
    top = m.amax(dim=0)
    lsum = torch.zeros_like(top)
    acc = torch.zeros_like(part[0, ..., :d])
    for c in range(part.shape[0]):
        w = torch.exp2(m[c] - top)
        lsum = lsum + part[c, ..., d + 1:] * w
        acc = acc + part[c, ..., :d] * w
    inv = 1.0 / torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    return (acc * inv).to(dtype)
