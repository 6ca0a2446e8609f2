"""Plain PyTorch versions of the port's kernels — they define correctness.

Each function computes what its CUDA kernel computes, in the kernel's
own operation order, with ordinary batched tensor ops over any leading
batch dims. `ops` runs these for tensors on the CPU; `chip_smoke.py`
holds each kernel against its plain version on the card.

The panel, triangular-solve and Schur versions take `acc_dtype`, the
mixed variant of the reference's kernels: with a wider acc_dtype they
compute in it and cast to the storage dtype once, at the end.
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
    return x.to(a.dtype)


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
    return z.to(b.dtype)


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
    return x.to(b.dtype)


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
    return (c.to(acc_dtype) - a.to(acc_dtype) @ b.to(acc_dtype)).to(c.dtype)


#: the masked-score sentinel of the reference's kernel (flash_attn.py:23)
NEG_INF = -1e30


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
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kk.transpose(-1, -2)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).float(), vv.float())
    return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)
