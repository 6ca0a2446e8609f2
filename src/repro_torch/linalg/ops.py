"""Differentiable secure ops — `torch.autograd.Function`s over the shared
LU (port of repro.linalg.ops).

`secure_slogdet` / `secure_solve` / `secure_inv` take tensors, compute
their forward value through the outsourced protocol (a `LinalgSession`),
and route their backward passes through the same verified factors:

    ∂ log|det M| / ∂M = M⁻ᵀ          (one wide identity-RHS round, cached)
    z = M⁻¹b:   b̄ = M⁻ᵀz̄            (one masked adjoint round)
                M̄ = −b̄ · zᵀ          (client-side outer product)
    Y = M⁻¹:    M̄ = −Yᵀ·Ȳ·Yᵀ        (client-side, no extra round)

so a gradient step through slogdet + solve costs one factorization plus
a few triangular-solve rounds, and the backward pass ships only the
blinded or public right-hand sides the forward ops do.

Sessions are cached per matrix value (SHA-256 of bytes ‖ shape ‖ dtype)
on a `SecureLinalg` context, which is how the forward slogdet, the
forward solve and both backward passes of one step land on a single
factorization. The protocol is deterministic in the matrix bytes (seeds,
keys, masks and probes all derive from SHA-256 of the plaintext), so a
re-opened session returns the same values. Autograd runs the backward of
CUDA tensors on its own device thread, so a context's cache and the
rounds of its sessions run under one lock.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from .session import LinalgSession

__all__ = [
    "SecureLinalg", "default_linalg",
    "secure_slogdet", "secure_solve", "secure_inv",
]


class SecureLinalg:
    """Session cache and protocol configuration of the differentiable ops.

    One context is one fleet configuration (num_servers, transport,
    device, client knobs). `session_for` returns the LinalgSession of a
    matrix value, opening one on first sight: every op and every backward
    pass that sees the same bytes shares it, so `factorizations` stays 1
    across a whole gradient step. `device` is where the sessions compute
    (None: the CUDA device, RuntimeError without one; "cpu" the plain
    path).
    """

    def __init__(self, num_servers: int = 2, *, transport=None,
                 max_sessions: int = 8, device=None, **session_kwargs):
        self.num_servers = num_servers
        self.transport = transport
        self.device = device
        self.session_kwargs = session_kwargs
        self.max_sessions = max_sessions
        self._sessions: dict = {}  #: guarded-by: self.lock
        self.lock = threading.RLock()

    def session_for(self, a) -> LinalgSession:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a)
        key = (hashlib.sha256(a.tobytes()).digest(), a.shape, str(a.dtype))
        with self.lock:
            s = self._sessions.get(key)
            if s is None:
                s = LinalgSession(a, self.num_servers,
                                  transport=self.transport,
                                  device=self.device,
                                  **self.session_kwargs)
                self._sessions[key] = s
                while len(self._sessions) > self.max_sessions:
                    # dicts iterate in insertion order: evict the oldest
                    self._sessions.pop(next(iter(self._sessions)))
            return s

    def clear(self) -> None:
        with self.lock:
            self._sessions.clear()


_default: SecureLinalg | None = None
_default_lock = threading.Lock()


def default_linalg() -> SecureLinalg:
    """The module-default context (2 inline servers on the CUDA device),
    built lazily."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SecureLinalg()
        return _default


def _square(name: str, a: torch.Tensor) -> None:
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{name} needs a square matrix, got "
                         f"{tuple(a.shape)}")


# -- slogdet ----------------------------------------------------------------

class _SlogDet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, linalg, a):
        with linalg.lock:
            sign, logabs = linalg.session_for(a).slogdet()
        ctx.linalg = linalg
        ctx.save_for_backward(a)
        sign, logabs = a.new_tensor(sign), a.new_tensor(logabs)
        ctx.mark_non_differentiable(sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, _g_sign, g_logabs):
        # sign is locally constant: its cotangent drops
        (a,) = ctx.saved_tensors
        with ctx.linalg.lock:
            inv_t = ctx.linalg.session_for(a).inv(transpose=True)
        return None, g_logabs * inv_t.to(a)


def secure_slogdet(a: torch.Tensor, *, linalg: SecureLinalg | None = None):
    """(sign, log|det a|) via the outsourced protocol; differentiable.

    Drop-in for `torch.linalg.slogdet` on one (n, n) matrix. The gradient
    of log|det| is a⁻ᵀ, through the session's verified factors: no second
    factorization, no new plaintext on the wire.
    """
    ctx = linalg if linalg is not None else default_linalg()
    a = torch.as_tensor(a)
    _square("secure_slogdet", a)
    return _SlogDet.apply(ctx, a)


# -- solve ------------------------------------------------------------------

class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, linalg, a, b):
        with linalg.lock:
            z = linalg.session_for(a).solve(b).to(b)
        ctx.linalg = linalg
        ctx.save_for_backward(a, z)
        return z

    @staticmethod
    def backward(ctx, zbar):
        a, z = ctx.saved_tensors
        with ctx.linalg.lock:
            bbar = ctx.linalg.session_for(a).solve(zbar, transpose=True)
        bbar = bbar.to(zbar)
        abar = None
        if ctx.needs_input_grad[1]:
            abar = -torch.outer(bbar, z) if z.ndim == 1 else -bbar @ z.T
        return None, abar, bbar


def secure_solve(a: torch.Tensor, b: torch.Tensor, *,
                 linalg: SecureLinalg | None = None) -> torch.Tensor:
    """a x = b through the session's verified LU; differentiable.

    Drop-in for `torch.linalg.solve` with b of shape (n,) or (n, c). The
    adjoint b̄ = a⁻ᵀz̄ is one more masked round through the same factors;
    ā = −b̄ zᵀ needs none.
    """
    ctx = linalg if linalg is not None else default_linalg()
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    _square("secure_solve", a)
    if b.ndim not in (1, 2) or b.shape[0] != a.shape[0]:
        raise ValueError(
            f"rhs shape {tuple(b.shape)} does not match matrix "
            f"{tuple(a.shape)}"
        )
    return _Solve.apply(ctx, a, b)


# -- inv --------------------------------------------------------------------

class _Inv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, linalg, a):
        with linalg.lock:
            y = linalg.session_for(a).inv().to(a)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, ybar):
        # d(A⁻¹) = −A⁻¹ dA A⁻¹ ⇒ Ā = −Yᵀ Ȳ Yᵀ, client-side: the wide
        # round ran (and is cached) in the forward pass
        (y,) = ctx.saved_tensors
        return None, -(y.T @ ybar @ y.T)


def secure_inv(a: torch.Tensor, *,
               linalg: SecureLinalg | None = None) -> torch.Tensor:
    """inv(a) via one wide public-permutation-RHS round; differentiable."""
    ctx = linalg if linalg is not None else default_linalg()
    a = torch.as_tensor(a)
    _square("secure_inv", a)
    return _Inv.apply(ctx, a)
