"""LinalgSession — many secure ops on one verified outsourced LU (port of
repro.linalg.session).

The paper outsources a determinant; everything else the client may want
from the same matrix (solve, inverse, the slogdet pair) is a function of
the same no-pivot factors of the augmented ciphertext
X' = [[X, 0], [R, I]]. This module grows an op plan around one
factorization (DESIGN.md §12): the first op pays the full SPDC protocol
(cipher → N-server LU → Authenticate → heal), every later op is a round
of triangular solves through the already-verified factors, dispatched to
the fleet as `TriSolveTask` column chunks and answered by each server's
left solves (`kernels.ops.trsm_left`: csrc/trsm.cu on the card).

Math. With EWD ciphering, B = V⁻¹M (V = diag(v)) and X = Rᵏ(B), R(A) =
Aᵀ·J one clockwise quarter-turn (J the exchange). With G = X⁻¹ — which
the factors give, because the border's block structure makes
inv(X')[:n, :n] = X⁻¹ and inv(X'ᵀ)[:n, :n] = X⁻ᵀ — the inverse of the
unrotated ciphertext is, case by case,

    B⁻¹ = G        (k ≡ 0)      B⁻ᵀ = Gᵀ
    B⁻¹ = Gᵀ·J     (k ≡ 1)      B⁻ᵀ = J·G
    B⁻¹ = J·G·J    (k ≡ 2)      B⁻ᵀ = J·Gᵀ·J
    B⁻¹ = J·Gᵀ     (k ≡ 3)      B⁻ᵀ = G·J

(growth-safe odd rotations compose the flip, giving X = Bᵀ: B⁻¹ = Gᵀ,
B⁻ᵀ = G). Each case is one round, G or Gᵀ applied to a (row-reversed)
right-hand side, and the client recovers M⁻¹w = B⁻¹(w/v) (EWD; ·v for
EWM), M⁻ᵀw = (B⁻ᵀw)/v and inv(M) = B⁻¹/v[None, :].

Trust boundary. The rounds never widen what the servers see: l and u are
material the fleet produced, inverse rounds ship only a public
permutation RHS (the secret 1/v column scaling happens here, after the
round), and secret right-hand sides pass through the `blind_rhs`
one-time pad: W = [z; 0] + X'·C with C from a mask lane of the session
digest that never leaves the client, so the reply is X'⁻¹[z; 0] + C and
unmasking is a subtraction. Each chunk is verified with client keys:
narrow (masked) rounds check the full residual ‖A·Y − W‖/‖W‖ against the
client-held X', wide (inverse) rounds a Freivalds probe from a secret
probe lane, fresh per round, chunk and attempt. Failed chunks heal
through `distrib.recovery.recover_solve`.

The masks and probes are drawn on the host with numpy from the same lanes
as the reference's, bit for bit; the checks and the client's algebra run
in torch on the session's device.
"""
from __future__ import annotations

import hashlib
import struct
import time
from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..api.client import _NUMPY_DTYPES, SPDCClient
from ..api.messages import TriSolveTask
from ..api.transport import resolve_transport
from ..core.keygen import keygen
from ..core.protocol import OpRecord, SPDCReport
from ..core.verify import authenticate, epsilon, growth_estimate
from ..device import synchronize
from ..distrib.recovery import recover_solve, trisolve_subseed

__all__ = ["LinalgSession", "LinalgVerificationError", "blind_rhs",
           "outsource_solve"]


class LinalgVerificationError(RuntimeError):
    """A triangular-solve round failed verification and could not heal."""


def _lane_rng(digest: bytes, tag: bytes, *idx: int) -> np.random.Generator:
    """Secret-keyed rng on a domain-separated lane of the session digest.

    Unlike `trisolve_subseed` (which ships to servers as a channel tag),
    these lanes never cross the boundary: they key the one-time-pad
    masks and the Freivalds probes, so a server holding every wire byte
    still cannot precompute against either.
    """
    h = hashlib.sha256()
    h.update(digest)
    h.update(tag)
    h.update(struct.pack(f">{len(idx)}q", *idx))
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "big"))


def _host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor (copied where the array is read-only,
    as wire-decoded arrays are)."""
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An operand (array or tensor) as a tensor of `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def blind_rhs(rhs_aug: torch.Tensor, x_aug: torch.Tensor, digest: bytes,
              rnd: int, transpose: int):
    """One-time-pad a secret RHS before it crosses the trust boundary.

    Returns (shipped, c): shipped = rhs + A·C where A is the matrix the
    round solves through (X' or X'ᵀ) and C is drawn from the secret mask
    lane at the round's scale, so the server's reply is A⁻¹rhs + C and
    the client unmasks by subtracting C. The residual check runs on the
    masked pair, so verification needs no unmasking. C and its scale are
    computed on the host as the reference computes them, bit for bit.
    """
    rng = _lane_rng(digest, b"trisolve-mask", rnd)
    host = rhs_aug.detach().cpu().numpy()
    scale = float(np.linalg.norm(host) / np.sqrt(host.size) + 1.0)
    c = rng.standard_normal(host.shape).astype(host.dtype) * scale
    c = torch.from_numpy(c).to(rhs_aug.device)
    a = x_aug.T if transpose else x_aug
    return rhs_aug + a @ c, c


class LinalgSession:
    """One matrix, one verified outsourced LU, a growing op plan.

    Every public op (`slogdet`, `solve`, `inv`) shares the factors of the
    session's single factorization: `factorizations` stays 1 however
    many ops run. Results are tensors on the session's device (None: the
    CUDA device, RuntimeError without one; "cpu" runs the plain path).
    """

    def __init__(
        self,
        m,
        num_servers: int = 2,
        *,
        transport=None,
        faults=None,
        recover: bool = True,
        standby: int = 0,
        method: str = "q2",
        mode: str = "ewd",
        lambda1: int = 128,
        lambda2: int = 128,
        dtype=None,
        growth_safe: bool | None = None,
        solve_rtol: float | None = None,
        device=None,
    ):
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        m = np.asarray(m)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            raise ValueError(
                f"LinalgSession needs one square matrix, got {m.shape}"
            )
        if dtype is None:
            dtype = m.dtype if np.issubdtype(m.dtype, np.floating) \
                else "float64"
        if growth_safe is None:
            # the op plan's default is ON: the det path can afford the
            # rotation cipher's elimination growth, triangular solves
            # through the factors cannot (rot90 of an SPD kernel matrix
            # is about the worst no-pivot LU input there is)
            growth_safe = True
        # equilibrate stays OFF: the op plan keeps only the scalar
        # log2_scale the det path reads, and solve/inv would need the
        # full scaling vectors
        self.client = SPDCClient(
            lambda1=lambda1, lambda2=lambda2, mode=mode, method=method,
            recover=recover, standby=standby, dtype=dtype,
            growth_safe=growth_safe, equilibrate=False, device=device,
        )
        self.device = self.client.device
        self.transport = resolve_transport(transport, device=self.device)
        self._session = self.client.open_session(m, num_servers,
                                                 faults=faults)
        self._session.keep_factors = True
        self.n = int(m.shape[0])
        self.num_servers = int(num_servers)
        self.digest = self._session.digest
        self.solve_rtol = solve_rtol
        self.factorizations = 0
        self._det_result = None
        self._factors = None
        self._wire_factors = None
        self._x_aug = None
        self._rtol = None
        self._inv_cache = None
        self._ops: list[OpRecord] = []
        self._rounds = 0
        self._meta = self._session.metas[0]
        key = keygen(lambda2, self._session.seeds[0], self.n)
        self._v = torch.as_tensor(key.v, dtype=self.client.dtype,
                                  device=self.device)

    @property
    def padding(self) -> int:
        """Identity-extension rows the augmented system carries beyond n
        (DESIGN.md §3)."""
        return self._session.n_aug - self.n

    # -- the one factorization ----------------------------------------------

    def _ensure_factors(self) -> None:
        if self._factors is not None:
            return
        t0 = time.perf_counter()
        res = self._session.run(self.transport)
        self.factorizations += 1
        self._det_result = res
        if not res.verified:
            raise LinalgVerificationError(
                "factorization rejected by Authenticate (residual "
                f"{float(res.residual):.3e}) and recovery "
                f"{'is disabled' if not self.client.recover else 'failed'}"
                " — the op plan cannot build on unverified factors"
            )
        l, u = self._session._factors
        xa = self._session.x_aug
        # Q2 (the client method, secret-probed: sensitive to the full
        # product the rounds build on) accepted these factors; Q3 on top
        # certifies the band Decipher reads. The growth widening is
        # uncapped: q3 runs after the probed check accepted the same
        # factors, so it is not a dial an attacker sets, and honest
        # no-pivot LU of smooth kernel matrices shows growth far past c·n.
        parts = self._session.partitions
        eps3 = epsilon(parts, xa.shape[-1], xa, dtype=xa.dtype) \
            * growth_estimate(u, xa)
        v3 = authenticate(l, u, xa, num_servers=parts, method="q3",
                          eps=eps3)
        if not v3.all_ok:
            raise LinalgVerificationError(
                "factors passed the probed check but failed the diagonal "
                f"Q3 check (residual {float(v3.residual):.3e} > eps "
                f"{float(v3.eps):.3e})"
            )
        self._factors = (l, u)
        self._x_aug = xa
        # what the rounds ship: one host copy of each factor per session
        self._wire_factors = (l.cpu().numpy(), u.cpu().numpy())
        # a triangular solve through a U with growth ρ loses ~ρ·u·n digits
        # even when everyone is honest; ρ is that of accepted factors
        rho = float(growth_estimate(torch.triu(u), xa))
        self._rtol = float(torch.finfo(xa.dtype).eps) * xa.shape[0] \
            * 256.0 * rho
        synchronize(self.device)
        self._ops.append(OpRecord(
            op="factor", verified=res.verified and v3.all_ok,
            residual=max(float(res.residual), float(v3.residual)),
            wall_s=time.perf_counter() - t0, round_trips=1,
        ))

    # -- public ops ----------------------------------------------------------

    def slogdet(self) -> tuple[float, float]:
        """(sign, log|det|) — free once the factors are verified."""
        t0 = time.perf_counter()
        self._ensure_factors()
        d = self._det_result.det
        self._ops.append(OpRecord(
            op="slogdet", verified=self._det_result.verified,
            residual=float(self._det_result.residual),
            wall_s=time.perf_counter() - t0,
        ))
        return float(d.sign), float(d.logabs)

    def solve(self, b, *, transpose: bool = False) -> torch.Tensor:
        """M x = b (or Mᵀ x = b) through the shared verified factors.

        b: (n,) or (n, c), an array or a tensor. Secret: it rides the
        `blind_rhs` pad.
        """
        b = _as_tensor(b, self.client.dtype, self.device)
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        if b2.ndim != 2 or b2.shape[0] != self.n:
            raise ValueError(
                f"rhs shape {tuple(b.shape)} does not match matrix size "
                f"{self.n}"
            )
        v = self._v[:, None]
        ewd = self._meta.mode == "ewd"
        if transpose:
            # M⁻ᵀw = (B⁻ᵀw)/v (EWD; ·v for EWM): scale after the round
            y = self._apply_binv(b2, adjoint=True, masked=True, op="solve_t")
            y = y / v if ewd else y * v
        else:
            # M⁻¹w = B⁻¹(w/v): scaling a masked round's input is safe,
            # the pad hides it; an inverse round must not (its public RHS
            # would carry key material)
            w = b2 / v if ewd else b2 * v
            y = self._apply_binv(w, adjoint=False, masked=True, op="solve")
        return y[:, 0] if vec else y

    def inv(self, *, transpose: bool = False) -> torch.Tensor:
        """inv(M) via one wide public-RHS round (cached). The round ships
        only permutation columns; the secret 1/v column scaling happens
        here, after verification."""
        if self._inv_cache is None:
            eye = torch.eye(self.n, dtype=self.client.dtype,
                            device=self.device)
            binv = self._apply_binv(eye, adjoint=False, masked=False,
                                    op="inv")
            self._inv_cache = binv / self._v[None, :] \
                if self._meta.mode == "ewd" else binv * self._v[None, :]
        return self._inv_cache.T if transpose else self._inv_cache

    @property
    def report(self) -> SPDCReport:
        """SPDCReport over the whole op plan (ops: one record per op)."""
        base = self._det_result.report if self._det_result is not None \
            else SPDCReport()
        return _dc_replace(base, ops=tuple(self._ops))

    # -- the triangular-solve rounds -----------------------------------------

    def _binv_plan(self, adjoint: bool) -> tuple[int, bool, bool]:
        """(transpose_round, pre_J, post_J) realizing B⁻¹ (or B⁻ᵀ) as one
        G/Gᵀ round with row reversals — the module docstring's table."""
        k = self._meta.rotate_k % 4
        if self._meta.flipped and k % 2 == 1:  # X = Bᵀ exactly
            return (0, False, False) if adjoint else (1, False, False)
        if not adjoint:
            return {0: (0, False, False), 1: (1, True, False),
                    2: (0, True, True), 3: (1, False, True)}[k]
        return {0: (1, False, False), 1: (0, False, True),
                2: (1, True, True), 3: (0, True, False)}[k]

    def _apply_binv(self, w: torch.Tensor, *, adjoint, masked,
                    op) -> torch.Tensor:
        """B⁻¹w (or B⁻ᵀw) for an (n, c) block, via one verified round."""
        self._ensure_factors()
        t0 = time.perf_counter()
        trans, pre, post = self._binv_plan(adjoint)
        z = w.flip(0) if pre else w
        xa = self._x_aug
        rhs = torch.zeros((xa.shape[0], z.shape[1]), dtype=xa.dtype,
                          device=xa.device)
        rhs[: self.n] = z  # border rows zero: inv(X')[:n, :n] = X⁻¹
        y = self._trisolve_round(rhs, transpose=trans, masked=masked,
                                 op=op, t0=t0)[: self.n]
        return y.flip(0) if post else y

    def _chunk_tasks(self, shipped_host: np.ndarray, transpose,
                     rnd) -> list[TriSolveTask]:
        l, u = self._wire_factors
        cols = shipped_host.shape[1]
        splits = np.array_split(np.arange(cols),
                                max(1, min(self.num_servers, cols)))
        tasks = []
        for i, idx in enumerate(splits):
            if idx.size == 0:
                continue
            tasks.append(TriSolveTask(
                server=i, num_servers=self.num_servers,
                l=l, u=u, rhs=shipped_host[:, idx[0] : idx[-1] + 1],
                subseed=trisolve_subseed(self.digest, rnd, i, 0),
                transpose=int(transpose), col0=int(idx[0]),
                session_id=self._session.session_id,
            ))
        return tasks

    def _tolerance(self) -> float:
        return self.solve_rtol if self.solve_rtol is not None else self._rtol

    def _check_chunk(self, task, res, w: torch.Tensor, rnd: int, chunk: int,
                     freivalds: bool) -> float | None:
        """Relative residual if the chunk verifies, None if it fails. w is
        the chunk's shipped columns on the session's device.

        The echo binding (subseed / col0 / transpose) runs first: a stale
        or replayed chunk from another dispatch fails before any math.
        """
        if res is None or res.subseed != task.subseed \
                or res.col0 != task.col0 or res.transpose != task.transpose:
            return None
        if tuple(np.shape(res.y)) != tuple(task.rhs.shape):
            return None
        y = _host_tensor(res.y).to(w.device, w.dtype)
        a = self._x_aug.T if task.transpose else self._x_aug
        tiny = float(torch.finfo(a.dtype).tiny)
        norm = torch.linalg.vector_norm
        if freivalds:
            # secret probe, fresh per (round, chunk, attempt): O(n'²) for
            # a wide chunk instead of O(n'²c), and useless to precompute
            rng = _lane_rng(self.digest, b"trisolve-probe",
                            rnd, chunk, task.attempt)
            r = torch.from_numpy(
                rng.standard_normal(a.shape[0]).astype(_NUMPY_DTYPES[a.dtype])
            ).to(a.device)
            ar = a.T @ r
            num = float(norm(ar @ y - r @ w))
            # the backward-error scale of the compared dot products,
            # ‖aᵀr‖·‖y‖: in the inverse round w is a unit-norm permutation
            # block while y carries ‖M⁻¹‖-scale entries
            den = float(norm(ar) * norm(y) + norm(r @ w)) + tiny
        else:
            num = float(norm(a @ y - w))
            den = float(norm(w)) + tiny
        rel = num / den
        return rel if rel <= self._tolerance() else None

    def _trisolve_round(self, rhs_aug, *, transpose, masked, op, t0):
        """Dispatch one round of column chunks, verify each, heal the bad
        ones, reassemble, unmask."""
        rnd = self._rounds
        self._rounds += 1
        if masked:
            shipped, c = blind_rhs(rhs_aug, self._x_aug, self.digest, rnd,
                                   transpose)
        else:
            shipped, c = rhs_aug, None
        # narrow secret rounds get the full residual, wide public rounds
        # (the inverse) the cheaper Freivalds probe
        freivalds = not masked
        tasks = self._chunk_tasks(shipped.cpu().numpy(), transpose, rnd)
        shipped_cols = [shipped[:, t.col0 : t.col0 + t.cols] for t in tasks]
        results = list(self.transport.solve_shards(
            tasks, faults=self._session.plan
        ))
        residuals, bad = [], []
        for i, (t, r) in enumerate(zip(tasks, results)):
            rel = self._check_chunk(t, r, shipped_cols[i], rnd, i, freivalds)
            if rel is None:
                bad.append(i)
            else:
                residuals.append(rel)
        healed = 0
        if bad:
            if not self.client.recover:
                raise LinalgVerificationError(
                    f"trisolve round {rnd} ({op}): chunks {bad} failed "
                    "verification and recover=False"
                )
            reissued: dict[int, TriSolveTask] = {}

            def make_task(i, attempt, phys):
                t = _dc_replace(
                    tasks[i], server=phys, attempt=attempt,
                    subseed=trisolve_subseed(self.digest, rnd, i, attempt),
                )
                reissued[i] = t
                return t

            def verify_chunk(i, res):
                return self._check_chunk(reissued[i], res, shipped_cols[i],
                                         rnd, i, freivalds)

            results, rep = recover_solve(
                results, bad, make_task=make_task,
                verify_chunk=verify_chunk, transport=self.transport,
                num_servers=self.num_servers, standby=self.client.standby,
            )
            if not rep.ok:
                raise LinalgVerificationError(
                    f"trisolve round {rnd} ({op}): recovery exhausted "
                    f"after {rep.rounds} rounds"
                )
            healed = len(rep.events)
            residuals.extend(e.residual for e in rep.events)
        y = torch.empty_like(shipped)
        for t, r in zip(tasks, results):
            y[:, t.col0 : t.col0 + t.cols] = _host_tensor(r.y)
        if masked:
            y = y - c
        synchronize(self.device)
        self._ops.append(OpRecord(
            op=op, verified=True,
            residual=max(residuals) if residuals else 0.0,
            wall_s=time.perf_counter() - t0, round_trips=1, healed=healed,
        ))
        return y


def outsource_solve(m, rhs, num_servers: int = 2, *, transpose: bool = False,
                    **session_kwargs):
    """One-shot audited solve facade: factor, verify (Q2 + Q3), solve.

    Returns (solution, session), with the standing of
    `core.protocol.outsource_determinant`: the whole PMOP → dispatch →
    blinded round → verify sequence runs inside, so callers never touch
    factors or masks. Hold a `LinalgSession` instead when several ops
    should share one factorization.
    """
    s = LinalgSession(m, num_servers, **session_kwargs)
    y = s.solve(rhs, transpose=transpose)
    return y, s
