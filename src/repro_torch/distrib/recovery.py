"""Verification-driven recovery — re-dispatch one shard, not the protocol
(port of repro.distrib.recovery).

When Authenticate rejects, the blocked-Q1 localization
(core.verify.localize) names the faulty server, every strip above it is
verified clean, and that server's strip is a function of its shard of
the ciphertext and the verified U rows above it. So the client re-issues
that one shard to a standby (or a healthy neighbour) under a fresh
dispatch sub-seed and splices the recomputed strips into the factors:
one recompute of ~1/N of the factorization and O(n·b) wire, not a full
restart.

The loop is verification-driven: recompute → re-verify → repeat. A
report-only fault heals in one round; an in-band relay poisoning (the
tampered U row was consumed downstream) heals one block row per round,
cascading at most N − s rounds, because each round's first failing block
row is computable from the verified rows above it. `max_rounds` defaults
to num_servers.

N + r standby (ServerPool): r spare servers are provisioned up front; a
failed server is retired and its shard goes to a spare, and with the
spares spent to the culprit's next healthy neighbour.

The recompute is `core.lu.lu_block_row`, the arithmetic an EdgeServer
runs; on CUDA tensors it runs the panel and triangular-solve kernels.
`recover_solve` is the analogue for the secure linalg sessions'
triangular-solve rounds: their column chunks are independent, so each
rejected chunk is re-issued to a replacement under a fresh
`trisolve_subseed` until it verifies.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.augment import augment_block_row
from ..core.lu import lu_block_row
from ..core.verify import Verdict, authenticate


def dispatch_subseed(digest: bytes, server: int, attempt: int) -> bytes:
    """Fresh per-dispatch sub-seed: H(Ψ-digest ‖ server ‖ attempt).

    Re-keys the client → server channel so a replayed or stale shard
    cannot impersonate a re-dispatch. Derived, never stored: the client
    keeps only Ψ's digest.
    """
    h = hashlib.sha256()
    h.update(digest)
    h.update(struct.pack(">qq", int(server), int(attempt)))
    return h.digest()


def trisolve_subseed(digest: bytes, rnd: int, chunk: int,
                     attempt: int) -> bytes:
    """Dispatch-channel key for one triangular-solve chunk (DESIGN.md
    §12): H(Ψ-digest ‖ "trisolve" ‖ round ‖ chunk ‖ attempt), a lane
    disjoint from `dispatch_subseed`'s."""
    h = hashlib.sha256()
    h.update(digest)
    h.update(b"trisolve")
    h.update(struct.pack(">qqq", int(rnd), int(chunk), int(attempt)))
    return h.digest()


def recover_solve(
    results: list,
    bad: list[int],
    *,
    make_task,
    verify_chunk,
    transport,
    num_servers: int,
    standby: int = 0,
    max_rounds: int | None = None,
    pool: "ServerPool | None" = None,
) -> tuple[list, "RecoveryReport"]:
    """Heal rejected triangular-solve chunks by re-dispatching them.

    The solve analogue of `recover_lu`, by columns instead of rows:
    chunks are independent (no relay, no cascade), so each round
    re-issues every failed chunk to a pool replacement with attempt + 1
    (a fresh `trisolve_subseed` keys it) and re-verifies it with the
    round's check. One honest replacement per chunk heals it;
    `max_rounds` (default num_servers) bounds a fleet that keeps lying.

    results: the round's TriSolveResults by chunk (None for timeouts);
        healed on a copy, which is returned.
    bad: chunk indices whose verification failed.
    make_task(chunk, attempt, replacement) -> TriSolveTask mints the
        re-issue: the session's closure holds the factors, the RHS and
        the digest, so this module touches no secret material.
    verify_chunk(chunk, result) -> float | None: the residual if the
        chunk now verifies, None if it still fails.
    """
    pool = pool or ServerPool(num_servers, standby)
    max_rounds = num_servers if max_rounds is None else max_rounds
    report = RecoveryReport(ok=False, rounds=0)
    results = list(results)
    pending = sorted(set(bad))
    attempts: dict[int, int] = {}
    for rnd in range(max_rounds):
        if not pending:
            break
        report.rounds = rnd + 1
        still_bad = []
        for c in pending:
            attempts[c] = attempts.get(c, 0) + 1
            phys, pool = pool.replacement_for(c % num_servers)
            task = make_task(c, attempts[c], phys)
            res = transport.repair(task, replacement=phys)
            residual = verify_chunk(c, res)
            if residual is None:
                still_bad.append(c)
                continue
            results[c] = res
            report.events.append(RecoveryEvent(
                round=rnd, server=c, replacement=phys,
                residual=float(residual),
                comm_elements=2 * task.rhs.size + 2 * task.l.size,
                subseed=task.subseed.hex(),
            ))
        pending = still_bad
    report.ok = not pending
    report.standby_used = pool.spares_used
    return results, report


def recovery_comm_elements(n: int, num_servers: int, server: int) -> int:
    """Wire cost (elements) of re-dispatching server `server`'s shard:
    its (b, n) ciphertext block row, the verified upstream U rows (their
    structural support only) and the (2·b·n) L/U strips coming back."""
    b = n // num_servers
    upstream = sum(b * (n - k * b) for k in range(server))
    return b * n + upstream + 2 * b * n


@dataclass(frozen=True)
class ServerPool:
    """N workers + r standbys (frozen bookkeeping: `replacement_for`
    returns the next pool state)."""

    num_servers: int
    standby: int = 0
    spares_used: int = 0
    retired: tuple[int, ...] = ()

    def replacement_for(self, server: int) -> tuple[int, "ServerPool"]:
        """Physical id that re-runs `server`'s shard, and the next pool.

        Standbys are numbered num_servers .. num_servers + standby − 1;
        once they are spent, the shard goes to the culprit's next
        never-retired neighbour, failing that a retired-but-healed one —
        never the culprit itself while another server exists.
        """
        retired = (*self.retired, server)
        if self.spares_used < self.standby:
            phys = self.num_servers + self.spares_used
            return phys, ServerPool(self.num_servers, self.standby,
                                    self.spares_used + 1, retired)
        candidates = [(server + 1 + i) % self.num_servers
                      for i in range(max(self.num_servers - 1, 1))]
        fresh = [c for c in candidates if c not in retired]
        phys = fresh[0] if fresh else candidates[0]
        return phys, ServerPool(self.num_servers, self.standby,
                                self.spares_used, retired)


@dataclass(frozen=True)
class RecoveryEvent:
    """One re-dispatch: which logical server failed, who re-ran its
    shard."""

    round: int
    server: int
    replacement: int
    residual: float
    comm_elements: int
    subseed: str  # hex digest of the fresh dispatch channel key
    matrices: tuple[int, ...] | None = None  # batch indices spliced


@dataclass
class RecoveryReport:
    """Outcome of the verification-driven re-dispatch loop."""

    ok: bool
    rounds: int
    events: list[RecoveryEvent] = field(default_factory=list)
    standby_used: int = 0
    #: the healed (L, U) the final verdict judged, held by reference (no
    #: copy) so a caller can audit what Decipher read; they stay alive as
    #: long as the report does
    factors: tuple[torch.Tensor, torch.Tensor] | None = field(
        default=None, repr=False, compare=False)

    @property
    def servers_replaced(self) -> tuple[int, ...]:
        return tuple(sorted({e.server for e in self.events}))


def _round_rng(digest: bytes, rnd: int) -> np.random.Generator:
    """The secret probe of verification round `rnd` (−1: the first
    verdict's): a server that solved one probe's null space gains
    nothing against the next."""
    h = hashlib.sha256(digest + struct.pack(">q", rnd)).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "big"))


def recover_lu(
    l: torch.Tensor,
    u: torch.Tensor,
    x: torch.Tensor,
    *,
    num_servers: int,
    method: str = "q3",
    standby: int = 0,
    max_rounds: int | None = None,
    digest: bytes = b"",
    pool: ServerPool | None = None,
    style: str = "nserver",
    verdict: Verdict | None = None,
    dispatch=None,
) -> tuple[torch.Tensor, torch.Tensor, Verdict, RecoveryReport]:
    """Heal a rejected factorization by re-dispatching localized shards.

    x is the ciphertext the client dispatched, (n, n) or a (B, n, n)
    stack. Each round takes each rejected matrix's first failing block
    row (the rows above it are clean), recomputes that strip from x and
    the verified upstream U rows, splices it into l and u for exactly the
    matrices that blamed that server, and authenticates again under a
    fresh secret probe. `style` names the operation order of the
    surviving rows (core.lu.lu_block_row), so the recompute replays it
    bit for bit.

    dispatch: optional hook that executes one re-dispatch,
    ``dispatch(x, u, server, attempt, replacement) -> (l_row, u_row)``;
    the Session passes one that mints a ShardTask and runs it on the
    replacement through its Transport. Default: `lu_block_row` here, the
    same arithmetic.

    Returns (l, u, final verdict, report); l and u are new tensors where
    anything was spliced, the inputs themselves otherwise.
    """
    n = x.shape[-1]
    batched = x.ndim == 3
    b = n // num_servers
    pool = pool or ServerPool(num_servers, standby)
    max_rounds = num_servers if max_rounds is None else max_rounds
    report = RecoveryReport(ok=False, rounds=0)
    attempts: dict[int, int] = {}
    if verdict is None:
        verdict = authenticate(l, u, x, num_servers=num_servers,
                               method=method, rng=_round_rng(digest, -1))

    for rnd in range(max_rounds):
        # the verdict is the accept/reject authority; localization only
        # guides healing, so a matrix whose verdict passes is never
        # re-dispatched
        failing = ~np.atleast_1d(np.asarray(verdict.ok))
        culprit = np.where(failing, np.atleast_1d(np.asarray(verdict.culprit)),
                           -1)
        to_heal = sorted({int(c) for c in culprit if c >= 0})
        if not to_heal:
            # healed, or a failure no block row is blamed for
            break
        report.rounds = rnd + 1
        if not report.events:
            l, u = l.clone(), u.clone()
        for s in to_heal:
            attempts[s] = attempts.get(s, 0) + 1
            phys, pool = pool.replacement_for(s)
            if dispatch is not None:
                l_row, u_row = dispatch(x, u, s, attempts[s], phys)
            else:
                l_row, u_row = lu_block_row(x, u, s, num_servers, style=style)
            rows = slice(s * b, (s + 1) * b)
            if batched:
                idx = np.nonzero(culprit == s)[0]
                at = torch.as_tensor(idx, device=l.device)
                l[at, rows, :] = l_row[at].to(l.device, l.dtype)
                u[at, rows, :] = u_row[at].to(u.device, u.dtype)
                sres = float(np.max(verdict.server_residual[idx, s]))
                hit: tuple[int, ...] | None = tuple(int(i) for i in idx)
            else:
                l[..., rows, :] = l_row.to(l.device, l.dtype)
                u[..., rows, :] = u_row.to(u.device, u.dtype)
                sres = float(verdict.server_residual[s])
                hit = None
            report.events.append(RecoveryEvent(
                round=rnd, server=s, replacement=phys, residual=sres,
                comm_elements=recovery_comm_elements(n, num_servers, s),
                subseed=dispatch_subseed(digest, s, attempts[s]).hex(),
                matrices=hit,
            ))
        verdict = authenticate(l, u, x, num_servers=num_servers,
                               method=method, rng=_round_rng(digest, rnd))

    report.ok = bool(np.all(verdict.ok))
    report.standby_used = pool.spares_used
    report.factors = (l, u)
    return l, u, verdict, report


def rederive_shard(
    x: torch.Tensor,
    *,
    padding: int,
    server: int,
    num_servers: int,
    rng: np.random.Generator | None = None,
) -> torch.Tensor:
    """One server's shard of the augmented ciphertext, re-derived from the
    unaugmented ciphertext x by replaying the border's draw
    (core.augment.augment_block_row; `rng` fresh, seeded as the session's
    `border_rng`). Returns the (…, b, n_aug) block row the replacement
    server receives."""
    n_aug = x.shape[-1] + padding
    if n_aug % num_servers != 0:
        raise ValueError(f"n+p={n_aug} not partitioned by N={num_servers}")
    b = n_aug // num_servers
    return augment_block_row(x, padding, server * b, b, rng=rng)
