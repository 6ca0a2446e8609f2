"""Rateless straggler-adaptive dispatch with fleet health (DESIGN.md §8;
port of repro.distrib.rateless).

The classic session binds strip i to server i and the only straggler
remedy is a deadline: wait d rounds, then drop the server wholesale.
This module replaces the deadline with the rateless shape of Bitar et
al.'s adaptive coded computation: the client over-decomposes the
bordered ciphertext into F = overdecompose × N strips and STREAMS them
to whichever workers are free — completion is "every strip verified",
never "every server answered by round d". A slow server is not a fault
to adjudicate; it simply pulls fewer strips.

Three mechanisms, one loop:

  * Per-strip verification gates the wavefront. Strip s of a lane is
    accepted only after a secret Q1-style probe (max |X_s·r − L_s·(U·r)|
    against the growth-widened ε(N), core.verify conventions) — so a
    tampered strip is caught BEFORE any downstream strip consumes its U
    rows, and re-dispatch costs one strip, not a localize→heal cascade.
    The final `Session.collect()` authenticate (Q2/Q3) remains the
    accept/reject authority; the strip probe is the scheduler's gate.
  * FleetHealth turns observations into assignment. EWMA completion
    latency ranks free workers (unknown workers are assumed fast —
    optimism costs one strip to correct); failures back a worker off
    exponentially with deterministic jitter; repeated failures or a
    single detected tamper quarantine it. Quarantined workers re-admit
    only by passing a probation probe: a re-issue of an already-verified
    strip, dispatched as attempt 0 so a persistent tamperer fails it.
  * The degradation ladder keeps the session answering. A strip that
    exhausts `max_attempts`, or a fleet below `min_live`, falls back to
    the client computing the strip inline — EdgeServer arithmetic, no
    transport, on the session's own device (the CUDA kernels when the
    session runs there) — slower, never wrong, never stuck. The rung is
    a protocol step, not a device fallback.

Lanes: a batched session is split into contiguous batch slices
("lanes"), each an independent sequential strip chain — the wavefront
dependency (strip s needs U rows 0..s−1) means a single matrix can only
pipeline one strip at a time, but L lanes keep L workers busy at once.

The scheduler's strip arithmetic (slicing, probes, acceptance) is host
numpy, as in the reference: every message transport hands its results
back as host arrays, and the ciphertext is copied to the host once per
session. Strip s is computed by `core.lu.lu_block_row` in the "nserver"
order over the U rows accepted before it, so a single matrix's
streamed factors are bit-equal to `lu_nserver(x_aug, F)` on the same
device.

Security is unchanged by F > N: a ShardTask still carries only a
ciphered block row and a derived sub-seed; cutting the same ciphertext
into thinner strips hands each worker STRICTLY LESS of it, and the PRT
argument never used "one strip per server" (DESIGN.md §8).
"""

from __future__ import annotations

import hashlib
import struct
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field

import numpy as np

from ..api.messages import ShardResult, ShardTask
from ..api.server import EdgeServer
from ..api.transport import TransportError, TransportTimeout
from ..configs.spdc import RATELESS_DEFAULT, RatelessConfig
from ..core.verify import epsilon
from .recovery import dispatch_subseed

__all__ = ["FleetHealth", "WorkerHealth", "RatelessReport", "run_rateless"]


@dataclass
class WorkerHealth:
    """Everything the client has observed about one physical worker."""

    worker_id: int
    ewma_latency_s: float | None = None  # None = never completed (optimism)
    completed: int = 0  # strips ACCEPTED from this worker
    discarded: int = 0  # late results thrown away (zombie futures)
    failures: int = 0  # transport errors + timeouts, lifetime
    consecutive_failures: int = 0
    tampers: int = 0  # probe-failed strips attributed here
    probes_passed: int = 0
    quarantined: bool = False
    quarantined_at: float = 0.0  # monotonic; probation cooldown anchor
    quarantine_count: int = 0
    next_ok_at: float = 0.0  # backoff gate (monotonic)

    def as_dict(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "ewma_latency_s": self.ewma_latency_s,
            "completed": self.completed,
            "discarded": self.discarded,
            "failures": self.failures,
            "tampers": self.tampers,
            "probes_passed": self.probes_passed,
            "quarantined": self.quarantined,
            "quarantine_count": self.quarantine_count,
        }


class FleetHealth:
    """Per-worker health the rateless scheduler assigns work by.

    Lives on the SPDCClient (not the Session) so what one session learned
    about the fleet — who is slow, who tampers — carries into the next.
    All mutation happens on the scheduler's thread; the tracker is plain
    bookkeeping, no locks, no clocks of its own (callers pass `now` from
    time.monotonic() so tests can drive it virtually).
    """

    def __init__(self, cfg: RatelessConfig | None = None):
        self.cfg = cfg or RATELESS_DEFAULT
        self.workers: dict[int, WorkerHealth] = {}

    def worker(self, wid: int) -> WorkerHealth:
        return self.workers.setdefault(wid, WorkerHealth(worker_id=wid))

    # -- observations --------------------------------------------------------

    def observe_success(self, wid: int, latency_s: float) -> None:
        w = self.worker(wid)
        w.consecutive_failures = 0
        a = self.cfg.ewma_alpha
        w.ewma_latency_s = (
            latency_s if w.ewma_latency_s is None
            else a * latency_s + (1.0 - a) * w.ewma_latency_s
        )

    def observe_failure(self, wid: int, now: float, *,
                        kind: str = "error") -> None:
        """A timeout or transport error: back the worker off exponentially
        (deterministic jitter — reproducible runs, no thundering herd),
        quarantine it after `quarantine_after` consecutive failures."""
        w = self.worker(wid)
        w.failures += 1
        w.consecutive_failures += 1
        k = w.consecutive_failures
        pause = min(self.cfg.backoff_base_s * 2.0 ** (k - 1),
                    self.cfg.backoff_max_s)
        h = hashlib.sha256(struct.pack(">qqq", wid, w.failures, 0)).digest()
        frac = (int.from_bytes(h[:4], "big") / 2**32) * 2.0 - 1.0
        w.next_ok_at = now + pause * (1.0 + self.cfg.backoff_jitter * frac)
        if k >= self.cfg.quarantine_after:
            self._quarantine(w, now)

    def observe_tamper(self, wid: int, now: float) -> None:
        """A strip that failed its secret probe: one strike is enough —
        an arithmetic slip and a forgery are indistinguishable to the
        client, and the probation probe is how the worker earns its way
        back either way."""
        w = self.worker(wid)
        w.tampers += 1
        self._quarantine(w, now)

    def observe_discard(self, wid: int, latency_s: float | None = None) -> None:
        """A zombie future resolved after its strip was re-streamed: the
        result is discarded but the latency sample is still real."""
        w = self.worker(wid)
        w.discarded += 1
        if latency_s is not None:
            self.observe_success(wid, latency_s)
            w.consecutive_failures = 0

    def _quarantine(self, w: WorkerHealth, now: float) -> None:
        if not w.quarantined:
            w.quarantine_count += 1
        w.quarantined = True
        w.quarantined_at = now

    def readmit(self, wid: int, now: float, latency_s: float) -> None:
        w = self.worker(wid)
        w.quarantined = False
        w.consecutive_failures = 0
        w.probes_passed += 1
        w.next_ok_at = now
        self.observe_success(wid, latency_s)

    # -- scheduling views ----------------------------------------------------

    def live(self, fleet: tuple[int, ...]) -> list[int]:
        return [wid for wid in fleet if not self.worker(wid).quarantined]

    def predicted_latency(self, wid: int) -> float:
        w = self.worker(wid)
        return 0.0 if w.ewma_latency_s is None else w.ewma_latency_s

    def assignable(self, fleet, busy, now: float) -> list[int]:
        """Live, idle, out-of-backoff workers — fastest predicted first,
        ties to the one that has completed least (spread the unknowns)."""
        ids = [
            wid for wid in self.live(fleet)
            if wid not in busy and self.worker(wid).next_ok_at <= now
        ]
        ids.sort(key=lambda w: (self.predicted_latency(w),
                                self.worker(w).completed, w))
        return ids

    def probation_due(self, fleet, busy, now: float) -> list[int]:
        return [
            wid for wid in fleet
            if self.worker(wid).quarantined and wid not in busy
            and now - self.worker(wid).quarantined_at
            >= self.cfg.probation_cooldown_s
        ]

    def next_wakeup(self, fleet, now: float) -> float | None:
        """Seconds until some benched worker becomes usable again (backoff
        expiry or probation due) — the scheduler's stall-sleep bound."""
        horizon = []
        for wid in fleet:
            w = self.worker(wid)
            if w.quarantined:
                horizon.append(
                    w.quarantined_at + self.cfg.probation_cooldown_s
                )
            elif w.next_ok_at > now:
                horizon.append(w.next_ok_at)
        if not horizon:
            return None
        return max(0.0, min(horizon) - now)

    def report(self) -> dict:
        return {
            "workers": {
                wid: w.as_dict() for wid, w in sorted(self.workers.items())
            },
        }


@dataclass
class RatelessReport:
    """What one rateless session did — attached to the SPDCResult."""

    num_strips: int
    lanes: int
    dispatches: int = 0
    retries: int = 0
    timeouts: int = 0
    tampered_strips: int = 0
    inline_strips: int = 0  # degradation-ladder completions
    probes: int = 0
    workers: dict = field(default_factory=dict)  # FleetHealth.report()

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["workers"] = dict(self.workers)
        return d


@dataclass
class _Lane:
    """One independent strip chain: a contiguous batch slice (or the
    whole matrix) advancing strip by strip as probes accept."""

    index: int
    sel: slice | None  # batch rows this lane owns (None = unbatched)
    x: np.ndarray  # (…, n', n') ciphertext view
    next_strip: int = 0
    attempts: int = 0  # dispatches of the CURRENT strip
    in_flight: bool = False
    l_rows: list = field(default_factory=list)
    u_rows: list = field(default_factory=list)
    # running concat of u_rows — u_known() is on the mint hot path, and
    # re-concatenating s blocks per dispatch is O(F^2) copies per lane
    u_cat: np.ndarray | None = None

    def u_known(self) -> np.ndarray:
        if self.u_cat is None:
            b, n = 0, self.x.shape[-1]
            return np.zeros((*self.x.shape[:-2], b, n), dtype=self.x.dtype)
        return self.u_cat


@dataclass
class _Dispatch:
    lane: _Lane | None  # None = probation probe
    strip: int
    worker: int
    attempt: int
    t0: float
    probe: bool = False
    stale: bool = False  # timed out client-side; result will be discarded


def _probe_vector(digest: bytes, lane: int, strip: int, attempt: int,
                  n: int, dtype) -> np.ndarray:
    """Fresh SECRET probe per (lane, strip, attempt) — a worker that
    solved one probe's null space gains nothing against the next."""
    h = hashlib.sha256(
        digest + b"rateless-probe"
        + struct.pack(">qqq", lane, strip, attempt)
    ).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "big"))
    return rng.standard_normal(n).astype(dtype)


def _verify_strip(x_row, l_row, u_known, r, eps_base) -> tuple[bool, float]:
    """Secret-probed acceptance of ONE strip (core.verify conventions):
    max |X_s·r − L_s·(U_{0..s}·r)| over the strip's rows, against the
    growth-widened ε(N). Columns of L_s beyond the known U rows must be
    structurally zero (an honest strip's are), so junk planted there
    cannot ride an accepted strip into the final factors."""
    rows = u_known.shape[-2]
    lhs = np.einsum("...ij,j->...i", x_row, r)
    rhs = np.einsum("...ij,...j->...i", l_row[..., :rows],
                    np.einsum("...ij,j->...i", u_known, r))
    res = float(np.max(np.abs(lhs - rhs)))
    tail = l_row[..., rows:]
    if tail.size:
        res = max(res, float(np.max(np.abs(tail))) * float(np.max(np.abs(r))))
    # growth_estimate's clamp(max|U|/max|X|, >= 1), in plain numpy — this
    # runs once per accepted strip on the scheduler's hot path, where a
    # jitted reduction's dispatch overhead would dominate the math
    gx = float(np.max(np.abs(x_row)))
    gu = float(np.max(np.abs(u_known))) if u_known.size else gx
    growth = max(1.0, gu / max(gx, np.finfo(np.asarray(x_row).dtype).tiny))
    return res <= eps_base * growth, res


def run_rateless(
    session,
    transport,
    cfg: RatelessConfig,
    fleet: FleetHealth,
    *,
    faults=(),
) -> tuple[np.ndarray, np.ndarray, RatelessReport]:
    """Drive one session's factorization through the rateless loop.

    Returns (l, u, report) with l/u host numpy arrays shaped like the
    fused sweep's output; `Session.collect()` authenticates them exactly
    as it would any transport's. Raises nothing for fleet trouble — the
    degradation ladder absorbs it — only for programming errors.
    """
    F = session.partitions
    b = session.strip_block
    # one host copy per session: the strips are sliced from it
    x_host = session.x_aug.detach().cpu().numpy()
    n = x_host.shape[-1]
    batched = x_host.ndim == 3
    fleet_ids = tuple(range(session.num_servers))

    if batched:
        B = x_host.shape[0]
        n_lanes = min(B, cfg.lanes or max(1, len(fleet_ids)))
        bounds = np.linspace(0, B, n_lanes + 1).astype(int)
        lanes = [
            _Lane(index=i, sel=slice(int(lo), int(hi)),
                  x=x_host[int(lo):int(hi)])
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:], strict=True))
            if hi > lo
        ]
    else:
        lanes = [_Lane(index=0, sel=None, x=x_host)]

    eps_base = float(
        np.max(np.asarray(
            epsilon(F, n, session.x_aug, dtype=session.x_aug.dtype)
        ))
    )
    report = RatelessReport(num_strips=F, lanes=len(lanes))
    pending: dict[Future, _Dispatch] = {}
    busy: set[int] = set()
    probe_seq = 0
    # the probe pool: an (x_row, u_above, verified row count) re-issue a
    # quarantined worker must reproduce to re-admit — filled by the first
    # verified strip of lane 0
    probe_strip: tuple[int, _Lane] | None = None

    boundary_checked = False

    def mint(lane: _Lane, strip: int, attempt: int) -> ShardTask:
        nonlocal boundary_checked
        s0 = strip * b
        # lane-disambiguated sub-seed token: lanes re-use strip indices,
        # the dispatch channel key must still be unique per (lane, strip)
        token = lane.index * F + strip
        task = ShardTask(
            server=strip,
            num_servers=F,
            x_row=np.ascontiguousarray(lane.x[..., s0:s0 + b, :]),
            subseed=dispatch_subseed(session.digest, token, attempt),
            style="nserver",
            attempt=attempt,
            u_upstream=lane.u_known() if strip > 0 else None,
            session_id=session.session_id,
        )
        # every mint composes the task from the same fields of the same
        # session, so one representative boundary check per session
        # covers them all — the per-strip payloads differ only in which
        # ciphertext rows they slice
        if not boundary_checked:
            session._assert_boundary([task], False)
            boundary_checked = True
        return task

    def accept(lane: _Lane, result: ShardResult) -> None:
        u = np.asarray(result.u_row)
        lane.l_rows.append(np.asarray(result.l_row))
        lane.u_rows.append(u)
        lane.u_cat = (
            u if lane.u_cat is None
            else np.concatenate([lane.u_cat, u], axis=-2)
        )
        lane.next_strip += 1
        lane.attempts = 0
        lane.in_flight = False

    def verify(lane: _Lane, strip: int, attempt: int,
               result: ShardResult) -> bool:
        s0 = strip * b
        r = _probe_vector(session.digest, lane.index, strip, attempt, n,
                          x_host.dtype)
        u_new = np.asarray(result.u_row)
        u_known = (
            u_new if lane.u_cat is None
            else np.concatenate([lane.u_cat, u_new], axis=-2)
        )
        ok, _ = _verify_strip(
            lane.x[..., s0:s0 + b, :], np.asarray(result.l_row),
            u_known, r, eps_base,
        )
        return ok

    def run_inline(lane: _Lane) -> None:
        """Degradation ladder, last rung: the client computes the strip
        itself — EdgeServer arithmetic on the session's device, no
        transport, no faults."""
        task = mint(lane, lane.next_strip, lane.attempts)
        lane.attempts += 1
        accept(lane, EdgeServer(None, device=session.x_aug.device).run(task))
        report.inline_strips += 1

    def dispatch(lane: _Lane, wid: int, now: float) -> None:
        task = mint(lane, lane.next_strip, lane.attempts)
        if lane.attempts > 0:
            report.retries += 1
        rec = _Dispatch(lane=lane, strip=lane.next_strip, worker=wid,
                        attempt=lane.attempts, t0=now)
        lane.attempts += 1
        lane.in_flight = True
        busy.add(wid)
        report.dispatches += 1
        fut = transport.start(task, wid, faults=faults,
                              timeout=cfg.request_timeout_s)
        pending[fut] = rec

    def dispatch_probe(wid: int, now: float) -> None:
        nonlocal probe_seq
        strip, lane = probe_strip
        s0 = strip * b
        probe_seq += 1
        task = ShardTask(
            server=strip,
            num_servers=F,
            x_row=np.ascontiguousarray(lane.x[..., s0:s0 + b, :]),
            # attempt stays 0 on the WIRE so a persistently tampering
            # worker misbehaves on the probe too; the sub-seed token keys
            # the channel uniquely per probe regardless
            subseed=dispatch_subseed(session.digest, -2, 1000 + probe_seq),
            style="nserver",
            attempt=0,
            u_upstream=(
                np.concatenate(lane.u_rows[:strip], axis=-2)
                if strip > 0 else None
            ),
            session_id=session.session_id,
        )
        # rec.attempt carries the probe sequence (not the wire attempt)
        # so verify_probe re-derives THIS probe's vector even when
        # several probes are in flight
        rec = _Dispatch(lane=None, strip=strip, worker=wid,
                        attempt=1000 + probe_seq, t0=now, probe=True)
        busy.add(wid)
        report.probes += 1
        fut = transport.start(task, wid, faults=faults,
                              timeout=cfg.request_timeout_s)
        pending[fut] = rec

    def verify_probe(rec: _Dispatch, result: ShardResult) -> bool:
        strip, lane = probe_strip
        s0 = strip * b
        r = _probe_vector(session.digest, -2, strip, rec.attempt, n,
                          x_host.dtype)
        u_known = np.concatenate(
            [*lane.u_rows[:strip], np.asarray(result.u_row)], axis=-2
        )
        ok, _ = _verify_strip(
            lane.x[..., s0:s0 + b, :], np.asarray(result.l_row),
            u_known, r, eps_base,
        )
        return ok

    def settle(fut: Future, now: float) -> None:
        rec = pending.pop(fut)
        busy.discard(rec.worker)
        err = fut.exception()
        if rec.stale:
            # zombie: its strip was re-streamed when the client-side
            # deadline passed; the worker is merely free again now
            if err is None:
                fleet.observe_discard(rec.worker, now - rec.t0)
            return
        if err is not None:
            if isinstance(err, (TransportError, FutureTimeout)):
                if isinstance(err, TransportTimeout):
                    report.timeouts += 1
                fleet.observe_failure(rec.worker, now)
                if rec.probe:
                    # a failed probe restarts the cooldown — no point
                    # re-probing a worker that just timed out
                    fleet.worker(rec.worker).quarantined_at = now
                elif rec.lane is not None:
                    rec.lane.in_flight = False
                return
            raise err
        result = fut.result()
        if rec.probe:
            if verify_probe(rec, result):
                fleet.readmit(rec.worker, now, now - rec.t0)
            else:
                fleet.observe_tamper(rec.worker, now)
            return
        lane = rec.lane
        lane.in_flight = False
        if rec.strip != lane.next_strip:
            # a duplicate answer for an already-accepted strip
            fleet.observe_discard(rec.worker, now - rec.t0)
            return
        if verify(lane, rec.strip, rec.attempt, result):
            accept(lane, result)
            fleet.observe_success(rec.worker, now - rec.t0)
            fleet.worker(rec.worker).completed += 1
        else:
            report.tampered_strips += 1
            fleet.observe_tamper(rec.worker, now)

    while True:
        now = time.monotonic()
        if all(lane.next_strip >= F for lane in lanes):
            # every strip verified — do NOT wait out stale zombies or
            # in-flight probes; their pool threads resolve in the
            # background and the unobserved results are simply dropped
            break
        open_lanes = [
            lane for lane in lanes
            if lane.next_strip < F and not lane.in_flight
        ]

        if probe_strip is None:
            for lane in lanes:
                if lane.next_strip > 0:
                    probe_strip = (0, lane)
                    break

        # degradation ladder, rungs 1–2: exhausted strips and a
        # too-small fleet complete inline — the session answers anyway
        live = fleet.live(fleet_ids)
        for lane in list(open_lanes):
            if lane.attempts >= cfg.max_attempts or len(live) < cfg.min_live:
                run_inline(lane)
                open_lanes.remove(lane)

        for wid in fleet.assignable(fleet_ids, busy, now):
            if not open_lanes:
                break
            # most-behind lane first: the stragglers' backlog gets the
            # fastest predicted worker
            open_lanes.sort(key=lambda lane: lane.next_strip)
            dispatch(open_lanes.pop(0), wid, now)

        if probe_strip is not None:
            for wid in fleet.probation_due(fleet_ids, busy, now):
                dispatch_probe(wid, now)

        if not pending:
            if not any(lane.next_strip < F for lane in lanes):
                break
            # nothing in flight, nothing assignable: either a bench is
            # about to expire (sleep until it does) or the fleet is gone
            # (finish inline)
            pause = fleet.next_wakeup(fleet_ids, time.monotonic())
            if pause is None or not fleet.live(fleet_ids):
                for lane in lanes:
                    while lane.next_strip < F:
                        run_inline(lane)
                break
            time.sleep(min(pause + 1e-3, 0.25))
            continue

        # client-side request deadline: transports that cannot preempt a
        # worker (threads) still converge on the one straggler policy —
        # the strip is re-streamed, the late future becomes a zombie
        if cfg.request_timeout_s is not None:
            for rec in pending.values():
                if rec.stale or now - rec.t0 <= cfg.request_timeout_s:
                    continue
                rec.stale = True
                report.timeouts += 1
                fleet.observe_failure(rec.worker, now)
                if rec.probe:
                    fleet.worker(rec.worker).quarantined_at = now
                elif rec.lane is not None:
                    rec.lane.in_flight = False

        done, _ = futures_wait(
            list(pending), timeout=0.05, return_when="FIRST_COMPLETED"
        )
        now = time.monotonic()
        for fut in done:
            settle(fut, now)

    # assemble: strips back into (…, n', n') factors, lanes back into
    # batch order (contiguous slices — concatenation restores it)
    def stack(rows_attr):
        per_lane = [
            np.concatenate(getattr(lane, rows_attr), axis=-2)
            for lane in lanes
        ]
        if not batched:
            return per_lane[0]
        return np.concatenate(per_lane, axis=0)

    report.workers = fleet.report()["workers"]
    return stack("l_rows"), stack("u_rows"), report
