"""The paper's own workload config: SPDC secure determinant outsourcing
(port of repro.configs.spdc).

Ported so far: `RatelessConfig`, the knobs of the rateless dispatch
layer (distrib.rateless), and its default instance. The gateway's
configs come with the gateway (ROADMAP A11).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RatelessConfig:
    """Knobs of the rateless dispatch layer (distrib.rateless).

    The scheduler streams strip tasks to whichever workers are free and
    completes when enough VERIFIED strips arrived — so there is no
    deadline to tune; these knobs shape how hard it leans on a degraded
    fleet, not whether it finishes.

    overdecompose: strips per matrix = overdecompose × num_servers (the
        paper's F > N rateless factor; 2 doubles the strips so a fast
        worker can absorb a slow one's share strip-by-strip).
    request_timeout_s: per-request wall-clock deadline handed to the
        transport (None = the transport's own default). A miss counts as
        a failure against the worker and the strip is re-streamed.
    max_attempts: dispatch attempts per strip before the client computes
        it inline (the degradation ladder's last rung — the session
        answers even with the whole fleet dark).
    backoff_base_s / backoff_max_s / backoff_jitter: exponential backoff
        between a worker's consecutive failures — base·2^(k−1) capped at
        max, ±jitter fraction drawn deterministically from the dispatch
        sub-seed (reproducible runs, no thundering herd).
    quarantine_after: consecutive failures (or ONE tamper) that bench a
        worker; it re-admits only by passing a probation probe — a
        re-issue of an already-verified strip checked against the known
        answer.
    probation_cooldown_s: how long a quarantined worker sits out before
        the scheduler spends a probe on it.
    ewma_alpha: weight of the newest latency sample in the per-worker
        EWMA the work-stealing assignment ranks workers by.
    min_live: fleet floor — fewer live workers than this flips the
        session to inline completion of the remaining strips.
    lanes: independent dispatch lanes for BATCHED sessions (each lane
        owns a contiguous slice of the batch and its own sequential
        strip chain, so lanes are what actually run concurrently).
        None = min(batch, fleet size); single matrices always run 1 lane.
    """

    overdecompose: int = 2
    request_timeout_s: float | None = 30.0
    max_attempts: int = 4
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.25
    quarantine_after: int = 2
    probation_cooldown_s: float = 0.5
    ewma_alpha: float = 0.5
    min_live: int = 1
    lanes: int | None = None

    def __post_init__(self):
        if self.overdecompose < 1:
            raise ValueError("overdecompose must be >= 1")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.min_live < 0:
            raise ValueError("min_live must be >= 0")


RATELESS_DEFAULT = RatelessConfig()
