"""Serving layer of the port (port of repro.serve).

Two stacks live here:

* **SPDC gateway** (`queue`, `resilience`, `metrics`, `locking`,
  `spdc_gateway`) — the paper's workload as a service: an async
  micro-batching determinant gateway that coalesces single-matrix client
  requests into batched protocol sweeps on the card (DESIGN.md §5), with
  admission control, circuit breakers, a result cache and a metrics and
  health surface (DESIGN.md §10). Entry points: `SPDCGateway`,
  `AsyncSPDCGateway`, `python -m repro_torch.launch.serve_spdc`.
* **LM serving** (`kvcache`, `steps`) — the KV caches and the prefill and
  decode steps (`python -m repro_torch.launch.serve`).
"""

from .metrics import (  # noqa: F401
    FlushEvent,
    GatewayMetrics,
    MetricsSnapshot,
    QuantileSketch,
    RejectEvent,
    VerdictEvent,
    render_healthz,
    render_prometheus,
)
from .queue import (  # noqa: F401
    BucketKey,
    GatewayOverloaded,
    GatewayStats,
    MicroBatchQueue,
    NoBucketFits,
    bucket_size_for,
)
from .resilience import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    BreakerOpen,
    CircuitBreaker,
    ResultCache,
    TokenBucket,
)
from .spdc_gateway import (  # noqa: F401
    AsyncSPDCGateway,
    GatewayResult,
    SPDCGateway,
)
