"""Online serving: micro-batched, bucket-laddered inference, replicated
behind a socket front end.

The counterpart of ``fast_tffm_tpu/serving``:

  * ``ServingEngine`` (engine.py) with its admission queue (admission.py),
    bucket ladder (buckets.py) and metrics (metrics.py): line, row and
    block (binary frame) submission, hot reload of full saves and delta
    chains swapped in between flushes; ``serve_lines`` is the pipe-mode
    ``serve`` verb;
  * the replicated tier: the wire protocol (protocol.py), replica worker
    processes (replica.py), the health-checked router with failover,
    restarts and one reload watcher (router.py), the TCP front end
    (frontend.py, ``serve --port``) and its clients (client.py).
"""

from fast_tffm_tpu_torch.serving.admission import AdmissionQueue
from fast_tffm_tpu_torch.serving.buckets import BucketLadder
from fast_tffm_tpu_torch.serving.engine import (
    DeadlineExceeded,
    EngineClosed,
    OverloadError,
    ServingEngine,
    serve_lines,
)
from fast_tffm_tpu_torch.serving.metrics import LatencyHistogram, ServingMetrics
from fast_tffm_tpu_torch.serving.protocol import (
    BadRequest,
    Overloaded,
    Unavailable,
    WireError,
)

__all__ = [
    "AdmissionQueue",
    "BadRequest",
    "BucketLadder",
    "DeadlineExceeded",
    "EngineClosed",
    "LatencyHistogram",
    "Overloaded",
    "OverloadError",
    "ServingEngine",
    "ServingMetrics",
    "Unavailable",
    "WireError",
    "serve_lines",
]
