"""Online serving: micro-batched, bucket-laddered inference on one device.

The counterpart of ``fast_tffm_tpu/serving``'s in-process engine:
``ServingEngine`` (engine.py) with its admission queue (admission.py),
bucket ladder (buckets.py) and metrics (metrics.py), and ``serve_lines``,
the pipe-mode ``serve`` verb.  The socket front end, router and replicas
are a later slice of the port.
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

__all__ = [
    "AdmissionQueue",
    "BucketLadder",
    "DeadlineExceeded",
    "EngineClosed",
    "LatencyHistogram",
    "OverloadError",
    "ServingEngine",
    "ServingMetrics",
    "serve_lines",
]
