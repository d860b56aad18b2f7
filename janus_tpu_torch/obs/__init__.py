"""Telemetry (counterpart: janus_tpu/obs): the metrics registry that the
runtime reports to."""
from janus_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
