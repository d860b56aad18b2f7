"""Telemetry (counterpart: janus_tpu/obs): the metrics registry that the
runtime reports to, the flight recorder of causal spans, the AIMD
block-size controller and the health watchdog."""
from janus_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    disable,
    enable,
    get_recorder,
)
from janus_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
from janus_tpu_torch.obs.scheduler import AdaptiveTick, SchedulerConfig  # noqa: F401
from janus_tpu_torch.obs.watchdog import (  # noqa: F401
    HealthWatchdog,
    WatchdogConfig,
    merge_health,
)
