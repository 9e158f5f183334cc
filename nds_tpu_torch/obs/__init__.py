"""Observability subsystem: structured event tracing, live telemetry,
and post-run profiling. The port of nds_tpu/obs/: the modules keep the
reference's event schema, file layout and HTTP routes, so each package's
reader and `profile` CLI read the other's event files.

`trace` — the Tracer (JSON-lines event log, `NDS_TRACE_DIR` /
`engine.trace_dir`, rotating at `engine.trace_rotate_bytes`), the golden
event schema, and thread-local binding.
`metrics` — the LIVE half: in-process counters/gauges/histograms fed
from `Tracer.emit` plus the /statusz run status (`engine.metrics_port`).
`httpserv` — the stdlib daemon-thread HTTP endpoint serving them.
`memwatch` — per-query device-memory/RSS high-water sampling + the
heartbeat liveness beacon.
`reader` — event-log parsing, validation, segment-chain reassembly,
fold-in summaries, operator aggregation, trace-dir compaction, and A/B
comparison (backing `cli/profile.py`).
`flight` — the always-on flight recorder: a process-wide bounded event
ring every Tracer feeds, flushed as self-contained failure bundles on
watchdog fire / ladder exhaustion / crash / `/debug/flight`.
`critpath` — critical-path reconstruction: per-query wall attributed to
named causes (exchange-wait/skew, spill-io, ladder retries, ...) with
mesh straggler naming (backing `profile --critical-path`).
"""

from .trace import (  # noqa: F401
    EVENT_SCHEMA,
    Tracer,
    bind,
    current,
    resolve_trace_dir,
    tracer_from_conf,
)
from .memwatch import MemorySampler  # noqa: F401
from .metrics import (  # noqa: F401
    METRIC_KINDS,
    MetricsRegistry,
    MetricsSink,
    resolve_metrics_port,
    validate_exposition,
)
