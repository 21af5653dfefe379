"""Telemetry of the port: the on-device ring, flow probes and link
accumulator, the phase profiler and the metrics registry (port of
``shadow1_tpu/telemetry``).

* ``telemetry.ring`` / ``probes`` / ``links`` — device planes written
  inside the window loop and drained at chunk boundaries;
* ``telemetry.profiler`` — host-side phase spans as Chrome trace events,
  and ``device_trace`` (``torch.profiler``) under them;
* ``telemetry.registry`` — the counter namespace, the JSONL record schema
  and Prometheus exposition.

``registry`` and ``profiler`` import no torch at module level.
"""

from shadow1_tpu_torch.telemetry.profiler import (  # noqa: F401
    PH_CHECKPOINT,
    PH_COMPILE,
    PH_DEVICE_TRACE,
    PH_DRAIN,
    PH_INIT,
    PH_RUN_CHUNK,
    PhaseProfiler,
    device_trace,
    maybe_span,
)
from shadow1_tpu_torch.telemetry.registry import (  # noqa: F401
    DROP_FIELDS,
    DROP_SPECS,
    METRIC_SPECS,
    RECORD_TYPES,
    RING_COUNTERS,
    RING_DIGESTS,
    RING_FIELDS,
    RING_GAUGES,
    RING_WORK,
    ExpositionServer,
    normalize,
    to_prometheus,
)
