"""Observability core of the port (port of ``paddle_tpu/observability``):
spans and counters (``comm_span`` opens ``torch.profiler.record_function``),
streaming histograms and the Prometheus exposition (``LogHistogram``,
``MetricsRegistry``), step telemetry (``StepMetrics``), request-lifecycle
tracing (``RequestTracer``) and the failure flight recorder
(``FlightRecorder``).

Switched by ``PADDLE_TPU_TORCH_TELEMETRY`` /
``PADDLE_TPU_TORCH_TRACE_REQUESTS`` / ``PADDLE_TPU_TORCH_FLIGHT_RECORDER``
(+ ``PADDLE_TPU_TORCH_TELEMETRY_DIR`` for file output). The fleet view,
the roofline ledger and the regression ratchet are not ported.
"""
from .exporters import (JsonlWriter, load_jsonl, process_rank,  # noqa: F401
                        write_chrome_trace)
from .flight_recorder import (FlightRecorder, flight_recorder_enabled,  # noqa: F401
                              load_dump)
from .histogram import (LogHistogram, histogram_sample_lines,  # noqa: F401
                        render_prometheus)
from .metrics import (PEAK_FLOPS_TABLE, StepMetrics, active,  # noqa: F401
                      peak_flops_info, peak_flops_per_device, set_active)
from .registry import MetricsRegistry  # noqa: F401
from .request_trace import RequestTracer  # noqa: F401
from .trace import (ENV_TELEMETRY, ENV_TELEMETRY_DIR, comm_span,  # noqa: F401
                    counters, overlap_flags, record_counter, reset_counters,
                    set_counter, telemetry_dir, telemetry_enabled)
