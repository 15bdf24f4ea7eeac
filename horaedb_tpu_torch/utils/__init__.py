"""Cross-cutting utilities: observability registry + tracing spans."""

from horaedb_tpu_torch.utils.metrics import (WIDE_BUCKETS, Counter, Gauge,
                                             Histogram, MetricsRegistry,
                                             registry)
from horaedb_tpu_torch.utils.tracing import (active_trace, current_span,
                                             current_trace_id, new_trace_id,
                                             op_trace, recorder, span,
                                             trace_add, trace_scope)

__all__ = ["WIDE_BUCKETS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "active_trace", "current_span",
           "current_trace_id", "new_trace_id", "op_trace", "recorder",
           "registry", "span", "trace_add", "trace_scope"]
