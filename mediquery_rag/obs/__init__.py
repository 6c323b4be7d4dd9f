"""Metrics & tracing. The reference had only emoji print lines (SURVEY §5);
here recall/QPS/latency are first-class measured quantities."""

from mediquery_rag.obs.metrics import (  # noqa: F401
    recall_at_k,
    device_time,
    Timer,
)
