"""Observability for the port: the metric registry subset the serving
engine and the resilient training loop report through."""

from apex_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    Timer,
    get_registry,
    set_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry", "Timer",
           "get_registry", "set_registry"]
