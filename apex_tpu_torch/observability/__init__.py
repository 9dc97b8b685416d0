"""Observability for the port: the metric registry subset the serving
engine reports through."""

from apex_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
    set_registry,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry",
           "get_registry", "set_registry"]
