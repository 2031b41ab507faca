"""Host-side observability (the port of ``repro.obs``): counters, gauges,
exact-percentile histograms, span timers, the device-counter bridge, the
snapshot sinks and the provenance block of the BENCH artifacts.

Everything accumulates on the host; device counters cross to it only when
a registry snapshots (``MetricsRegistry.register_collector``), and sinks
(:class:`InMemorySink`, :class:`JSONLSink`) receive whole snapshots via
:meth:`MetricsRegistry.emit`.
"""
from repro_torch.obs.bridge import DeviceCounterBridge
from repro_torch.obs.meta import bench_meta
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Span)
from repro_torch.obs.sinks import InMemorySink, JSONLSink, Sink

__all__ = ["Counter", "DeviceCounterBridge", "Gauge", "Histogram",
           "MetricsRegistry", "Span", "InMemorySink", "JSONLSink", "Sink",
           "bench_meta"]
