"""Host-side observability: counters, gauges, exact-percentile histograms
and the device-counter bridge (copies of ``repro.obs.metrics`` and
``repro.obs.bridge``; the sinks and ``bench_meta`` are not ported yet)."""
from repro_torch.obs.bridge import DeviceCounterBridge
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Span)

__all__ = ["Counter", "DeviceCounterBridge", "Gauge", "Histogram",
           "MetricsRegistry", "Span"]
