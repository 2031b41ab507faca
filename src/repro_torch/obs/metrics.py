"""Metric primitives + the registry (DESIGN.md §10).

Design constraints, in order:

  1. Near-zero hot-path cost.  ``Counter.inc`` is one int add;
     ``Histogram.record_many`` appends ONE numpy array reference per
     call (no copies, no sorting); spans are two ``perf_counter_ns``
     reads.  Nothing allocates per sample.
  2. Never inside jit.  These objects are plain host Python; structures
     that carry device-resident counters expose them through registry
     *collectors* that are only invoked at snapshot time -- an explicit
     force boundary -- so attaching metrics never adds a host sync to a
     dispatch path.
  3. Exact tails.  The log2 bucket vector is for cheap merging and
     shape inspection; p50/p99/p999 are computed from the retained raw
     samples (``method="nearest"``: every reported quantile is an
     actually-observed value).  Past ``max_samples`` the reservoir
     degrades gracefully to uniform subsampling and the snapshot says
     so (``exact: false``) instead of silently lying.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

# log2 bucket i counts samples in [2^i, 2^(i+1)) * RESOLUTION seconds;
# RESOLUTION = 1 ns so bucket 0 starts at the clock's own granularity.
N_BUCKETS = 64
RESOLUTION = 1e-9


class Counter:
    """Monotone host-side total."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc requires n >= 0, got {n}")
        self.value += int(n)


class Gauge:
    """Last-written level (may go up or down)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Log2-bucketed distribution with exact sample-based quantiles.

    ``record``/``record_many`` append to a chunk list (one array ref per
    call); buckets and quantiles are computed lazily at snapshot time.
    ``max_samples`` bounds retained memory: beyond it, chunks are
    uniformly subsampled 2x (repeatedly as needed) and quantiles become
    estimates -- flagged via ``exact`` in the snapshot.
    """
    __slots__ = ("_chunks", "_n", "_sum", "_min", "_max", "_stride",
                 "max_samples")

    def __init__(self, max_samples: int = 1 << 25):
        self.max_samples = max_samples
        self.reset()

    def reset(self) -> None:
        self._chunks = []
        self._n = 0          # recorded sample count (pre-subsampling)
        self._sum = 0.0
        self._min = None
        self._max = None
        self._stride = 1     # keep every _stride-th sample

    def record(self, value: float) -> None:
        self.record_many(np.asarray([value], np.float64))

    def record_many(self, values: np.ndarray) -> None:
        values = np.asarray(values)
        if values.size == 0:
            return
        self._n += values.size
        self._sum += float(values.sum())
        lo, hi = float(values.min()), float(values.max())
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)
        self._chunks.append(values[::self._stride]
                            if self._stride > 1 else values)
        if sum(c.size for c in self._chunks) > self.max_samples:
            # halve retention uniformly; min/max/sum/count stay exact
            self._stride *= 2
            self._chunks = [np.concatenate(self._chunks)[::2]]

    @property
    def count(self) -> int:
        return self._n

    def _samples(self) -> np.ndarray:
        if not self._chunks:
            return np.empty((0,), np.float64)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]

    def percentile(self, q: float) -> float:
        """Quantile from retained samples (``q`` in [0, 100]); every
        value returned was actually observed (method="nearest")."""
        s = self._samples()
        if s.size == 0:
            return float("nan")
        return float(np.percentile(s, q, method="nearest"))

    def buckets(self) -> np.ndarray:
        """i64[64] log2 bucket counts over the RETAINED samples: bucket
        i covers [2^i, 2^(i+1)) ns (values < 1 ns land in bucket 0)."""
        s = self._samples()
        out = np.zeros((N_BUCKETS,), np.int64)
        if s.size:
            idx = np.clip(np.floor(np.log2(np.maximum(
                s / RESOLUTION, 1.0))).astype(np.int64), 0, N_BUCKETS - 1)
            np.add.at(out, idx, 1)
        return out

    def snapshot(self) -> dict:
        exact = self._stride == 1
        d = {
            "count": self._n,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "mean": self._sum / self._n if self._n else None,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "p999": self.percentile(99.9),
            "exact": exact,
        }
        if not np.isfinite(d["p50"]):
            d["p50"] = d["p99"] = d["p999"] = None
        b = self.buckets()
        nz = np.flatnonzero(b)
        d["buckets_log2ns"] = {int(i): int(b[i]) for i in nz}
        return d


class Span:
    """Context-manager stage timer: records elapsed seconds into its
    histogram on exit.  Two clock reads; reentrant-safe (each ``with``
    gets its own instance via :meth:`MetricsRegistry.span`)."""
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist
        self._t0 = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.record((time.perf_counter_ns() - self._t0) * 1e-9)


class MetricsRegistry:
    """The one read path for every structure's telemetry.

    Named counters/gauges/histograms are created on first reference
    (``registry.counter("spine.redelivered").inc()``).  Structures with
    device-resident counters register a *collector* -- a zero-arg
    callable returning a flat dict -- that is invoked ONLY at snapshot
    time, so the device->host crossing happens at an explicit
    force/flush boundary, never per-op (DESIGN.md §10).

    A background thread (a ``Snapshotter``'s build) may create metrics
    while the main thread snapshots: creation and the snapshot's copy of
    the tables hold one lock.
    """

    def __init__(self, sinks=()):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self.sinks = list(sinks)

    # -- metric accessors (create on first use) ---------------------------

    def _get(self, table: dict, name: str, make):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.get(name)
                if m is None:
                    m = table[name] = make()
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str, max_samples: Optional[int] = None
                  ) -> Histogram:
        return self._get(self._hists, name, lambda: Histogram(
            **({} if max_samples is None else {"max_samples": max_samples})))

    def span(self, name: str) -> Span:
        """``with registry.span("route"): ...`` -- stage timer into the
        ``span.<name>`` histogram."""
        return Span(self.histogram(f"span.{name}"))

    def register_collector(self, name: str,
                           fn: Callable[[], dict]) -> None:
        """Register a flat-dict provider read at snapshot time.  The
        latest registration under a name wins (a structure re-attaching
        after recovery replaces its old closure)."""
        with self._lock:
            self._collectors[name] = fn

    # -- read path --------------------------------------------------------

    def snapshot(self) -> dict:
        """One structured view of everything: host metrics + every
        collector's device-counter crossing.  THE force boundary at
        which device telemetry becomes host-visible.  Collectors run
        FIRST so gauges they refresh (e.g. snapshot age) read current."""
        with self._lock:
            collectors = list(self._collectors.items())
        collected = {k: fn() for k, fn in collectors}
        with self._lock:
            counters, gauges, hists = (list(t.items()) for t in (
                self._counters, self._gauges, self._hists))
        return {
            "counters": {k: c.value for k, c in counters},
            "gauges": {k: g.value for k, g in gauges},
            "histograms": {k: h.snapshot() for k, h in hists},
            "collected": collected,
        }

    def reset_volatile(self) -> None:
        """Clear gauges and histograms (the volatile view); counters --
        the durable monotone totals -- survive, mirroring how recovery
        rebuilds volatile indexes but never un-counts committed work."""
        with self._lock:
            gauges, hists = list(self._gauges.values()), list(
                self._hists.values())
        for g in gauges:
            g.set(0.0)
        for h in hists:
            h.reset()

    def emit(self, label: str = "") -> dict:
        """Snapshot + push to every sink.  Returns the snapshot."""
        snap = self.snapshot()
        if label:
            snap = {"label": label, **snap}
        for s in self.sinks:
            s.write(snap)
        return snap
