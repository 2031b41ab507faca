"""Device-counter crossing: durable monotone totals over resetting state.

The structures' ``n_psync``/``n_ops`` live in device state that recovery
legitimately resets to zero (a recovered ``SetState``/``QueueState`` is
rebuilt from persisted payloads; its accounting planes start fresh).
Operators still want MONOTONE lifetime totals -- "psyncs since the
process started serving", across any number of crash/recover cycles.

:class:`DeviceCounterBridge` provides that: at every fold boundary
(snapshot, flush, the instant before a crash is applied) it reads the
current device counter values, adds the delta since the previous fold to
a registry counter ``<name>.<key>_total``, and re-baselines.  A negative
delta means the device counter was reset since the last fold (a recovery
the caller did not announce); the bridge then counts the full current
value -- conservative, never double-counting announced folds because
:meth:`mark_reset` re-baselines explicitly on the recovery path.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.obs.metrics import MetricsRegistry


class DeviceCounterBridge:
    __slots__ = ("registry", "name", "_last")

    def __init__(self, registry: MetricsRegistry, name: str):
        self.registry = registry
        self.name = name
        self._last: Dict[str, int] = {}

    def fold(self, **current: int) -> None:
        """Add each counter's delta since the last fold to its durable
        ``<name>.<key>_total``.  Call only at force boundaries -- the
        values passed are host ints the caller already synced."""
        for k, v in current.items():
            v = int(v)
            delta = v - self._last.get(k, 0)
            if delta < 0:              # un-announced device-counter reset
                delta = v
            if delta:
                self.registry.counter(f"{self.name}.{k}_total").inc(delta)
            self._last[k] = v

    def mark_reset(self, **current: int) -> None:
        """Re-baseline after an announced device-counter reset (recovery)
        WITHOUT folding: the pre-reset deltas were folded by the caller
        before the crash was applied."""
        for k, v in current.items():
            self._last[k] = int(v)

    def total(self, key: str) -> int:
        return self.registry.counter(f"{self.name}.{key}_total").value
