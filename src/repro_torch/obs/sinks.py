"""Snapshot sinks: where ``MetricsRegistry.emit`` sends its snapshots
(a copy of ``repro.obs.sinks``).

The protocol is deliberately tiny (``write(snapshot)``, ``close()``) so
a tracker backend can slot in later without touching the registry.  Two
reference sinks ship:

  InMemorySink   appends snapshots to a list (tests, short drivers)
  JSONLSink      one JSON object per line to a file (the machine-
                 readable trail a long open-loop run leaves behind)
"""
from __future__ import annotations

import json
from typing import IO, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Sink(Protocol):
    """A snapshot consumer; registered via ``MetricsRegistry(sinks=...)``
    or appended to ``registry.sinks``."""

    def write(self, snapshot: dict) -> None: ...

    def close(self) -> None: ...


class InMemorySink:
    """Keeps every emitted snapshot in ``records`` (newest last)."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, snapshot: dict) -> None:
        self.records.append(snapshot)

    def close(self) -> None:
        pass


def _to_jsonable(obj):
    """Recursively coerce numpy scalars/arrays and tensors (on any device)
    so snapshots serialize."""
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class JSONLSink:
    """One snapshot per line, flushed on every write (a crash mid-run
    loses at most the snapshot being written, matching the durable-set
    spirit of the repo)."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO] = open(path, "a")

    def write(self, snapshot: dict) -> None:
        if self._f is None:
            raise ValueError(f"JSONLSink({self.path!r}) is closed")
        json.dump(_to_jsonable(snapshot), self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
