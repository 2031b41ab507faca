"""Fault-tolerance runtime: crash/restart orchestration, straggler
mitigation and elastic restore hooks (DESIGN.md §5; the port's own copy
of ``repro.runtime.ft``, numpy only).

On thousands of nodes the failure model is: (a) hard host loss ->
restart from the last SOFT-committed checkpoint (single-fsync commits mean
the window of lost work is one save interval, and torn files are ignored
by construction); (b) stragglers -> detect via step-time statistics and
rebalance the data shards away from the slow host; (c) elastic resize ->
restore the same logical checkpoint onto a different mesh (records hold
full logical arrays keyed by tree path, so any target sharding works).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np


@dataclass
class StragglerMonitor:
    """Per-host step-time EMA; flags hosts slower than ratio x median."""
    n_hosts: int
    ratio: float = 1.5
    alpha: float = 0.2
    ema: Optional[np.ndarray] = None

    def record(self, host_times: np.ndarray):
        t = np.asarray(host_times, dtype=np.float64)
        if self.ema is None:
            self.ema = t.copy()
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * t
        return self

    def stragglers(self) -> List[int]:
        if self.ema is None:
            return []
        med = float(np.median(self.ema))
        return [i for i, v in enumerate(self.ema) if v > self.ratio * med]

    def rebalanced_weights(self) -> np.ndarray:
        """Data-shard weights inversely proportional to host speed."""
        if self.ema is None:
            return np.ones(self.n_hosts) / self.n_hosts
        inv = 1.0 / np.maximum(self.ema, 1e-9)
        return inv / inv.sum()


class ResilientLoop:
    """Wraps a train loop with checkpoint/restart semantics.

    The caller provides pure step/save/restore callables; ``run`` retries
    across injected or real failures, restoring the last committed step
    and reseeking the data pipeline (deterministic replay)."""

    def __init__(self, manager, data, save_every: int = 50,
                 async_save: bool = True, max_restarts: int = 10):
        self.manager = manager
        self.data = data
        self.save_every = save_every
        self.async_save = async_save
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, step_fn, n_steps: int,
            restore_fn: Callable, snapshot_fn: Callable,
            fail_at: Optional[int] = None):
        """restore_fn(manager, like_state) -> (state, start_step) or None;
        snapshot_fn(state) -> host pytree to persist."""
        while True:
            restored = restore_fn(self.manager, state)
            if restored is not None:
                state, start = restored
            else:
                start = 0
            self.data.seek(start)
            try:
                for step in range(start, n_steps):
                    batch = next(iter(self.data))
                    if fail_at is not None and step == fail_at \
                            and self.restarts == 0:
                        self.restarts += 1
                        raise RuntimeError("injected host failure")
                    state, metrics = step_fn(state, batch)
                    if (step + 1) % self.save_every == 0 or step == n_steps - 1:
                        self.manager.save(step + 1, snapshot_fn(state),
                                          async_=self.async_save)
                self.manager.wait()
                return state, n_steps
            except RuntimeError:
                if self.restarts > self.max_restarts:
                    raise
                self.manager.wait()
                self.manager._recover_index()      # fresh process simulation
                continue
