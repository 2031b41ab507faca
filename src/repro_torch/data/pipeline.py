"""Deterministic synthetic data pipeline: sharded, restart-skippable,
prefetching (the port's own copy of ``repro.data.pipeline``, numpy only:
batch b is bit for bit the JAX package's).

Real deployments swap ``SyntheticTokens`` for a file-backed source; the
contract that matters for fault tolerance is ``seek(step)``: after a
restore the pipeline resumes at the exact batch index, so a restart
replays no data (deterministic counter-based generation, no RNG state to
persist -- the durable checkpoint only stores the step).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticTokens:
    """Counter-based token stream: batch b is a pure function of (seed, b)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 shard: int = 0, num_shards: int = 1, seed: int = 0):
        assert global_batch % num_shards == 0
        self.vocab = vocab
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.step = 0

    def seek(self, step: int):
        self.step = step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.step, self.shard))
        toks = rng.integers(0, self.vocab,
                            (self.local_batch, self.seq + 1), dtype=np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch with bounded queue (overlap host->device)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        try:
            for x in self.it:
                self.q.put(x)
        finally:
            self.q.put(self.done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self.q.get()
        if x is self.done:
            raise StopIteration
        return x
