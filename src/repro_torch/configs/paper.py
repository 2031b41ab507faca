"""Configuration of the paper's own workloads (Section 6 evaluation).

A copy of ``repro.configs.paper``: the same dataclass and the same
Figure 1 entries."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SetBenchConfig:
    name: str
    capacity: int          # durable-area node slots
    key_range: int
    index: str             # probe (hash table) | scan (list regime)
    batch: int             # lanes per batched op ("threads")
    read_pct: int          # % contains ops


# Paper Figure 1: scalability (lists 256 / 1024 keys; hash 1M keys).
LIST_SHORT = SetBenchConfig("list-256", 512, 256, "scan", 64, 90)
LIST_LONG = SetBenchConfig("list-1024", 2048, 1024, "scan", 64, 90)
HASH_1M = SetBenchConfig("hash-1m", 1 << 18, 1 << 17, "probe", 256, 90)
