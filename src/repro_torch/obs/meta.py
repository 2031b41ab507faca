"""Provenance block for every BENCH_*.json artifact the port writes (the
port's copy of ``repro.obs.meta``).

:func:`validate_meta` is the guard: an artifact without provenance, or
one written by an emitter at a different ``SCHEMA_VERSION``, fails
instead of being silently compared against floors that may mean
something else.  ``SCHEMA_VERSION`` bumps whenever a BENCH emitter
changes field meaning (not on additive fields).

:func:`bench_meta` stamps the torch and CUDA versions and the card's name
and power limit (as ``nvidia-smi`` reports them; ``None`` without a card),
since a time means nothing without the card and the limit it ran under.
"""
from __future__ import annotations

import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch

SCHEMA_VERSION = 1

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")


def validate_meta(bench: dict, path: str) -> List[str]:
    """Hard provenance gate for one BENCH payload: returns the failure
    messages (empty == valid).  A missing meta block or a schema-version
    mismatch is a FAILURE -- every current emitter writes the block via
    :func:`bench_meta`, so its absence means a stale artifact (or a
    foreign file) is about to be graded against today's floors."""
    meta = bench.get("meta")
    if meta is None:
        return [f"{path} has no meta block: stale or hand-written "
                "artifact; re-run the emitter (every BENCH emitter writes "
                "provenance via repro_torch.obs.meta.bench_meta)"]
    v = meta.get("schema_version")
    if v != SCHEMA_VERSION:
        return [f"{path} schema_version={v!r} != expected "
                f"{SCHEMA_VERSION}: emitter and guard disagree on field "
                "meaning; regenerate the artifact with this tree's "
                "emitters"]
    return []


def git_commit() -> str:
    """HEAD of the checkout this package lies in, or "unknown"."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, check=True,
            cwd=Path(__file__).resolve().parent).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card() -> Tuple[Optional[str], Optional[str]]:
    """(name, power limit) of the first card, read from ``nvidia-smi``
    under a timeout; (None, None) when there is no card or no reading."""
    if not torch.cuda.is_available():
        return None, None
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=10, check=True).stdout
        name, limit = out.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), limit.strip()
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None, None


def bench_meta() -> dict:
    name, limit = card()
    return {"git_commit": git_commit(), "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda, "device_name": name,
            "power_limit": limit, "schema_version": SCHEMA_VERSION}
