"""Stage-machine NVM simulation shared by the durable-set algorithms.

The paper's correctness argument (Claims B.4 / C.13) reduces every node's
durable lifecycle to a monotonic state machine whose writes all land in one
cache line, so TSO same-line ordering guarantees that a crash exposes a
*prefix* of the machine:

    FREE(0) -> INVALID(1) -> PAYLOAD(2) -> VALID(3) -> DELETED(4)

Per node we track ``cur`` (volatile stage) and ``flushed`` (stage covered by
the last explicit psync).  A crash may expose, independently per node, any
``persisted in [flushed, cur]``.  Recovery classifies ``persisted == VALID``
as a set member and everything else as reclaimable (Sections 3.5 / 4.6).

PyTorch copy of ``repro.core.nvm``: the same constants, and functions that
agree with the JAX ones bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# Lifecycle stages (see module docstring).
FREE, INVALID, PAYLOAD, VALID, DELETED = 0, 1, 2, 3, 4

# Volatile index sentinels.
EMPTY = -1
TOMB = -2

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), without int64
    overflow: the constant is split into 16-bit halves, so every partial
    product stays below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Deterministic avalanching hash of int32 keys (lowered from splitmix).

    Torch has no uint32 shift on the CPU, so the uint32 arithmetic of the
    JAX version runs in int64 and is masked to 32 bits after each multiply.
    Returns int64 values in [0, 2**32) -- the uint32 result, widened."""
    x = x.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def crash_persisted_stage(cur: torch.Tensor, flushed: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """Adversarial crash: per-node persisted stage in [flushed, cur].

    ``u`` in [0, 1) drives the adversary.  The product ``u * span`` stays in
    float32, as in the JAX version, so both pick the same stage at the edges.
    """
    span = (cur - flushed + 1).to(torch.float32)
    off = torch.floor(u.to(torch.float32) * span).to(cur.dtype)
    return torch.minimum(torch.maximum(flushed + off, flushed), cur)


def np_hash32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    return x ^ (x >> 16)
