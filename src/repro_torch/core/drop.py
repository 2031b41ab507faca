"""Scatter with JAX's ``mode="drop"`` semantics.

JAX drops updates whose index is out of range; torch raises ``IndexError``.
The JAX code marks a lane it does not want written with the index ``n``
(one past the end), so here the update lands in one extra sentinel row that
is sliced off.  The real lanes of every caller write distinct indices."""
from __future__ import annotations

import torch


def set_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` for a 1-D ``dst`` of length n
    and ``idx`` in [0, n], where n marks a dropped lane.  Out of place."""
    buf = torch.cat([dst, dst.new_empty((1,))])
    if isinstance(src, torch.Tensor):
        src = src.to(dst.dtype)
    buf[idx] = src
    return buf[:-1]
