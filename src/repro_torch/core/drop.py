"""JAX's indexing semantics that torch lacks: ``mode="drop"`` scatters and
sized ``where``.

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


def where_sized(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.where(mask, size=size, fill_value=fill)[0]`` as int32: the
    first ``size`` indices of the True lanes of the 1-D ``mask``, in
    ascending order, padded with ``fill``.  Each True lane's rank is
    scattered into a buffer of fixed size, so the host never waits for
    the count."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    return set_drop(torch.full((size,), fill, dtype=torch.int32,
                               device=mask.device), tgt,
                    torch.arange(n, dtype=torch.int32, device=mask.device))
