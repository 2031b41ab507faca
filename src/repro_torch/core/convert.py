"""State carried across packages: SetState <-> numpy planes.

``state_from_numpy`` takes the 16 leaves of a ``SetState`` as numpy arrays
(a dict, or a NamedTuple such as the JAX package's ``SetState`` after
``np.asarray`` of each leaf) and returns this package's ``SetState`` on a
device; ``state_to_numpy`` goes the other way.  Together they start both
packages from one state and compare them leaf by leaf.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.durable_set import SetState

# numpy dtype of every leaf: int32 throughout, the overflow latch bool.
LEAF_DTYPES: Dict[str, np.dtype] = {
    f: np.dtype(np.bool_ if f == "overflow" else np.int32)
    for f in SetState._fields}


def state_from_numpy(planes, device="cuda") -> SetState:
    """``SetState`` on ``device`` from numpy planes.  Every leaf must be
    present at its dtype (int32, or bool for ``overflow``); a plane at
    another dtype -- for instance int64 counters from a 64-bit run --
    raises instead of being truncated."""
    if hasattr(planes, "_asdict"):
        planes = planes._asdict()
    dev = resolve_device(device)
    missing = set(SetState._fields) - set(planes)
    if missing:
        raise ValueError(f"state_from_numpy: missing leaves {sorted(missing)}")
    leaves = {}
    for f in SetState._fields:
        a = np.asarray(planes[f])
        if a.dtype != LEAF_DTYPES[f]:
            raise ValueError(f"state_from_numpy: leaf {f!r} has dtype "
                             f"{a.dtype}, expected {LEAF_DTYPES[f]}")
        leaves[f] = torch.from_numpy(np.array(a)).to(dev)
    return SetState(**leaves)


def state_to_numpy(state: SetState) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, keyed by field name."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in SetState._fields}
