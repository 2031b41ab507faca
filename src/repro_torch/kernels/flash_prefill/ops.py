"""Entry point of prefill attention for the model code: the plain version
when every tensor lies on the CPU, else the kernel, which launches on CUDA
tensors or raises (nothing falls back).  The JAX wrapper's S % 128 gate is
gone: the kernel masks the ragged edge."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """q f[B, S, H, D]; k, v f[B, S, KV, D] -> f[B, S, H, D]."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_prefill_ref(q, k, v, window=window)
    return flash_prefill_cuda(q, k, v, window=window)
