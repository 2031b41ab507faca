"""Entry point of prefill attention for the model code: the plain version
when every tensor lies on the CPU, else the kernel, which launches on CUDA
tensors or raises (nothing falls back).  The JAX wrapper's S % 128 gate is
gone: the kernel masks the ragged edge."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, q_pos: Optional[torch.Tensor] = None,
                  k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q f[B, Sq, H, D]; k, v f[B, Sk, KV, D]; q_pos i32[B, Sq] and k_pos
    i32[B, Sk] or neither (then the mask is by index and Sq == Sk)
    -> f[B, Sq, H, D]."""
    tensors = [t for t in (q, k, v, q_pos, k_pos) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return flash_prefill_ref(q, k, v, window=window, q_pos=q_pos,
                                 k_pos=k_pos)
    return flash_prefill_cuda(q, k, v, window=window, q_pos=q_pos,
                              k_pos=k_pos)
