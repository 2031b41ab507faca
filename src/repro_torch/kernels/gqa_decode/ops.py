"""Entry point of GQA decode attention for the model code: the plain
version when every tensor lies on the CPU, else the kernel, which launches
on CUDA tensors or raises (nothing falls back)."""
from __future__ import annotations

import torch

from repro_torch.kernels.gqa_decode.kernel import gqa_decode_cuda
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """q f[B, H, D]; k, v f[B, S, KV, D]; length i32[B] -> f[B, H, D]."""
    if all(t.device.type == "cpu" for t in (q, k, v, length)):
        return gqa_decode_ref(q, k, v, length)
    return gqa_decode_cuda(q, k, v, length)
