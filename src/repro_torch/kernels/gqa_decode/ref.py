"""Plain PyTorch version of GQA decode attention (a port of
``repro.kernels.gqa_decode.ref.gqa_decode_ref``)."""
import math

import torch

NEG_INF = -1e30


def gqa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention with a GQA KV cache.

    q f[B, H, D]; k,v f[B, S, KV, D]; length i32[B] (valid cache prefix).
    H % KV == 0; returns f[B, H, D] (same dtype as q).
    """
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, kv, g, d)
    logits = torch.einsum("bngd,bsnd->bngs", qf, k.float()) / math.sqrt(d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < length.to(q.device)[:, None])                  # (B, S)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngs,bsnd->bngd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)
