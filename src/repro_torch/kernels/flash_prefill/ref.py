"""Plain PyTorch version of causal (optionally windowed) GQA prefill
attention (a port of ``repro.kernels.flash_prefill.ref.flash_prefill_ref``).
It materializes the (B, KV, G, S, S) logits: a reference, not a kernel."""
import math

import torch

NEG_INF = -1e30


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0) -> torch.Tensor:
    """q f[B,S,H,D]; k,v f[B,S,KV,D]; window 0 == full causal.
    Returns f[B,S,H,D] (q dtype)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, s, kv, g, d)
    logits = torch.einsum("bqngd,bknd->bngqk", qf, k.float()) / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
