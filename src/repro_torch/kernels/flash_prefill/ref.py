"""Plain PyTorch version of GQA prefill attention (a port of
``repro.kernels.flash_prefill.ref.flash_prefill_ref``, with the positions
operand of the JAX model's ``attention_dense``).  It materializes the
(B, KV, G, Sq, Sk) logits: a reference, not a kernel."""
import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0, q_pos: Optional[torch.Tensor] = None,
                      k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q f[B,Sq,H,D]; k,v f[B,Sk,KV,D]; window 0 == no window.

    Without positions the mask is causal by sequence index (Sq == Sk).
    With q_pos i32[B,Sq] and k_pos i32[B,Sk] a pair is live when
    k_pos <= q_pos, and k_pos > q_pos - window when window > 0, as in
    ``attention_dense``.  Masked logits are -1e30, so a query with no live
    key averages every value, as there.  Returns f[B,Sq,H,D] (q dtype)."""
    if (q_pos is None) != (k_pos is None):
        raise ValueError("flash_prefill: give both q_pos and k_pos or "
                         "neither")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, sq, kv, g, d)
    logits = torch.einsum("bqngd,bknd->bngqk", qf, k.float()) / math.sqrt(d)
    if q_pos is None:
        qp = torch.arange(sq, device=q.device)[None, :, None]
        kp = torch.arange(sk, device=q.device)[None, None, :]
    else:
        qp = q_pos.to(device=q.device, dtype=torch.int32)[:, :, None]
        kp = k_pos.to(device=q.device, dtype=torch.int32)[:, None, :]
    mask = kp <= qp                                          # (B|1, Sq, Sk)
    if window:
        mask &= kp > qp - window
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
