"""Shared neural building blocks (a port of ``repro.models.layers``): norms,
rotary embeddings, prefill and decode attention through the port's
kernels, training attention (``attention_dense``, plain PyTorch under
autograd), the KV cache ring, SwiGLU MLP.

Params are dict subtrees produced by ``params.py``.  Compute dtype follows
the config; norms, rotary and softmax run in f32.  Large matrix products
stay ``torch.matmul``, as the JAX package leaves them to XLA.  The
multi-device pieces (``constrain``, ``_sharded_flash_decode``) are not
ported: the port runs on one card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.gqa_decode.ops import gqa_decode

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return out.to(x.dtype)


def head_rms(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """qk-norm: RMS over the head dim (qwen3)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dim/2) in f32."""
    half = dim // 2
    dev = positions.device
    expo = -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    # theta filled on the device: torch.tensor(theta, device="cuda") would
    # be a host-to-device copy, which synchronizes the host with the card
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=dev),
                      expo)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x (B, S, H, D); positions (B, S), or (3, B, S) for M-RoPE, whose
    temporal, height and width sections rotate the first, next and last
    ``mrope_sections`` frequency pairs.  Half-split rotation."""
    d = x.shape[-1]
    half = d // 2
    if mrope_sections is not None and positions.dim() == 3:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to half the head dim {half}")
        cos_p, sin_p = _rope_angles(positions, d, theta)   # (3, B, S, half)
        parts_c, parts_s, off = [], [], 0
        for i, n in enumerate(mrope_sections):
            parts_c.append(cos_p[i, ..., off:off + n])
            parts_s.append(sin_p[i, ..., off:off + n])
            off += n
        cos, sin = torch.cat(parts_c, -1), torch.cat(parts_s, -1)
    else:
        cos, sin = _rope_angles(positions, d, theta)        # (B, S, half)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int],
                      q_pos: Optional[torch.Tensor] = None,
                      k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention over a whole prompt through the port's
    ``flash_prefill`` op: the counterpart of the JAX package's
    ``attention_dense`` on the prefill path.

    Without positions the mask is causal by sequence index (optionally
    windowed), which is ``attention_dense`` at the default positions
    arange(S), and needs Sq == Sk.  With ``q_pos`` (B,Sq) and ``k_pos``
    (B,Sk) a pair is live when k_pos <= q_pos (and k_pos > q_pos - window
    with a window): ``attention_dense`` at those positions.  All-zero
    positions make every pair live, which is its ``causal=False`` without
    a window (whisper's encoder and cross-attention).

    q (B,Sq,H,D); k (B,Sk,KV,D); v (B,Sk,KV,Dv) with Dv <= D (MLA's values
    are narrower than its queries and keys).  The kernel takes one head
    dim, so V is padded with zeros to D and the output sliced back to Dv;
    the scale stays 1/sqrt(D), as ``attention_dense`` takes it from q."""
    dv = v.shape[-1]
    if dv < q.shape[-1]:
        v = F.pad(v, (0, q.shape[-1] - dv))
    out = flash_prefill(q, k, v, window=window or 0, q_pos=q_pos,
                        k_pos=k_pos)
    return out[..., :dv] if dv < q.shape[-1] else out


def _grouped_logits(q: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """q (B,Sq,KV,G,D) x kf (B,Sk,KV,D) f32 -> (B,KV,G,Sq,Sk) f32 logits."""
    return torch.einsum("bqngd,bknd->bngqk", q.float(), kf)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int], causal: bool = True,
                    q_chunk: int = 512) -> torch.Tensor:
    """Memory-chunked multi-query attention for training: the JAX
    package's ``attention_dense``, plain PyTorch that autograd
    differentiates (no kernel of the port has a backward).

    q (B,Sq,H,D); k (B,Sk,KV,D); v (B,Sk,KV,Dv) (MLA's Dv < D); positions
    are absolute per token, (B,Sq) and (B,Sk).  A pair is live when
    k_pos <= q_pos (if ``causal``) and k_pos > q_pos - window (with a
    window).  Chunking over Sq (the largest divisor of Sq at or under
    ``q_chunk``) bounds the live logits to (B,KV,G,chunk,Sk).  Logits and
    softmax in f32; the probabilities are cast to v's dtype, and their
    product with v (accumulated in f32 by the matmul) to q's dtype."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv, g, d)
    kf = k.float()                  # cast once, not once per chunk

    def chunk_fn(qc, qpc):
        logits = _grouped_logits(qc, kf) * scale         # (B,KV,G,C,Sk)
        mask = None
        if causal:
            mask = k_pos[:, None, :] <= qpc[:, :, None]
        if window:
            live = k_pos[:, None, :] > qpc[:, :, None] - window
            mask = live if mask is None else mask & live
        if mask is not None:
            logits = torch.where(mask[:, None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bngqk,bknd->bqngd", p, v)
        return out.reshape(b, qc.shape[1], h, dv)

    if sq <= q_chunk:
        return chunk_fn(qg, q_pos).to(q.dtype)
    while sq % q_chunk:
        q_chunk -= 1          # largest divisor (e.g. whisper's 1500 -> 500)
    outs = [chunk_fn(qg[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token decode over a (possibly ring) cache, through the port's
    ``gqa_decode`` op.

    q (B,1,H,D); ck/cv (B,W,KV,D); valid_len (B,) number of live slots."""
    return gqa_decode(q[:, 0], ck, cv, valid_len)[:, None]


# ---------------------------------------------------------------------------
# QKV projection + cache plumbing for the standard (non-MLA) path
# ---------------------------------------------------------------------------

def qkv_project(p, x, cfg: ModelConfig, positions):
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms(p["q_norm"], q, cfg.norm_eps)
        k = head_rms(p["k_norm"], k, cfg.norm_eps)
    secs = cfg.mrope_sections if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, secs)
    k = apply_rope(k, positions, cfg.rope_theta, secs)
    return q, k, v


def cache_window(cfg: ModelConfig, max_seq: int) -> int:
    """Ring-buffer length for the KV cache: the SWA window if sub-quadratic,
    else the full sequence."""
    if cfg.attn_kind == "swa":
        return min(max_seq, cfg.window)
    return max_seq


def cache_write(ck, cv, k, v, pos0):
    """Write S new entries at ring positions (pos0 + arange(S)) % W, in
    place (the JAX version returns new arrays).

    When S > W several positions share a slot and the last one wins, as XLA
    resolves the duplicate scatter on the CPU; ``index_put_`` on CUDA does
    not define which duplicate wins, so only the last W positions are
    written."""
    w = ck.shape[1]
    s = k.shape[1]
    if s > w:
        k, v = k[:, s - w:], v[:, s - w:]
        pos0 = pos0 + (s - w)
        s = w
    idx = (pos0[:, None] + torch.arange(s, device=ck.device)[None, :]) % w
    bidx = torch.arange(ck.shape[0], device=ck.device)[:, None]
    ck[bidx, idx] = k.to(ck.dtype)
    cv[bidx, idx] = v.to(cv.dtype)
    return ck, cv


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(p, x):
    dt = x.dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)
