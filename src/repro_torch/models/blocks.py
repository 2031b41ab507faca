"""Per-kind block application for prefill / decode (a port of
``repro.models.blocks`` for the dense ``attn`` kind).

Pre-norm residual: x + attn(norm(x)), then x + mlp(norm(x)).  The other
kinds of the JAX package (moe, enc, dec, mlstm, slstm, rglru) and MLA
raise ``NotImplementedError`` naming their ROADMAP item, as does the train
mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import NOT_PORTED, not_ported


def _attn_prefill(p, x, cfg, positions, window, cache):
    q, k, v = L.qkv_project(p, x, cfg, positions)
    out = L.attention_prefill(q, k, v, window)
    pos0 = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    L.cache_write(cache["k"], cache["v"], k, v, pos0)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype), cache


def _attn_decode(p, x, cfg, pos, cache):
    b = x.shape[0]
    positions = pos[:, None]                              # (B,1)
    q, k, v = L.qkv_project(p, x, cfg, positions)
    w = cache["k"].shape[1]
    ck, cv = L.cache_write(cache["k"], cache["v"], k, v, pos)
    valid = torch.clamp(pos + 1, max=w).to(torch.int32)
    out = L.attention_decode(q, ck, cv, valid)
    return out.reshape(b, 1, -1) @ p["wo"].to(x.dtype), cache


def _check_kind(kind: str, cfg: ModelConfig) -> None:
    if kind in NOT_PORTED:
        raise not_ported(f"block kind {kind!r} ({NOT_PORTED[kind]})")
    if kind != "attn":
        raise ValueError(kind)
    if cfg.mla:
        raise not_ported("MLA attention")
    if cfg.family == "hybrid":
        raise not_ported("the hybrid family's local attention")


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device) -> Dict[str, Any]:
    _check_kind(kind, cfg)
    w = L.cache_window(cfg, max_seq)
    shape = (batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_block(kind: str, p: Dict[str, Any], x: torch.Tensor, *,
                cfg: ModelConfig, mode: str, positions=None, cache=None,
                pos=None) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (x, cache).  ``cache`` is the same dict, its tensors updated
    in place.  The JAX version also returns an auxiliary loss, which only
    MoE blocks make."""
    _check_kind(kind, cfg)
    if mode == "train":
        raise not_ported("training (forward_train, loss and optimizer)")
    window = cfg.window if cfg.attn_kind == "swa" else None
    h = L.norm(p["ln1"], x, cfg)
    if mode == "prefill":
        mix, cache = _attn_prefill(p["attn"], h, cfg, positions, window,
                                   cache)
    elif mode == "decode":
        mix, cache = _attn_decode(p["attn"], h, cfg, pos, cache)
    else:
        raise ValueError(mode)
    x = x + mix
    h2 = L.norm(p["ln2"], x, cfg)
    return x + L.mlp(p["mlp"], h2), cache
