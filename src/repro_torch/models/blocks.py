"""Per-kind block application for prefill / decode (a port of
``repro.models.blocks``): the ``attn`` and ``moe`` kinds, MLA, the
recurrent ``mlstm``, ``slstm`` and ``rglru`` kinds, and whisper's
bidirectional encoder (``enc``) and cross-attending decoder (``dec``).

Pre-norm residual throughout.  GQA attention runs through the port's
``flash_prefill`` and ``gqa_decode`` kernels; the hybrid family's ``attn``
blocks are local attention over its window.  Prefill masks by sequence
index at the default positions and by the given positions otherwise
(``mask_pos``, M-RoPE's temporal row).  The encoder's attention and the
decoder's cross-attention prefill go through ``flash_prefill`` at all-zero
positions (every pair live, ``attention_dense``'s ``causal=False``); the
cross-attention decode through ``gqa_decode`` over the whole cross cache.
MLA (minicpm3) prefill materializes per-head keys from the latent and goes
through ``flash_prefill`` with its narrower values padded; its decode runs
*absorbed* attention in the latent space as f32 einsums, as the JAX
package does outside any kernel, so the cache is only (r + rope_dim) per
token.  The train mode raises ``NotImplementedError`` naming its ROADMAP
item.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import seqmix as SM
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import NOT_PORTED, not_ported

NEG_INF = -1e30
RECURRENT = {"mlstm": (SM.mlstm_seq, SM.mlstm_decode, SM.mlstm_cache),
             "slstm": (SM.slstm_seq, SM.slstm_decode, SM.slstm_cache),
             "rglru": (SM.rglru_seq, SM.rglru_decode, SM.rglru_cache)}


# ---------------------------------------------------------------------------
# Attention sub-block (standard GQA path)
# ---------------------------------------------------------------------------

def _attn_prefill(p, x, cfg, positions, window, cache, mask_pos=None):
    q, k, v = L.qkv_project(p, x, cfg, positions)
    out = L.attention_prefill(q, k, v, window, mask_pos, mask_pos)
    pos0 = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    L.cache_write(cache["k"], cache["v"], k, v, pos0)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)


def _attn_decode(p, x, cfg, pos, cache):
    b = x.shape[0]
    positions = pos[:, None]                              # (B,1)
    if cfg.mrope:       # the cache counter in all three sections, as JAX
        positions = pos[None, :, None].expand(3, b, 1)
    q, k, v = L.qkv_project(p, x, cfg, positions)
    w = cache["k"].shape[1]
    ck, cv = L.cache_write(cache["k"], cache["v"], k, v, pos)
    valid = torch.clamp(pos + 1, max=w).to(torch.int32)
    out = L.attention_decode(q, ck, cv, valid)
    return out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLA attention (minicpm3)
# ---------------------------------------------------------------------------

def _mla_project_q(p, x, cfg):
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    q = (x @ p["wq_a"].to(dt)) @ p["wq_b"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim + cfg.rope_dim)
    return q[..., :cfg.head_dim], q[..., cfg.head_dim:]   # nope, rope parts


def _mla_latent(p, x, cfg, positions):
    """The latent (B,S,r) and the shared rotary key (B,S,rope_dim)."""
    r = cfg.kv_lora_rank
    lat_full = x @ p["wkv_a"].to(x.dtype)                 # (B,S,r+rd)
    k_rope = L.apply_rope(lat_full[:, :, None, r:], positions,
                          cfg.rope_theta)[:, :, 0]
    return lat_full[..., :r], k_rope


def _mla_cache_write(cache, lat, k_rope, pos0):
    """Both latent caches written in place through views with a unit KV
    axis, as the JAX version writes them through ``cache_write``."""
    L.cache_write(cache["lat"][..., None, :], cache["kr"][..., None, :],
                  lat[..., None, :], k_rope[..., None, :], pos0)


def _mla_prefill(p, x, cfg, positions, window, cache, mask_pos=None):
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    rd, h, hd = cfg.rope_dim, cfg.n_heads, cfg.head_dim
    q_nope, q_rope = _mla_project_q(p, x, cfg)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    lat, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = (lat @ p["wk_b"].to(dt)).reshape(b, s, h, hd)
    v = (lat @ p["wv_b"].to(dt)).reshape(b, s, h, hd)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], -1)
    out = L.attention_prefill(q, k, v, window, mask_pos,
                              mask_pos)                   # (B,S,H,hd)
    pos0 = torch.zeros((b,), dtype=torch.int32, device=x.device)
    _mla_cache_write(cache, lat, k_rope, pos0)
    return out.reshape(b, s, h * hd) @ p["wo"].to(dt)


def _mla_decode(p, x, cfg, pos, cache):
    """Absorbed MLA decode: attention entirely in the latent space."""
    b = x.shape[0]
    dt = x.dtype
    r, rd, h, hd = cfg.kv_lora_rank, cfg.rope_dim, cfg.n_heads, cfg.head_dim
    positions = pos[:, None]
    q_nope, q_rope = _mla_project_q(p, x, cfg)            # (B,1,H,hd/rd)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    lat, k_rope = _mla_latent(p, x, cfg, positions)
    _mla_cache_write(cache, lat, k_rope, pos)
    clat, ckr = cache["lat"].float(), cache["kr"].float()  # (B,W,r), (B,W,rd)
    w = clat.shape[1]
    valid = torch.clamp(pos + 1, max=w)

    wk_b = p["wk_b"].to(dt).reshape(r, h, hd).float()
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk_b)
    logits = torch.einsum("bhr,bwr->bhw", q_lat, clat) + \
        torch.einsum("bhd,bwd->bhw", q_rope[:, 0].float(), ckr)
    logits = logits / math.sqrt(hd + rd)
    mask = torch.arange(w, device=x.device)[None, None, :] < \
        valid[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    ctx_lat = torch.einsum("bhw,bwr->bhr", pr, clat)
    wv_b = p["wv_b"].to(dt).reshape(r, h, hd).float()
    out = torch.einsum("bhr,rhd->bhd", ctx_lat, wv_b)
    out = out.reshape(b, 1, h * hd).to(dt)
    return out @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Whisper: the encoder's self-attention and the decoder's cross-attention
# ---------------------------------------------------------------------------

def _zero_positions(b: int, s: int, device) -> torch.Tensor:
    """All-zero positions, filled on the device: every pair live."""
    return torch.zeros((b, s), dtype=torch.int32, device=device)


def _enc_attn(p, x, cfg, positions):
    """Bidirectional self-attention (``attention_dense`` with causal=False
    and no window) through ``flash_prefill`` at zero positions; rotary at
    ``positions``, as the JAX encoder."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = L.qkv_project(p, x, cfg, positions)
    zero = _zero_positions(b, s, x.device)
    out = L.attention_prefill(q, k, v, None, zero, zero)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def _cross_attn(p, x, xk, xv, cfg, mode):
    """x (B,S,d) against the encoder's keys and values xk, xv (B,Senc,KV,hd):
    every pair live.  Prefill runs ``flash_prefill`` at zero positions with
    Sk = Senc; a decode step runs ``gqa_decode`` over all Senc slots (the
    JAX ``attention_dense`` at qp = kp = 0), the length filled on the
    device."""
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    se = xk.shape[1]
    if mode == "prefill":
        out = L.attention_prefill(q, xk, xv, None,
                                  _zero_positions(b, s, x.device),
                                  _zero_positions(b, se, x.device))
    else:
        length = torch.full((b,), se, dtype=torch.int32, device=x.device)
        out = L.attention_decode(q, xk, xv, length)
    return out.reshape(b, s, -1) @ p["wo"].to(dt)


def cross_kv(p, enc_out, cfg):
    b, se = enc_out.shape[0], enc_out.shape[1]
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(b, se, cfg.n_kv_heads,
                                           cfg.head_dim)
    v = (enc_out @ p["wv"].to(dt)).reshape(b, se, cfg.n_kv_heads,
                                           cfg.head_dim)
    return k, v


# ---------------------------------------------------------------------------
# Block dispatch
# ---------------------------------------------------------------------------

ATTENTION_KINDS = ("attn", "moe", "enc", "dec")


def attention_layers(cfg: ModelConfig) -> int:
    """``flash_prefill`` launches of one prefill: one per attn and moe
    layer (MLA included) and per encoder layer, two per decoder layer
    (self and cross)."""
    per = {"attn": 1, "moe": 1, "dec": 2}
    return cfg.enc_layers + sum(count * sum(per.get(k, 0) for k in period)
                                for period, count in cfg.stacks())


def decode_attention_layers(cfg: ModelConfig) -> int:
    """``gqa_decode`` launches of one decode step: one per GQA attn and moe
    layer (none for MLA, which attends in the latent space), two per
    decoder layer (self and cross)."""
    per = {"dec": 2} if cfg.mla else {"attn": 1, "moe": 1, "dec": 2}
    return sum(count * sum(per.get(k, 0) for k in period)
               for period, count in cfg.stacks())


def _check_kind(kind: str) -> None:
    if kind in NOT_PORTED:
        raise not_ported(f"block kind {kind!r} ({NOT_PORTED[kind]})")
    if kind not in ATTENTION_KINDS and kind not in RECURRENT:
        raise ValueError(kind)


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device) -> Dict[str, Any]:
    _check_kind(kind)
    if kind == "enc":
        raise ValueError("the encoder keeps no cache")
    if kind in RECURRENT:
        return RECURRENT[kind][2](cfg, batch, device)    # f32 states
    w = L.cache_window(cfg, max_seq)
    if cfg.mla and kind != "dec":
        return {"lat": torch.zeros((batch, w, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "kr": torch.zeros((batch, w, cfg.rope_dim), dtype=dtype,
                                  device=device)}
    if kind == "attn" and cfg.family == "hybrid":
        w = min(w, cfg.window)                            # local attention
    shape = (batch, w, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "dec":   # the cross-attention cache, filled by prefill
        xshape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        c["xk"] = torch.zeros(xshape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(xshape, dtype=dtype, device=device)
    return c


def apply_block(kind: str, p: Dict[str, Any], x: torch.Tensor, *,
                cfg: ModelConfig, mode: str, positions=None, cache=None,
                pos=None, enc_out=None, mask_pos=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (x, cache).  ``cache`` is the same dict, its tensors updated
    in place (None for the encoder, which keeps none).  ``mask_pos`` (B,S)
    masks prefill attention by position; None masks by index.  ``enc_out``
    is the encoder's output, which a ``dec`` block's prefill projects into
    its cross cache.  The JAX version also returns an auxiliary loss, which
    only MoE blocks make and only training reads; ``moe_ffn`` computes it
    and it is dropped here."""
    _check_kind(kind)
    if mode == "train":
        raise not_ported("training (forward_train, loss and optimizer)")
    if mode not in ("prefill", "decode"):
        raise ValueError(mode)
    window = cfg.window if cfg.attn_kind == "swa" else None
    if kind == "attn" and cfg.family == "hybrid":
        window = cfg.window                               # local attention
    h = L.norm(p["ln1"], x, cfg)

    if kind in RECURRENT:
        seq, decode, _ = RECURRENT[kind]
        if mode == "prefill":
            mix, state = seq(p["mix"], h, cfg)
        else:
            mix, state = decode(p["mix"], h, cache, cfg)
        for key, val in state.items():
            cache[key].copy_(val)
        x = x + mix
        if kind == "mlstm":
            return x, cache
        h2 = L.norm(p["ln2"], x, cfg)
        return x + L.mlp(p["mlp"], h2), cache

    if kind == "enc":
        mix = _enc_attn(p["attn"], h, cfg, positions)
    elif cfg.mla and kind != "dec":
        if mode == "prefill":
            mix = _mla_prefill(p["attn"], h, cfg, positions, window, cache,
                               mask_pos)
        else:
            mix = _mla_decode(p["attn"], h, cfg, pos, cache)
    elif mode == "prefill":
        mix = _attn_prefill(p["attn"], h, cfg, positions, window, cache,
                            mask_pos)
    else:
        mix = _attn_decode(p["attn"], h, cfg, pos, cache)
    x = x + mix
    if kind == "dec":   # whisper cross-attention
        hx = L.norm(p["lnx"], x, cfg)
        if mode == "prefill":
            xk, xv = cross_kv(p["xattn"], enc_out, cfg)
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
        else:
            xk, xv = cache["xk"], cache["xv"]
        x = x + _cross_attn(p["xattn"], hx, xk, xv, cfg, mode)
    h2 = L.norm(p["ln2"], x, cfg)
    if kind == "moe":
        ff, _ = moe_ffn(p["moe"], h2, cfg)
    else:
        ff = L.mlp(p["mlp"], h2)
    return x + ff, cache
