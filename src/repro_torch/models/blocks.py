"""Per-kind block application for train / prefill / decode (a port of
``repro.models.blocks``): the ``attn`` and ``moe`` kinds, MLA, the
recurrent ``mlstm``, ``slstm`` and ``rglru`` kinds, and whisper's
bidirectional encoder (``enc``) and cross-attending decoder (``dec``).

Pre-norm residual throughout.  Serving attention runs through the port's
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
token.

The train mode is the JAX package's: every attention through
``attention_dense`` (plain PyTorch, differentiated by autograd; neither
kernel has a backward), masked by the (B, S) positions, the encoder and
the cross-attention at zero positions and not causal; the recurrent kinds
run their sequence forms and drop the final states.  Nothing in train
mode touches a cache or writes in place into a tensor autograd saved.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import seqmix as SM
from repro_torch.models import tp as TP
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import NOT_PORTED, not_ported, slstm_width

NEG_INF = L.NEG_INF
RECURRENT = {"mlstm": (SM.mlstm_seq, SM.mlstm_decode, SM.mlstm_cache),
             "slstm": (SM.slstm_seq, SM.slstm_decode, SM.slstm_cache),
             "rglru": (SM.rglru_seq, SM.rglru_decode, SM.rglru_cache)}


# ---------------------------------------------------------------------------
# Attention sub-block (standard GQA path)
# ---------------------------------------------------------------------------

def _attn_prefill(p, x, cfg, positions, window, cache, mask_pos=None,
                  ctx=None):
    q, k, v = L.qkv_project(p, x, cfg, positions)
    out = L.attention_prefill(q, k, v, window, mask_pos, mask_pos)
    pos0 = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    L.cache_write(cache["k"], cache["v"], k, v, pos0,
                  L.seq_slots(ctx, cache["k"].shape[1]))
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)


def _attn_decode(p, x, cfg, pos, cache, ctx=None):
    b = x.shape[0]
    positions = pos[:, None]                              # (B,1)
    if cfg.mrope:       # the cache counter in all three sections, as JAX
        positions = pos[None, :, None].expand(3, b, 1)
    q, k, v = L.qkv_project(p, x, cfg, positions)
    slots = L.seq_slots(ctx, cache["k"].shape[1])
    w = cache["k"].shape[1] if slots is None else slots[1]
    ck, cv = L.cache_write(cache["k"], cache["v"], k, v, pos, slots)
    valid = torch.clamp(pos + 1, max=w).to(torch.int32)
    out = L.attention_decode(q, ck, cv, valid, ctx)
    return out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)


def _pos2d(positions):
    """(B,S) view of positions (M-RoPE's temporal section masks)."""
    return positions[0] if positions.dim() == 3 else positions


def _attn_train(p, x, cfg, positions, window, tp=None):
    """With ``tp`` (a ``models/tp.py::Line`` over ``model``), ``wq``,
    ``wk``, ``wv`` and their biases hold this rank's columns
    (column-parallel: its query heads and their KV heads, or a block of a
    KV head that ``qkv_project`` gathers; qk-norm and rotary run on those
    heads, and ``attention_dense`` unchanged, the GQA groups being
    contiguous) and ``wo`` its heads' rows (row-parallel, its partial sums
    summed)."""
    if tp is not None:
        x = tp.copy_to(x)
    q, k, v = L.qkv_project(p, x, cfg, positions, tp)
    pos2 = _pos2d(positions)
    out = L.attention_dense(q, k, v, pos2, pos2, window)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.reduce_from(out)


# ---------------------------------------------------------------------------
# MLA attention (minicpm3)
# ---------------------------------------------------------------------------

def _mla_project_q(p, x, cfg, tp=None):
    """The per-head query parts (nope, rope) of x; with ``tp`` (the
    ``model`` line) of this rank's heads, ``wq_b`` holding their
    columns."""
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    h = cfg.n_heads
    q = x @ p["wq_a"].to(dt)
    if tp is not None:
        # Trap: which gradients come out whole.  wq_a is split on data and
        # replicated on model: the gathers never sum its gradient over
        # model, so the copy sits on its output, where the rank's columns
        # begin, and not on x (whose copy would leave wq_a's gradient the
        # rank's part)
        q = tp.copy_to(q)
        h //= tp.size
    q = (q @ p["wq_b"].to(dt)).reshape(b, s, h, cfg.head_dim + cfg.rope_dim)
    return q[..., :cfg.head_dim], q[..., cfg.head_dim:]   # nope, rope parts


def _mla_latent(p, x, cfg, positions, tp=None):
    """The latent (B,S,r) and the shared rotary key (B,S,rope_dim); with
    ``tp``, copied onto the line (wkv_a's trap is wq_a's: the latent feeds
    the rank's heads' ``wk_b`` and ``wv_b`` columns and the rotary key is
    broadcast to its heads alone, so both gradients are partial sums)."""
    r = cfg.kv_lora_rank
    lat_full = x @ p["wkv_a"].to(x.dtype)                 # (B,S,r+rd)
    if tp is not None:
        lat_full = tp.copy_to(lat_full)
    k_rope = L.apply_rope(lat_full[:, :, None, r:], positions,
                          cfg.rope_theta)[:, :, 0]
    return lat_full[..., :r], k_rope


def _mla_cache_write(cache, lat, k_rope, pos0):
    """Both latent caches written in place through views with a unit KV
    axis, as the JAX version writes them through ``cache_write``."""
    L.cache_write(cache["lat"][..., None, :], cache["kr"][..., None, :],
                  lat[..., None, :], k_rope[..., None, :], pos0)


def _mla_qkv(p, x, cfg, positions, tp=None):
    """Per-head q, k (nope and the shared rotary part, broadcast over the
    heads) and v (at its own width hd) from the latent, with the latent
    and the rotary key.  With ``tp`` the heads are this rank's: ``wq_b``,
    ``wk_b`` and ``wv_b`` hold their columns, whole heads (a contiguous
    block of h*(hd+rd) or h*hd columns, head-major as the reshape
    reads)."""
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    rd, h, hd = cfg.rope_dim, cfg.n_heads, cfg.head_dim
    if tp is not None:
        h //= tp.size
    q_nope, q_rope = _mla_project_q(p, x, cfg, tp)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    lat, k_rope = _mla_latent(p, x, cfg, positions, tp)
    k_nope = (lat @ p["wk_b"].to(dt)).reshape(b, s, h, hd)
    v = (lat @ p["wv_b"].to(dt)).reshape(b, s, h, hd)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], -1)
    return q, k, v, lat, k_rope


def _mla_train(p, x, cfg, positions, window, tp=None):
    """With ``tp`` on this rank's heads (``_mla_qkv``), ``wo`` holding
    their rows (row-parallel, its partial sums summed)."""
    b, s = x.shape[0], x.shape[1]
    q, k, v, _, _ = _mla_qkv(p, x, cfg, positions, tp)
    pos2 = _pos2d(positions)
    out = L.attention_dense(q, k, v, pos2, pos2, window)  # (B,S,H,hd)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return out if tp is None else tp.reduce_from(out)


def _mla_prefill(p, x, cfg, positions, window, cache, mask_pos=None):
    b, s = x.shape[0], x.shape[1]
    q, k, v, lat, k_rope = _mla_qkv(p, x, cfg, positions)
    out = L.attention_prefill(q, k, v, window, mask_pos,
                              mask_pos)                   # (B,S,H,hd)
    pos0 = torch.zeros((b,), dtype=torch.int32, device=x.device)
    _mla_cache_write(cache, lat, k_rope, pos0)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


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


def _enc_attn(p, x, cfg, positions, mode):
    """Bidirectional self-attention (``attention_dense`` with causal=False
    and no window): in train mode ``attention_dense`` itself, else
    ``flash_prefill`` at zero positions; rotary at ``positions``, as the
    JAX encoder."""
    b, s = x.shape[0], x.shape[1]
    q, k, v = L.qkv_project(p, x, cfg, positions)
    if mode == "train":
        pos2 = _pos2d(positions)
        out = L.attention_dense(q, k, v, pos2, pos2, None, causal=False)
    else:
        zero = _zero_positions(b, s, x.device)
        out = L.attention_prefill(q, k, v, None, zero, zero)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def _cross_attn(p, x, xk, xv, cfg, mode):
    """x (B,S,d) against the encoder's keys and values xk, xv (B,Senc,KV,hd):
    every pair live (the JAX ``attention_dense`` at qp = kp = 0, not
    causal).  Train mode runs that itself; prefill runs ``flash_prefill``
    at zero positions with Sk = Senc; a decode step runs ``gqa_decode``
    over all Senc slots, the length filled on the device."""
    b, s = x.shape[0], x.shape[1]
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    se = xk.shape[1]
    if mode == "train":
        out = L.attention_dense(q, xk, xv, _zero_positions(b, s, x.device),
                                _zero_positions(b, se, x.device), None,
                                causal=False)
    elif mode == "prefill":
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


@functools.lru_cache(maxsize=None)
def _split_keys(kind: str, cfg: ModelConfig, n: int) -> Tuple[str, ...]:
    """The keys of the recurrent state leaves of a ``kind`` layer that
    ``launch/specs.py::cache_specs`` splits over a ``model`` line of ``n``
    ranks, by its rule on the whole leaf's shape: fixed for a config, so
    decided once and not at every layer and decode step."""
    from repro_torch.launch.specs import state_split
    whole = RECURRENT[kind][2](cfg, 1, "meta")
    return tuple(k for k, a in whole.items()
                 if state_split(k, tuple(a.shape), n))


def _split_states(kind: str, cfg: ModelConfig, ctx):
    """Serving under an enabled ``ctx``: (the ``model`` line, the keys of
    the recurrent state leaves split over it, ``_split_keys``), or None
    where the cache holds every leaf whole."""
    if ctx is None or not ctx.enabled:
        return None
    tp = TP.line(ctx, "tp")
    keys = _split_keys(kind, cfg, tp.size) if tp.size > 1 else ()
    return (tp, keys) if keys else None


def _gather_states(cache, split):
    """The cache with the rank's blocks of the ``split`` state leaves
    gathered whole over the ``model`` line (split on their last dim): one
    all-gather for them all, one a layer and decode step.  Every rank of
    the line then runs the one-process decode on the same whole state.
    Trap: collective order.  A hybrid's attention layers combine their
    sequence-split softmax over the same line: every rank runs the layers
    in one order, so the gathers and the combines pair up."""
    if split is None:
        return cache
    tp, keys = split
    n = tp.size
    got = tp.all_gather(torch.cat([cache[k].reshape(-1) for k in keys]),
                        0).view(n, -1)
    out, at = dict(cache), 0
    for k in keys:
        blk = cache[k]
        part = got[:, at:at + blk.numel()].reshape((n,) + tuple(blk.shape))
        out[k] = part.movedim(0, -2).reshape(blk.shape[:-1] +
                                             (n * blk.shape[-1],))
        at += blk.numel()
    return out


def _write_states(cache, state, split) -> None:
    """The new recurrent state into the cache in place: the rank's block
    of each ``split`` leaf, every other leaf whole."""
    tp, keys = split or (None, ())
    for key, val in state.items():
        if key in keys:
            w = cache[key].shape[-1]
            val = val[..., tp.coord * w:(tp.coord + 1) * w]
        cache[key].copy_(val)


def apply_block(kind: str, p: Dict[str, Any], x: torch.Tensor, *,
                cfg: ModelConfig, mode: str, positions=None, cache=None,
                pos=None, enc_out=None, mask_pos=None, ctx=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]],
                           Optional[torch.Tensor]]:
    """Returns (x, cache, aux), as the JAX version does.  In prefill and
    decode ``cache`` is the same dict, its tensors updated in place (None
    for the encoder, which keeps none); in train mode it is None and no
    cache is read.  ``aux`` is the MoE blocks' auxiliary loss (f32 scalar)
    and None for the blocks that make none (JAX's zeros).  ``mask_pos``
    (B,S) masks prefill attention by position; None masks by index.  In
    train mode ``positions`` masks attention (its (B,S) row).  ``enc_out``
    is the encoder's output, which a ``dec`` block projects into its cross
    keys and values (into its cross cache in prefill).  ``ctx`` (a
    ``ShardCtx``) with ``seq_shard_cache`` makes the self-attention caches
    this rank's block of slots (``layers.seq_slots``).  In train mode an
    enabled ``ctx`` makes ``p`` this rank's compute blocks of the sharded
    train step: an ``attn`` block runs on its heads (MLA's too) and MLP
    columns over the ``model`` line, a ``moe`` block on its columns of the
    experts' width or its whole experts (``models/moe.py``), its auxiliary
    loss covering the rows of the whole ``dp`` line
    (``models/model.py::_check_ctx`` refuses the other kinds where that
    line has more than one rank)."""
    _check_kind(kind)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    train = mode == "train"
    tp = dp = None
    if train and ctx is not None and ctx.enabled:
        tp, dp = TP.line(ctx, "tp"), TP.line(ctx, "dp")
    window = cfg.window if cfg.attn_kind == "swa" else None
    if kind == "attn" and cfg.family == "hybrid":
        window = cfg.window                               # local attention
    h = L.norm(p["ln1"], x, cfg)

    if kind in RECURRENT:
        seq, decode, _ = RECURRENT[kind]
        if train:
            mix, _ = seq(p["mix"], h, cfg, tp)
        else:
            split = _split_states(kind, cfg, ctx)
            if mode == "decode":
                mix, state = decode(p["mix"], h,
                                    _gather_states(cache, split), cfg)
            else:
                mix, state = seq(p["mix"], h, cfg)
            _write_states(cache, state, split)
        x = x + mix
        if kind == "mlstm":
            return x, cache, None
        h2 = L.norm(p["ln2"], x, cfg)
        width = slstm_width(cfg) if kind == "slstm" else cfg.d_ff
        return x + L.mlp(p["mlp"], h2, TP.split(tp, width)), cache, None

    if kind == "enc":
        mix = _enc_attn(p["attn"], h, cfg, positions, mode)
    elif cfg.mla and kind != "dec":
        if train:
            mix = _mla_train(p["attn"], h, cfg, positions, window, tp)
        elif mode == "prefill":
            mix = _mla_prefill(p["attn"], h, cfg, positions, window, cache,
                               mask_pos)
        else:
            mix = _mla_decode(p["attn"], h, cfg, pos, cache)
    elif train:
        mix = _attn_train(p["attn"], h, cfg, positions, window, tp)
    elif mode == "prefill":
        mix = _attn_prefill(p["attn"], h, cfg, positions, window, cache,
                            mask_pos, ctx)
    else:
        mix = _attn_decode(p["attn"], h, cfg, pos, cache, ctx)
    x = x + mix
    if kind == "dec":   # whisper cross-attention
        hx = L.norm(p["lnx"], x, cfg)
        if mode == "decode":
            xk, xv = cache["xk"], cache["xv"]
        else:
            xk, xv = cross_kv(p["xattn"], enc_out, cfg)
            if not train:
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
        x = x + _cross_attn(p["xattn"], hx, xk, xv, cfg, mode)
    h2 = L.norm(p["ln2"], x, cfg)
    aux = None
    if kind == "moe":
        ff, aux = moe_ffn(p["moe"], h2, cfg, dp, tp)
    else:
        ff = L.mlp(p["mlp"], h2, TP.split(tp, cfg.d_ff))
    return x + ff, cache, aux
