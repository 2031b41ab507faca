"""Shared neural building blocks (a port of ``repro.models.layers``): norms,
rotary embeddings, prefill and decode attention through the port's
kernels, training attention (``attention_dense``, plain PyTorch under
autograd), the KV cache ring, SwiGLU MLP.

Params are dict subtrees produced by ``params.py``.  Compute dtype follows
the config; norms, rotary and softmax run in f32.  Large matrix products
stay ``torch.matmul``, as the JAX package leaves them to XLA.

The multi-device pieces work on each rank's plain local tensors under the
current ``ModelMesh`` (``launch/meshctx.py``): ``constrain_spec`` resolves
roles into the spec JAX's ``constrain`` would impose (the port imposes
none: with explicit collectives the layout is the caller's), and with a
``ShardCtx`` whose ``seq_shard_cache`` is set each rank holds a block of
every KV cache's slots, which ``cache_write`` fills and
``_sharded_flash_decode`` attends over, combining the ranks of the
``model`` axis by an online softmax (``all_reduce`` MAX, then SUM).  In
the sharded train step the projections and the MLP run on this rank's
heads and columns (``qkv_project``'s and ``mlp``'s ``tp``; the
collectives in ``models/tp.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.gqa_decode.ops import gqa_decode

NEG_INF = -1e30


def constrain_spec(ctx, shape, *roles) -> Optional[tuple]:
    """The spec that the JAX package's ``constrain(ctx, x, *roles)`` hands
    to ``with_sharding_constraint`` for an ``x`` of ``shape``: each role
    ("dp", "tp", "sp") resolved into its axes, dropped where their ranks do
    not divide the dim; one entry a role.  None where JAX imposes nothing
    (a disabled ctx).  An enabled ctx needs the current mesh."""
    if ctx is None or not ctx.enabled:
        return None
    from repro_torch.launch.meshctx import require_mesh
    mesh = require_mesh(ctx)
    axes = []
    for dim, r in zip(shape, roles):
        if r == "dp":
            a = ctx.dp()
        elif r == "tp":
            a = ctx.tp()
        elif r == "sp":
            a = ctx.tp() if ctx.sp_activations else None
        else:
            a = None
        if a is not None and dim % mesh.axis_size(a) != 0:
            a = None
        axes.append(a)
    return tuple(axes)


def seq_slots(ctx, wl: int) -> Optional[Tuple[int, int]]:
    """(lo, W) of a KV cache part of ``wl`` slots when ``ctx`` splits the
    caches on the sequence: this rank holds global ring slots [lo, lo +
    wl) of W = wl x the ``model`` axis's ranks.  None for a whole cache."""
    if ctx is None or not (ctx.enabled and ctx.seq_shard_cache):
        return None
    from repro_torch.launch.meshctx import require_mesh
    mesh = require_mesh(ctx)
    tp = ctx.tp()
    return mesh.coord(tp) * wl, wl * mesh.axis_size(tp)

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
                     valid_len: torch.Tensor, ctx=None) -> torch.Tensor:
    """Single-token decode over a (possibly ring) cache, through the port's
    ``gqa_decode`` op.

    q (B,1,H,D); ck/cv (B,W,KV,D); valid_len (B,) number of live slots.
    When ``ctx.seq_shard_cache`` the cache is this rank's block of the
    sequence (``seq_slots``) and attention runs as a flash decode with an
    online-softmax combine across the ``model`` axis."""
    if ctx is not None and ctx.enabled and ctx.seq_shard_cache:
        return _sharded_flash_decode(ctx, q, ck, cv, valid_len)
    return gqa_decode(q[:, 0], ck, cv, valid_len)[:, None]


def _sharded_flash_decode(ctx, q, ck, cv, valid_len):
    """The JAX package's ``_sharded_flash_decode`` on this rank's slots:
    q (B,1,H,D) and valid_len (B,) this rank's rows, ck/cv (B,W/n,KV,D)
    its block of the ring.  Logits and softmax in f32; the row max is
    reduced by MAX over the ``model`` axis, then the denominators and the
    weighted values by SUM (one ``all_reduce`` of both).  A rank with no
    live slot adds exp(NEG_INF - m) = 0; with no live slot anywhere every
    slot weighs 1, the uniform mean over all W of ``gqa_decode_ref``.
    Plain PyTorch: no kernel returns a rank's partials yet."""
    from repro_torch.launch.meshctx import require_mesh
    mesh = require_mesh(ctx)
    tp = ctx.tp()
    b, _, h, d = q.shape
    wl, kv = ck.shape[1], ck.shape[2]
    g = h // kv
    qg = q[:, 0].reshape(b, kv, g, d).float()
    logits = torch.einsum("bngd,bsnd->bngs", qg, ck.float()) / math.sqrt(d)
    slot = mesh.coord(tp) * wl + torch.arange(wl, device=q.device)
    mask = slot[None, :] < valid_len[:, None]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    m_g = mesh.all_reduce(logits.amax(-1, keepdim=True), dist.ReduceOp.MAX,
                          tp)
    p = torch.exp(logits - m_g)
    acc = torch.einsum("bngs,bsnd->bngd", p, cv.float())
    la = mesh.all_reduce(torch.cat([acc, p.sum(-1, keepdim=True)], -1),
                         dist.ReduceOp.SUM, tp)
    out = la[..., :d] / torch.clamp(la[..., d:], min=1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# QKV projection + cache plumbing for the standard (non-MLA) path
# ---------------------------------------------------------------------------

def qkv_project(p, x, cfg: ModelConfig, positions, tp=None):
    """q, k, v of x (rotary applied, qk-norm where configured).

    With ``tp`` (a ``models/tp.py::Line`` over ``model``, ``x`` already
    copied onto it) ``wq`` and ``bq`` hold this rank's query heads'
    columns, and ``wk``, ``wv`` and their biases its block of the KV
    columns.  Where the line divides the KV heads that block is whole KV
    heads, the GQA groups of the rank's query heads (contiguous).  Where it
    does not (recurrentgemma's one KV head, qwen3-32b-smoke's two over 4
    ranks), ``param_pspecs`` still splits ``kv_dim``: the block cuts a head.
    Trap: a KV head split mid-head.  The rank's columns are gathered into
    the whole K and V (``copy_to(all_gather(.))``: every rank reads only
    its groups' heads, so the gradient is partial and sums over the line
    before each rank keeps its block), k-norm and rotary run on the whole
    K (k-norm's gradient is then partial, summed as ``TP_PARTIAL``'s), and
    each of the rank's query heads takes its group's KV head, head // (H /
    KV): the K and V returned have one head per query head."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    mid = tp is not None and kvh % tp.size != 0
    if tp is not None:
        h //= tp.size
        kvh = kvh if mid else kvh // tp.size
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if mid:     # one gather and one sum over the line for both
        k, v = tp.copy_to(tp.all_gather(torch.stack([k, v]), -1)).unbind(0)
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, h, cfg.head_dim)
    k = k.reshape(b, s, kvh, cfg.head_dim)
    v = v.reshape(b, s, kvh, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms(p["q_norm"], q, cfg.norm_eps)
        k = head_rms(p["k_norm"], k, cfg.norm_eps)
    secs = cfg.mrope_sections if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, secs)
    k = apply_rope(k, positions, cfg.rope_theta, secs)
    if mid:
        group = torch.arange(tp.coord * h, (tp.coord + 1) * h,
                             device=x.device) // (cfg.n_heads // kvh)
        k, v = k.index_select(2, group), v.index_select(2, group)
    return q, k, v


def cache_window(cfg: ModelConfig, max_seq: int) -> int:
    """Ring-buffer length for the KV cache: the SWA window if sub-quadratic,
    else the full sequence."""
    if cfg.attn_kind == "swa":
        return min(max_seq, cfg.window)
    return max_seq


def cache_write(ck, cv, k, v, pos0, slots: Optional[Tuple[int, int]] = None):
    """Write S new entries at ring positions (pos0 + arange(S)) % W, in
    place (the JAX version returns new arrays).

    When S > W several positions share a slot and the last one wins, as XLA
    resolves the duplicate scatter on the CPU; ``index_put_`` on CUDA does
    not define which duplicate wins, so only the last W positions are
    written.

    With ``slots`` = (lo, W) the cache holds only ring slots [lo, lo + wl)
    of a ring of W (``seq_slots``), and only the positions landing there
    are written, with no host read: a decode step (S = 1) scatters each
    row's entry to its slot, or, where the slot is another rank's, writes
    back the value of a slot of its own; a prefill writes every slot of
    the block, from the position that lands on it or from itself."""
    wl = ck.shape[1]
    lo, w = slots if slots is not None else (0, wl)
    s = k.shape[1]
    if s > w:
        k, v = k[:, s - w:], v[:, s - w:]
        pos0 = pos0 + (s - w)
        s = w
    dev = ck.device
    bidx = torch.arange(ck.shape[0], device=dev)[:, None]
    if slots is None:
        idx = (pos0[:, None] + torch.arange(s, device=dev)[None, :]) % w
        ck[bidx, idx] = k.to(ck.dtype)
        cv[bidx, idx] = v.to(cv.dtype)
    elif s == 1:
        at = pos0[:, None] % w - lo                        # (B, 1)
        keep = ((at >= 0) & (at < wl))[..., None, None]
        at = torch.clamp(at, 0, wl - 1)
        ck[bidx, at] = torch.where(keep, k.to(ck.dtype), ck[bidx, at])
        cv[bidx, at] = torch.where(keep, v.to(cv.dtype), cv[bidx, at])
    else:
        # the offset from pos0 of the position landing on each slot
        off = (lo + torch.arange(wl, device=dev)[None, :]
               - pos0[:, None]) % w                        # (B, wl)
        keep = (off < s)[..., None, None]
        off = torch.clamp(off, max=s - 1)
        ck.copy_(torch.where(keep, k[bidx, off].to(ck.dtype), ck))
        cv.copy_(torch.where(keep, v[bidx, off].to(cv.dtype), cv))
    return ck, cv


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(p, x, tp=None):
    """SwiGLU.  With ``tp`` (a ``models/tp.py::Line`` over ``model``),
    ``wi``/``wg`` hold this rank's columns of the hidden width
    (column-parallel) and ``wo`` its rows (row-parallel): the input's
    gradient and the output's partial sums are summed over the line.  The
    caller passes ``models/tp.py::split(line, width)``: where
    ``param_pspecs`` keeps the width whole (sLSTM's 1365 over 2 ranks)
    that is None, and the MLP runs whole on every rank, on the replicated
    input, with no collective."""
    dt = x.dtype
    if tp is not None:
        x = tp.copy_to(x)
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    out = h @ p["wo"].to(dt)
    return out if tp is None else tp.reduce_from(out)
