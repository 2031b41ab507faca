"""Recurrent sequence mixers (a port of ``repro.models.seqmix``): mLSTM
(chunkwise parallel), sLSTM (serial) and RG-LRU (log-depth scan), the
xLSTM and RecurrentGemma families.

mLSTM keeps the JAX package's chunkwise form (dense products within a
chunk, a state recurrence across chunks); the ``lax.scan`` over chunks
becomes a loop over them.  sLSTM's recurrence is nonlinear and serial: the
input products are hoisted out of the loop over time, so only the
(B, d) x (d, 4d) recurrent product stays inside.  RG-LRU's diagonal linear
recurrence runs as ceil(log2 S) passes of its combine over the whole
sequence, where JAX calls ``lax.associative_scan``.  The recurrent states
stay f32 whatever the compute dtype, as in the JAX package.  Every function
returns the new state as a new dict; the block writes it into the cache.

In the sharded train step (``tp``, the ``model`` line; ``models/tp.py``)
mLSTM runs its cell on the rank's heads, RG-LRU on the rank's channels,
and sLSTM whole on every rank of the line from its gathered weights.
Trap: collectives under remat.  The weight and activation gathers run
again in the layer's recomputation, in the same order on every rank: no
gather may depend on what one rank alone sees.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import slstm_width
from repro_torch.models.tp import split as _split

CLIP = 8.0
CHUNK = 256                 # mLSTM's chunk, min(CHUNK, S), as in the JAX package


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM) -- chunkwise parallel
# ---------------------------------------------------------------------------

def _mlstm_gate_logits(up, zc, w_if, tp):
    """The input and forget gates' logits of every head (B,S,2H) from z,
    the first half of ``up``; ``zc`` is z's copy onto the line ``tp`` (z
    itself without one).  Trap: which gradients come out whole.  ``w_if``
    is whole on ``model`` and split on ``data``: the gathers never sum its
    gradient over ``model``.  So its product reads the replicated z and
    the copy sits on its output (each rank reads only its heads' gates, a
    partial gradient summed there); read from ``zc``, its gradient would
    be the rank's heads' part."""
    gif = torch.chunk(up, 2, dim=-1)[0] @ w_if
    return gif if tp is None else tp.copy_to(gif)


def mlstm_seq(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              tp=None):
    """x (B,S,d) -> ((B,S,d), final state {'c','n'}).
    State: C (B,H,D,D), n (B,H,D).  S must be a multiple of the chunk
    min(CHUNK, S), as the JAX version asserts.

    With ``tp`` (the sharded train step's ``model`` line, whose size
    divides H) the rank runs the cell on its H / tp heads: ``w_up`` is its
    block, gathered whole (Trap: half-major.  At tp = 2 rank 0's block is
    all of z and rank 1's all of skip_in), and ``up`` is computed whole on
    the replicated x.  ``wq``, ``wk`` and ``wv`` hold its heads' columns,
    fed the copy of ``up`` onto the line, as the skip path's columns are;
    ``w_if`` is whole on ``model`` and split on ``data``, so its product
    reads the replicated z and the copy sits on its output (the gates of
    every head; the rank takes its heads').  ``w_down`` holds its heads'
    rows, their partial sums summed.  The final state returned is the
    rank's heads'."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"mlstm_seq: S={s} is not a multiple of the chunk "
                         f"{c}")
    nc = s // c

    w_up = p["w_up"] if tp is None else tp.all_gather(p["w_up"], 1)
    up = x @ w_up.to(dt)                                # (B,S,2*inner)
    z, skip_in = torch.chunk(up if tp is None else tp.copy_to(up), 2,
                             dim=-1)
    gif = _mlstm_gate_logits(up, z, p["w_if"].to(dt), tp)  # (B,S,2H)
    h0 = 0                      # the heads the cell runs: [h0, h0 + h)
    skip_scale = p["skip_scale"]
    if tp is not None:
        h //= tp.size
        h0 = tp.coord * h
        skip_in = skip_in[..., h0 * hd:(h0 + h) * hd]
        skip_scale = skip_scale[h0 * hd:(h0 + h) * hd]
    inner = h * hd
    q = (z @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (z @ p["wk"].to(dt)).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (z @ p["wv"].to(dt)).reshape(b, s, h, hd)
    gif = gif.float()
    log_i = torch.clamp(gif[..., h0:h0 + h], -CLIP, CLIP)
    log_f = F.logsigmoid(gif[..., cfg.n_heads + h0:cfg.n_heads + h0 + h])

    qc = q.reshape(b, nc, c, h, hd).float()
    kc = k.reshape(b, nc, c, h, hd).float()
    vc = v.reshape(b, nc, c, h, hd).float()
    lic = log_i.reshape(b, nc, c, h)
    lfc = log_f.reshape(b, nc, c, h)
    acum = torch.cumsum(lfc, dim=2)                     # within-chunk decay
    a_last = acum[:, :, -1:, :]                         # (B,nc,1,H)

    # intra-chunk: D[t, s'] = exp(A_t - A_s' + log_i_s') for s' <= t
    dmat = acum[:, :, :, None, :] - acum[:, :, None, :, :] \
        + lic[:, :, None, :, :]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    dmat = torch.where(causal, dmat, float("-inf"))     # (B,nc,c,c,H)
    logits = torch.einsum("bnthd,bnshd->bntsh", qc, kc)
    intra = torch.einsum("bntsh,bnshd->bnthd", logits * torch.exp(dmat), vc)
    intra_n = torch.einsum("bntsh,bnshd->bnthd", torch.exp(dmat), kc)

    # inter-chunk recurrent state
    k_sc = kc * torch.exp(a_last - acum + lic)[..., None]   # (B,nc,c,H,D)
    dc = torch.einsum("bnshd,bnshe->bnhde", k_sc, vc)   # per-chunk state add
    dn = k_sc.sum(2)                                    # (B,nc,H,D)
    decay = torch.exp(a_last[:, :, 0, :])               # (B,nc,H)

    cst = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    nst = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
    cs, ns = [], []                                     # pre-chunk states
    for i in range(nc):
        cs.append(cst)
        ns.append(nst)
        cst = cst * decay[:, i, :, None, None] + dc[:, i]
        nst = nst * decay[:, i, :, None] + dn[:, i]
    cs = torch.stack(cs, 1)                             # (B,nc,H,D,D)
    ns = torch.stack(ns, 1)

    q_dec = qc * torch.exp(acum)[..., None]
    inter = torch.einsum("bnthd,bnhde->bnthe", q_dec, cs)
    inter_n = torch.einsum("bnthd,bnhd->bnth", q_dec, ns)[..., None]
    num = intra + inter                                 # (B,nc,c,H,D)
    den = torch.einsum("bnthd,bnthd->bnth", qc, intra_n)[..., None] + inter_n
    out = num / torch.clamp(den.abs(), min=1.0)
    out = out.reshape(b, s, inner).to(dt)
    out = out + F.silu(skip_in) * skip_scale.to(dt)
    out = out @ p["w_down"].to(dt)
    return (out if tp is None else tp.reduce_from(out)), {"c": cst,
                                                          "n": nst}


def mlstm_decode(p, x, cache, cfg: ModelConfig):
    """x (B,1,d); cache {'c': (B,H,D,D), 'n': (B,H,D)}."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    up = x[:, 0] @ p["w_up"].to(dt)
    z, skip_in = torch.chunk(up, 2, dim=-1)
    q = (z @ p["wq"].to(dt)).reshape(b, h, hd).float()
    k = (z @ p["wk"].to(dt)).reshape(b, h, hd).float() / math.sqrt(hd)
    v = (z @ p["wv"].to(dt)).reshape(b, h, hd).float()
    gif = (z @ p["w_if"].to(dt)).float()
    i_g = torch.exp(torch.clamp(gif[..., :h], -CLIP, CLIP))[..., None]
    f_g = torch.sigmoid(gif[..., h:])[..., None]
    c = cache["c"] * f_g[..., None] \
        + i_g[..., None] * k[..., :, None] * v[..., None, :]
    n = cache["n"] * f_g + i_g * k
    num = torch.einsum("bhd,bhde->bhe", q, c)
    den = torch.einsum("bhd,bhd->bh", q, n).abs()[..., None]
    out = (num / torch.clamp(den, min=1.0)).reshape(b, h * hd).to(dt)
    out = out + F.silu(skip_in) * p["skip_scale"].to(dt)
    return (out @ p["w_down"].to(dt))[:, None], {"c": c, "n": n}


def mlstm_cache(cfg: ModelConfig, batch: int, device):
    h, hd = cfg.n_heads, cfg.head_dim
    return {"c": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# sLSTM -- serial loop over time (input products hoisted)
# ---------------------------------------------------------------------------

def _slstm_cell(g, c, n):
    i, f, z, o = torch.chunk(g, 4, dim=-1)
    i = torch.exp(torch.clamp(i, -CLIP, CLIP))
    f = torch.sigmoid(f)
    c = f * c + i * torch.tanh(z)
    n = f * n + i
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return h, c, n


def _slstm_out(p, hs, tp=None):
    """The gated output MLP; with ``tp`` (``models/tp.py::split`` of the
    line at its width) on the rank's columns, else whole."""
    dt = hs.dtype
    if tp is not None:
        hs = tp.copy_to(hs)
    up = F.silu(hs @ p["w_gate"].to(dt)) * (hs @ p["w_up"].to(dt))
    out = up @ p["w_down"].to(dt)
    return out if tp is None else tp.reduce_from(out)


def slstm_seq(p, x, cfg: ModelConfig, tp=None):
    """With ``tp`` (the sharded train step's ``model`` line) the block runs
    whole on every rank of it: ``w_x`` and ``w_h`` (their blocks cut
    across the four gates: gate-major, not this rank's units) are gathered
    once, before the loop over time (never a gather a step), and the loop
    runs on the replicated x.  Its gradient is whole on every rank, so the
    gather's backward keeps the block with no sum.  The output MLP follows
    its width's spec (``_slstm_out``)."""
    b, s, d = x.shape
    dt = x.dtype
    w_x, w_h = p["w_x"], p["w_h"]
    if tp is not None:
        w_x, w_h = tp.all_gather(torch.stack([w_x, w_h]), -1).unbind(0)
    gx = (x @ w_x.to(dt)).float()                       # (B,S,4d) hoisted
    w_h = w_h.to(dt)
    h = c = n = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        g = gx[:, t] + (h.to(dt) @ w_h).float()
        h, c, n = _slstm_cell(g, c, n)
        hs.append(h)
    out = _slstm_out(p, torch.stack(hs, 1).to(dt),      # (B,S,d)
                     _split(tp, slstm_width(cfg)))
    return out, {"h": h, "c": c, "n": n}


def slstm_decode(p, x, cache, cfg: ModelConfig):
    dt = x.dtype
    gx = (x[:, 0] @ p["w_x"].to(dt)).float()
    g = gx + (cache["h"].to(dt) @ p["w_h"].to(dt)).float()
    h, c, n = _slstm_cell(g, cache["c"], cache["n"])
    return _slstm_out(p, h.to(dt))[:, None], {"h": h, "c": c, "n": n}


def slstm_cache(cfg: ModelConfig, batch: int, device):
    return {key: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                             device=device) for key in ("h", "c", "n")}


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin) -- log-depth scan
# ---------------------------------------------------------------------------

def _causal_conv(xw, w, bias):
    """xw (B,S,R); w (K,R) depthwise causal conv from a zero history.
    Returns (out, the last K-1 inputs)."""
    k = w.shape[0]
    pad = xw.new_zeros((xw.shape[0], k - 1, xw.shape[2]))
    xp = torch.cat([pad, xw], dim=1)                    # (B,S+K-1,R)
    out = sum(xp[:, i:i + xw.shape[1]] * w[i] for i in range(k)) + bias
    return out, (xp[:, -(k - 1):] if k > 1 else None)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1: ceil(log2 S)
    passes of the combine (a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l +
    b_r), each over the whole sequence (Hillis-Steele)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def _rglru_gate(p, conv):
    """The decay a and the input multiplier from the conv output (f32)."""
    gate_in = torch.sigmoid(conv)
    log_a = -8.0 * F.softplus(p["a_param"].float()) * gate_in
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, mult


def _rglru_gate_input(xw, tp):
    """Every channel of the conv's output (B,S,R) from the rank's block of
    them: the rank's gate columns of ``w_in_gate`` read all R, so the
    gradient is partial on each rank and the copy onto the line sums it
    before the gather's backward keeps the block (a gather alone would
    keep the rank's own part of it)."""
    return tp.copy_to(tp.all_gather(xw, -1))


def rglru_seq(p, x, cfg: ModelConfig, tp=None):
    """With ``tp`` (the sharded train step's ``model`` line, whose size
    divides R) on the rank's R / tp channels: ``w_x``, ``w_gate``,
    ``conv_w``, ``conv_b``, ``a_param`` and ``w_in_gate`` hold its
    channels' columns, fed the copy of x onto the line; the gate's input
    is every channel of the conv, gathered, whose gradient is partial (the
    rank's gate columns read it), so the gather sits under a copy; the
    scan runs on the rank's channels, ``w_down`` holds their rows, and
    their partial sums are summed.  The final state returned is the
    rank's channels'."""
    dt = x.dtype
    if tp is not None:
        x = tp.copy_to(x)
    xw_in = x @ p["w_x"].to(dt)                         # (B,S,R)
    xw, conv_state = _causal_conv(xw_in, p["conv_w"].to(dt),
                                  p["conv_b"].to(dt))
    gin = xw if tp is None else _rglru_gate_input(xw, tp)
    # log a_t = -softplus(a_param) * 8 * sigmoid(gate)  (Griffin eq. 4-ish)
    a, mult = _rglru_gate(p, (gin @ p["w_in_gate"].to(dt)).float())
    h = linear_scan(a, mult * xw.float())
    # jax.nn.gelu's default is the tanh approximation
    out = h.to(dt) * F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    out = out @ p["w_down"].to(dt)
    if tp is not None:
        out = tp.reduce_from(out)
    return out, {"h": h[:, -1], "conv": conv_state.float()}


def rglru_decode(p, x, cache, cfg: ModelConfig):
    """x (B,1,d); cache {'h': (B,R), 'conv': (B,K-1,R)}, both f32.  As in
    JAX, the f32 history promotes the conv and the gate product to f32."""
    dt = x.dtype
    xw = x[:, 0] @ p["w_x"].to(dt)                      # (B,R)
    k = p["conv_w"].shape[0]
    hist = torch.cat([cache["conv"], xw[:, None].float()], dim=1)  # (B,K,R)
    conv = sum(hist[:, i] * p["conv_w"][i].to(dt).float() for i in range(k)) \
        + p["conv_b"].to(dt).float()
    a, mult = _rglru_gate(p, conv @ p["w_in_gate"].to(dt).float())
    h = cache["h"] * a + mult * conv
    out = h.to(dt) * F.gelu(x[:, 0] @ p["w_gate"].to(dt), approximate="tanh")
    out = (out @ p["w_down"].to(dt))[:, None]
    return out, {"h": h, "conv": hist[:, 1:]}


def rglru_cache(cfg: ModelConfig, batch: int, device):
    r = cfg.lru_dim or cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                dtype=torch.float32, device=device)}
