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
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

CLIP = 8.0
CHUNK = 256                 # mLSTM's chunk, min(CHUNK, S), as in the JAX package


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM) -- chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_seq(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig):
    """x (B,S,d) -> ((B,S,d), final state {'c','n'}).
    State: C (B,H,D,D), n (B,H,D).  S must be a multiple of the chunk
    min(CHUNK, S), as the JAX version asserts."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    inner = h * hd
    dt = x.dtype
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"mlstm_seq: S={s} is not a multiple of the chunk "
                         f"{c}")
    nc = s // c

    up = x @ p["w_up"].to(dt)                           # (B,S,2*inner)
    z, skip_in = torch.chunk(up, 2, dim=-1)
    q = (z @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (z @ p["wk"].to(dt)).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (z @ p["wv"].to(dt)).reshape(b, s, h, hd)
    gif = (z @ p["w_if"].to(dt)).float()                # (B,S,2H)
    log_i = torch.clamp(gif[..., :h], -CLIP, CLIP)
    log_f = F.logsigmoid(gif[..., h:])                  # (B,S,H) <= 0

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
    out = out + F.silu(skip_in) * p["skip_scale"].to(dt)
    return out @ p["w_down"].to(dt), {"c": cst, "n": nst}


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


def _slstm_out(p, hs):
    dt = hs.dtype
    up = F.silu(hs @ p["w_gate"].to(dt)) * (hs @ p["w_up"].to(dt))
    return up @ p["w_down"].to(dt)


def slstm_seq(p, x, cfg: ModelConfig):
    b, s, d = x.shape
    dt = x.dtype
    gx = (x @ p["w_x"].to(dt)).float()                  # (B,S,4d) hoisted
    w_h = p["w_h"].to(dt)
    h = c = n = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        g = gx[:, t] + (h.to(dt) @ w_h).float()
        h, c, n = _slstm_cell(g, c, n)
        hs.append(h)
    out = _slstm_out(p, torch.stack(hs, 1).to(dt))      # (B,S,d)
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


def rglru_seq(p, x, cfg: ModelConfig):
    dt = x.dtype
    xw_in = x @ p["w_x"].to(dt)                         # (B,S,R)
    xw, conv_state = _causal_conv(xw_in, p["conv_w"].to(dt),
                                  p["conv_b"].to(dt))
    # log a_t = -softplus(a_param) * 8 * sigmoid(gate)  (Griffin eq. 4-ish)
    a, mult = _rglru_gate(p, (xw @ p["w_in_gate"].to(dt)).float())
    h = linear_scan(a, mult * xw.float())
    # jax.nn.gelu's default is the tanh approximation
    out = h.to(dt) * F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    out = out @ p["w_down"].to(dt)
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
