"""Sort-based top-k MoE dispatch, capacity-bounded and group-local (a port
of ``repro.models.moe``).

Tokens are sorted and capacity-packed within their batch row, as in the
JAX package: every gather and scatter stays inside the row, and every
shape comes from the config and the input's shape, so the dispatch never
waits on the device (no loop over experts, no boolean indexing).  The
expert FFN is three batched products over the (B, E, C, .) buffer; the
JAX package computes them outside any kernel, and here they stay
``torch.einsum``.

Per-(row, expert) capacity C = ceil(S*k/E * cf) rounded up to 8, at least
8; a token past its expert's capacity is dropped (its gate counts 0).

In the sharded train step the experts run tensor-parallel over the
``model`` line (``moe_ffn``'s ``tp``): on each expert's columns, or on
whole experts where ``params.expert_parallel`` splits them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp
from repro_torch.models.params import expert_parallel


def capacity(s: int, cfg: ModelConfig) -> int:
    """Slots per (row, expert) for rows of ``s`` tokens."""
    cap = int(math.ceil(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


class Plan(NamedTuple):
    """The group-local dispatch of one (B, S) input: each row's T = S*k
    lanes sorted by expert (``order``), their tokens, gates and whether
    each is kept within its expert's capacity, and its buffer slot
    (``dest``; the sentinel E*cap where dropped)."""
    order: torch.Tensor
    tok_sorted: torch.Tensor
    g_sorted: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    cap: int


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(gates (B,S,E) f32, top-k gates renormalized (B,S,k), top-k experts
    (B,S,k)) of x (B,S,d)."""
    gates = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    # lax.top_k puts the lower index first among equal values: a stable
    # descending sort does too, where torch.topk leaves ties unordered
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :cfg.top_k], topi[..., :cfg.top_k]
    return gates, topv / topv.sum(-1, keepdim=True), topi


def plan(topi: torch.Tensor, topv: torch.Tensor, cfg: ModelConfig) -> Plan:
    """The per-row sort, rank and capacity of the top-k assignments."""
    b, s, k = topi.shape
    e, t, dev = cfg.n_experts, s * k, topi.device
    e_flat = topi.reshape(b, t)                                     # (B,T)
    g_flat = topv.reshape(b, t)
    tok_of = torch.arange(s, device=dev).repeat_interleave(k)[None].expand(
        b, t)
    order = torch.argsort(e_flat, dim=1, stable=True)               # (B,T)
    e_sorted = torch.gather(e_flat, 1, order)
    tok_sorted = torch.gather(tok_of, 1, order)
    g_sorted = torch.gather(g_flat, 1, order)
    idx = torch.arange(t, device=dev)[None].expand(b, t)
    # the first sorted lane of each expert: .at[].min over a row of T
    group_start = torch.full((b, e), t, dtype=torch.int64,
                             device=dev).scatter_reduce(
        1, e_sorted, idx, "amin")                                   # (B,E)
    rank = idx - torch.gather(group_start, 1, e_sorted)

    cap = capacity(s, cfg)
    keep = rank < cap
    # a dropped lane goes to the sentinel row E*cap, sliced off below (the
    # idiom of core/drop.py for JAX's mode="drop" scatter)
    dest = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(rank, e * cap))
    return Plan(order, tok_sorted, g_sorted, keep, dest, cap)


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts of ``p`` over buf (B, E', C, d): one batched
    product per projection."""
    dt = buf.dtype
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["wg"].to(dt))) \
        * torch.einsum("becd,edf->becf", buf, p["wi"].to(dt))
    return torch.einsum("becf,efd->becd", h, p["wo"].to(dt))


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, dp=None,
            tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux_loss f32 scalar).  With ``dp`` (a
    ``models/tp.py::Line``: x is this rank's rows of the batch split over
    it) the auxiliary loss is the whole batch's.

    With ``tp`` (the ``model`` line; x whole on it) the experts run on this
    rank's blocks of ``param_pspecs``: its columns of every expert's width
    (``wi``/``wg``, and ``wo``'s rows), or with ``expert_parallel(cfg)``
    its E / tp whole experts, the arctic dense residual column- and
    row-parallel.  Routing, the aux loss, the sort and the pack run
    replicated on every rank of the line, from the same residual."""
    if x.shape[1] == 1 and x.shape[0] > 1:
        # decode: one token per row -- per-row groups would allocate a full
        # (B, E, C, d) buffer for B tokens; one group of B tokens keeps the
        # buffer at (1, E, C, d)
        out, aux = moe_ffn(p, x.reshape(1, x.shape[0], x.shape[2]), cfg)
        return out.reshape(x.shape), aux
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = s * k
    dt = x.dtype
    dev = x.device

    gates, topv, topi = route(x, p["router"], cfg)

    # load-balancing aux loss (Switch-style), over the whole batch
    me = gates.mean(dim=(0, 1))                                     # (E,)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, topi.reshape(-1),
        torch.full((b * t,), 1.0 / (b * t), dtype=torch.float32, device=dev))
    if dp is not None:
        # computed globally, as JAX's GSPMD computes it: the ranks hold
        # equal numbers of rows, so the whole batch's means are the mean of
        # the ranks' means over the dp line (one all-reduce, whose backward
        # is the identity: each rank differentiates through its own rows),
        # then the product.  A mean of the ranks' own aux losses would be
        # another number.  On a line of one rank this is me and ce bit for
        # bit
        tot = dp.reduce_from(torch.cat([me, ce])) / dp.size
        me, ce = tot[:e], tot[e:]
    aux = (me * ce).sum() * e * cfg.router_aux_coef

    # ---- group-local (per-row) sort + rank + capacity ----
    pl = plan(topi, topv, cfg)
    cap = pl.cap

    # ---- pack: all indexing is within the batch row ----
    xs = torch.gather(x, 1, pl.tok_sorted[..., None].expand(b, t, d))
    if tp is not None:
        # Trap: which gradients come out whole.  The router is split on
        # data and replicated on model, so the gathers never sum its
        # gradient over model: it must be whole on every rank by itself.
        # The copy sits on the dispatched tokens, where the experts' path
        # leaves x, so it sums that path's partial gradients (the rank's
        # columns or experts) and nothing of the routing path's, which is
        # whole already; on x it would count the router's gradient tp
        # times
        xs = tp.copy_to(xs)
    buf = x.new_zeros((b, e * cap + 1, d)).scatter_(
        1, pl.dest[..., None].expand(b, t, d), xs)
    buf = buf[:, :e * cap].reshape(b, e, cap, d)

    # ---- expert FFN ----
    if tp is not None and expert_parallel(cfg):
        # this rank's E / tp whole experts on their slab of the buffer; the
        # slabs gathered along E into the whole buffer on every rank
        n = e // tp.size
        out_buf = tp.all_gather(_experts(p, buf[:, tp.coord * n:
                                                (tp.coord + 1) * n]), 1)
    else:
        out_buf = _experts(p, buf)
    out_buf = out_buf.reshape(b, e * cap, d)

    # ---- unpack: gather back per row, weight by gate prob ----
    safe = pl.dest.clamp(0, e * cap - 1)
    contrib = torch.gather(out_buf, 1, safe[..., None].expand(b, t, d))
    if tp is not None and not expert_parallel(cfg):
        # the rank's columns of the width give partial sums: summed over
        # model here, on the (B, T, d) lanes (the gather is linear, and T
        # lanes are fewer than the E*cap slots), and before the gates
        # weight them.  Trap: the gates and the aux loss are replicated,
        # and so are their gradients; gates multiplying each rank's
        # partial would make the router's gradient partial beside the aux
        # loss's whole part, which no one sum repairs
        contrib = tp.reduce_from(contrib)
    contrib = contrib * (pl.g_sorted * pl.keep).to(dt)[..., None]
    # back to token order (order is a permutation of each row), then the k
    # contributions of each token summed; JAX adds them into zeros by a
    # scatter, which for k = 2 is the same sum
    unsorted = torch.empty_like(contrib).scatter_(
        1, pl.order[..., None].expand(b, t, d), contrib)
    out = unsorted.reshape(b, s, k, d).sum(2)

    if cfg.moe_dense_ff:
        out = out + mlp(p["dense"], x, tp)
    return out, aux
