"""The collectives of the sharded train step on a (data, model) grid of
ranks, written out: the JAX package has no such module, because GSPMD
inserts them from the specs.

On the grid every param leaf and its AdamW state are held in blocks by
``models/params.py::param_pspecs``: the ``fsdp`` role splits a dim over
``data``, the ``tp`` and ``ep`` roles over ``model``.  Each rank computes
on its rows of the batch (``dp``) and, over ``model`` (Megatron-style
tensor parallelism), on its heads (``attn`` and MLA blocks, mLSTM's
cell), its columns of an MLP's hidden width, of RG-LRU's width, of every
expert's width (a ``moe`` block whose experts do not split:
``expert_parallel`` false) or its whole experts (``expert_parallel``
true), and its rows of the vocabulary.  sLSTM's serial loop runs whole on
every rank of the line, from its gathered weights.

  copy_to      identity forward, SUM over the line backward (an input
               entering a column-parallel product: each rank's partial
               gradient of it summed)
  reduce_from  SUM over the line forward, identity backward (a
               row-parallel product's partial sums, a vocabulary-parallel
               embedding, the cross entropy's sums)
  all_gather   the ranks' blocks concatenated along a dim forward, this
               rank's block of the gradient backward (the experts'
               outputs on the expert-parallel route)
  gather       a layer's ``data`` blocks gathered into the leaves the
               layer computes with (whole on ``data``, still split on
               ``model``); backward sums the gradients over the batch's
               ``dp`` axis and keeps this rank's blocks (reduce-scatter),
               and sums the gradient of a leaf replicated on ``model`` but
               applied to this rank's heads over ``model`` as well

Which gradients sum over ``model``: only those of leaves whole on
``data`` flagged in ``Layout.partial`` (``models/model.py::TP_PARTIAL``:
qk-norm's scales, mLSTM's ``skip_scale``).  A leaf split on ``data`` and
replicated on ``model`` is never summed over ``model``, so its gradient
must come out whole on every model rank by itself: the MoE router, MLA's
``wq_a`` and ``wkv_a`` and mLSTM's ``w_if`` (roles ``(fsdp, None)``), and
the leaves whose ``model`` axis ``param_pspecs`` dropped, are such
leaves.  Their products run on
the replicated residual, and the ``copy_to`` that sums the partial
gradients of the rank's columns or experts sits after them (on MLA's
``x @ wq_a`` and ``x @ wkv_a``, on MoE's dispatched tokens, on mLSTM's
``z @ w_if``), so that no partial gradient reaches them.

Split or whole: each product follows its weight's spec.  ``param_pspecs``
drops ``model`` from a dim that the line does not divide (JAX's rule:
xlstm-350m's sLSTM width 1365 over 2 ranks), and ``split(tp, dim)``
applies that same rule to the same dim: a leaf split over ``model`` runs
on the rank's block, a leaf left whole runs whole on every rank.  Never
decide it from a tensor's shape.  A product computed whole on every rank
reads the replicated input, never a ``copy_to``'s output (read through a
``copy_to``, its whole gradient would be summed tp times); a ``copy_to``
sits only on a tensor whose gradient is partial on each rank.

Two compositions need no autograd function of their own:

  all_gather of a WEIGHT block (sLSTM's ``w_x`` and ``w_h``, mLSTM's
      ``w_up``): the product then runs replicated, its gradient is whole
      on every rank, and the gather's backward keeps the rank's block of
      it, which is the block's gradient.
  copy_to(all_gather(x_block, dim)) of an ACTIVATION (a KV head split
      mid-head, RG-LRU's gate input): the whole tensor feeds only the
      rank's columns downstream, so its gradient is partial; backward
      sums it over the line, then keeps the rank's block (a
      reduce-scatter, written as its two halves).

Trap: the layout is gate-major and half-major, not head-major.  A rank's
block of mLSTM's ``w_up`` is half of [z | skip_in] (at tp = 2 rank 1 holds
all of skip_in), of sLSTM's ``w_x`` and ``w_h`` a quarter of [i | f | z |
o] at tp = 4: never read as "this rank's units".  Those weights are
gathered and applied whole.

Each is an autograd function over the lines of a ``ModelMesh``
(``launch/mesh.py``), a no-op on a line of one rank.  A layer's leaves
travel flattened into one buffer: one collective a layer, not one a leaf
(each ``gloo`` collective of card tensors costs milliseconds).

Gradient accumulation: inside ``accumulate(sink, final)`` a gather's
backward adds its layer's unreduced gradient into ``sink`` and returns
none, until the ``final`` microbatch, whose backward reduces the sum once.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Line(NamedTuple):
    """This rank's line of ``axes`` (an axis name, a tuple, or None for a
    line of one rank) on ``mesh``."""
    mesh: object
    axes: object

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axes)

    @property
    def coord(self) -> int:
        return self.mesh.coord(self.axes)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _ReduceFrom.apply(x, self)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's blocks of ``x`` concatenated along ``dim`` in their
        coordinate order; backward keeps this rank's block of the gradient
        (the gradient of the whole is the same on every rank: what follows
        runs replicated)."""
        return x if self.size == 1 else _AllGather.apply(x, self, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise MAX of a tensor without gradient over the line
        (a copy; ``x`` itself on a line of one rank)."""
        if self.size == 1:
            return x
        return self.mesh.all_reduce(x.detach().clone(), dist.ReduceOp.MAX,
                                    self.axes)


def line(ctx, role: str) -> Line:
    """The line of a ``ShardCtx`` role ("tp", "dp" or "fsdp") on the
    current mesh."""
    from repro_torch.launch.meshctx import require_mesh
    return Line(require_mesh(ctx), getattr(ctx, role)())


def split(tp: Optional[Line], dim: int) -> Optional[Line]:
    """``tp`` where ``param_pspecs`` splits a dim of ``dim`` over it (the
    line divides it), None where the leaf is whole on ``model`` and its
    product runs whole on every rank (or where there is no line)."""
    return tp if tp is not None and dim % tp.size == 0 else None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln):
        ctx.ln = ln
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.ln.mesh.all_reduce(g, dist.ReduceOp.SUM, ctx.ln.axes), \
            None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln):
        out = x.clone(memory_format=torch.contiguous_format)
        return ln.mesh.all_reduce(out, dist.ReduceOp.SUM, ln.axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln, dim):
        ctx.ln, ctx.dim, ctx.k = ln, dim, x.shape[dim]
        n = ln.size
        part = x.movedim(dim, 0)
        whole = ln.mesh.all_gather(part, ln.axes).view((n,) + part.shape)
        return whole.reshape((n * part.shape[0],) + part.shape[1:]) \
            .movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        at = ctx.ln.coord * ctx.k
        return g.narrow(ctx.dim, at, ctx.k).contiguous(), None, None


# ---------------------------------------------------------------------------
# FSDP over data
# ---------------------------------------------------------------------------

class GradSink:
    """Unreduced gradients of each gathered layer, summed over the
    microbatches of one step (``accumulate``)."""

    def __init__(self):
        self.flat: Dict[object, torch.Tensor] = {}
        self.final = True


_SINK: Optional[GradSink] = None


@contextlib.contextmanager
def accumulate(sink: GradSink, final: bool):
    """The gathers made while the block runs (and their backward, run
    inside it) add their gradients into ``sink``; on the ``final``
    microbatch they reduce the sum, once."""
    global _SINK
    prev, _SINK = _SINK, sink
    sink.final = final
    try:
        yield sink
    finally:
        _SINK = prev


class Layout(NamedTuple):
    """The split of one gathered group of leaves (a layer's, or the
    top-level ones): per leaf, the dim split over ``data`` (None where the
    leaf is whole on ``data``) and whether its gradient also sums over
    ``model`` (a leaf replicated on ``model`` applied to this rank's
    heads)."""
    data_dims: Tuple[Optional[int], ...]
    partial: Tuple[bool, ...]


def layout(specs: Sequence[tuple], fsdp_axis, partial: Sequence[bool]
           ) -> Layout:
    """The ``Layout`` of leaves of ``specs``, split over ``fsdp_axis``."""
    dims = []
    for spec in specs:
        at = [i for i, a in enumerate(spec)
              if a is not None and a == fsdp_axis]
        dims.append(at[0] if at else None)
    return Layout(tuple(dims), tuple(partial))


class Gatherer(NamedTuple):
    """What a train step's gathers need: the ``data`` line of the params'
    blocks (``fsdp``), the ``dp`` line of the batch's rows (None where
    every rank holds every row: the gradients are then already whole)
    and the ``model`` line."""
    fsdp: Line
    dp: Line
    tp: Line

    def gather(self, key, blocks: Sequence[torch.Tensor], lay: Layout
               ) -> List[torch.Tensor]:
        """The leaves whole on ``data`` from this rank's ``blocks``."""
        return list(_Gather.apply(self, key, lay, _SINK, *blocks))


def _split(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """(n, numel / n): ``t``'s n blocks along ``dim``, each flattened."""
    shp = t.shape
    return t.reshape(shp[:dim] + (n, shp[dim] // n) + shp[dim + 1:]) \
        .movedim(dim, 0).reshape(n, -1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: Gatherer, key, lay: Layout, sink, *blocks):
        n = g.fsdp.size
        ctx.g, ctx.key, ctx.lay, ctx.sink = g, key, lay, sink
        ctx.shapes = [tuple(b.shape) for b in blocks]
        split = [i for i, d in enumerate(lay.data_dims)
                 if d is not None and n > 1]
        out = [b.view_as(b) for b in blocks]
        if not split:
            return tuple(out)
        # each rank's blocks flattened into one buffer, gathered in the
        # data line's order (rank-major), then each leaf's n blocks put
        # back along its split dim
        flat = torch.cat([blocks[i].reshape(-1) for i in split])
        whole = g.fsdp.mesh.all_gather(flat, g.fsdp.axes).view(n, -1)
        at = 0
        for i in split:
            shp, d = ctx.shapes[i], lay.data_dims[i]
            k = blocks[i].numel()
            part = whole[:, at:at + k].reshape((n,) + shp)
            out[i] = part.movedim(0, d).reshape(
                shp[:d] + (n * shp[d],) + shp[d + 1:])
            at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        g, lay = ctx.g, ctx.lay
        n = g.fsdp.size
        split = [i for i, d in enumerate(lay.data_dims)
                 if d is not None and n > 1]
        whole = [i for i in range(len(grads)) if i not in split]
        # the split leaves' gradients as (n, per rank): row c holds the
        # gradient of the blocks rank c keeps; the whole leaves' flat
        parts = [torch.cat([_split(grads[i], lay.data_dims[i], n)
                            for i in split], 1) if split else None,
                 torch.cat([grads[i].reshape(-1) for i in whole])
                 if whole else None]
        sink = ctx.sink
        if sink is not None:
            if ctx.key in sink.flat:
                parts = [a if b is None else a + b
                         for a, b in zip(parts, sink.flat.pop(ctx.key))]
            if not sink.final:
                sink.flat[ctx.key] = parts
                return (None,) * (4 + len(grads))
        # Trap: which gradients sum over which axis.  Every gradient sums
        # over the batch's dp axis (the ranks hold other rows), unless
        # every rank holds every row (dp None: the gradients are whole
        # already, and only this rank's blocks are kept).  dp is the axis
        # the params split over (no pod axis: _check_ctx).  The split
        # leaves reduce-scatter; the whole ones all-reduce, so that every
        # replica gets the same bits (a reduce-scatter's chunks sum the
        # ranks in other orders).  Over model, the leaves applied to the
        # replicated residual (ln1, ln2, final_norm) already hold their
        # whole gradient on every model rank and are not summed again; a
        # leaf replicated on model but applied to this rank's heads
        # (q_norm, k_norm: lay.partial) holds a partial one and sums over
        # model too.
        out = [None] * len(grads)
        if split:
            mine = g.fsdp.mesh.reduce_scatter(parts[0].view(-1),
                                              g.dp.axes) \
                if g.dp.size > 1 else parts[0][g.fsdp.coord]
            at = 0
            for i in split:
                k = math.prod(ctx.shapes[i])
                out[i] = mine[at:at + k].view(ctx.shapes[i])
                at += k
        if whole:
            flat = g.dp.mesh.all_reduce(parts[1], dist.ReduceOp.SUM,
                                        g.dp.axes)
            at, span = 0, {}
            for i in whole:
                span[i] = slice(at, at + math.prod(ctx.shapes[i]))
                at = span[i].stop
            part = [i for i in whole if lay.partial[i]]
            if part and g.tp.size > 1:
                sel = g.tp.mesh.all_reduce(
                    torch.cat([flat[span[i]] for i in part]),
                    dist.ReduceOp.SUM, g.tp.axes)
                at = 0
                for i in part:
                    k = span[i].stop - span[i].start
                    flat[span[i]] = sel[at:at + k]
                    at += k
            for i in whole:
                out[i] = flat[span[i]].view(ctx.shapes[i])
        return (None, None, None, None) + tuple(out)
