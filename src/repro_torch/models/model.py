"""Top-level model (a port of ``repro.models.model``): embedding -> block
stacks -> final norm, then the chunked cross-entropy loss in training and
the logits of the last position in serving, with per-layer KV caches.

Layer params are stacked on a leading dim as in the JAX package; a Python
loop over that dim replaces ``lax.scan``.  Serving reads views of each
layer's slices (no copies), and updates the KV caches IN PLACE, one layer
slice at a time: ``prefill`` and ``decode_step`` return the same cache
dict they were given, where the JAX functions return new stacked caches
(at qwen3-32b's serving shape that saves a 1 GiB copy per step); the
recurrent blocks copy their new states into theirs.  Training takes each
stacked leaf apart once with ``torch.unbind`` (whose backward stacks the
layers' gradients once; a view ``a[i]`` per layer would zero-fill a
stack-sized gradient for every layer) and runs each layer body under
``cfg.remat``: plain, ``torch.utils.checkpoint`` ("full"), or a selective
checkpoint that saves the outputs of weight products and recomputes the
rest ("dots", JAX's ``dots_with_no_batch_dims_saveable``).  The hybrid
family's embedding is scaled by sqrt(d_model), as in JAX.

The front ends are the JAX package's stubs: a vlm batch may carry patch
embeddings (``embeds``, (B, S, d_model)) in place of tokens, and its
default positions are M-RoPE's (3, B, S) arange; an audio batch carries
frame embeddings (``embeds``, (B, enc_seq, d_model)) for the encoder and
decoder ``tokens``.  Positions given in the batch ((B, S), or (3, B, S)
for M-RoPE) go to rotary and to the attention mask (M-RoPE's temporal
row), as in JAX: in serving through ``flash_prefill``'s positions
operand, without them the mask is by sequence index.  Nothing reads them
on the host.

Serving on a mesh: ``init_cache``, ``prefill`` and ``decode_step`` take
an optional ``ShardCtx`` (``launch/specs.py::make_shard_ctx``) under the
current ``ModelMesh`` (``launch/meshctx.py``).  Each rank then holds its
block of every cache leaf (``launch/specs.py::cache_specs``), is handed
its rows of the tokens (``specs.local_rows``) and returns the logits of
those rows; the weights are whole on every rank.  With
``seq_shard_cache`` the attention caches are split on the sequence over
the ``model`` axis: a prefill attends over the whole prompt as on one
card and writes only the rank's slots, and a decode step combines the
ranks' partial softmaxes (``layers._sharded_flash_decode``).  With
``ctx=None`` every signature and result is the one-card one.

Training on a mesh: ``forward_train``, ``loss_fn`` and ``ce_loss_chunked``
take the same optional ``ctx``.  Each rank then holds its blocks of every
param by ``param_pspecs`` and its rows of the batch; a layer's ``data``
blocks are gathered inside its remat body, an ``attn`` block runs on the
rank's heads (MLA's too) and MLP columns, a ``moe`` block on its columns
of the experts' width or its whole experts, an ``mlstm`` block on its
heads, an ``rglru`` block on its channels, an ``slstm`` block whole from
its gathered weights, a leaf whole on ``model`` whole, and the embedding
and the cross entropy are vocabulary-parallel (``models/tp.py`` has the
collectives).  In serving a recurrent state split over ``model`` is
gathered whole for each decode step and the rank keeps its block of the
new one.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import apply_block, init_block_cache
from repro_torch.models.params import (expert_parallel,
                                       init_params,  # noqa: F401
                                       param_count, param_pspecs,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.models import tp as TP

__all__ = ["init_params", "param_count", "forward_train", "loss_fn",
           "ce_loss_chunked", "init_cache", "prefill", "decode_step"]

_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Remat "dots": keep the outputs of weight products (2-D ``mm`` and
    ``addmm``, what a (B,S,d) @ (d,f) product lowers to), recompute the
    rest (the batched attention products included)."""
    if op in _WEIGHT_PRODUCTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy: every tensor it needs from
    outside must be one of its arguments."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)




def _embed(params, tokens, cfg: ModelConfig, ctx=None):
    """The tokens' embeddings.  In the sharded train step (an enabled
    ``ctx``) ``embed/w`` holds this rank's rows of the vocabulary: a token
    outside them embeds to zeros and the ``model`` line sums the rows."""
    w = params["embed"]["w"]
    dt = getattr(torch, cfg.compute_dtype)
    tp = TP.line(ctx, "tp") if ctx is not None and ctx.enabled else None
    if tp is None or tp.size == 1:
        x = w[tokens.long()].to(dt)
    else:
        rows = w.shape[0]
        local = tokens.long() - tp.coord * rows
        hit = (local >= 0) & (local < rows)
        x = torch.where(hit[..., None],
                        w[torch.clamp(local, 0, rows - 1)].to(dt), 0)
        x = tp.reduce_from(x)
    if cfg.family != "hybrid":
        return x
    # JAX rounds the weakly typed scale to the compute dtype before the
    # product; torch would multiply by the unrounded one (a CPU scalar: no
    # copy to the device)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt).item()


def _unembed_w(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["unembed"]["w"]


def _default_positions(cfg: ModelConfig, b: int, s: int, device):
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    if cfg.mrope:
        return pos[None].expand(3, b, s)
    return pos


def _given_positions(given, cfg: ModelConfig, b: int, s: int, device):
    """A batch's positions as int32 on ``device`` (a cast on the device, no
    host read): (B, S), or (3, B, S) for M-RoPE.  Returns them and their
    (B, S) mask row (M-RoPE's temporal section, as JAX's ``_pos2d``)."""
    want = [(b, s)] + ([(3, b, s)] if cfg.mrope else [])
    if tuple(given.shape) not in want:
        raise ValueError(f"positions of shape {tuple(given.shape)}"
                         f" for a batch of {b} x {s}; expected "
                         + " or ".join(str(w) for w in want))
    given = given.to(device=device, dtype=torch.int32)
    return given, given[0] if given.dim() == 3 else given


def _run_stacks(params, x, cfg: ModelConfig, mode: str, positions, caches,
                pos=None, enc_out=None, mask_pos=None, ctx=None):
    """Apply all decoder stacks, layer by layer, updating ``caches`` in
    place.  Returns x."""
    for si, (period, count) in enumerate(cfg.stacks()):
        sp = params[f"stack_{si}"]
        sc = caches[f"stack_{si}"]
        for i in range(count):
            pi = tree_map(lambda a: a[i], sp)
            ci = tree_map(lambda a: a[i], sc)
            for bi, kind in enumerate(period):
                key = f"b{bi}_{kind}"
                x, _, _ = apply_block(kind, pi[key], x, cfg=cfg, mode=mode,
                                      positions=positions, cache=ci[key],
                                      pos=pos, enc_out=enc_out,
                                      mask_pos=mask_pos, ctx=ctx)
    return x


# the leaves replicated on ``model`` (and whole on ``data``) that an
# ``attn`` block applies to this rank's heads (k_norm to the whole K where
# a KV head is split mid-head: only the rank's groups reach the loss) and
# an ``mlstm`` block to its heads' skip columns: their gradients are
# partial sums over ``model``, summed by the gathers' backward.  Not among
# them: the norms applied to the replicated residual (whole on every
# rank), and the leaves split on ``data`` and replicated on ``model`` --
# the MoE router, MLA's wq_a and wkv_a, mLSTM's w_if, the MLP and sLSTM
# leaves whose ``model`` axis ``param_pspecs`` dropped -- which the
# gathers never sum over ``model``: ``moe.py``, ``blocks.py`` and
# ``seqmix.py`` place their ``copy_to`` so that those gradients come out
# whole on every rank
TP_PARTIAL = ("q_norm", "k_norm", "skip_scale")


def _train_stack(sp, period, x, aux, cfg: ModelConfig, positions,
                 enc_out=None, ctx=None, shard=None, key=None):
    """One layer stack in train mode, no caches: each layer's body under
    the remat policy, its param slices passed in as arguments.  ``aux``
    carries the sum of the MoE blocks' auxiliary losses (None while no
    block has made one).  Returns (x, aux).

    In the sharded train step (``shard`` = (``Gatherer``, the stack's
    specs)) ``sp`` holds this rank's blocks, and the remat body gathers
    one layer's ``data`` blocks first: the gathered weights are freed
    after the layer and gathered again in the recomputation.  Trap:
    collectives under remat.  The recomputed forward runs its collectives
    again during the backward; every rank recomputes the same layers in
    the same order, or the ranks hang."""
    # each stacked leaf taken apart once; layer i's slices in
    # tree_leaves order
    layers = zip(*(torch.unbind(a, 0) for _, a in tree_leaves(sp)))

    def body(xc, auxc, positions, enc_out, *leaves):
        pi = tree_unflatten(sp, leaves)
        for bi, kind in enumerate(period):
            xc, _, a = apply_block(kind, pi[f"b{bi}_{kind}"], xc, cfg=cfg,
                                   mode="train", positions=positions,
                                   enc_out=enc_out, ctx=ctx)
            if a is not None:
                auxc = a if auxc is None else auxc + a
        return xc, auxc

    if shard is None:
        body = _remat(body, cfg)
        for leaves in layers:
            x, aux = body(x, aux, positions, enc_out, *leaves)
        return x, aux

    gatherer, specs = shard
    flat = list(tree_leaves(specs))
    lay = TP.layout([spec[1:] for _, spec in flat], gatherer.fsdp.axes,
                    [gatherer.tp.size > 1 and path.rsplit("/", 1)[-1] in
                     TP_PARTIAL for path, _ in flat])

    def sharded_body(i, xc, auxc, positions, enc_out, *blocks):
        return body(xc, auxc, positions, enc_out,
                    *gatherer.gather((key, i), blocks, lay))

    sharded_body = _remat(sharded_body, cfg)
    for i, blocks in enumerate(layers):
        x, aux = sharded_body(i, x, aux, positions, enc_out, *blocks)
    return x, aux


def _run_encoder(params, embeds, cfg: ModelConfig, mode: str = "prefill",
                 ctx=None, shard=None):
    """Whisper encoder over precomputed frame embeddings (the front end is
    a stub): learned positions, bidirectional blocks, final norm.  In the
    sharded train step ``shard`` is (``Gatherer``, the param specs)."""
    b, s, _ = embeds.shape
    x = embeds.to(getattr(torch, cfg.compute_dtype))
    x = x + params["pos_enc"]["w"][:s].to(x.dtype)[None]
    positions = _default_positions(cfg, b, s, x.device)
    sp = params["enc_stack_0"]
    if mode == "train":
        x, _ = _train_stack(sp, ("enc",), x, None, cfg, positions, ctx=ctx,
                            shard=shard and (shard[0],
                                             shard[1]["enc_stack_0"]),
                            key="enc_stack_0")
    else:
        for i in range(cfg.enc_layers):
            pi = tree_map(lambda a: a[i], sp)
            x, _, _ = apply_block("enc", pi["b0_enc"], x, cfg=cfg,
                                  mode=mode, positions=positions)
    return L.norm(params["enc_final_norm"], x, cfg)


def _pos_dec(params, idx):
    """Whisper's learned decoder positions at ``idx``, clamped to the
    table as in JAX (a gather on the device)."""
    w = params["pos_dec"]["w"]
    return w[torch.clamp(idx, max=w.shape[0] - 1).long()]


def _decoder_input(params, batch, cfg: ModelConfig, mode: str, ctx=None,
                   shard=None):
    """The first hidden state, its (B, S) and the encoder's output (audio
    only): decoder tokens plus learned positions and the encoder over the
    frames (audio), given embeddings (vlm), else embedded tokens.  ``ctx``
    and ``shard``: the sharded train step's (``_train_shard``)."""
    enc_out = None
    if cfg.family == "audio":
        enc_out = _run_encoder(params, batch["embeds"], cfg, mode, ctx,
                               shard)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg, ctx)
        idx = torch.arange(s, device=x.device)
        x = x + _pos_dec(params, idx).to(x.dtype)[None]
    elif "embeds" in batch:
        x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
        b, s = x.shape[0], x.shape[1]
    else:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg, ctx)
    return x, b, s, enc_out


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def _train_shard(params, cfg: ModelConfig, ctx):
    """The sharded train step's pieces for an enabled ``ctx``: its checks
    (``_check_ctx``, before any collective), the ``Gatherer`` of the
    current mesh, the param specs, and ``params`` with the top-level
    leaves (the embeddings, the final norms, whisper's positions) gathered
    over ``data``; the stacks stay blocks, gathered a layer at a time.
    (None, params) for ``ctx=None`` or a disabled ctx."""
    if ctx is None or not ctx.enabled:
        return None, params
    _check_ctx(cfg, ctx, train=True)
    g = TP.Gatherer(TP.line(ctx, "fsdp"), TP.line(ctx, "dp"),
                    TP.line(ctx, "tp"))
    specs = param_pspecs(cfg, ctx, mesh=g.fsdp.mesh)
    top = {k: v for k, v in params.items() if "stack_" not in k}
    flat = list(tree_leaves({k: specs[k] for k in top}))
    got = g.gather("top", [a for _, a in tree_leaves(top)],
                   TP.layout([spec for _, spec in flat], g.fsdp.axes,
                             [False] * len(flat)))
    return (g, specs), dict(params, **tree_unflatten(top, got))


def _forward_train(params, batch, cfg: ModelConfig, ctx):
    """``forward_train``'s (x, aux) and the params it computed with (the
    top-level leaves gathered in the sharded train step)."""
    shard, params = _train_shard(params, cfg, ctx)
    x, b, s, enc_out = _decoder_input(params, batch, cfg, "train", ctx,
                                      shard)
    given = batch.get("positions")
    if given is None:
        positions = _default_positions(cfg, b, s, x.device)
    else:
        positions, _ = _given_positions(given, cfg, b, s, x.device)
    aux = None
    for si, (period, _) in enumerate(cfg.stacks()):
        key = f"stack_{si}"
        x, aux = _train_stack(params[key], period, x, aux, cfg, positions,
                              enc_out, ctx, shard and (shard[0],
                                                       shard[1][key]), key)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.norm(params["final_norm"], x, cfg)
    return x, aux, params


def forward_train(params, batch: Dict[str, Any], cfg: ModelConfig,
                  ctx=None):
    """Returns (final hidden (B,S,d), aux_loss f32 scalar): the batch's
    ``positions`` (or the default arange) drive rotary and the attention
    masks; the MoE blocks' auxiliary losses are summed in f32.

    With an enabled ``ctx`` (``launch/specs.py::make_shard_ctx`` of a
    train shape) under the current ``ModelMesh``: ``params`` are this
    rank's blocks by ``param_pspecs(cfg, ctx, mesh=mesh)``, the batch is
    its rows by ``batch_pspecs``, and the hidden state returned is those
    rows' (whole on the ``model`` line: Megatron-SP's split of the
    residual between blocks is not made, ROADMAP item 12.5e).  A
    collective of the whole grid."""
    x, aux, _ = _forward_train(params, batch, cfg, ctx)
    return x, aux


def _ce_chunk(xc, w_un, lc):
    """(sum of token losses, count of labelled tokens) over one chunk, in
    f32; a label < 0 masks its token."""
    logits = (xc @ w_un.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(lc, min=0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _ce_chunk_tp(xc, w_un, lc, tp):
    """``_ce_chunk`` with ``w_un`` this rank's columns of the vocabulary
    (block ``tp.coord`` of the ``model`` line): the max over the line
    (without gradient: the log-sum-exp does not depend on it), the sum of
    exponentials and the gold logit (from the rank holding the label, 0
    elsewhere) summed over it in one all-reduce."""
    logits = (xc @ w_un.to(xc.dtype)).float()
    cols = logits.shape[-1]
    m = tp.max(logits.detach().amax(-1))
    local = lc.long() - tp.coord * cols
    hit = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1,
                        torch.clamp(local, 0, cols - 1)[..., None])[..., 0]
    sums = tp.reduce_from(torch.stack(
        [torch.exp(logits - m[..., None]).sum(-1),
         torch.where(hit, gold, 0.0)], -1))
    valid = (lc >= 0).float()
    lse = torch.log(sums[..., 0]) + m
    return ((lse - sums[..., 1]) * valid).sum(), valid.sum()


def ce_loss_chunked(x, w_un, labels, tokens_per_chunk: int = 65536,
                    ctx=None):
    """Mean cross entropy without materializing the full (B, S, V) logits.

    Chunks along the sequence, as JAX does: c = max(1, min(S, tokens //
    B)), decreased until it divides S.  With two or more chunks each is
    recomputed in backward (``torch.utils.checkpoint``) instead of saving
    its (B, c, V) f32 logits.

    With an enabled ``ctx``, ``x`` is this rank's rows (whole on the
    ``model`` line), ``w_un`` this rank's columns of the vocabulary and
    ``labels`` its rows: the logits are the rank's columns, the cross
    entropy is vocabulary-parallel (``_ce_chunk_tp``), and the chunks are
    cut by the rank's B (only the order of the sums changes).  Trap: the
    mean of the loss.  It is the summed token loss over the GLOBAL count
    of labelled tokens: the rank's sum and count are summed over the
    ``dp`` line by an all-reduce whose backward is the identity, so each
    rank differentiates its own sum over the global count (dividing by a
    rank's own count and averaging differs wherever the ranks hold other
    counts of labels)."""
    b, s, _ = x.shape
    c = max(1, min(s, tokens_per_chunk // b))
    while s % c:
        c -= 1
    nc = s // c
    chunk, dp = _ce_chunk, None
    if ctx is not None and ctx.enabled:
        tp, dp = TP.line(ctx, "tp"), TP.line(ctx, "dp")
        x = tp.copy_to(x)
        chunk = functools.partial(_ce_chunk_tp, tp=tp)
    if nc == 1:
        num, den = chunk(x, w_un, labels)
    else:
        parts = [ckpt.checkpoint(chunk, x[:, i * c:(i + 1) * c], w_un,
                                 labels[:, i * c:(i + 1) * c],
                                 use_reentrant=False)
                 for i in range(nc)]
        num = sum(p[0] for p in parts)
        den = sum(p[1] for p in parts)
    if dp is not None:
        num, den = dp.reduce_from(torch.stack([num, den]))
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, batch, cfg: ModelConfig, ctx=None):
    """Returns (ce + aux, {"ce": ce, "aux": aux}), device tensors.  With an
    enabled ``ctx`` (``forward_train``'s) the values are the whole
    batch's on every rank, and their gradient on a rank is its part: the
    gradients its rows give its blocks (``models/tp.py`` sums them)."""
    x, aux, params = _forward_train(params, batch, cfg, ctx)
    loss = ce_loss_chunked(x, _unembed_w(params, cfg), batch["labels"],
                           ctx=ctx)
    return loss + aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

# the block kinds with tensor-parallel compute in the sharded train step
TP_KINDS = {"attn", "moe", "mlstm", "slstm", "rglru"}


def _check_ctx(cfg: ModelConfig, ctx, train: bool = False) -> None:
    """An enabled ``ctx`` needs the current mesh (``require_mesh`` raises
    without one or with one of other axes or another group).  Serving:
    MLA and the ``ssm`` family never take the sequence split (JAX's
    ``make_shard_ctx`` never gives it them).  Training (``train``): the
    sharded step has tensor-parallel compute for the ``TP_KINDS``, MLA
    included, on query heads, KV width (a KV head may split mid-head),
    mLSTM heads, RG-LRU width, expert width (or the experts, where
    ``expert_parallel`` splits them), the dense residual's width and
    vocabulary that the ``model`` line divides; an MLP or sLSTM width
    that it does not divide is whole on ``model`` (``param_pspecs`` drops
    the axis, as JAX does) and runs whole.  It has no ``pod`` axis (ZeRO's
    optimizer blocks over it differ from the params').  What it lacks
    (ROADMAP item 12.5e) raises ``NotImplementedError`` here, from the
    config and the grid alone: before any collective, on every rank."""
    if ctx is None or not ctx.enabled:
        return
    from repro_torch.launch.meshctx import require_mesh
    mesh = require_mesh(ctx)
    if not train:
        if ctx.seq_shard_cache and (cfg.mla or cfg.family == "ssm"):
            raise ValueError(f"{cfg.name}: a sequence-sharded cache is for "
                             "standard attention; MLA and the ssm family "
                             "keep whole caches")
        return
    missing = []
    if ctx.pod_axis:
        missing.append("a pod axis")
    n = mesh.axis_size(ctx.tp())
    if n > 1:
        kinds = {k for period, _ in cfg.stacks() for k in period}
        if cfg.family == "audio":
            kinds.add("enc")
        if kinds - TP_KINDS:
            missing.append(f"the {sorted(kinds - TP_KINDS)} block kinds")
        dims = [("vocabulary", cfg.vocab)]
        if kinds & {"attn", "moe"}:
            dims.append(("query heads", cfg.n_heads))
            if not cfg.mla:
                dims.append(("KV width", cfg.kv_dim))
        if "mlstm" in kinds:
            dims.append(("mLSTM heads", cfg.n_heads))
        if "rglru" in kinds:
            dims.append(("RG-LRU width", cfg.lru_dim or cfg.d_model))
        if "moe" in kinds:
            dims.append(("experts", cfg.n_experts) if expert_parallel(cfg)
                        else ("expert width", cfg.d_ff))
            if cfg.moe_dense_ff:
                dims.append(("dense residual width", cfg.moe_dense_ff))
        for what, dim in dims:
            if dim % n:
                missing.append(f"{dim} {what} over {n} model ranks")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the sharded train step lacks tensor-parallel "
            f"compute for {'; '.join(missing)} (ROADMAP item 12.5e)")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda", ctx=None) -> Dict[str, Any]:
    """Zero caches for ``batch`` rows of ``max_seq`` tokens.  With an
    enabled ``ctx`` the rank allocates only its block of each leaf, by
    ``launch/specs.py::cache_specs`` on the current mesh."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    if ctx is not None and ctx.enabled:
        return _init_cache_part(cfg, batch, max_seq, dtype, device, ctx)
    caches: Dict[str, Any] = {}
    for si, (period, count) in enumerate(cfg.stacks()):
        one = {f"b{bi}_{kind}": init_block_cache(kind, cfg, batch, max_seq,
                                                 dtype, device)
               for bi, kind in enumerate(period)}
        caches[f"stack_{si}"] = tree_map(
            lambda a: torch.zeros((count,) + tuple(a.shape), dtype=a.dtype,
                                  device=a.device), one)
    caches["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches


def _init_cache_part(cfg, batch, max_seq, dtype, device, ctx):
    """This rank's block of every leaf of ``init_cache(cfg, batch,
    max_seq)``, a recurrent state split over its width included (the
    blocks gather it whole for a decode step).  Raises where the
    ``model`` axis cannot make a sequence split (JAX's ``shard_map``
    refuses it)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.meshctx import require_mesh
    from repro_torch.launch.specs import cache_specs, local_shape
    _check_ctx(cfg, ctx)
    mesh = require_mesh(ctx)
    whole = init_cache(cfg, batch, max_seq, dtype, device="meta")
    specs = cache_specs(cfg, ShapeConfig("cache", max_seq, batch, "decode"),
                        ctx, mesh)
    tp, n = ctx.tp(), mesh.axis_size(ctx.tp())

    def part(leaf, spec, name):
        if isinstance(leaf, dict):
            return {key: part(leaf[key], spec[key], key) for key in leaf}
        if n > 1 and name in ("k", "v") and ctx.seq_shard_cache \
                and spec[2] != tp:
            raise ValueError(f"{cfg.name}: a cache of {leaf.shape[2]} "
                             f"slots does not split over {n} ranks")
        return torch.zeros(local_shape(tuple(leaf.shape), spec, mesh),
                           dtype=leaf.dtype, device=device)

    return part(whole, specs, None)


def prefill(params, batch, caches, cfg: ModelConfig, ctx=None):
    """Run the prompt through the model, filling caches in place.
    Returns (caches, logits of the last position (B, V) f32).  An audio
    batch holds ``embeds`` (the encoder's frames) and ``tokens``; a vlm
    batch ``embeds`` or ``tokens``; any batch may hold ``positions``, which
    then mask attention by position (else by index).  With an enabled
    ``ctx``, the batch and the caches are this rank's parts."""
    _check_ctx(cfg, ctx)
    x, b, s, enc_out = _decoder_input(params, batch, cfg, "prefill")
    given = batch.get("positions")
    if given is None:
        positions = _default_positions(cfg, b, s, x.device)
        mask_pos = None
    else:
        positions, mask_pos = _given_positions(given, cfg, b, s, x.device)
    x = _run_stacks(params, x, cfg, "prefill", positions, caches,
                    enc_out=enc_out, mask_pos=mask_pos, ctx=ctx)
    caches["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, -1] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits


def decode_step(params, caches, tokens, cfg: ModelConfig, ctx=None):
    """One decode step.  tokens (B,1) i32.  Returns (caches, logits (B,V)),
    the caches updated in place.  With an enabled ``ctx``, the tokens and
    the caches are this rank's parts (a collective over the ``model`` axis
    with ``seq_shard_cache``: every rank of it calls this together)."""
    _check_ctx(cfg, ctx)
    pos = caches["pos"]
    x = _embed(params, tokens, cfg)
    if cfg.family == "audio":
        x = x + _pos_dec(params, pos).to(x.dtype)[:, None]
    x = _run_stacks(params, x, cfg, "decode", None, caches, pos=pos, ctx=ctx)
    caches["pos"] = pos + 1
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, 0] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits
