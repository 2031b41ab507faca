"""Parameter definitions and initialization (a port of
``repro.models.params``: every block kind, the audio family's encoder
stack and learned positions included).

``param_defs(cfg)`` builds a tree of ``PD`` (shape, per-dim sharding
roles, init); ``init_params`` materializes it on a device and
``param_pspecs`` resolves the roles into a partition spec a leaf (a plain
tuple with one entry a dim, ``models/sharding.py``) on a ``ShardCtx``.
Stacked layer params carry a leading 'stack' dim, as in the JAX package,
so a JAX parameter tree converts by a plain copy
(``repro_torch.models.convert``).  On a (data, model) grid of ranks each
rank holds its block of every leaf by those specs
(``launch/specs.py::put``; ``train/steps.py::shard_train_state``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import ShardCtx, matrix_spec

# ROADMAP queue A, item 12 (model stack): the block kinds whose
# parameters, caches and mixers are not ported yet (none: every kind
# serves and trains)
NOT_PORTED: Dict[str, str] = {}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A, item 12: model stack)")


class PD(NamedTuple):
    shape: Tuple[int, ...]
    roles: Tuple[Optional[str], ...]   # 'fsdp' | 'tp' | 'ep' | None per dim
    init: str = "normal"               # normal | zeros | ones
    scale_dim: int = -2                # fan-in dim index for init scale


def _attn_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, PD]:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    defs: Dict[str, PD] = {}
    if cfg.mla and not cross:
        r, rq, rd = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_dim
        defs["wq_a"] = PD((d, rq), ("fsdp", None))
        defs["wq_b"] = PD((rq, cfg.n_heads * (hd + rd)), (None, "tp"))
        defs["wkv_a"] = PD((d, r + rd), ("fsdp", None))
        defs["wk_b"] = PD((r, cfg.n_heads * hd), (None, "tp"))
        defs["wv_b"] = PD((r, cfg.n_heads * hd), (None, "tp"))
        defs["wo"] = PD((cfg.n_heads * hd, d), ("tp", "fsdp"))
    else:
        defs["wq"] = PD((d, qd), ("fsdp", "tp"))
        defs["wk"] = PD((d, kvd), ("fsdp", "tp"))
        defs["wv"] = PD((d, kvd), ("fsdp", "tp"))
        defs["wo"] = PD((qd, d), ("tp", "fsdp"))
        if cfg.qkv_bias:
            defs["bq"] = PD((qd,), ("tp",), "zeros")
            defs["bk"] = PD((kvd,), ("tp",), "zeros")
            defs["bv"] = PD((kvd,), ("tp",), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = PD((hd,), (None,), "ones")
        defs["k_norm"] = PD((hd,), (None,), "ones")
    return defs


def _mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None
              ) -> Dict[str, PD]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": PD((d, f), ("fsdp", "tp")),
        "wg": PD((d, f), ("fsdp", "tp")),
        "wo": PD((f, d), ("tp", "fsdp")),
    }


def expert_parallel(cfg: ModelConfig) -> bool:
    """Whether the experts split over ``model`` (the ``ep`` role: each rank
    holds whole experts) rather than their width (``tp``)."""
    return cfg.n_experts % 16 == 0


def _moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    ep = expert_parallel(cfg)  # when the expert count shards cleanly
    er = "ep" if ep else None
    inner = "fsdp" if ep else "fsdp"
    tpf = None if ep else "tp"
    defs: Dict[str, Any] = {
        "router": PD((d, e), ("fsdp", None)),
        "wi": PD((e, d, f), (er, inner, tpf)),
        "wg": PD((e, d, f), (er, inner, tpf)),
        "wo": PD((e, f, d), (er, tpf, inner)),
    }
    if cfg.moe_dense_ff:
        defs["dense"] = _mlp_defs(cfg, cfg.moe_dense_ff)
    return defs


def _norm_def(cfg: ModelConfig) -> Dict[str, PD]:
    out = {"scale": PD((cfg.d_model,), (None,), "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = PD((cfg.d_model,), (None,), "zeros")
    return out


def _mlstm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    inner = h * hd
    return {
        "w_up": PD((d, 2 * inner), ("fsdp", "tp")),
        "wq": PD((inner, inner), ("fsdp", "tp")),
        "wk": PD((inner, inner), ("fsdp", "tp")),
        "wv": PD((inner, inner), ("fsdp", "tp")),
        "w_if": PD((inner, 2 * h), ("fsdp", None)),   # input/forget gates
        "w_down": PD((inner, d), ("tp", "fsdp")),
        "skip_scale": PD((inner,), (None,), "ones"),
    }


def slstm_width(cfg: ModelConfig) -> int:
    """The width of sLSTM's output MLP and of its block's MLP (1365 at
    xlstm-350m's d_model 1024: ``param_pspecs`` keeps it whole on a
    ``model`` axis of 2)."""
    return (4 * cfg.d_model) // 3


def _slstm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    up = slstm_width(cfg)
    # 4 gates (i, f, z, o) from the input and the recurrent hidden state
    return {
        "w_x": PD((d, 4 * d), ("fsdp", "tp")),
        "w_h": PD((d, 4 * d), ("fsdp", "tp")),
        "w_up": PD((d, up), ("fsdp", "tp")),
        "w_gate": PD((d, up), ("fsdp", "tp")),
        "w_down": PD((up, d), ("tp", "fsdp")),
    }


def _rglru_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    r = cfg.lru_dim or d
    return {
        "w_x": PD((d, r), ("fsdp", "tp")),
        "w_gate": PD((d, r), ("fsdp", "tp")),
        "conv_w": PD((cfg.conv_width, r), (None, "tp")),
        "conv_b": PD((r,), ("tp",), "zeros"),
        "a_param": PD((r,), ("tp",), "ones"),    # recurrence decay logits
        "w_in_gate": PD((r, r), ("fsdp", "tp")),
        "w_down": PD((r, d), ("tp", "fsdp")),
    }


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """Parameter defs for one block of the given kind (pre-norm residual)."""
    if kind in ("attn", "enc"):
        return {"ln1": _norm_def(cfg), "attn": _attn_defs(cfg),
                "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}
    if kind == "moe":
        return {"ln1": _norm_def(cfg), "attn": _attn_defs(cfg),
                "ln2": _norm_def(cfg), "moe": _moe_defs(cfg)}
    if kind == "dec":                      # whisper decoder block
        return {"ln1": _norm_def(cfg), "attn": _attn_defs(cfg),
                "lnx": _norm_def(cfg), "xattn": _attn_defs(cfg, cross=True),
                "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}
    if kind == "mlstm":
        return {"ln1": _norm_def(cfg), "mix": _mlstm_defs(cfg)}
    if kind == "slstm":
        return {"ln1": _norm_def(cfg), "mix": _slstm_defs(cfg),
                "ln2": _norm_def(cfg),
                "mlp": _mlp_defs(cfg, slstm_width(cfg))}
    if kind == "rglru":
        return {"ln1": _norm_def(cfg), "mix": _rglru_defs(cfg),
                "ln2": _norm_def(cfg), "mlp": _mlp_defs(cfg)}
    if kind in NOT_PORTED:
        raise not_ported(f"block kind {kind!r} ({NOT_PORTED[kind]})")
    raise ValueError(f"unknown block kind {kind}")


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "embed": {"w": PD((cfg.vocab, cfg.d_model), ("tp", "fsdp"))},
        "final_norm": _norm_def(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = {"w": PD((cfg.d_model, cfg.vocab), ("fsdp", "tp"))}
    if cfg.family == "audio":
        # learned positional embeddings (whisper); the conv front end is a
        # stub: the caller passes frame embeddings
        defs["pos_dec"] = {"w": PD((4096, cfg.d_model), (None, "fsdp"))}
        defs["pos_enc"] = {"w": PD((cfg.enc_seq, cfg.d_model),
                                   (None, "fsdp"))}
        defs["enc_final_norm"] = _norm_def(cfg)
        defs["enc_stack_0"] = _stack(cfg, ("enc",), cfg.enc_layers)
    for si, (period, count) in enumerate(cfg.stacks()):
        defs[f"stack_{si}"] = _stack(cfg, period, count)
    return defs


def _stack(cfg: ModelConfig, period: Tuple[str, ...], count: int):
    body = {f"b{i}_{kind}": block_defs(cfg, kind)
            for i, kind in enumerate(period)}
    return tree_map(lambda pd: PD((count,) + pd.shape, (None,) + pd.roles,
                                  pd.init, pd.scale_dim), body)


# ---------------------------------------------------------------------------
# Trees of dicts (the JAX package's pytrees)
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in tree}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order, the order of JAX's
    ``tree.flatten`` over dicts."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], f"{prefix}/{key}" if prefix
                                   else key)
    else:
        yield prefix, tree


def tree_unflatten(tree, leaves):
    """``tree``'s structure (nested dicts) holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), _sorted(tree))


def _sorted(tree):
    if isinstance(tree, dict):
        return {key: _sorted(tree[key]) for key in sorted(tree)}
    return tree


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random parameters on ``device``: normal / sqrt(fan-in) for weights,
    ones and zeros for scales and biases, as in the JAX package (the values
    differ: one ``torch.Generator`` seeded with ``seed`` replaces JAX's
    split keys).

    Each leaf is allocated once in the parameter dtype and filled one
    layer at a time through an f32 draw of one layer's size, so no stacked
    leaf ever exists in f32 (qwen3-32b's stacked ``mlp/wi`` alone would be
    33.5 GB in f32)."""
    dev = torch.device(device)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def mk(pd: PD):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        fan_in = pd.shape[pd.scale_dim] if len(pd.shape) > 1 else pd.shape[0]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(pd.shape, dtype=dtype, device=dev)
        rows = out.reshape(-1, *pd.shape[-2:]) if len(pd.shape) > 2 \
            else out[None]
        for layer in rows:
            layer.copy_(torch.randn(layer.shape, generator=gen, device=dev,
                                    dtype=torch.float32).mul_(scale))
        return out

    return tree_map(mk, param_defs(cfg))


def param_pspecs(cfg: ModelConfig, ctx: ShardCtx, opt: bool = False,
                 mesh=None):
    """A spec tree of ``param_defs(cfg)``'s structure; ``opt=True`` maps
    fsdp -> fsdp_opt (ZeRO over the pod axis).  With ``mesh`` (a
    ``ModelMesh``, or any object with a ``shape`` dict), an axis whose
    ranks do not divide the dim is dropped, as JAX drops it (pjit rejects
    uneven input shardings)."""
    def size(axes) -> int:
        if axes is None or mesh is None:
            return 1
        n = 1
        for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
            n *= mesh.shape[a]
        return n

    def spec(pd: PD) -> tuple:
        roles = tuple("fsdp_opt" if (opt and r == "fsdp") else r
                      for r in pd.roles)
        raw = matrix_spec(ctx, roles)
        if mesh is None:
            return raw
        return tuple(a if dim % size(a) == 0 else None
                     for a, dim in zip(raw, pd.shape))

    return tree_map(spec, param_defs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(int(math.prod(pd.shape))
               for _, pd in tree_leaves(param_defs(cfg)))
