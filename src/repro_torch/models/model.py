"""Top-level model for serving (a port of the serving half of
``repro.models.model``): embedding -> block stacks -> final norm -> logits
of the last position, with per-layer KV caches.

Layer params are stacked on a leading dim as in the JAX package; a Python
loop over that dim replaces ``lax.scan``, and each layer reads views of its
slices (no copies).  The KV caches are updated IN PLACE, one layer slice at
a time: ``prefill`` and ``decode_step`` return the same cache dict they
were given, where the JAX functions return new stacked caches (at
qwen3-32b's serving shape that saves a 1 GiB copy per step); the
recurrent blocks copy their new states into theirs.  The hybrid family's
embedding is scaled by sqrt(d_model), as in JAX.  Training
(``forward_train``, the loss) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import apply_block, init_block_cache
from repro_torch.models.params import (init_params, not_ported,  # noqa: F401
                                       param_count, tree_map)

__all__ = ["init_params", "param_count", "init_cache", "prefill",
           "decode_step"]


def _embed(params, tokens, cfg: ModelConfig):
    w = params["embed"]["w"]
    dt = getattr(torch, cfg.compute_dtype)
    x = w[tokens.long()].to(dt)
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
    if cfg.mrope:
        raise not_ported("M-RoPE (the vlm family)")
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _run_stacks(params, x, cfg: ModelConfig, mode: str, positions, caches,
                pos=None):
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
                x, _ = apply_block(kind, pi[key], x, cfg=cfg, mode=mode,
                                   positions=positions, cache=ci[key],
                                   pos=pos)
    return x


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    dtype = dtype or getattr(torch, cfg.compute_dtype)
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


def prefill(params, batch, caches, cfg: ModelConfig):
    """Run the prompt through the model, filling caches in place.
    Returns (caches, logits of the last position (B, V) f32).  Positions
    other than the default arange(S) raise (checking given positions costs
    one host synchronization)."""
    if cfg.family in ("audio", "vlm") or "embeds" in batch:
        raise not_ported(f"the {cfg.family} family's frontend")
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _default_positions(cfg, b, s, x.device)
    given = batch.get("positions")
    if given is not None and not torch.equal(given.to(positions),
                                             positions):
        # the flash_prefill kernel masks by sequence index
        raise NotImplementedError(
            "prefill takes only the default positions arange(S); other "
            "positions need the dense masked attention (ROADMAP queue A, "
            "item 12: model stack)")
    x = _run_stacks(params, x, cfg, "prefill", positions, caches)
    caches["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, -1] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits


def decode_step(params, caches, tokens, cfg: ModelConfig):
    """One decode step.  tokens (B,1) i32.  Returns (caches, logits (B,V)),
    the caches updated in place."""
    pos = caches["pos"]
    x = _embed(params, tokens, cfg)
    x = _run_stacks(params, x, cfg, "decode", None, caches, pos=pos)
    caches["pos"] = pos + 1
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, 0] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits
