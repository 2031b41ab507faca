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
embedding is scaled by sqrt(d_model), as in JAX.

The front ends are the JAX package's stubs: a vlm batch may carry patch
embeddings (``embeds``, (B, S, d_model)) in place of tokens, and its
default positions are M-RoPE's (3, B, S) arange; an audio batch carries
frame embeddings (``embeds``, (B, enc_seq, d_model)) for the encoder and
decoder ``tokens``.  Positions given in the batch ((B, S), or (3, B, S)
for M-RoPE) go to rotary and, through ``flash_prefill``'s positions
operand, to the attention mask (M-RoPE's temporal row), as in JAX; without
them the mask is by sequence index.  Nothing reads them on the host.
Training (``forward_train``, the loss) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.blocks import apply_block, init_block_cache
from repro_torch.models.params import (init_params,  # noqa: F401
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
        raise ValueError(f"prefill: positions of shape {tuple(given.shape)}"
                         f" for a prompt of {b} x {s}; expected "
                         + " or ".join(str(w) for w in want))
    given = given.to(device=device, dtype=torch.int32)
    return given, given[0] if given.dim() == 3 else given


def _run_stacks(params, x, cfg: ModelConfig, mode: str, positions, caches,
                pos=None, enc_out=None, mask_pos=None):
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
                                   pos=pos, enc_out=enc_out,
                                   mask_pos=mask_pos)
    return x


def _run_encoder(params, embeds, cfg: ModelConfig):
    """Whisper encoder over precomputed frame embeddings (the front end is
    a stub): learned positions, bidirectional blocks, final norm."""
    b, s, _ = embeds.shape
    x = embeds.to(getattr(torch, cfg.compute_dtype))
    x = x + params["pos_enc"]["w"][:s].to(x.dtype)[None]
    positions = _default_positions(cfg, b, s, x.device)
    sp = params["enc_stack_0"]
    for i in range(cfg.enc_layers):
        pi = tree_map(lambda a: a[i], sp)
        x, _ = apply_block("enc", pi["b0_enc"], x, cfg=cfg, mode="prefill",
                           positions=positions)
    return L.norm(params["enc_final_norm"], x, cfg)


def _pos_dec(params, idx):
    """Whisper's learned decoder positions at ``idx``, clamped to the
    table as in JAX (a gather on the device)."""
    w = params["pos_dec"]["w"]
    return w[torch.clamp(idx, max=w.shape[0] - 1).long()]


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
    Returns (caches, logits of the last position (B, V) f32).  An audio
    batch holds ``embeds`` (the encoder's frames) and ``tokens``; a vlm
    batch ``embeds`` or ``tokens``; any batch may hold ``positions``, which
    then mask attention by position (else by index)."""
    enc_out = None
    if cfg.family == "audio":
        enc_out = _run_encoder(params, batch["embeds"], cfg)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
        idx = torch.arange(s, device=x.device)
        x = x + _pos_dec(params, idx).to(x.dtype)[None]
    elif "embeds" in batch:
        x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
        b, s = x.shape[0], x.shape[1]
    else:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed(params, tokens, cfg)
    given = batch.get("positions")
    if given is None:
        positions = _default_positions(cfg, b, s, x.device)
        mask_pos = None
    else:
        positions, mask_pos = _given_positions(given, cfg, b, s, x.device)
    x = _run_stacks(params, x, cfg, "prefill", positions, caches,
                    enc_out=enc_out, mask_pos=mask_pos)
    caches["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, -1] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits


def decode_step(params, caches, tokens, cfg: ModelConfig):
    """One decode step.  tokens (B,1) i32.  Returns (caches, logits (B,V)),
    the caches updated in place."""
    pos = caches["pos"]
    x = _embed(params, tokens, cfg)
    if cfg.family == "audio":
        x = x + _pos_dec(params, pos).to(x.dtype)[:, None]
    x = _run_stacks(params, x, cfg, "decode", None, caches, pos=pos)
    caches["pos"] = pos + 1
    x = L.norm(params["final_norm"], x, cfg)
    logits = (x[:, 0] @ _unembed_w(params, cfg).to(x.dtype)).float()
    return caches, logits
