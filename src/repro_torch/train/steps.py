"""Serve step builders (a port of ``make_serve_steps`` of
``repro.train.steps``; the train step waits for the training slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_serve_steps(cfg: ModelConfig):
    def prefill_step(params, batch, caches):
        return M.prefill(params, batch, caches, cfg)

    def decode_serve_step(params, caches, tokens):
        caches, logits = M.decode_step(params, caches, tokens, cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return caches, next_tok, logits

    return prefill_step, decode_serve_step
