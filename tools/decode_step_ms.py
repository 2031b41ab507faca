#!/usr/bin/env python3
"""Milliseconds a one-card decode step of the serving path, for the tree on
``PYTHONPATH``:

    PYTHONPATH=src python3 tools/decode_step_ms.py [--arch qwen3-32b]
        [--layers 64] [--batch 8] [--prompt 512] [--steps 16]
        [--device cuda]

Random bf16 weights from seed 0 (``init_params``), a prefill of ``batch``
rows of ``prompt`` zero tokens through ``make_serve_steps(cfg)`` (no mesh),
then ``steps`` greedy decode steps, each synchronized and timed on the
host; ``gqa_decode``'s launches over them.  It imports ``repro_torch``
from ``PYTHONPATH``, so it measures another tree too (an older commit
unpacked beside the checkout): run it on both trees in one call, in
turns.  The last line is one JSON object with the tree's ``repro_torch``
path, the card's name and power limit, each step's ms and their median.
``--device cpu --arch qwen3-32b-smoke`` rehearses it without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import repro_torch
from repro_torch.configs.base import get_config
from repro_torch.kernels.gqa_decode.kernel import gqa_decode_cuda
from repro_torch.models import model as M
from repro_torch.train import steps as TS


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to rehearse")
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.splitlines()[0]
    cfg = get_config(args.arch).with_layers(args.layers)
    params = M.init_params(cfg, seed=0, device=dev)
    prefill, decode = TS.make_serve_steps(cfg)
    cache = M.init_cache(cfg, args.batch, args.prompt + args.steps + 1,
                         device=dev)
    tok = torch.zeros((args.batch, args.prompt), dtype=torch.int32,
                      device=dev)
    cache, logits = prefill(params, {"tokens": tok}, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    gqa_decode_cuda.launches = 0
    ms = []
    for _ in range(args.steps):
        sync(dev)
        t0 = time.perf_counter()
        cache, nxt, _ = decode(params, cache, nxt)
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    out = dict(tree=repro_torch.__file__, card=card, arch=args.arch,
               layers=args.layers, batch=args.batch, prompt=args.prompt,
               ms=ms, median_ms=float(np.median(ms)),
               gqa_decode_launches=gqa_decode_cuda.launches)
    print(f"{args.arch} ({args.layers} layers), B {args.batch}, prompt "
          f"{args.prompt}: median {out['median_ms']:.3f} ms a decode step "
          f"over {args.steps}, gqa_decode {out['gqa_decode_launches']} "
          f"launches ({card}; {out['tree']})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
