"""Training driver (a port of ``repro.launch.train``): data pipeline ->
train step -> SOFT durable checkpoints (async), with crash/restart
resumption.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b-smoke \
      --steps 50 --batch 4 --seq 64 --ckpt /tmp/ckpt [--crash-at 23] \
      [--device cpu]

The same flags, printed lines and return codes as the JAX driver, plus
``--device`` (default the GPU; without one it raises unless ``--device
cpu``).  A restart restores the last SOFT-committed checkpoint (one fsync
per commit) through the port's store, with the state as ``like``, and
the data pipeline reseeks so that no batch is replayed.  An async save
copies the state to the host before the next step updates it in place.
Loss and grad norm are read on the host only on the lines printed.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim import adamw
from repro_torch.store.checkpoint import CheckpointManager
from repro_torch.train import steps as TS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate a process kill after this step")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup=10,
                                total_steps=args.steps,
                                state_dtype=cfg.opt_dtype)
    state = TS.init_train_state(cfg, 0, opt_cfg, device=dev)
    step_fn = TS.make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=0)

    mgr = CheckpointManager(args.ckpt, keep=2) if args.ckpt else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(like=state)
        print(f"[restore] resumed from step {start} "
              f"(fsyncs so far: {mgr.fsyncs})")
    data.seek(start)

    t0 = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(iter(data)).items()}
        state, metrics = step_fn(state, batch)
        tokens_done += args.batch * args.seq
        if (step + 1) % 10 == 0 or step == start:
            dt = time.time() - t0
            print(f"step {step + 1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={tokens_done / max(dt, 1e-9):.0f}")
        if mgr is not None and (step + 1) % args.save_every == 0:
            mgr.save(step + 1, state, async_=True)
        if args.crash_at is not None and step + 1 == args.crash_at:
            print(f"[crash] simulated power failure at step {step + 1}; "
                  f"rerun the same command to resume")
            if mgr:
                mgr.close()
            return 1
    if mgr is not None:
        mgr.save(args.steps, state)
        print(f"[done] final checkpoint at step {args.steps}; "
              f"total fsyncs={mgr.fsyncs}")
        mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
