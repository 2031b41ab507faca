"""Serving entry point (a port of the single-wave path of
``repro.launch.serve``): batched prefill + greedy decode with a durable
request registry (the paper's set as serving metadata).

Completed request ids are inserted into a SOFT ``DurableMap``; a crash
loses the volatile index but not the registry, so after recovery the
server knows exactly which requests had completed.  Each completion costs
one psync; recovery costs none.  Prefill attention runs the port's
``flash_prefill`` kernel and decode attention its ``gqa_decode`` kernel;
the registry (the probe backend by default, as in ``repro.launch.serve``)
runs ``hash_probe``'s probe-window kernel and, on ``--crash``,
``recovery_scan``.  ``--snapshot-every N`` snapshots the registry in the
background every N serving steps (``repro_torch.store.snapshot``); a crash
then recovers from the latest snapshot and the stamp delta, where the
backend supports it (bucket and scan), and from the full pool otherwise.
``--shards N`` (N > 1) swaps in the hash-partitioned ``ShardedDurableMap``
(``repro_torch.core.shard``) with its ``--router``, ``--placement`` and
``--max-lane-budget``; each shard's lookups and recovery run the same
kernels, once per shard.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b-smoke \\
      --requests 8 --prompt-len 32 --gen 16 [--crash] [--device cpu] \\
      [--snapshot-every 1 [--snapshot-dir DIR]] [--shards 8 [--router v1]
      [--placement strided] [--max-lane-budget L]]

It runs on the GPU unless given ``--device cpu``.  ``run`` is the same path
for a caller that holds a config object.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import DurableMap, SetSpec, ShardedDurableMap
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry
from repro_torch.store.snapshot import SnapshotPolicy, Snapshotter
from repro_torch.train import steps as TS

# Options of repro.launch.serve that wait for their slices.  ``--pipeline``
# raises only above 1: depth 1 is the single wave served here.
NOT_PORTED = {
    "--queue": "ROADMAP queue A, item 8 (durable queue)",
    "--queue-capacity": "ROADMAP queue A, item 8 (durable queue)",
    "--pipeline": "ROADMAP queue A, item 11 (pipelined serving waves)",
    "--autosplit": "ROADMAP queue A, item 10 (online resize)",
    "--open-loop": "ROADMAP queue A, item 11 (bench_serve)",
}


# Node-pool size of the completion registry, as in repro.launch.serve.
REGISTRY_CAPACITY = 1024


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ModelConfig, requests: int = 8, prompt_len: int = 32,
        gen: int = 16, crash: bool = False, backend: str = "probe",
        device="cuda", params=None, snapshot_every: int = 0,
        snapshot_dir: Optional[str] = None, shards: int = 1,
        router: str = "v2", placement: str = "contiguous",
        max_lane_budget: int = 0) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` tokens for ``gen``
    tokens each, record the completions in the registry, and with
    ``crash`` crash and recover it.  ``params`` defaults to
    ``init_params(cfg, seed=0)``.  ``snapshot_every`` > 0 snapshots the
    registry every that many serving steps into ``snapshot_dir`` (a fresh
    temporary directory by default), and the crash recovers through the
    snapshotter.  ``shards`` > 1 makes the registry a ``ShardedDurableMap``
    with that router, placement and lane cap.  Returns the generated
    tokens, the registry's counts and the timings (the device synchronized
    around prefill and around the decode loop)."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    prefill_step, decode_step = TS.make_serve_steps(cfg)

    m = MetricsRegistry()     # one snapshot() reaches every structure
    spec = SetSpec(capacity=REGISTRY_CAPACITY, mode="soft", backend=backend)
    if shards > 1:            # same facade API, hash-partitioned runtime
        registry = ShardedDurableMap(spec, n_shards=shards, router=router,
                                     placement=placement,
                                     max_lane_budget=max_lane_budget,
                                     metrics=m, metrics_name="registry",
                                     device=dev)
        budgets = registry.precompile(requests)
        if budgets:
            print(f"registry router v2: pre-compiled lane budgets "
                  f"{budgets} ({placement} placement)")
    else:
        registry = DurableMap(spec, metrics=m, metrics_name="registry",
                              device=dev)
    # background snapshots: the capture is a host copy of already-durable
    # planes at the dispatch boundary, the build and save run off the hot
    # path, so the serving loop's psync bill is unchanged
    snapshotter = None
    if snapshot_every > 0:
        base = snapshot_dir or tempfile.mkdtemp(prefix="serve_snap_")
        snapshotter = Snapshotter(registry, os.path.join(base, "registry"),
                                  SnapshotPolicy(every_steps=snapshot_every))
        print(f"snapshotter: every {snapshot_every} step(s) -> {base}")
    b = requests
    req_ids = np.arange(1000, 1000 + b, dtype=np.int32)
    max_seq = prompt_len + gen
    rng = np.random.default_rng(0)
    all_toks = rng.integers(0, cfg.vocab, (b, prompt_len))

    t0 = time.time()
    caches = M.init_cache(cfg, b, max_seq, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    caches, logits = prefill_step(
        params, {"tokens": torch.as_tensor(all_toks, dtype=torch.int32,
                                           device=dev)}, caches)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _sync(dev)
    t2 = time.perf_counter()
    out = [nxt]
    for _ in range(gen - 1):
        caches, nxt, logits = decode_step(params, caches, nxt)
        out.append(nxt)
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    t3 = time.perf_counter()
    dt = time.time() - t0
    print(f"served {b} requests x {gen} tokens in {dt:.2f}s "
          f"({b * gen / dt:.1f} tok/s)")

    # durably record completions: one psync per request (SOFT bound)
    registry.insert(req_ids, tokens[:, -1])
    if snapshotter is not None:
        snapshotter.maybe_snapshot(1)     # the wave is serving step 1
    reg = m.snapshot()["collected"]["registry"]
    shard_tag = f" x{shards} shards" if shards > 1 else ""
    print(f"registry[{backend}{shard_tag}]: {reg['size']} completed, "
          f"psyncs={reg['psyncs']} (== #requests)")
    if shards > 1 and reg.get("last_route"):
        lr = reg["last_route"]
        print(f"router: lane_budget={lr['lane_budget']} "
              f"groups={lr['groups']} dropped={reg['router_dropped']}")
    result = {"tokens": tokens, "logits": logits, "params": params,
              "registered": reg["size"], "psyncs": reg["psyncs"],
              "seconds": dt, "tok_per_s": b * gen / dt,
              "prefill_ms": (t2 - t1) * 1e3,
              "decode_ms_per_step": (t3 - t2) * 1e3 / max(gen - 1, 1)}

    if crash:
        if snapshotter is None:
            registry.crash_and_recover()
        else:   # hybrid recovery where the backend supports it
            snapshotter.wait()    # the build commits, as it would live
            snapshotter.recover()
        done = registry.contains(req_ids)     # host array when sharded
        if isinstance(done, torch.Tensor):
            done = done.cpu().numpy()
        if not done.all():
            raise RuntimeError(f"registry lost {int((~done).sum())} of {b} "
                               "completions in crash and recovery")
        print(f"after crash+recovery: all {b} completions still registered")
        if snapshotter is not None:
            g = m.snapshot()["gauges"]
            print("hybrid recovery: "
                  f"{int(g['registry.last_recovery_from_delta_slots'])} "
                  "delta slot(s) re-scanned, "
                  f"{int(g['registry.last_recovery_from_snapshot_slots'])} "
                  "restored from the snapshot")
        reg = m.snapshot()["collected"]["registry"]
        result.update(registered_after_recovery=int(done.sum()),
                      recovery_psyncs=reg["recovery_psyncs"],
                      psyncs_after_recovery=reg["psyncs"])
    if snapshotter is not None:
        snapshotter.close()
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, item in NOT_PORTED.items():
        if flag == "--pipeline":
            continue                      # checked on its value below
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise NotImplementedError(f"{flag} is not ported yet ({item})")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b-smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--crash", action="store_true")
    ap.add_argument("--backend", default="probe",
                    choices=("probe", "scan", "bucket"),
                    help="registry index backend: probe = linear probing "
                         "(hash_probe's probe-window kernel), scan = full "
                         "traversal, bucket = set-associative buckets "
                         "(hash_probe's bucket kernel); every backend "
                         "recovers through recovery_scan")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the GPU)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="background-snapshot the registry every N serving "
                         "steps; --crash then recovers from the latest "
                         "snapshot + the stamp delta (bucket and scan "
                         "backends; probe falls back to the full-pool "
                         "scan).  0 disables")
    ap.add_argument("--snapshot-dir", default=None,
                    help="snapshot store directory (default: a fresh "
                         "temp dir)")
    ap.add_argument("--shards", type=int, default=1,
                    help="hash-partition the registry over N shards "
                         "(N > 1 = ShardedDurableMap; each shard's lookups "
                         "and recovery run the kernels)")
    ap.add_argument("--router", default="v2", choices=("v1", "v2"),
                    help="sharded registry router: v2 = two-stage with "
                         "adaptive lane budgets (default), v1 = "
                         "single-stage lane_factor router")
    ap.add_argument("--placement", default="contiguous",
                    choices=("contiguous", "strided"),
                    help="shard storage order across the router's groups "
                         "(v2)")
    ap.add_argument("--max-lane-budget", type=int, default=0,
                    help="cap the v2 adaptive lane budget (0 = uncapped; "
                         "a cap drops + counts over-budget lanes)")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="registry pipeline depth; only 1 (one wave) is "
                         "ported")
    args = ap.parse_args(argv)
    if args.pipeline < 1:
        ap.error("--pipeline must be >= 1")
    if args.pipeline > 1:
        raise NotImplementedError(
            f"--pipeline {args.pipeline} is not ported yet "
            f"({NOT_PORTED['--pipeline']})")
    run(get_config(args.arch), requests=args.requests,
        prompt_len=args.prompt_len, gen=args.gen, crash=args.crash,
        backend=args.backend, device=args.device,
        snapshot_every=args.snapshot_every, snapshot_dir=args.snapshot_dir,
        shards=args.shards, router=args.router, placement=args.placement,
        max_lane_budget=args.max_lane_budget)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
