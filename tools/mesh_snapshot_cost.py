#!/usr/bin/env python3
"""What one snapshot of a sharded map partitioned over ``gloo`` ranks
costs each rank, beside one process:

    PYTHONPATH=src python3 tools/mesh_snapshot_cost.py [--device cpu]

``chip_smoke.py`` phase 3c2's bucket map (8 shards of 2^18 slots, 2^19
keys prefilled in batches of 8192 from the key range 2^20) is built with
``use_shard_map=True`` in one process and in each of 4 ranks sharing the
card (``repro_torch.launch.mesh.spawn``), snapshotted once through a
``Snapshotter`` (``snapshot()``, then ``wait()``), driven by 10 mixed
batches of 1024 lanes and recovered through the snapshot.  For each
process: the ``recovery_scan`` launches of the snapshot (its build) and
of the recovery, the device memory that the snapshot added to the
process's peak (``reset_peak_memory_stats`` before ``snapshot()``, read
after ``wait()``), and the ms of ``snapshot()`` (the capture, on the
main thread), of ``wait()`` and of the recovery.

It imports ``repro_torch`` from ``PYTHONPATH``, so this script measures
another tree too (an older commit unpacked beside the checkout): run it
on both trees in one call, in turns.  The last line is one JSON object
with the tree's ``repro_torch`` path, the card's name and power limit and
every process's figures.  ``--device cpu`` rehearses it without a card
(its memory figures are then NaN and it launches no kernel).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

import repro_torch
from repro_torch.core.engine import (OP_CONTAINS, OP_INSERT, OP_REMOVE,
                                     SetSpec)
from repro_torch.core.shard import ShardedDurableMap
from repro_torch.kernels.recovery_scan.kernel import scan_cuda
from repro_torch.launch import mesh
from repro_torch.store.snapshot import Snapshotter

RANKS, SHARDS, SEED = 4, 8, 0
GEOMETRY = dict(capacity=1 << 21, key_range=1 << 20, prefill=1 << 19,
                prefill_batch=8192, batches=10, lanes=1024)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device, snap_dir, g):
    """One process's map (its rows in a group, all 8 shards without one):
    the prefill, one snapshot, the batches and recovery through it."""
    rng = np.random.default_rng([SEED, g["capacity"], 5])
    m = ShardedDurableMap(SetSpec(capacity=g["capacity"], backend="bucket"),
                          n_shards=SHARDS, device=device, use_shard_map=True)
    dev = m.device
    for k in rng.choice(g["key_range"], g["prefill"], replace=False).astype(
            np.int32).reshape(-1, g["prefill_batch"]):
        m.insert(k, k * 7 + 1)
    sn = Snapshotter(m, snap_dir)
    cuda = dev.type == "cuda"
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    scans = scan_cuda.launches
    t0 = time.perf_counter()
    sn.snapshot()
    t1 = time.perf_counter()
    step = sn.wait()
    t2 = time.perf_counter()
    out = {"rows": [m.rows.start, m.rows.stop], "step": step,
           "build_launches": scan_cuda.launches - scans,
           "peak_mib": ((torch.cuda.max_memory_allocated(dev) - base)
                        / 2 ** 20 if cuda else float("nan")),
           "capture_ms": 1e3 * (t1 - t0), "wait_ms": 1e3 * (t2 - t1)}
    n, b = g["batches"], g["lanes"]
    ops = rng.choice(np.array([OP_CONTAINS, OP_INSERT, OP_REMOVE], np.int32),
                     size=(n, b), p=[0.9, 0.05, 0.05])
    keys = rng.integers(0, g["key_range"], (n, b), dtype=np.int32)
    for i in range(n):
        m.apply(ops[i], keys[i], keys[i])
    u = np.random.default_rng([SEED, 7]).random(
        (SHARDS, g["capacity"] // SHARDS)).astype(np.float32)
    scans = scan_cuda.launches
    sync(dev)
    t0 = time.perf_counter()
    sn.recover(u)
    sync(dev)
    out["recover_ms"] = 1e3 * (time.perf_counter() - t0)
    out["recover_launches"] = scan_cuda.launches - scans
    out["len"] = len(m)
    sn.close()
    return out


def rank_run(rank, device, snap_dir, g):
    return run(device, snap_dir, g)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--capacity", type=int, default=GEOMETRY["capacity"])
    ap.add_argument("--prefill", type=int, default=GEOMETRY["prefill"])
    args = ap.parse_args(argv)
    g = dict(GEOMETRY, capacity=args.capacity, prefill=args.prefill,
             prefill_batch=min(GEOMETRY["prefill_batch"], args.prefill))
    card = "cpu"
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (pass --device cpu to rehearse)")
        from repro_torch.kernels import _build
        _build.build(["recovery_scan", "hash_probe"])
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="mesh_snapshot_cost_") as tmp:
        one = run(args.device, os.path.join(tmp, "one"), g)
        if args.device != "cpu":
            torch.cuda.empty_cache()
        ranks = mesh.spawn(rank_run, RANKS, args.device,
                           os.path.join(tmp, "mesh"), g)
    for label, x in [("one process", one)] + [
            (f"rank {r}", x) for r, x in enumerate(ranks)]:
        print(f"{label}: rows {x['rows']}, snapshot build launches "
              f"{x['build_launches']}, peak added {x['peak_mib']:.3f} MiB, "
              f"capture {x['capture_ms']:.3f} ms, wait {x['wait_ms']:.3f} "
              f"ms, recovery {x['recover_ms']:.3f} ms in "
              f"{x['recover_launches']} launches ({card})")
    if any(x["len"] != one["len"] for x in ranks):
        raise SystemExit("the ranks' maps disagree with one process's")
    print(json.dumps({"tree": os.path.dirname(repro_torch.__file__),
                      "card": card, "geometry": g, "one": one,
                      "ranks": ranks}))


if __name__ == "__main__":
    main()
