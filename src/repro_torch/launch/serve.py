"""Serving entry point (a port of ``repro.launch.serve``): batched prefill
+ greedy decode with a durable request registry (the paper's set as
serving metadata).

Completed request ids are inserted into a SOFT ``DurableMap``; a crash
loses the volatile index but not the registry, so after recovery the
server knows exactly which requests had completed.  Each completion costs
one psync; recovery costs none.  Prefill attention runs the port's
``flash_prefill`` kernel and decode attention its ``gqa_decode`` kernel;
the registry (the probe backend by default, as in ``repro.launch.serve``)
runs ``hash_probe``'s probe-window kernel and, on ``--crash``,
``recovery_scan``.  ``--snapshot-every N`` snapshots the registry (and,
with ``--queue``, the spine queues) in the background every N serving
steps (``repro_torch.store.snapshot``); a crash then recovers from the
latest snapshot and the stamp delta, where the structure supports it
(bucket and scan registries, the queues), and from the full pool
otherwise.  ``--shards N`` (N > 1) swaps in the hash-partitioned
``ShardedDurableMap`` (``repro_torch.core.shard``) with its ``--router``,
``--placement`` and ``--max-lane-budget``; each shard's lookups and
recovery run the same kernels, once per shard.  ``--autosplit W`` makes
the registry an ``ElasticShardedMap`` (``repro_torch.core.resize``) that
starts an online S -> 2S split once its fill factor reaches W; the
migration advances one increment per serving step and is drained at the
end, each child rebuilt through ``recovery_scan``.

``--queue`` makes the driver the durable request/completion SPINE
(DESIGN.md §7): arrivals are acknowledged by a durable enqueue into a
request ``DurableQueue`` (``repro_torch.core.queue``), the server peeks
(volatile, zero psync) the batch it serves, and after generation the
completion path runs response-enqueue -> registry-insert ->
request-dequeue-commit.  The dequeue becomes durable only AFTER the
completion is recorded, so a crash at any point loses no acknowledged
request: it is either still live in the request queue (re-served; the
registry dedups the redelivery) or already in the registry.  Each request
costs 4 psyncs; every queue recovery runs ``recovery_scan``.  ``--crash``
drills the invariant end to end.

``--pipeline N`` (N > 1, with ``--shards`` > 1) serves the requests in
``min(requests, 2N)`` waves through the depth-N pipelined sharded
registry: wave k+1's durable ack is issued after wave k's generation has
been launched, and each wave's registry insert is flushed durable before
that wave's dequeue commit, so the spine's ordering and its 4 psyncs per
request hold per wave.  On one CUDA stream the ack's host reads wait for
the generation queued before them; ``run`` reports per wave whether the
ack finished while the generation still ran (``ack_overlapped``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b-smoke \\
      --requests 8 --prompt-len 32 --gen 16 [--crash] [--device cpu] \\
      [--snapshot-every 1 [--snapshot-dir DIR]] [--shards 8 [--router v1]
      [--placement strided] [--max-lane-budget L] [--pipeline 2]]
      [--queue [--queue-capacity 1024]] [--autosplit 0.75]

``--open-loop`` hands every other flag to
:mod:`repro_torch.launch.bench_serve`, the open-loop tail-latency harness
(``--duration``, ``--rate``, ``--utilization``, ``--quick``, ``--out``,
``--device``, ...), as the JAX driver does.

``--arch`` takes every config of ``repro_torch.configs.all`` but the
audio family's: the dense GQA models (qwen3-32b, h2o-danube-3-4b,
qwen1.5-110b with its QKV bias), MoE (mixtral-8x22b, arctic-480b), MLA
(minicpm3-4b), xLSTM (xlstm-350m), RG-LRU with local attention
(recurrentgemma-2b) and the vlm qwen2-vl-2b, whose token prompts run at
the default M-RoPE positions, as in ``repro.launch.serve``, each with its
``-smoke`` variant.  Attention layers run ``flash_prefill`` in prefill and
``gqa_decode`` in decode, except MLA's decode, which attends in the latent
space with plain products as the JAX package does; the recurrent layers
run no kernel.  whisper-base is refused with a ``ValueError``: its prefill
reads frame embeddings, which serve, having token prompts only, has none
of (``repro.launch.serve`` fails on the missing ``embeds`` the same way).

It runs on the GPU unless given ``--device cpu``.  ``run`` is the same path
for a caller that holds a config object.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import (DurableMap, DurableQueue, ElasticShardedMap,
                              QueueSpec, SetSpec, ShardedDurableMap)
from repro_torch.core.device import resolve_device
from repro_torch.launch import bench_serve
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry
from repro_torch.store.snapshot import SnapshotPolicy, Snapshotter
from repro_torch.train import steps as TS

# Node-pool size of the completion registry, as in repro.launch.serve.
REGISTRY_CAPACITY = 1024

PIPELINE_NEEDS_SHARDS = ("--pipeline > 1 requires --shards > 1 (the "
                         "pipelined dispatch path lives in the sharded "
                         "registry router)")
AUTOSPLIT_RANGE = "--autosplit must be a fill factor in (0, 1]"
AUTOSPLIT_NEEDS = ("--autosplit requires --router v2 and --pipeline 1 (the "
                   "split frontier commits at dispatch boundaries)")
AUDIO_NEEDS_EMBEDS = ("serve drives token prompts only, and the audio "
                      "family's prefill also reads the encoder's frame "
                      "embeddings (batch['embeds']), which no serve flag "
                      "provides (repro.launch.serve never passes them "
                      "either)")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_numpy(x) -> np.ndarray:
    """Per-lane results as a host array: a tensor on any device, or an
    array-like (the sharded map's results and pipelined handles)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _expect(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def run(cfg: ModelConfig, requests: int = 8, prompt_len: int = 32,
        gen: int = 16, crash: bool = False, backend: str = "probe",
        device="cuda", params=None, snapshot_every: int = 0,
        snapshot_dir: Optional[str] = None, shards: int = 1,
        router: str = "v2", placement: str = "contiguous",
        max_lane_budget: int = 0, queue: bool = False,
        queue_capacity: int = 1024, pipeline: int = 1,
        autosplit: float = 0.0) -> dict:
    """Serve ``requests`` prompts of ``prompt_len`` tokens for ``gen``
    tokens each, record the completions in the registry, and with
    ``crash`` crash and recover it.  ``params`` defaults to
    ``init_params(cfg, seed=0)``.  ``snapshot_every`` > 0 snapshots the
    registry (and the queues) every that many serving steps into
    ``snapshot_dir`` (a fresh temporary directory by default), and the
    crash recovers through the snapshotters.  ``shards`` > 1 makes the
    registry a ``ShardedDurableMap`` with that router, placement, lane cap
    and ``pipeline`` depth; ``pipeline`` > 1 serves in waves.  ``queue``
    runs the request/completion spine through two ``queue_capacity``-slot
    SOFT queues.  ``autosplit`` > 0 makes the registry an
    ``ElasticShardedMap`` of ``max(1, shards)`` shards that begins an
    online split when its fill factor reaches ``autosplit``, advances it
    one ``step()`` per serving step and drains it before the summary.
    Returns the generated tokens, the structures' counts and the timings
    (for one wave, the device synchronized around prefill and around the
    decode loop)."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: {AUDIO_NEEDS_EMBEDS}")
    if pipeline < 1:
        raise ValueError("--pipeline must be >= 1")
    if pipeline > 1 and shards <= 1:
        raise ValueError(PIPELINE_NEEDS_SHARDS)
    if autosplit:
        if not 0 < autosplit <= 1:
            raise ValueError(AUTOSPLIT_RANGE)
        if router != "v2" or pipeline != 1:
            raise ValueError(AUTOSPLIT_NEEDS)
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=dev)
    prefill_step, decode_step = TS.make_serve_steps(cfg)

    m = MetricsRegistry()     # one snapshot() reaches every structure
    spec = SetSpec(capacity=REGISTRY_CAPACITY, mode="soft", backend=backend)
    if autosplit:             # elastic geometry: splits online under load
        registry = ElasticShardedMap(spec, n_shards=max(1, shards),
                                     placement=placement,
                                     max_lane_budget=max_lane_budget,
                                     metrics=m, metrics_name="registry",
                                     device=dev)
        budgets = registry.precompile(requests)
        if budgets:
            print(f"registry router v2: pre-compiled lane budgets "
                  f"{budgets} (elastic, autosplit @ fill "
                  f">= {autosplit})")
    elif shards > 1:          # same facade API, hash-partitioned runtime
        registry = ShardedDurableMap(spec, n_shards=shards, router=router,
                                     placement=placement,
                                     max_lane_budget=max_lane_budget,
                                     pipeline_depth=pipeline,
                                     metrics=m, metrics_name="registry",
                                     device=dev)
        budgets = registry.precompile(requests)
        if budgets:
            print(f"registry router v2: pre-compiled lane budgets "
                  f"{budgets} ({placement} placement)")
    else:
        registry = DurableMap(spec, metrics=m, metrics_name="registry",
                              device=dev)
    b = requests
    req_ids = np.arange(1000, 1000 + b, dtype=np.int32)

    req_q = resp_q = None
    if queue:
        qspec = QueueSpec(capacity=queue_capacity, mode="soft")
        req_q = DurableQueue(qspec, metrics=m, metrics_name="req_queue",
                             device=dev)
        resp_q = DurableQueue(qspec, metrics=m, metrics_name="resp_queue",
                              device=dev)

    # background snapshots: the capture is a host copy of already-durable
    # planes at the dispatch boundary, the build and save run off the hot
    # path, so the serving loop's psync bill is unchanged
    snaps = {}
    if snapshot_every > 0:
        base = snapshot_dir or tempfile.mkdtemp(prefix="serve_snap_")
        pol = SnapshotPolicy(every_steps=snapshot_every)
        snaps["registry"] = Snapshotter(
            registry, os.path.join(base, "registry"), pol)
        if queue:
            snaps["req_queue"] = Snapshotter(
                req_q, os.path.join(base, "req_q"), pol)
            snaps["resp_queue"] = Snapshotter(
                resp_q, os.path.join(base, "resp_q"), pol)
        print(f"snapshotter: every {snapshot_every} step(s) -> {base}")
    serve_step = 0

    def snapshot_tick():
        nonlocal serve_step
        serve_step += 1
        for s in snaps.values():
            s.maybe_snapshot(serve_step)
        if autosplit:
            # the autosplit watermark: one migration increment rides each
            # serving step, so the split amortizes across live traffic
            if registry.migrating:
                registry.step()
            elif registry.fill_factor() >= autosplit:
                print(f"autosplit: fill {registry.fill_factor():.3f} >= "
                      f"{autosplit:g} -> online split "
                      f"S={registry.n_shards} -> {2 * registry.n_shards}")
                registry.begin_split()

    def crash_recover(structure, key):
        """Crash+recover one structure -- through its snapshotter's
        hybrid path when snapshots are on, the full-pool scan otherwise."""
        if key in snaps:
            snaps[key].wait()      # the build commits, as it would live
            snaps[key].recover()
        else:
            structure.crash_and_recover()

    @contextlib.contextmanager
    def phase(name):
        """Span-time a spine phase (host clock) and bill the queue psyncs
        it paid to ``phase.<name>.psyncs``."""
        qp0 = (req_q.psyncs + resp_q.psyncs) if queue else 0
        with m.span(name):
            yield
        if queue:
            m.counter(f"phase.{name}.psyncs").inc(
                req_q.psyncs + resp_q.psyncs - qp0)

    def ack(ids):
        """Durable admission: the ack psync makes each request
        survivable."""
        with phase("ack"):
            acked = _to_numpy(req_q.enqueue(ids))
        _expect(acked.all(), "admission queue full")
        return acked

    def peek_served(ids):
        """Volatile peek (zero psync) of the batch about to be served."""
        served, ok = req_q.peek(len(ids))
        _expect(ok.all() and (served == ids).all(),
                "the request queue's head is not the batch served")

    def commit(n):
        with phase("commit"):
            _, committed = req_q.dequeue(n)
        _expect(committed.all(), "a dequeue commit failed")

    max_seq = prompt_len + gen
    rng = np.random.default_rng(0)
    all_toks = rng.integers(0, cfg.vocab, (b, prompt_len))

    def generate(tok_rows, times=None):
        """Prefill + decode one wave: (tokens, last logits) on the device.
        Without ``times`` nothing waits for the device; with it, the
        device is synchronized around prefill and the decode loop, and
        their host times are stored there."""
        caches = M.init_cache(cfg, len(tok_rows), max_seq, device=dev)
        if times is not None:
            _sync(dev)
            t1 = time.perf_counter()
        caches, logits = prefill_step(
            params, {"tokens": torch.as_tensor(tok_rows, dtype=torch.int32,
                                               device=dev)}, caches)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        if times is not None:
            _sync(dev)
            t2 = time.perf_counter()
        out = [nxt]
        for _ in range(gen - 1):
            caches, nxt, logits = decode_step(params, caches, nxt)
            out.append(nxt)
        tokens = torch.cat(out, dim=1)
        if times is not None:
            _sync(dev)
            t3 = time.perf_counter()
            times.update(prefill_ms=(t2 - t1) * 1e3,
                         decode_ms_per_step=(t3 - t2) * 1e3
                         / max(gen - 1, 1))
        return tokens, logits

    times = {}
    overlapped = []
    t0 = time.time()
    if pipeline == 1:
        if queue:
            acked = ack(req_ids)
            print(f"spine: acknowledged {int(acked.sum())} requests "
                  f"durably (req-queue psyncs={req_q.psyncs})")
            peek_served(req_ids)
        with phase("generate"):
            tokens, logits = generate(all_toks, times)
        dt = time.time() - t0
        print(f"served {b} requests x {gen} tokens in {dt:.2f}s "
              f"({b * gen / dt:.1f} tok/s)")
        # durably record completions: one psync per request (SOFT bound).
        # Spine order: response enqueue -> registry insert -> request
        # dequeue COMMIT -- the dequeue's psync comes only after the
        # completion is durable, so no acknowledged request is lost.
        with phase("record"):
            if queue:
                resp_q.enqueue(req_ids)
            registry.insert(req_ids, tokens[:, -1])
        if queue:
            commit(b)
        snapshot_tick()
    else:
        # Depth-N pipelined waves: wave k+1's durable ack is issued after
        # wave k's generation is launched, and each wave's pipelined
        # registry insert is FLUSHED (forced durable) before that wave's
        # dequeue commit, so the spine's ordering holds per wave.
        waves = [w for w in np.array_split(np.arange(b),
                                           min(b, 2 * pipeline))
                 if len(w)]
        if queue:
            ack(req_ids[waves[0]])
        parts = []
        for k, idx in enumerate(waves):
            ids = req_ids[idx]
            if queue:
                peek_served(ids)
            tok_w, logits_w = generate(all_toks[idx])      # async
            parts.append((tok_w, logits_w))
            if queue and k + 1 < len(waves):
                launched = None
                if dev.type == "cuda":
                    launched = torch.cuda.Event()
                    launched.record()
                ack(req_ids[waves[k + 1]])
                if launched is not None:
                    # False: the generation was still running when the
                    # ack returned
                    overlapped.append(not launched.query())
            last = tok_w[:, -1].cpu().numpy()              # force wave k
            with phase("record"):
                if queue:
                    resp_q.enqueue(ids)
                registry.insert(ids, last)                 # staged, lazy
                registry.pipeline_flush()   # durable BEFORE dequeue commit
            if queue:
                commit(len(ids))
            snapshot_tick()
        tokens = torch.cat([p[0] for p in parts])
        logits = torch.cat([p[1] for p in parts])
        dt = time.time() - t0
        print(f"served {b} requests x {gen} tokens in {len(waves)} waves "
              f"(depth-{pipeline} registry pipeline) in {dt:.2f}s "
              f"({b * gen / dt:.1f} tok/s)")

    # end-of-run summary: everything below reads the ONE metrics snapshot
    snap = m.snapshot()
    coll = snap["collected"]
    reg = coll["registry"]
    result = {"tokens": tokens, "logits": logits, "params": params,
              "registered": reg["size"], "psyncs": reg["psyncs"],
              "seconds": dt, "tok_per_s": b * gen / dt, **times}
    if queue:
        by_phase = {k.split(".")[1]: v for k, v in snap["counters"].items()
                    if k.startswith("phase.") and k.endswith(".psyncs")}
        spine_psyncs = (coll["req_queue"]["psync_total"]
                        + coll["resp_queue"]["psync_total"])
        print(f"spine: {coll['resp_queue']['size']} completions enqueued, "
              f"request queue drained (len={coll['req_queue']['size']}), "
              f"psyncs by phase {by_phase}, total spine psyncs="
              f"{spine_psyncs}")
        result.update(
            spine_psyncs=spine_psyncs, phase_psyncs=by_phase,
            phase_ms={k[len("span."):]: h["sum"] * 1e3
                      for k, h in snap["histograms"].items()},
            ack_overlapped=overlapped)
    shard_tag = f" x{shards} shards" if shards > 1 else ""
    print(f"registry[{backend}{shard_tag}]: {reg['size']} completed, "
          f"psyncs={reg['psyncs']} (== #requests)")
    if shards > 1 and reg.get("last_route"):
        lr = reg["last_route"]
        print(f"router: lane_budget={lr['lane_budget']} "
              f"groups={lr['groups']} dropped={reg['router_dropped']}")
    if autosplit:
        while not registry.step():      # drain an in-flight migration
            pass
        print(f"elastic registry: n_shards={registry.n_shards} "
              f"(splits={registry.splits}), fill="
              f"{registry.fill_factor():.3f}, migrated="
              f"{registry.migrated_nodes} node(s) at "
              f"{registry.migration_psyncs} migration psync(s); hot-path "
              f"psyncs={registry.psyncs} (== #requests, unchanged)")

    if crash:
        late_ids = None
        if queue:
            # acked-but-not-yet-served work at crash time: exactly the
            # requests the spine's ordering promises to redeliver
            late_ids = req_ids + b
            ack(late_ids)
        crash_recover(registry, "registry")
        done = _to_numpy(registry.contains(req_ids))
        _expect(done.all(), f"registry lost {int((~done).sum())} of {b} "
                "completions in crash and recovery")
        print(f"after crash+recovery: all {b} completions still registered")
        if snaps:
            g = m.snapshot()["gauges"]
            print(f"hybrid recovery: "
                  f"{int(g.get('registry.last_recovery_from_delta_slots', 0))}"
                  f" delta slot(s) re-scanned, "
                  f"{int(g.get('registry.last_recovery_from_snapshot_slots', 0))}"
                  f" restored from the snapshot")
        reg = m.snapshot()["collected"]["registry"]
        result.update(registered_after_recovery=int(done.sum()),
                      recovery_psyncs=reg["recovery_psyncs"],
                      psyncs_after_recovery=reg["psyncs"])
        if queue:
            crash_recover(req_q, "req_queue")
            crash_recover(resp_q, "resp_queue")
            # no acknowledged request lost: each is in the registry or
            # still live in the recovered request queue
            vals, ok = resp_q.peek(b)
            _expect(ok.all() and set(vals.tolist()) == set(req_ids.tolist()),
                    "completions lost from the response queue")
            redelivered = len(req_q)
            _expect(redelivered == len(late_ids), "acked requests lost")
            ids, ok = req_q.peek(redelivered)   # re-serve survivors
            _expect(ok.all(), "a survivor could not be read back")
            with phase("record"):
                resp_q.enqueue(ids)
                registry.insert(ids, ids)   # dedups already-completed ids
                if shards > 1:
                    registry.pipeline_flush()
            commit(redelivered)
            m.counter("spine.redelivered").inc(redelivered)
            _expect(_to_numpy(registry.contains(late_ids)).all(),
                    "a redelivered request is not registered")
            snap = m.snapshot()
            coll = snap["collected"]
            print(f"spine after crash+recovery: "
                  f"{snap['counters']['spine.redelivered']} acked requests "
                  f"redelivered and committed, "
                  f"{coll['resp_queue']['size']} completions survive, "
                  f"request queue drained (len={coll['req_queue']['size']}); "
                  f"recovery psyncs: "
                  f"registry={coll['registry']['recovery_psyncs']} "
                  f"req_queue={coll['req_queue']['recovery_psyncs']} "
                  f"resp_queue={coll['resp_queue']['recovery_psyncs']} "
                  f"(all zero by construction)")
            result.update(
                redelivered=snap["counters"]["spine.redelivered"],
                queue_recovery_psyncs={
                    k: coll[k]["recovery_psyncs"]
                    for k in ("req_queue", "resp_queue")},
                completions_after_recovery=coll["resp_queue"]["size"],
                req_queue_len=coll["req_queue"]["size"])
    for s in snaps.values():
        s.close()
    return result


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--open-loop" in argv:
        # rate-driven tail-latency harness; every remaining flag is a
        # bench_serve flag (--duration, --rate, --quick, --out, --device)
        argv.remove("--open-loop")
        return bench_serve.main(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--open-loop", action="store_true",
                    help="delegate to repro_torch.launch.bench_serve: "
                         "open-loop Poisson arrivals + BENCH_torch_serve."
                         "json (all other flags are bench_serve flags)")
    ap.add_argument("--arch", default="qwen3-32b-smoke",
                    help="any config of repro_torch.configs.all, e.g. "
                         "mixtral-8x22b-smoke")
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
    ap.add_argument("--queue", action="store_true",
                    help="drive traffic through the durable request/"
                         "completion spine: DurableQueue ack -> peek/serve "
                         "-> response enqueue -> registry insert -> dequeue "
                         "commit (each queue recovery runs recovery_scan)")
    ap.add_argument("--queue-capacity", type=int, default=1024,
                    help="ring slots per spine queue (power of two)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="background-snapshot the registry (and, with "
                         "--queue, the spine queues) every N serving "
                         "steps; --crash then recovers from the latest "
                         "snapshot + the stamp delta (bucket and scan "
                         "registries, the queues; a probe registry falls "
                         "back to the full-pool scan).  0 disables")
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
    ap.add_argument("--autosplit", type=float, default=0.0,
                    help="fill-factor watermark in (0, 1]: the registry "
                         "becomes an ElasticShardedMap and an online "
                         "S -> 2S shard split starts when live size / "
                         "capacity crosses the watermark; the migration "
                         "advances one increment per serving step, "
                         "interleaved with live traffic.  0 disables "
                         "(fixed geometry)")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="registry pipeline depth: > 1 serves the requests "
                         "in waves through the pipelined sharded registry "
                         "-- with --queue, wave k+1's durable ack is issued "
                         "after wave k's generation is launched; requires "
                         "--shards > 1")
    args = ap.parse_args(argv)
    if args.pipeline < 1:
        ap.error("--pipeline must be >= 1")
    if args.pipeline > 1 and args.shards <= 1:
        ap.error(PIPELINE_NEEDS_SHARDS)
    if args.autosplit:
        if not 0 < args.autosplit <= 1:
            ap.error(AUTOSPLIT_RANGE)
        if args.router != "v2" or args.pipeline != 1:
            ap.error(AUTOSPLIT_NEEDS)
    run(get_config(args.arch), requests=args.requests,
        prompt_len=args.prompt_len, gen=args.gen, crash=args.crash,
        backend=args.backend, device=args.device,
        snapshot_every=args.snapshot_every, snapshot_dir=args.snapshot_dir,
        shards=args.shards, router=args.router, placement=args.placement,
        max_lane_budget=args.max_lane_budget, queue=args.queue,
        queue_capacity=args.queue_capacity, pipeline=args.pipeline,
        autosplit=args.autosplit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
