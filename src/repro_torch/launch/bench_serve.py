"""Open-loop serving benchmark: tail latency under an arrival RATE (the
port of ``repro.launch.bench_serve``).

A closed-loop driver issues the next batch the moment the previous one
finishes, so it can never observe queueing delay, the quantity an SLO is
written against.  This driver is OPEN-LOOP: requests arrive on a Poisson
process at a configured (or auto-calibrated) rate whether or not the
spine has finished the previous batch, land in a host backlog, and are
served in fixed power-of-two batches through the durable
request/completion spine of :mod:`repro_torch.launch.serve` (DESIGN.md
§7):

    durable ack enqueue -> volatile peek/serve (registry mixed batch)
    -> response enqueue -> request dequeue COMMIT -> response delivery

Per-request latency = (completion force time - arrival time), recorded
in the :class:`repro_torch.obs.Histogram` whose log2 buckets + exact
p50/p99/p999 land in ``BENCH_torch_serve.json``.

Workload shape (the paper's Section 6 mix under serving skew):
reads/updates/deletes 50/25/25 over a Zipf-popular key space of millions
of distinct keys.  Equal update/delete fractions keep the live set
stationary (a key is present iff its LAST update was an insert =>
P(present) -> 1/2 per touched key), so the 2^20-capacity registry never
overflows even over multi-minute runs.

The registry's lookups run ``hash_probe``'s kernels on the card (the
probe-window entry at the default ``--backend probe``, the bucket entry
with ``--backend bucket``).  Their library is loaded, and the CUDA
context made, before the clock starts, so no latency sample holds a
kernel build.  On one CUDA stream the ``ack``, ``dispatch`` and
``commit`` spans time host launches (and the sharded registry's host
syncs), and ``force`` absorbs the device time queued before it.

  PYTHONPATH=src python -m repro_torch.launch.bench_serve --duration 60
  PYTHONPATH=src python -m repro_torch.launch.bench_serve --quick
  PYTHONPATH=src python -m repro_torch.launch.bench_serve --device cpu \\
      --quick --duration 2

It runs on the GPU unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import (DurableMap, DurableQueue, QueueSpec,
                              ShardedDurableMap, SetSpec)
from repro_torch.core import queue as Q
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import OP_CONTAINS, OP_INSERT, OP_NOP, OP_REMOVE
from repro_torch.kernels import _build
from repro_torch.obs import JSONLSink, MetricsRegistry, bench_meta


@dataclasses.dataclass
class ServeConfig:
    """Open-loop run shape (all the knobs BENCH_torch_serve.json
    records)."""
    duration: float = 60.0        # seconds of offered traffic
    rate: float = 0.0             # requests/sec; 0 = auto-calibrate
    utilization: float = 0.6      # auto-rate = utilization * closed-loop
    batch: int = 1024             # spine batch (power of two, padded)
    capacity: int = 1 << 20       # registry slots TOTAL
    key_range: int = 4_000_000    # distinct keys the popularity law covers
    zipf_s: float = 1.1           # Zipf popularity exponent
    read_pct: int = 50            # reads; updates/deletes split the rest
    mode: str = "soft"
    backend: str = "probe"
    shards: int = 8
    queue_capacity: int = 4096    # per spine queue (power of two)
    seed: int = 0
    jsonl: str = ""               # optional per-interval snapshot trail
    device: str = "cuda"          # torch device of the spine's state


def _percentiles_ms(hist) -> dict:
    snap = hist.snapshot()
    out = {"count": snap["count"], "exact": snap["exact"]}
    for k in ("mean", "p50", "p99", "p999", "max"):
        v = snap[k]
        out[f"{k}_ms"] = None if v is None else v * 1e3
    return out


class _ArrivalGen:
    """Vectorized Poisson/Zipf arrival stream.

    Draws interarrival gaps, keys, and op codes in chunks (one RNG call
    per plane per chunk) so the host generator never becomes the
    bottleneck it would be as a per-event Python loop.  ``take(now, n)``
    returns up to ``n`` arrivals with arrival time <= ``now`` --
    the open-loop contract: time advances whether or not the spine kept
    up.
    """
    CHUNK = 1 << 14

    def __init__(self, cfg: ServeConfig, rate: float):
        self._rng = np.random.default_rng(cfg.seed)
        self._cfg = cfg
        self._rate = rate
        self._t = np.empty((0,), np.float64)
        self._k = np.empty((0,), np.int32)
        self._o = np.empty((0,), np.int32)
        self._clock = 0.0          # arrival time of the last drawn event

    def _refill(self) -> None:
        cfg, rng, n = self._cfg, self._rng, self.CHUNK
        t = self._clock + np.cumsum(rng.exponential(1.0 / self._rate, n))
        self._clock = float(t[-1])
        keys = ((rng.zipf(cfg.zipf_s, n) - 1) % cfg.key_range).astype(
            np.int32)
        u = rng.random(n)
        rd = cfg.read_pct / 100.0
        ops = np.where(u < rd, OP_CONTAINS,
                       np.where(u < rd + (1.0 - rd) / 2.0,
                                OP_INSERT, OP_REMOVE)).astype(np.int32)
        self._t = np.concatenate([self._t, t])
        self._k = np.concatenate([self._k, keys])
        self._o = np.concatenate([self._o, ops])

    def next_arrival(self) -> float:
        if self._t.size == 0:
            self._refill()
        return float(self._t[0])

    def take(self, now: float, max_n: int):
        """Arrivals due by ``now`` (at most ``max_n``): (t, keys, ops)."""
        while self._t.size < max_n and self._clock <= now:
            self._refill()
        n = min(int(np.searchsorted(self._t, now, side="right")), max_n)
        out = self._t[:n], self._k[:n], self._o[:n]
        self._t, self._k, self._o = self._t[n:], self._k[n:], self._o[n:]
        return out


def _load_kernels(cfg: ServeConfig, device: torch.device) -> None:
    """Build (or find) and load the kernel library the registry's lookups
    launch, and synchronize the CUDA context, before any timed round: the
    port's counterpart of the JAX driver's precompile.  Nothing to do on
    the CPU, where the wrappers run their plain versions, or for the scan
    backend, whose lookups launch no kernel."""
    if device.type != "cuda":
        return
    if cfg.backend in ("probe", "bucket"):
        _build.load("hash_probe")
    torch.cuda.synchronize(device)


def _build_spine(cfg: ServeConfig, registry_metrics: MetricsRegistry):
    spec = SetSpec(capacity=cfg.capacity, mode=cfg.mode,
                   backend=cfg.backend)
    if cfg.shards > 1:
        registry = ShardedDurableMap(spec, n_shards=cfg.shards,
                                     metrics=registry_metrics,
                                     metrics_name="registry",
                                     device=cfg.device)
        # the lane budgets short open-loop rounds realize (the JAX driver
        # compiles them here; the eager map only validates them)
        registry.precompile(cfg.batch, partial=True)
    else:
        registry = DurableMap(spec, metrics=registry_metrics,
                              metrics_name="registry", device=cfg.device)
    qspec = QueueSpec(capacity=cfg.queue_capacity, mode=cfg.mode)
    req_q = DurableQueue(qspec, metrics=registry_metrics,
                         metrics_name="req_queue", device=cfg.device)
    resp_q = DurableQueue(qspec, metrics=registry_metrics,
                          metrics_name="resp_queue", device=cfg.device)
    return registry, req_q, resp_q


def _spine_round(m: MetricsRegistry, registry, req_q, resp_q, spec_q,
                 keys: np.ndarray, ops: np.ndarray) -> int:
    """One padded spine batch (DESIGN.md §7 ordering).  ``ops`` may
    contain OP_NOP padding; real lanes = the request ids this round
    acknowledges, serves, and commits.  Returns the real-lane count
    AFTER the full round is forced -- the completion instant.

    The queues get device copies of the keys and of the active mask (a
    padded batch bills no psync for its OP_NOP lanes); the registry takes
    the host arrays, since its stage-1 router runs on the host."""
    dev = req_q.device
    real = ops != OP_NOP
    active = torch.tensor(real, device=dev)
    dkeys = torch.tensor(keys, dtype=torch.int32, device=dev)
    with m.span("ack"):
        req_q.state, ok_in, _ = Q.enqueue_impl(
            req_q.state, dkeys, spec=spec_q, active=active)
    with m.span("dispatch"):
        # volatile peek is implicit (the batch IS in hand); the mixed
        # registry batch does route (host stage 1) + device dispatch
        res = registry.apply(ops, keys, keys)
    with m.span("commit"):
        # completion durable BEFORE the request dequeue commit
        resp_q.state, _, _ = Q.enqueue_impl(
            resp_q.state, dkeys, spec=spec_q, active=active)
        req_q.state, _, ok_c, _ = Q.dequeue(req_q.state, active,
                                            spec=spec_q)
        resp_q.state, _, ok_d, _ = Q.dequeue(resp_q.state, active,
                                             spec=spec_q)   # delivery
    with m.span("force"):
        if isinstance(res, torch.Tensor):     # force registry results
            res.cpu()
        n_acked, n_committed, n_delivered = torch.stack(
            [ok_in.sum(), ok_c.sum(), ok_d.sum()]).tolist()
    n_real = int(real.sum())
    if n_acked < n_real:
        m.counter("spine.ack_rejected").inc(n_real - n_acked)
    if n_committed < n_real or n_delivered < n_real:
        m.counter("spine.commit_short").inc(n_real - min(n_committed,
                                                         n_delivered))
    return n_real


def _calibrate_rate(cfg: ServeConfig, m, registry, req_q, resp_q,
                    gen_rng) -> float:
    """Closed-loop throughput probe (also the warm-up of the eager
    launches): a few back-to-back full batches through the spine; auto
    rate = ``utilization`` * measured ops/s."""
    qspec = req_q.spec
    keys = ((gen_rng.zipf(cfg.zipf_s, cfg.batch) - 1)
            % cfg.key_range).astype(np.int32)
    ops = np.full((cfg.batch,), OP_CONTAINS, np.int32)
    _spine_round(m, registry, req_q, resp_q, qspec, keys, ops)  # warm-up
    rounds, t0 = 3, time.perf_counter()
    for _ in range(rounds):
        _spine_round(m, registry, req_q, resp_q, qspec, keys, ops)
    closed = rounds * cfg.batch / (time.perf_counter() - t0)
    return cfg.utilization * closed


def run_open_loop(cfg: ServeConfig) -> dict:
    """Run the open-loop experiment; returns the BENCH_torch_serve
    payload (the JAX driver's keys)."""
    device = resolve_device(cfg.device)
    sinks = [JSONLSink(cfg.jsonl)] if cfg.jsonl else []
    m = MetricsRegistry(sinks=sinks)
    registry, req_q, resp_q = _build_spine(cfg, m)
    _load_kernels(cfg, device)
    qspec = req_q.spec
    latency = m.histogram("serve.latency")

    rate = cfg.rate
    if rate <= 0:
        rate = _calibrate_rate(cfg, m, registry, req_q, resp_q,
                               np.random.default_rng(cfg.seed + 1))
    # calibration traffic must not leak into the measured run: clear the
    # volatile view, zero the spine counters, and baseline the durable
    # per-structure totals (folded by this snapshot) for the psync/op math
    m.reset_volatile()
    for name in ("spine.requests", "spine.ack_rejected",
                 "spine.commit_short"):
        m.counter(name).value = 0
    latency = m.histogram("serve.latency")
    base_coll = m.snapshot()["collected"]
    base = {n: (c.get("psync_total", 0), c.get("ops_total", 0))
            for n, c in base_coll.items()}

    arrivals = _ArrivalGen(cfg, rate)
    backlog_t = np.empty((0,), np.float64)
    backlog_k = np.empty((0,), np.int32)
    backlog_o = np.empty((0,), np.int32)
    backlog_peak = 0
    served = 0

    t0 = time.perf_counter()
    t_end = cfg.duration
    while True:
        now = time.perf_counter() - t0
        if now >= t_end:
            break
        if backlog_t.size < cfg.batch:
            at, ak, ao = arrivals.take(now, cfg.batch * 4)
            if at.size:
                backlog_t = np.concatenate([backlog_t, at])
                backlog_k = np.concatenate([backlog_k, ak])
                backlog_o = np.concatenate([backlog_o, ao])
        backlog_peak = max(backlog_peak, backlog_t.size)
        if backlog_t.size == 0:
            # idle: sleep to the next arrival instead of spinning
            wait = min(max(arrivals.next_arrival() - now, 0.0),
                       t_end - now, 0.01)
            if wait > 0:
                time.sleep(wait)
            continue
        n = min(backlog_t.size, cfg.batch)
        keys = np.zeros((cfg.batch,), np.int32)
        ops = np.full((cfg.batch,), OP_NOP, np.int32)
        keys[:n] = backlog_k[:n]
        ops[:n] = backlog_o[:n]
        t_arr = backlog_t[:n]
        backlog_t, backlog_k, backlog_o = (backlog_t[n:], backlog_k[n:],
                                           backlog_o[n:])
        _spine_round(m, registry, req_q, resp_q, qspec, keys, ops)
        done = time.perf_counter() - t0
        latency.record_many(done - t_arr)
        served += n
        m.counter("spine.requests").inc(n)
        m.gauge("spine.backlog").set(int(backlog_t.size))
        if sinks and served % (64 * cfg.batch) == 0:
            m.emit(label=f"t={done:.1f}s")

    wall = time.perf_counter() - t0
    snap = m.snapshot()
    coll = snap["collected"]

    def per_op(name: str) -> Optional[float]:
        c = coll.get(name, {})
        bp, bo = base.get(name, (0, 0))
        ops_t = c.get("ops_total", 0) - bo
        return (c.get("psync_total", 0) - bp) / ops_t if ops_t else None

    payload = {
        "meta": bench_meta(),
        "config": dataclasses.asdict(cfg),
        "offered_rate": rate,
        "duration_sec": wall,
        "requests_completed": served,
        "ops_per_sec": served / wall if wall > 0 else 0.0,
        "latency": _percentiles_ms(latency),
        "psync_per_op": {"registry": per_op("registry"),
                         "req_queue": per_op("req_queue"),
                         "resp_queue": per_op("resp_queue")},
        "spans_ms": {k.split(".", 1)[1]: _percentiles_ms(h)
                     for k, h in m._hists.items()
                     if k.startswith("span.")},
        "counters": {
            "backlog_peak": backlog_peak,
            "backlog_end": int(backlog_t.size),
            "ack_rejected": m.counter("spine.ack_rejected").value,
            "commit_short": m.counter("spine.commit_short").value,
            "router_dropped": coll.get("registry", {}).get(
                "router_dropped", 0),
            "pipeline_abandoned": coll.get("registry", {}).get(
                "pipeline_abandoned", 0),
            "registry_overflowed": coll["registry"]["overflowed"],
            "queue_overflowed": (coll["req_queue"]["overflowed"]
                                 or coll["resp_queue"]["overflowed"]),
            "registry_size_end": coll["registry"]["size"],
        },
    }
    for s in sinks:
        s.write({"label": "final", **snap})
        s.close()
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    dflt = ServeConfig()
    ap.add_argument("--duration", type=float, default=dflt.duration)
    ap.add_argument("--rate", type=float, default=dflt.rate,
                    help="offered requests/sec (0 = auto-calibrate to "
                         "--utilization of measured closed-loop)")
    ap.add_argument("--utilization", default=str(dflt.utilization),
                    help="utilization target, or a comma-separated sweep "
                         "(e.g. 0.6,0.75,0.9): each point runs its own "
                         "open loop; the sweep + latency-throughput knee "
                         "land under 'utilization_sweep' in --out while "
                         "the first point stays the guarded payload")
    ap.add_argument("--batch", type=int, default=dflt.batch)
    ap.add_argument("--capacity", type=int, default=dflt.capacity)
    ap.add_argument("--key-range", type=int, default=dflt.key_range)
    ap.add_argument("--zipf-s", type=float, default=dflt.zipf_s)
    ap.add_argument("--read-pct", type=int, default=dflt.read_pct)
    ap.add_argument("--mode", default=dflt.mode)
    ap.add_argument("--backend", default=dflt.backend,
                    choices=("probe", "scan", "bucket"))
    ap.add_argument("--shards", type=int, default=dflt.shards)
    ap.add_argument("--queue-capacity", type=int,
                    default=dflt.queue_capacity)
    ap.add_argument("--seed", type=int, default=dflt.seed)
    ap.add_argument("--jsonl", default="",
                    help="also stream interval snapshots to this JSONL")
    ap.add_argument("--device", default=dflt.device,
                    help="torch device of the spine (default: the GPU)")
    ap.add_argument("--out", default="BENCH_torch_serve.json")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke shape: 20s at a small geometry")
    args = ap.parse_args(argv)

    try:
        utils = [float(u) for u in str(args.utilization).split(",")
                 if u.strip()]
    except ValueError:
        ap.error("--utilization must be a float or comma-separated floats")
    if not utils:
        ap.error("--utilization needs at least one value")
    if len(utils) > 1 and args.rate > 0:
        ap.error("a --utilization sweep requires --rate 0 (auto-calibrate "
                 "each point)")

    kw = {f.name: getattr(args, f.name)
          for f in dataclasses.fields(ServeConfig)
          if f.name != "utilization"}
    if args.quick:
        kw.update(duration=min(kw["duration"], 20.0), batch=256,
                  capacity=1 << 16, key_range=200_000,
                  queue_capacity=1024, shards=min(kw["shards"], 4))

    payloads = []
    for u in utils:
        cfg = ServeConfig(utilization=u, **kw)
        p = run_open_loop(cfg)
        payloads.append(p)
        lat = p["latency"]
        print(f"[u={u:.2f}] open-loop: {p['requests_completed']} requests "
              f"in {p['duration_sec']:.1f}s "
              f"({p['ops_per_sec']:.0f} ops/s at offered rate "
              f"{p['offered_rate']:.0f}/s)")
        print(f"[u={u:.2f}] latency ms: p50={lat['p50_ms']:.2f} "
              f"p99={lat['p99_ms']:.2f} p999={lat['p999_ms']:.2f} "
              f"(exact={lat['exact']})")
        print(f"[u={u:.2f}] psync/op: {p['psync_per_op']}")
        print(f"[u={u:.2f}] counters: {p['counters']}")

    # The first point keeps the payload's shape; a multi-point run rides
    # the sweep + its knee alongside it.
    payload = payloads[0]
    if len(payloads) > 1:
        sweep = [{
            "utilization": u,
            "offered_rate": p["offered_rate"],
            "ops_per_sec": p["ops_per_sec"],
            "p50_ms": p["latency"]["p50_ms"],
            "p99_ms": p["latency"]["p99_ms"],
            "p999_ms": p["latency"]["p999_ms"],
            "backlog_peak": p["counters"]["backlog_peak"],
            "backlog_end": p["counters"]["backlog_end"],
        } for u, p in zip(utils, payloads)]
        # latency-throughput knee: the highest utilization whose p99 stays
        # within KNEE_FACTOR of the lowest-utilization p99 -- past it the
        # open-loop queueing term dominates and the tail blows up.
        KNEE_FACTOR = 3.0
        base_p99 = sweep[0]["p99_ms"]
        knee = sweep[0]
        for pt in sorted(sweep, key=lambda s: s["utilization"]):
            if pt["p99_ms"] <= KNEE_FACTOR * base_p99:
                knee = pt
        payload["utilization_sweep"] = sweep
        payload["knee"] = {"factor_vs_lowest_p99": KNEE_FACTOR, **knee}
        print(f"knee: u={knee['utilization']:.2f} at "
              f"{knee['ops_per_sec']:.0f} ops/s, p99={knee['p99_ms']:.2f}ms "
              f"(<= {KNEE_FACTOR:.0f}x the p99 at "
              f"u={sweep[0]['utilization']:.2f})")
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
