#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Environment: torch, CUDA, nvcc, Triton and the card (nvidia-smi); then
   both CUDA kernels are built from ``src/repro_torch/kernels/csrc`` (one
   nvcc each, started together).
2. Kernel vs plain version on the card, bit for bit: ``recovery_scan`` on
   random legal stages at N = 2^21, 2^23 and 2^21 + 3; ``hash_probe`` at
   NB = 2^19, W = 8 over a table that ``build_buckets`` filled from a real
   pool, B = 1024 and 65536, half present keys and half absent.  Each
   kernel's median time (L2 flushed between launches), its plain version's
   time and its bound from bytes moved at 3.35 TB/s.
3. Main path: the paper's hash-set experiment (key range 2^20, 90% reads)
   on a bucket-backend ``DurableMap`` of 2^21 slots in SOFT mode.  Prefill
   2^19 keys, 200 mixed batches of 1024 lanes, crash, recover, 20 more
   batches; every result, the size, the psync and op counters, the recovery
   histogram and the full key range's membership are held against a host
   reference that follows the same linearization.  The kernels' launch
   counts are zeroed before this phase and must both be > 0 after it.
   Then a shorter run at 2^16 slots in the link-free and log-free modes.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (DurableMap, SetSpec, OP_CONTAINS,  # noqa: E402
                              OP_INSERT, OP_REMOVE, VALID)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import probe_cuda  # noqa: E402
from repro_torch.kernels.hash_probe.ops import (bucket_of,  # noqa: E402
                                                build_buckets)
from repro_torch.kernels.hash_probe.ref import probe_ref  # noqa: E402
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SEED = 0
KERNELS = ("recovery_scan", "hash_probe")
SPIN_CYCLES = 2_000_000            # ~1 ms of device spin ahead of a timed call


def expect(ok, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# 1. environment and build
# ---------------------------------------------------------------------------

def environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print("nvcc: " + sh([_build.nvcc_path(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not importable")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    for name in KERNELS:
        _build.load(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(fn, dev, reps: int = 50) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` calls.  On the
    card each call is bracketed by CUDA events, with the 50 MB L2 flushed
    before it (the callers read state written long before) and the stream
    held busy by a spin kernel while the host enqueues the call, so the
    events see the device work and not the host's enqueue; on the CPU the
    host clock."""
    fn()
    times = []
    if dev.type == "cuda":
        flush = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def wall_ms(fn, dev, reps: int = 50) -> float:
    """Host milliseconds per call of ``reps`` back-to-back calls and one
    synchronization: what a caller pays, enqueue included."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_scan(dev, sizes):
    """recovery_scan kernel vs plain at each N; returns the JSON fields
    measured at the first (main-path) size."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, row = 0, None
    for n in sizes:
        stages = torch.randint(0, 5, (n,), generator=gen, device=dev,
                               dtype=torch.int32)
        mask, hist = scan_cuda(stages)
        mask_p, hist_p = scan_ref(stages)
        e = max(int((mask.int() - mask_p.int()).abs().max()),
                int((hist - hist_p).abs().max()))
        expect(e == 0, f"recovery_scan differs from plain at N={n}")
        expect(int(hist.sum()) == n, f"recovery_scan histogram sum at N={n}")
        err = max(err, e)
        ms = time_ms(lambda: scan_cuda(stages), dev)
        plain = time_ms(lambda: scan_ref(stages), dev)
        wall = wall_ms(lambda: scan_cuda(stages), dev)
        bound = bytes_ms(5 * n + 4 * 5)      # stages in, mask + hist out
        print(f"recovery_scan N={n}: equal; kernel {ms:.6f} ms, plain "
              f"{plain:.6f} ms, bound {bound * 1e3:.3f} us (bytes); "
              f"wrapper {wall:.6f} ms per call back to back")
        if row is None:
            row = dict(ms=ms, plain_ms=plain, bound_ms=bound)
    row["max_abs_err"] = err
    return row


def check_probe(dev, capacity, key_range, live, nb, w, batches):
    """hash_probe kernel vs plain over a table that build_buckets filled
    from a pool of ``capacity`` slots holding ``live`` keys."""
    rng = np.random.default_rng(SEED)
    keys = np.zeros(capacity, np.int32)
    cur = np.zeros(capacity, np.int32)
    slots = rng.choice(capacity, live, replace=False)
    live_keys = rng.choice(key_range, live, replace=False).astype(np.int32)
    keys[slots] = live_keys
    cur[slots] = VALID
    dkeys = torch.from_numpy(keys).to(dev)
    bkeys, bids, ovf = build_buckets(dkeys, torch.from_numpy(cur).to(dev),
                                     nb=nb, w=w)
    print(f"hash_probe table: NB={nb} W={w}, {live} live keys, "
          f"{int(ovf)} overflowed their bucket")
    absent = np.setdiff1d(np.arange(key_range, dtype=np.int32), live_keys)
    err, row = 0, None
    for b in batches:
        q = np.concatenate([rng.choice(live_keys, b // 2),
                            rng.choice(absent, b - b // 2)]).astype(np.int32)
        qk = torch.from_numpy(rng.permutation(q)).to(dev)
        qb = bucket_of(qk, nb)
        got = probe_cuda(bkeys, bids, qb, qk)
        ref = probe_ref(bkeys, bids, qb, qk)
        e = int((got - ref).abs().max())
        expect(e == 0, f"hash_probe differs from plain at B={b}")
        hit = got >= 0
        expect(bool((dkeys[got[hit].long()] == qk[hit]).all()),
               "hash_probe returned a node that holds another key")
        # a present key is missed only if it overflowed its bucket
        hits = int(hit.sum())
        expect(hits == b // 2 or (int(ovf) > 0 and hits < b // 2),
               f"hash_probe found {hits} of {b // 2} present keys")
        err = max(err, e)
        ms = time_ms(lambda: probe_cuda(bkeys, bids, qb, qk), dev)
        plain = time_ms(lambda: probe_ref(bkeys, bids, qb, qk), dev)
        wall = wall_ms(lambda: probe_cuda(bkeys, bids, qb, qk), dev)
        rows = int(torch.unique(qb).numel())
        # queries (bucket, key) in, ids out, and each touched row's W keys
        # and W ids read once
        bound = bytes_ms(12 * b + rows * w * 8)
        print(f"hash_probe B={b} ({rows} distinct rows): equal; kernel "
              f"{ms:.6f} ms, plain {plain:.6f} ms, bound "
              f"{bound * 1e3:.3f} us (bytes); wrapper {wall:.6f} ms per "
              "call back to back")
        if row is None:
            row = dict(ms=ms, plain_ms=plain, bound_ms=bound)
    row["max_abs_err"] = err
    return row


# ---------------------------------------------------------------------------
# 3. the main path against a host reference
# ---------------------------------------------------------------------------

class Reference:
    """Plain host model of one map under apply's linearization: contains
    see the pre-batch set, then inserts in lane order (first lane wins),
    then removes in lane order.  Tracks the psyncs each mode must pay."""

    def __init__(self, key_range: int, mode: str):
        self.present = np.zeros(key_range, bool)
        self.value = np.zeros(key_range, np.int32)
        self.mode = mode
        self.psyncs = 0
        self.ops = 0

    def apply(self, ops, keys, values):
        res = np.zeros(ops.size, bool)
        c = ops == OP_CONTAINS
        res[c] = self.present[keys[c]]
        wins = lose = 0
        added = set()
        for i in np.flatnonzero(ops == OP_INSERT):
            k = keys[i]
            if not self.present[k]:
                self.present[k] = True
                self.value[k] = values[i]
                added.add(k)
                res[i] = True
                wins += 1
            elif k in added:
                lose += 1
        removed = set()
        for i in np.flatnonzero(ops == OP_REMOVE):
            k = keys[i]
            if self.present[k]:
                self.present[k] = False
                removed.add(k)
                res[i] = True
                wins += 1
            elif k in removed:
                lose += 1
        self.psyncs += {"soft": wins, "linkfree": wins + lose,
                        "logfree": 2 * (wins + lose)}[self.mode]
        self.ops += ops.size
        return res


def traffic(rng, n_batches, b, key_range):
    """Mixed batches: 90% contains, 5% insert, 5% remove, keys uniform."""
    ops = rng.choice(np.array([OP_CONTAINS, OP_INSERT, OP_REMOVE], np.int32),
                     size=(n_batches, b), p=[0.9, 0.05, 0.05])
    keys = rng.integers(0, key_range, (n_batches, b), dtype=np.int32)
    vals = rng.integers(0, 1 << 31, (n_batches, b), dtype=np.int32)
    return ops, keys, vals


def drive(m, ref, dev, ops, keys, vals, label):
    """Apply the batches, timed between synchronizations, then check every
    lane against the reference.  Returns ops/s."""
    dops = torch.from_numpy(ops).to(dev)
    dkeys = torch.from_numpy(keys).to(dev)
    dvals = torch.from_numpy(vals).to(dev)
    sync(dev)
    t0 = time.perf_counter()
    out = [m.apply(dops[i], dkeys[i], dvals[i]) for i in range(len(ops))]
    sync(dev)
    dt = time.perf_counter() - t0
    got = torch.stack(out).cpu().numpy()
    for i in range(len(ops)):
        exp = ref.apply(ops[i], keys[i], vals[i])
        expect((got[i] == exp).all(),
               f"{label}: batch {i} results differ from the reference")
    expect(len(m) == int(ref.present.sum()), f"{label}: size")
    expect(m.psyncs == ref.psyncs,
           f"{label}: psyncs {m.psyncs} != reference {ref.psyncs}")
    expect(m.ops == ref.ops, f"{label}: ops {m.ops} != {ref.ops}")
    return ops.size / dt


def check_membership(m, ref, dev, chunk: int, label: str):
    """Every key of the range through contains (batches of ``chunk`` lanes:
    the op bodies build B x B matrices) and a sample through get."""
    n = ref.present.size
    got = np.concatenate([
        m.contains(torch.arange(s, min(s + chunk, n), dtype=torch.int32,
                                device=dev)).cpu().numpy()
        for s in range(0, n, chunk)])
    expect((got == ref.present).all(),
           f"{label}: membership differs for {(got != ref.present).sum()} "
           "keys")
    sample = np.flatnonzero(ref.present)[:chunk].astype(np.int32)
    vals = m.get(torch.from_numpy(sample).to(dev)).cpu().numpy()
    expect((vals == ref.value[sample]).all(), f"{label}: get values")
    ref.ops += n + sample.size
    expect(m.ops == ref.ops and m.psyncs == ref.psyncs,
           f"{label}: reads changed the counters unexpectedly")


def profile(m, ref, dev, batches, label):
    """Mixed batches under torch.profiler: the device's busy share of the
    window and the kernels that take its time.  Only device-side events
    (kernels, copies, fills) are summed: the host operators that launched
    them report the same time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(m, ref, dev, *batches, f"{label} profiled")
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    n_batches = len(batches[0])
    print(f"{label} profile: {n_batches} batches, wall {wall_us:.1f} us, "
          f"device busy {busy:.1f} us ({100 * busy / wall_us:.2f}%), "
          f"{sum(r[1] for r in rows) / n_batches:.1f} device ops per batch")
    for us, n, key in rows[:10]:
        print(f"  {us:12.1f} us {n:6d}x  {key[:90]}")


def run_map(dev, mode, capacity, key_range, prefill, n_batches, n_after, b,
            chunk, label, n_profiled=0):
    """One map through prefill, mixed traffic, crash + recovery and more
    traffic, checked at every step; then ``n_profiled`` batches under the
    profiler.  Returns (ops/s, recovery ms)."""
    rng = np.random.default_rng([SEED, capacity])
    m = DurableMap(SetSpec(capacity=capacity, mode=mode, backend="bucket"),
                   device=dev)
    ref = Reference(key_range, mode)
    pre = rng.choice(key_range, prefill, replace=False).astype(np.int32)
    pre = pre.reshape(-1, b)
    drive(m, ref, dev, np.full(pre.shape, OP_INSERT, np.int32), pre,
          rng.integers(0, 1 << 31, pre.shape, dtype=np.int32),
          f"{label} prefill")
    ops_s = drive(m, ref, dev, *traffic(rng, n_batches, b, key_range),
                  f"{label} traffic")
    expect(not m.overflowed, f"{label}: overflow latched")

    u = rng.random(capacity, dtype=np.float32)
    m.crash_and_recover(torch.from_numpy(u).to(dev))
    hist = m.last_recovery_hist
    expect(int(hist.sum()) == capacity, f"{label}: histogram sum")
    expect(int(hist[VALID]) == int(ref.present.sum()),
           f"{label}: VALID bin {int(hist[VALID])} != reference size")
    expect(m.psyncs == 0 and m.ops == 0, f"{label}: counters after recovery")
    ref.psyncs = ref.ops = 0
    check_membership(m, ref, dev, chunk, f"{label} after recovery")
    drive(m, ref, dev, *traffic(rng, n_after, b, key_range),
          f"{label} after recovery")
    check_membership(m, ref, dev, chunk, f"{label} end")
    if n_profiled:
        profile(m, ref, dev, traffic(rng, n_profiled, b, key_range), label)
    rec_ms = m.last_recovery_seconds * 1e3
    print(f"{label}: {mode}, {capacity} slots, {len(m)} live; mixed "
          f"batches {ops_s:.1f} ops/s; recovery {rec_ms:.3f} ms; "
          f"histogram {hist.tolist()}")
    return ops_s, rec_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = environment()

    scan = check_scan(dev, [1 << 21, 1 << 23, (1 << 21) + 3])
    probe = check_probe(dev, capacity=1 << 21, key_range=1 << 20,
                        live=1 << 19, nb=1 << 19, w=8, batches=[1024, 65536])
    print("library_ms: no single PyTorch call computes either function")

    scan_cuda.launches = probe_cuda.launches = 0
    run_map(dev, "soft", capacity=1 << 21, key_range=1 << 20,
            prefill=1 << 19, n_batches=200, n_after=20, b=1024, chunk=4096,
            label="main path", n_profiled=10)
    launches = {"recovery_scan": scan_cuda.launches,
                "hash_probe": probe_cuda.launches}
    print(f"main-path launches: {launches}")
    expect(all(v > 0 for v in launches.values()),
           "a kernel of the main path was never launched")

    for mode in ("linkfree", "logfree"):
        run_map(dev, mode, capacity=1 << 16, key_range=1 << 15,
                prefill=1 << 14, n_batches=20, n_after=5, b=1024,
                chunk=4096, label=f"{mode} run")

    record = {"kernels": [
        {"name": "recovery_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/recovery_scan.cu",
         "replaces": "src/repro/kernels/recovery_scan/kernel.py:42",
         "launches": launches["recovery_scan"], **scan,
         "bound_by": "bytes", "library_ms": None},
        {"name": "hash_probe", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_probe.cu",
         "replaces": "src/repro/kernels/hash_probe/kernel.py:64",
         "launches": launches["hash_probe"], **probe,
         "bound_by": "bytes", "library_ms": None},
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
