"""Focused reproduction of the paper's recovery semantics on the PyTorch
port, ``repro_torch``: drive the stage-machine NVM adversary through torn
states and show what recovery keeps, for both algorithms plus the
instruction-level oracle; then the batched engine's recovery path (the
``recovery_scan`` CUDA kernel on the GPU) on an adversarial eviction
schedule.

Run:  PYTHONPATH=src python examples/crash_recovery_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import DurableMap, OracleSet, SetSpec
from repro_torch.core.oracle import DELETED, FREE, INVALID, PAYLOAD, VALID

NAMES = {FREE: "FREE", INVALID: "INVALID", PAYLOAD: "PAYLOAD",
         VALID: "VALID", DELETED: "DELETED"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    dev = ap.parse_args(argv).device

    for mode in ("linkfree", "soft"):
        print(f"--- {mode}: crash at every durable event of insert(7) ---")
        for crash_at in range(8):
            o = OracleSet(8, mode=mode)
            o.insert(1, 10)                       # completed before crash
            res = o.insert(7, 70, budget=crash_at)
            img = o.crash([0] * 8)                # most adversarial eviction
            rec = OracleSet.recover(img)
            stages = [NAMES[s] for s, _, _ in img[:3]]
            ok, msg = o.check_recovery(rec)
            status = "pending" if res is None else f"returned {res}"
            print(f"  crash@{crash_at}: insert(7) {status:14s} "
                  f"recovered={sorted(rec)} node-stages={stages} -> {msg}")
            assert ok and 1 in rec
        print()
    print("Key property shown above: a pending insert may or may not "
          "survive, but ONLY atomically (never a torn node), and every "
          "completed operation always survives -- durable linearizability "
          "(Definitions B.19/C.17 of the paper).")

    # Batched engine, per index backend: every backend classifies the
    # durable areas with recovery_scan and reports the stage histogram
    # (FREE/INVALID/PAYLOAD/VALID/DELETED telemetry).
    print("\n--- batched engine: crash + recovery per index backend ---")
    keys = np.arange(48, dtype=np.int32)
    for backend in ("probe", "scan", "bucket"):
        m = DurableMap(SetSpec(capacity=128, mode="soft", backend=backend),
                       device=dev)
        m.insert(keys, keys * 7)
        m.remove(keys[:16])
        m.crash_and_recover(np.random.rand(128).astype(np.float32))
        hit = m.contains(keys).cpu().numpy()
        assert hit[16:].all() and not hit[:16].any()
        print(f"  backend={backend:6s} recovered size={len(m):2d} "
              f"stage-hist={m.last_recovery_hist}")


if __name__ == "__main__":
    main()
