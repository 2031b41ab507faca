"""Quickstart: durable lock-free sets (link-free & SOFT) on the PyTorch
port, ``repro_torch``.

The public surface is ``DurableMap`` configured by a frozen ``SetSpec``
(DESIGN.md §4): pick the psync algorithm with ``mode`` and the volatile
index backend with ``backend``.  On the GPU the probe backend's lookups
run ``hash_probe``'s probe-window CUDA kernel, the bucket backend's its
bucket kernel, and every recovery ``recovery_scan``; on the CPU each
kernel's plain PyTorch version runs instead.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import DurableMap, SetSpec


def host(x) -> np.ndarray:
    """A result tensor (on any device) as a host array."""
    return x.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    dev = ap.parse_args(argv).device

    for mode in ("soft", "linkfree", "logfree"):
        m = DurableMap(SetSpec(capacity=1024, mode=mode), device=dev)

        # batched ops: one batch == many racing "threads"
        keys = np.arange(100, dtype=np.int32)
        m.insert(keys, keys * 10)
        m.remove(keys[:50])
        hit = host(m.contains(keys))
        assert hit[50:].all() and not hit[:50].any()
        assert list(host(m.get(keys[50:53]))) == [500, 510, 520]

        print(f"[{mode:9s}] size={len(m):3d} psyncs={m.psyncs:4d} "
              f"(updates=150 -> psync/update="
              f"{m.psyncs / 150:.2f})")

        # power failure: volatile index is lost, durable areas survive;
        # recovery scans validity words and rebuilds the index.
        m.crash_and_recover(np.random.rand(1024).astype(np.float32))
        hit = host(m.contains(keys))
        assert hit[50:].all() and not hit[:50].any()
        print(f"[{mode:9s}] recovered {len(m)} members after crash OK")

    # Same battery on every index backend -- "probe" and "bucket" look up
    # through hash_probe's kernels on the GPU, "scan" traverses the pool.
    keys = np.arange(64, dtype=np.int32)
    for backend in ("probe", "scan", "bucket"):
        m = DurableMap(SetSpec(capacity=256, mode="soft", backend=backend),
                       device=dev)
        m.insert(keys, keys + 1000)
        m.remove(keys[::2])
        m.crash_and_recover()
        hit = host(m.contains(keys))
        assert hit[1::2].all() and not hit[::2].any()
        print(f"[backend={backend:6s}] size={len(m):2d} after "
              f"insert/remove/crash/recover OK "
              f"(recovery stage hist={m.last_recovery_hist})")

    print("\nSOFT hits the Cohen et al. lower bound: 1 psync/update, "
          "0 psync/read; log-free (the baseline we beat) pays ~2x.")


if __name__ == "__main__":
    main()
