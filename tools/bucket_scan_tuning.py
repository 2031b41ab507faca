#!/usr/bin/env python3
"""Two tuning reads of the map's kernels on one card, kept apart from
``chip_smoke.py``, whose helpers they use:

    python3 tools/bucket_scan_tuning.py

1. The bucket entry of ``csrc/hash_probe.cu`` built at 64, 128 and 256
   threads a block (the source with its ``kBucketThreads`` line
   rewritten, one nvcc each, started together, into the build directory)
   and timed in turns, reading and hashing the buckets, on the 2^21-slot
   map's table (NB 2^19, W 8) at B 1024 and 65536 and on one shard's
   (2^18 slots) at B 256; each result held against the plain version.
2. The loads in flight of every kernel of ``hash_probe.cu`` and
   ``recovery_scan.cu``, read from their SASS (``cuobjdump -sass``).

The last line is one JSON object with both.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (N_SHARDS, SEED, _queries, bucket_table,  # noqa: E402
                        expect, sh, time_ms)
from repro_torch.core import SetSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hash_probe.ops import bucket_of  # noqa: E402
from repro_torch.kernels.hash_probe.ref import probe_ref  # noqa: E402


def cases(dev):
    """(label, bkeys, bids, queries) at the map's and a shard's shapes,
    half the queries present."""
    per = (1 << 21) // N_SHARDS
    nb_s, w_s = SetSpec(capacity=per, backend="bucket").bucket_geometry()
    rng = np.random.default_rng(SEED)
    out = []
    for cap, nb, w, bs in ((1 << 21, 1 << 19, 8, (1024, 65536)),
                           (per, nb_s, w_s, (2 * 1024 // N_SHARDS,))):
        _, bk, bi, _, live_keys = bucket_table(dev, cap, cap // 2, cap // 4,
                                               nb, w)
        out += [(f"NB={nb} B={b}", bk, bi,
                 _queries(rng, live_keys, cap // 2, b, dev)) for b in bs]
    return out


BLOCK_SIZES = (64, 128, 256)      # bucket-kernel blocks timed


def bucket_block_sizes(dev, cases):
    """The bucket kernel built at each of ``BLOCK_SIZES`` threads a block
    (this tree's source with its ``kBucketThreads`` line rewritten, one
    nvcc each, started together, into the build directory) and timed in
    turns, each size twice (ascending, then descending), on each case
    (label, bkeys, bids, keys), reading the buckets and hashing them.
    Returns {case: {source: {threads: [ms, ms]}}}; skipped, empty, in a
    tree whose source has no such line."""
    import ctypes
    import re
    src = (_build.CSRC / "hash_probe.cu").read_text()
    line = re.compile(r"constexpr int kBucketThreads = \d+;")
    if not line.search(src):
        print("hash_probe block sizes: this tree's source sets no "
              "kBucketThreads; skipped")
        return {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in BLOCK_SIZES:
        cu = _build.BUILD_DIR / f"hash_probe_threads{t}.cu"
        cu.write_text(line.sub(f"constexpr int kBucketThreads = {t};", src))
        so = cu.with_suffix(".so")
        procs[t] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for t, (proc, so) in procs.items():
        log = proc.communicate()[0]
        expect(proc.returncode == 0, f"nvcc at {t} threads a block:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.hash_probe.restype = ctypes.c_int
        lib.hash_probe.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[t] = lib
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, bk, bi, q in cases:
        nb, w = bk.shape
        b = q.shape[0]
        qb = bucket_of(q, nb)
        want = probe_ref(bk, bi, None, q)
        res = torch.empty_like(q)
        out[label] = {}
        for source, qp in (("read", qb.data_ptr()), ("hashed", 0)):
            times = {t: [] for t in BLOCK_SIZES}
            for t in (*BLOCK_SIZES, *reversed(BLOCK_SIZES)):
                def call(lib=libs[t]):
                    err = lib.hash_probe(bk.data_ptr(), bi.data_ptr(), qp,
                                         q.data_ptr(), res.data_ptr(), b, nb,
                                         w, stream)
                    expect(err == 0, f"hash_probe at {t} threads: error "
                           f"{err}")
                call()
                expect(torch.equal(res, want),
                       f"hash_probe at {t} threads differs from plain")
                times[t].append(time_ms(call, dev))
            out[label][source] = times
            print(f"hash_probe block sizes, {label}, buckets {source}: "
                  + "; ".join(f"{t} threads {v[0]:.6f} and {v[1]:.6f} ms"
                              for t, v in times.items()))
    return out


def sass_loads(name):
    """Each kernel of ``csrc/<name>.cu`` as built, read from its SASS
    (``cuobjdump -sass``): its global loads (LDG) and, in SASS order, how
    many loads are in flight when an instruction first reads a register
    that one of them writes, once after each run of loads; and its
    asynchronous copies (LDGSTS, ``cp.async``) in flight at each wait
    (DEPBAR).  Returns {kernel: {"loads": [...], "copies": [...]}}; empty
    where the toolkit has no cuobjdump."""
    import re
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        print(f"sass {name}: no cuobjdump beside nvcc; not read")
        return {}
    filt = Path(_build.nvcc_path()).parent / "cu++filt"
    sass = sh([str(tool), "-sass", str(_build._lib_path(name))])
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    reg = re.compile(r"\bR(\d+)(\.64)?\b")
    found = {}
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split(None, 1)[0]
        if filt.exists():
            fn = sh([str(filt), fn])
        cut = fn.find("_kernel")
        if cut >= 0:
            end = cut + len("_kernel")
            if fn[end:end + 1] == "<":
                depth = 0
                for j in range(end, len(fn)):
                    depth += {"<": 1, ">": -1}.get(fn[j], 0)
                    if depth == 0:
                        end = j + 1
                        break
            fn = fn[fn.rfind(":", 0, cut) + 1:end]
        pending, counts, loads, fresh = {}, [], 0, False
        copies, waits = 0, []
        for text in insn.findall(chunk):
            text = re.sub(r"^@!?U?P\w+\s+", "", text)
            op, _, rest = text.partition(" ")
            ops = [o.strip() for o in rest.split(",")]
            srcs = ops if op.startswith(("ST", "RED", "ATOM")) else ops[1:]
            used = set()
            for o in srcs:
                for m in reg.finditer(o):
                    r = int(m.group(1))
                    used.update((r, r + 1) if m.group(2) else (r,))
            hit = {k for k, regs in pending.items() if regs & used}
            if hit and fresh:      # the first use since the last load
                counts.append(len(pending))
                fresh = False
            for k in hit:
                del pending[k]
            if op.startswith("LDGSTS"):
                copies += 1
                continue
            if op.startswith("LDGDEPBAR"):     # the copies' commit
                continue
            if op.startswith("DEPBAR") and copies:
                waits.append(copies)
                copies = 0
            if op.startswith("LDG"):
                fresh = True
                width = 4 if ".128" in op else 2 if ".64" in op else 1
                m = reg.match(ops[0])
                if m:
                    r = int(m.group(1))
                    pending[loads] = set(range(r, r + width))
                loads += 1
        found[fn] = {"loads": counts, "copies": waits}
        print(f"sass {name}: {fn}: {loads} LDG; loads in flight at each "
              f"first use: {counts}"
              + (f"; cp.async copies in flight at each wait: {waits}"
                 if waits else ""))
    return found


def main() -> int:
    if not torch.cuda.is_available():
        print("bucket_scan_tuning: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build(("hash_probe", "recovery_scan"))
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    blocks = bucket_block_sizes(dev, cases(dev))
    sass = {name: sass_loads(name) for name in ("hash_probe",
                                                "recovery_scan")}
    print(json.dumps({"block_sizes": blocks, "sass_loads_in_flight": sass,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
