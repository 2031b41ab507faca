"""The CUDA kernels on the card against their plain versions.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  They import no
JAX, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import (DurableMap, DurableQueue,  # noqa: E402
                              ElasticShardedMap, QueueSpec, SetSpec,
                              ShardedDurableMap)
from repro_torch.kernels.flash_prefill.kernel import (  # noqa: E402
    flash_prefill_cuda)
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_prefill_ref)
from repro_torch.kernels.gqa_decode.kernel import gqa_decode_cuda  # noqa: E402
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref  # noqa: E402
from repro_torch.core import durable_set as DS  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402
from repro_torch.core.durable_set import MODES  # noqa: E402
from repro_torch.core.nvm import EMPTY, TOMB, np_hash32  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import (  # noqa: E402
    probe_cuda, table_probe_cuda)
from repro_torch.kernels.hash_probe.ops import (bucket_of,  # noqa: E402
                                                build_buckets)
from repro_torch.kernels.hash_probe.ops import (  # noqa: E402
    lookup as hp_lookup)
from repro_torch.kernels.hash_probe.ref import (probe_ref,  # noqa: E402
                                                table_lookup_ref)
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402
from repro_torch.launch import bench_serve, serve  # noqa: E402
from repro_torch.obs import MetricsRegistry, bench_meta  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import queue as TQ  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.store.snapshot import (Snapshotter,  # noqa: E402
                                        load_resharded)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", (0, 1, 3, 4, 5, 1000, 4096 + 3,
                               (1 << 12) - 1, (1 << 12) + 1, (1 << 16) - 1,
                               (1 << 16) + 1, 1 << 20, (1 << 21) + 3,
                               1 << 23))
@pytest.mark.parametrize("offset", (0, 1))
def test_scan_kernel_matches_plain(cuda, n, offset):
    """Any N, 0 included, aligned or not (a view one element in takes the
    scalar path)."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.integers(0, 5, n + offset).astype(np.int32))
    stages = base.to(cuda)[offset:]
    before = scan_cuda.launches
    mask, hist = scan_cuda(stages)
    assert scan_cuda.launches == before + 1
    mask_p, hist_p = scan_ref(stages)
    torch.cuda.synchronize()
    assert torch.equal(mask, mask_p) and torch.equal(hist, hist_p)


@pytest.mark.parametrize("nb,w,b", [(64, 8, 8), (256, 8, 128),
                                    (512, 16, 256), (1024, 8, 64),
                                    (128, 3, 100), (1 << 16, 8, 4096)])
def test_probe_kernel_matches_plain(cuda, nb, w, b):
    rng = np.random.default_rng(nb + b)
    n = nb * w // 2
    keys = torch.from_numpy(
        rng.choice(10 ** 7, n, replace=False).astype(np.int32)).to(cuda)
    cur = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(cuda)
    bk, bi, _ = build_buckets(keys, cur, nb=nb, w=w)
    q = torch.cat([keys[: b // 2], torch.from_numpy(
        rng.integers(2 * 10 ** 7, 3 * 10 ** 7, b - b // 2).astype(
            np.int32)).to(cuda)])
    qb = bucket_of(q, nb)
    before = probe_cuda.launches
    got = probe_cuda(bk, bi, qb, q)
    assert probe_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, probe_ref(bk, bi, qb, q))


def _hashed_table(rng, nb, w, b):
    """An arbitrary (NB, W) table and b queries: negative, large and
    extreme keys, half of them written into one or two ways of their
    hashed row with a live id (two: the max over matches decides), the
    rest absent; EMPTY in a quarter of the ways.  Ids stay below 2^24,
    the JAX kernel's f32 budget: tests/test_torch_hash_probe.py builds
    its CPU parity cases here too."""
    lim = np.iinfo(np.int32)
    bkeys = rng.integers(lim.min, lim.max, (nb, w), dtype=np.int64)
    bids = rng.integers(0, 1 << 24, (nb, w))
    bids[rng.random((nb, w)) < 0.25] = EMPTY
    q = rng.integers(lim.min, lim.max, b, dtype=np.int64)
    q[: min(b, 4)] = [lim.min, lim.max, -1, 0][: min(b, 4)]
    q[4:b // 2] = rng.integers(-(1 << 12), 1 << 12, max(0, b // 2 - 4))
    q = q.astype(np.int32)
    rows = (np_hash32(q) % np.uint32(nb)).astype(np.int64)
    hit = np.flatnonzero(rng.random(b) < 0.5)
    ways = rng.integers(0, w, (hit.size, 2))
    bkeys[rows[hit], ways[:, 0]] = bkeys[rows[hit], ways[:, 1]] = q[hit]
    bids[rows[hit], ways[:, 0]] = rng.integers(0, 1 << 24, hit.size)
    bids[rows[hit], ways[:, 1]] = rng.integers(-1, 1 << 24, hit.size)
    return bkeys.astype(np.int32), bids.astype(np.int32), q


@pytest.mark.parametrize("b", (1, 7, 257))
@pytest.mark.parametrize("w", (1, 3, 8, 16))
@pytest.mark.parametrize("nb", (24, 64, 1000))
def test_hashed_probe_kernel_matches_plain(cuda, nb, w, b):
    """The bucket entry hashing each key itself (no bucket operand) equals
    its plain version, bit for bit, at NB a power of two or not, every
    row-read path (W 8, W 16 by int4 pairs, W 1 and 3 by scalars) and B
    not a multiple of a block; one launch a call."""
    rng = np.random.default_rng([nb, w, b])
    bk, bi, q = (torch.from_numpy(a).to(cuda)
                 for a in _hashed_table(rng, nb, w, b))
    before = probe_cuda.launches
    got = probe_cuda(bk, bi, None, q)
    assert probe_cuda.launches == before + 1
    want = probe_ref(bk, bi, None, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(want, probe_ref(bk, bi, bucket_of(q, nb), q))


@pytest.mark.parametrize("w", (8, 16))
def test_hashed_probe_kernel_reads_an_unaligned_table(cuda, w):
    """Tables that do not start on 16 bytes take the scalar path, for both
    bucket sources; a table of no bucket cannot be hashed into."""
    rng = np.random.default_rng(w)
    nb, b = 1000, 257
    bkeys, bids, q = _hashed_table(rng, nb, w, b)
    flat = [torch.from_numpy(np.concatenate([[0], a.ravel()]).astype(
        np.int32)).to(cuda)[1:].view(nb, w) for a in (bkeys, bids)]
    bk, bi = flat
    assert bk.data_ptr() % 16 and bi.data_ptr() % 16
    q = torch.from_numpy(q).to(cuda)
    qb = bucket_of(q, nb)
    got = probe_cuda(bk, bi, None, q)
    got_read = probe_cuda(bk, bi, qb, q)
    torch.cuda.synchronize()
    want = probe_ref(bk, bi, None, q)
    assert torch.equal(got, want) and torch.equal(got_read, want)
    with pytest.raises(ValueError, match="NB = 0"):
        probe_cuda(bk[:0], bi[:0], None, q)


def test_hashed_probe_kernel_at_the_map_table(cuda):
    """NB 2^19, W 8 (the 2^21-slot map's geometry), a table build_buckets
    filled from a pool of 2^21 slots with 2^19 live keys, B 65536, half
    present: the hashed entry equals the plain version and the read entry
    over ``bucket_of``, and finds every present key that did not
    overflow."""
    rng = np.random.default_rng(19)
    cap, nb, w, b = 1 << 21, 1 << 19, 8, 1 << 16
    keys = np.zeros(cap, np.int32)
    cur = np.zeros(cap, np.int32)
    slots = rng.choice(cap, 1 << 19, replace=False)
    live = rng.choice(1 << 20, 1 << 19, replace=False).astype(np.int32)
    keys[slots], cur[slots] = live, 3
    bk, bi, ovf = build_buckets(torch.from_numpy(keys).to(cuda),
                                torch.from_numpy(cur).to(cuda), nb=nb, w=w)
    q = np.concatenate([rng.choice(live, b // 2),
                        rng.integers(1 << 20, 1 << 21, b - b // 2)])
    q = torch.from_numpy(rng.permutation(q).astype(np.int32)).to(cuda)
    got = probe_cuda(bk, bi, None, q)
    want = probe_ref(bk, bi, None, q)
    read = probe_cuda(bk, bi, bucket_of(q, nb), q)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(read, want)
    hits = int((got >= 0).sum())
    assert hits == b // 2 or (int(ovf) > 0 and hits < b // 2)


def test_scan_kernel_back_to_back_keeps_its_histogram_exact(cuda):
    """1000 scans on one stream, of grids of one block and of many, with no
    synchronization between them: every histogram is exact, so the
    stream's bin words are back at 0 after each launch."""
    rng = np.random.default_rng(1000)
    sizes = (5, 4096, (1 << 16) + 1, (1 << 20) + 3)
    stages = [torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32))
              .to(cuda) for n in sizes]
    want = [scan_ref(x)[1] for x in stages]
    # scan_ref clips out-of-range stages into bins 0 and 4; the kernel
    # counts exact matches of 0..4, as the TPU kernel does
    exact = [torch.stack([(x == k).sum() for k in range(5)]).int()
             for x in stages]
    assert any(not torch.equal(a, e) for a, e in zip(want, exact))
    hists = [scan_cuda(stages[i % len(sizes)])[1] for i in range(1000)]
    torch.cuda.synchronize()
    for i, h in enumerate(hists):
        assert torch.equal(h, exact[i % len(sizes)]), i


def test_scan_kernel_on_two_streams_keeps_each_histogram_exact(cuda):
    """Scans enqueued on two streams at once, with no synchronization
    between them, each get an exact histogram: every stream has its own
    bin words, so the blocks of two scans never add into one word."""
    rng = np.random.default_rng(2)
    sizes = ((1 << 20) + 3, (1 << 16) + 1)
    stages = [torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
              .to(cuda) for n in sizes]
    exact = [scan_ref(x)[1] for x in stages]
    streams = [torch.cuda.Stream() for _ in sizes]
    hists = [[] for _ in sizes]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(200):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                hists[j].append(scan_cuda(stages[j])[1])
    torch.cuda.synchronize()
    for j, hs in enumerate(hists):
        for i, h in enumerate(hs):
            assert torch.equal(h, exact[j]), (j, i)


def _device_ops(fn):
    """Names of the device operations (kernels, copies, fills) that one
    warm call of ``fn`` runs, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def test_lookup_and_scan_are_one_device_operation_each(cuda):
    """``hp_ops.lookup`` (hash and probe) and ``scan_cuda`` (mask and every
    bin of the histogram) each run exactly one device operation."""
    rng = np.random.default_rng(4)
    bk, bi, q = (torch.from_numpy(a).to(cuda)
                 for a in _hashed_table(rng, 1 << 10, 8, 1024))
    stages = torch.from_numpy(rng.integers(0, 5, 1 << 21).astype(
        np.int32)).to(cuda)
    lookup_ops = _device_ops(lambda: hp_lookup(bk, bi, q))
    scan_ops = _device_ops(lambda: scan_cuda(stages))
    assert len(lookup_ops) == 1 and "hash_probe" in lookup_ops[0], \
        lookup_ops
    assert len(scan_ops) == 1 and "recovery_scan" in scan_ops[0], scan_ops


def _probe_table(rng, t, n, fill, tomb=0.0, dense=0, wrap=False, b=8,
                 offsets=False):
    """An arbitrary linear-probe table over a pool of n keys (ids past the
    pool too) and b queries, half of them pool keys: ``dense`` slots from 0
    hold no EMPTY (chains that reach max_probe); ``wrap`` draws half the
    queries from keys whose home slot is among the last 16; ``offsets``
    puts query j's home slot j mod 4 past a 4-slot boundary, so every
    window start the kernel's aligned 16-byte loads meet is covered, and
    writes each present query's id into its window."""
    pool = rng.choice(10 ** 8, n, replace=False).astype(np.int32)
    table = np.full(t, EMPTY, np.int32)
    slots = rng.choice(t, int(t * fill), replace=False)
    table[slots] = rng.integers(0, n + 4, slots.size)
    table[:dense] = rng.integers(0, n, dense)
    table[rng.random(t) < tomb] = TOMB
    q = np.where(rng.random(b) < 0.5, rng.choice(pool, b),
                 rng.integers(2 * 10 ** 8, 3 * 10 ** 8, b)).astype(np.int32)
    if wrap:
        cand = rng.choice(pool, min(n, 64 * b))
        late = cand[(np_hash32(cand) & np.uint32(t - 1)) >= t - 16]
        q[: min(b // 2, late.size)] = late[: b // 2]
    if offsets:
        m = 4 * b + 64
        src = np.concatenate([rng.integers(0, n, m), np.full(m, -1)])
        cand = np.where(src >= 0, pool[src.clip(0)],
                        rng.integers(2 * 10 ** 8, 3 * 10 ** 8, 2 * m))
        home = np_hash32(cand.astype(np.int32)).astype(np.int64) & (t - 1)
        for o in range(4):
            pick = rng.choice(np.flatnonzero(home % 4 == o), q[o::4].size)
            q[o::4] = cand[pick]
            # a pool key's id at a random step of its window, below and
            # above every max_probe tested
            live = pick[src[pick] >= 0]
            step = rng.integers(0, 256, live.size)
            table[(home[live] + step) & (t - 1)] = src[live]
    return table, pool, q


# (T, N, fill, TOMB share, dense slots, wrap, offsets): chip_smoke.py's
# phase: the 2^21-slot map's table, wrapping windows, TOMBs and full
# chains, and the serving registry's table; then the kernel's edges:
# tables of 4 and 8 slots that a window wraps many times, every window
# offset mod 4, and one shard's table (2^18 slots of 8, T 2^20)
PROBE_TABLES = {"map": (1 << 23, 1 << 21, 1 / 16, 0.0, 0, False, False),
                "wrap": (256, 64, 0.5, 0.1, 0, True, False),
                "tombs-chains": (1024, 256, 0.3, 0.3, 512, False, False),
                "registry": (4096, 1024, 0.25, 0.0, 0, False, False),
                "t4": (4, 64, 0.75, 0.25, 0, False, True),
                "t8": (8, 64, 0.5, 0.25, 0, False, True),
                "offsets": (1024, 256, 0.4, 0.1, 300, False, True),
                "shard": (1 << 20, 1 << 18, 1 / 16, 0.0, 0, False, True)}


@pytest.mark.parametrize("b", (0, 1, 3, 5, 7, 8, 256, 257, 1024, 65536))
@pytest.mark.parametrize("max_probe", (1, 3, 5, 127, 128, 129, 200))
@pytest.mark.parametrize("kind", sorted(PROBE_TABLES))
def test_table_probe_kernel_matches_plain(cuda, kind, max_probe, b):
    t, n, fill, tomb, dense, wrap, offsets = PROBE_TABLES[kind]
    rng = np.random.default_rng(b + max_probe)
    table, pool, q = _probe_table(rng, t, n, fill, tomb, dense, wrap, b,
                                  offsets)
    table, pool, q = (torch.from_numpy(a).to(cuda) for a in (table, pool, q))
    before = table_probe_cuda.launches
    got = table_probe_cuda(table, pool, q, max_probe)
    assert table_probe_cuda.launches == before + (b > 0)
    want = table_lookup_ref(table, pool, q, max_probe)
    torch.cuda.synchronize()
    assert got.shape == (b,) and torch.equal(got, want)


def test_table_probe_kernel_reads_an_unaligned_table(cuda):
    """A table that does not start on 16 bytes is copied to an aligned one
    before the kernel's 16-byte loads; a table under 4 slots is refused."""
    rng = np.random.default_rng(1)
    table, pool, q = _probe_table(rng, 1024, 256, 0.5, 0.2, 300, True, 512)
    base = torch.from_numpy(np.concatenate([[0], table]).astype(
        np.int32)).to(cuda)
    pool, q = torch.from_numpy(pool).to(cuda), torch.from_numpy(q).to(cuda)
    got = table_probe_cuda(base[1:], pool, q)
    torch.cuda.synchronize()
    assert torch.equal(got, table_lookup_ref(base[1:], pool, q))
    with pytest.raises(ValueError, match="power of two from 4"):
        table_probe_cuda(base[:2], pool, q)


def test_argmax_of_a_bool_plane_is_its_first_true_on_cuda(cuda):
    """The port reads jnp.argmax of a bool plane ("first True") as
    torch.argmax of its uint8 cast; on the card too."""
    rng = np.random.default_rng(2)
    plane = rng.random((512, 4096)) < 0.01
    plane[:, -1] |= ~plane.any(axis=1)
    first = torch.from_numpy(plane).to(cuda)
    got = DS._first(first)[:, 0].cpu().numpy()
    np.testing.assert_array_equal(got, plane.argmax(axis=1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ("probe", "scan"))
def test_probe_and_scan_maps_on_the_card_match_the_cpu(cuda, backend, mode):
    """The same batches and crash on the card and on the CPU: the same
    results and every SetState leaf; the card's probe lookups go through
    the probe-window kernel and every recovery through recovery_scan."""
    rng = np.random.default_rng(7)
    maps = [DurableMap(SetSpec(capacity=1 << 12, mode=mode, backend=backend),
                       device=dev) for dev in (cuda, "cpu")]
    table_probe_cuda.launches = scan_cuda.launches = 0
    for step in range(8):
        ops = rng.choice(3, 256, p=[0.5, 0.3, 0.2]).astype(np.int32)
        keys = rng.integers(0, 3000, 256).astype(np.int32)
        res = [m.apply(ops, keys).cpu().numpy() for m in maps]
        np.testing.assert_array_equal(res[0], res[1])
        if step == 4:
            u = rng.random(1 << 12, dtype=np.float32)
            for m in maps:
                m.crash_and_recover(u)
            np.testing.assert_array_equal(maps[0].last_recovery_hist,
                                          maps[1].last_recovery_hist)
    got, want = (state_to_numpy(m.state) for m in maps)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert scan_cuda.launches == 1
    assert (table_probe_cuda.launches > 0) == (backend == "probe")


def test_map_on_the_card_uses_both_kernels(cuda):
    scan_cuda.launches = probe_cuda.launches = 0
    m = DurableMap(SetSpec(capacity=1 << 12, backend="bucket"), device=cuda)
    keys = np.arange(0, 2000, 3, dtype=np.int32)
    assert m.insert(keys).all()
    m.crash_and_recover()
    got = m.contains(np.arange(2000, dtype=np.int32)).cpu().numpy()
    np.testing.assert_array_equal(np.flatnonzero(got), keys)
    assert scan_cuda.launches == 1 and probe_cuda.launches == 2


@pytest.mark.parametrize("d", (8, 64, 4096, 1 << 16))
def test_scan_kernel_on_a_padded_delta(cuda, d):
    """recovery_scan over the gathered delta of a hybrid recovery at each
    padded length: the delta's stages, then stage FREE in the padding."""
    rng = np.random.default_rng(d)
    n = 1 << 17
    persisted = torch.from_numpy(
        rng.integers(0, 5, n).astype(np.int32)).to(cuda)
    slots = np.sort(rng.choice(n, d * 3 // 4 + 1, replace=False))
    delta_idx = torch.from_numpy(TE.pad_delta(slots, n)).to(cuda)
    assert delta_idx.numel() == d
    valid = delta_idx < n
    gathered = torch.where(valid, persisted[torch.where(valid, delta_idx, 0)
                                            .long()], 0)
    before = scan_cuda.launches
    mask, hist = scan_cuda(gathered)
    assert scan_cuda.launches == before + 1
    mask_p, hist_p = scan_ref(gathered)
    torch.cuda.synchronize()
    assert torch.equal(mask, mask_p) and torch.equal(hist, hist_p)


def _clone(state):
    return type(state)(*(t.clone() for t in state))


@pytest.mark.parametrize("backend", ("bucket", "scan"))
def test_hybrid_recovery_on_the_card_equals_full(cuda, backend, tmp_path):
    """2^16 slots on the card: a snapshot through the Snapshotter, a delta
    of mixed batches, a crash; recovery through the snapshot and the stamp
    delta equals the full rebuild under the same adversary, every leaf and
    the histogram, and classifies the delta with one recovery_scan
    launch."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    spec = SetSpec(capacity=n, backend=backend)
    m = DurableMap(spec, device=cuda)
    keys = (rng.choice(4 * n, n // 2, replace=False) + 1).astype(np.int32)
    for chunk in np.split(keys[: n // 4], 16):
        assert m.insert(chunk).all()
    sn = Snapshotter(m, str(tmp_path / "snap"))
    sn.snapshot()
    sn.wait()
    for _ in range(20):
        m.apply(rng.choice(3, 1024, p=[0.5, 0.3, 0.2]).astype(np.int32),
                rng.choice(keys, 1024))
    ref = DurableMap(spec, device=cuda)
    ref.state = _clone(m.state)
    u = rng.random(n, dtype=np.float32)
    ref.crash_and_recover(u)
    scan_cuda.launches = 0
    sn.recover(u)
    assert scan_cuda.launches == 1
    got, want = state_to_numpy(m.state), state_to_numpy(ref.state)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(m.last_recovery_hist,
                                  ref.last_recovery_hist)
    assert m.psyncs == 0
    sn.close()


# the JAX tests' tolerances: decode test_kernels.py:53-54, prefill
# test_seqmix_reference.py:78-79
DECODE_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
PREFILL_ATOL = {"float32": 3e-5, "bfloat16": 4e-2}


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, getattr(torch, dtype))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype", sorted(DECODE_ATOL))
@pytest.mark.parametrize("b,h,kv,d,s", [(8, 64, 8, 128, 544),
                                        (2, 32, 8, 120, 300),
                                        (1, 4, 4, 16, 7)])
def test_gqa_decode_kernel_matches_plain(cuda, b, h, kv, d, s, dtype):
    rng = np.random.default_rng(b * s + d)
    q = _randn(rng, (b, h, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    ln = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).to(
        cuda)
    before = gqa_decode_cuda.launches
    got = gqa_decode_cuda(q, k, v, ln)
    assert gqa_decode_cuda.launches == before + 1
    want = gqa_decode_ref(q, k, v, ln)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= \
        DECODE_ATOL[dtype]


@pytest.mark.parametrize("s", (9, 1000))
def test_gqa_decode_kernel_with_no_live_slot_is_uniform(cuda, s):
    """length 0 masks every slot: the softmax is uniform, as in the plain
    version, also where S spans several of the kernel's chunks (S 1000:
    8 chunks of 128 slots)."""
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, 4, 16), "float32", cuda)
    k = _randn(rng, (2, s, 2, 16), "float32", cuda)
    v = _randn(rng, (2, s, 2, 16), "float32", cuda)
    ln = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    got = gqa_decode_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gqa_decode_ref(q, k, v, ln), atol=2e-5,
                               rtol=0)
    torch.testing.assert_close(got[0], v[0].mean(0).repeat_interleave(2, 0),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DECODE_ATOL))
@pytest.mark.parametrize("s", (1, 7, 65, 300, 4096))
@pytest.mark.parametrize("g", (1, 8, 16))
@pytest.mark.parametrize("d", (8, 120, 256))
def test_gqa_decode_kernel_edges(cuda, d, g, s, dtype):
    """Lengths 0, 1, S - 1, S and S + 5 in one batch; S below, at and above
    one chunk; head dims that pad (8, 120); G 16 takes two head tiles."""
    rng = np.random.default_rng(d + g + s)
    b, kv = 5, 2
    q = _randn(rng, (b, kv * g, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    ln = torch.tensor([0, 1, s - 1, s, s + 5], dtype=torch.int32,
                      device=cuda)
    got = gqa_decode_cuda(q, k, v, ln)
    want = gqa_decode_ref(q, k, v, ln)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= \
        DECODE_ATOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DECODE_ATOL))
def test_gqa_decode_kernel_copies_unaligned_cache(cuda, dtype):
    """A cache view that starts off a 16-byte boundary is copied, not
    misread."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 8, 64), dtype, cuda)
    flat = _randn(rng, (2 * 100 * 2 * 64 + 1,), dtype, cuda)
    k = flat[1:].view(2, 100, 2, 64)
    v = flat[:-1].view(2, 100, 2, 64)
    ln = torch.tensor([37, 100], dtype=torch.int32, device=cuda)
    got = gqa_decode_cuda(q, k, v, ln)
    torch.cuda.synchronize()
    assert float((got.float() - gqa_decode_ref(q, k, v, ln).float()
                  ).abs().max()) <= DECODE_ATOL[dtype]


# Shapes: the serving shape; h2o-danube-3-4b's head dim with a window;
# D = 256 and D = 8 (the bf16 kernel pads both to its 64-column tiles);
# S = 1 and S that are not multiples of the 64-row tiles, with and without
# a window, at G = 1, 2 and 8.
@pytest.mark.parametrize("dtype", sorted(PREFILL_ATOL))
@pytest.mark.parametrize("b,s,h,kv,d,window", [(8, 512, 64, 8, 128, 0),
                                               (2, 300, 32, 8, 120, 128),
                                               (1, 70, 4, 2, 256, 0),
                                               (2, 33, 6, 3, 8, 5),
                                               (2, 1, 16, 2, 8, 0),
                                               (2, 1, 4, 4, 120, 16),
                                               (1, 1, 2, 1, 256, 0),
                                               (2, 100, 16, 2, 8, 0),
                                               (2, 100, 16, 2, 120, 0),
                                               (2, 100, 16, 2, 120, 33),
                                               (1, 130, 4, 2, 256, 50),
                                               (2, 65, 8, 8, 120, 7)])
def test_flash_prefill_kernel_matches_plain(cuda, b, s, h, kv, d, window,
                                            dtype):
    rng = np.random.default_rng(b * s + d)
    q = _randn(rng, (b, s, h, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    before = flash_prefill_cuda.launches
    got = flash_prefill_cuda(q, k, v, window)
    assert flash_prefill_cuda.launches == before + 1
    want = flash_prefill_ref(q, k, v, window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= \
        PREFILL_ATOL[dtype]


@pytest.mark.parametrize("dtype", sorted(PREFILL_ATOL))
def test_flash_prefill_kernel_window_one_returns_own_value(cuda, dtype):
    """window = 1: each query sees only its own key, so the output is v at
    the query's own position, for every query head of the group."""
    rng = np.random.default_rng(2)
    b, s, h, kv, d = 2, 77, 8, 2, 120
    q = _randn(rng, (b, s, h, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    got = flash_prefill_cuda(q, k, v, 1)
    torch.cuda.synchronize()
    want = v.repeat_interleave(h // kv, dim=2)
    assert float((got.float() - want.float()).abs().max()) <= \
        PREFILL_ATOL[dtype]
    assert float((got.float() - flash_prefill_ref(q, k, v, 1).float()
                  ).abs().max()) <= PREFILL_ATOL[dtype]


@pytest.mark.parametrize("dtype", sorted(PREFILL_ATOL))
def test_flash_prefill_kernel_window_beyond_s_is_causal(cuda, dtype):
    """A window longer than the sequence masks nothing more than
    causality: the same output as window 0."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 2, 150, 8, 2, 64
    q = _randn(rng, (b, s, h, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    got = flash_prefill_cuda(q, k, v, 4 * s)
    full = flash_prefill_cuda(q, k, v, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, full)
    assert float((got.float() - flash_prefill_ref(q, k, v, 0).float()
                  ).abs().max()) <= PREFILL_ATOL[dtype]


@pytest.mark.parametrize("dtype", sorted(PREFILL_ATOL))
def test_flash_prefill_kernel_reads_through_strides(cuda, dtype):
    """q, k, v as views of one fused projection, as a caller may hold
    them: the kernel reads them in place."""
    rng = np.random.default_rng(1)
    b, s, h, kv, d = 2, 40, 4, 2, 16
    qkv = _randn(rng, (b, s, (h + 2 * kv) * d), dtype, cuda)
    q = qkv[..., :h * d].unflatten(-1, (h, d))
    k = qkv[..., h * d:(h + kv) * d].unflatten(-1, (kv, d))
    v = qkv[..., (h + kv) * d:].unflatten(-1, (kv, d))
    assert not q.is_contiguous()
    got = flash_prefill_cuda(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_prefill_ref(q.contiguous(), k.contiguous(),
                               v.contiguous()),
        atol=PREFILL_ATOL[dtype], rtol=0)


def test_flash_prefill_kernel_copies_unaligned_bf16(cuda):
    """A bf16 view whose start is not 16-byte aligned cannot be read by
    TMA: the wrapper copies it first, and the result is the same."""
    rng = np.random.default_rng(4)
    b, s, h, kv, d = 2, 70, 4, 2, 64
    flat = _randn(rng, (b * s * (h + 2 * kv) * d + 1,), "bfloat16", cuda)
    q = flat[1:b * s * h * d + 1].view(b, s, h, d)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    k = _randn(rng, (b, s, kv, d), "bfloat16", cuda)
    v = _randn(rng, (b, s, kv, d), "bfloat16", cuda)
    got = flash_prefill_cuda(q, k, v)
    torch.cuda.synchronize()
    assert float((got.float() - flash_prefill_ref(q, k, v).float()
                  ).abs().max()) <= PREFILL_ATOL["bfloat16"]


def test_serve_on_the_card_uses_every_kernel(cuda):
    """The serving path at smoke size on the card, on the default (probe)
    registry: each of its four kernels launched as often as the path
    says."""
    cfg = get_config("qwen3-32b-smoke")
    for fn in (scan_cuda, table_probe_cuda, gqa_decode_cuda,
               flash_prefill_cuda):
        fn.launches = 0
    res = serve.run(cfg, requests=4, prompt_len=8, gen=4, crash=True,
                    device=cuda)
    assert res["registered_after_recovery"] == 4 and res["psyncs"] == 4
    assert flash_prefill_cuda.launches == cfg.n_layers
    assert gqa_decode_cuda.launches == cfg.n_layers * 3
    assert table_probe_cuda.launches > 0 and scan_cuda.launches == 1


_LOOKUP = {"bucket": probe_cuda, "probe": table_probe_cuda}


def _shard_traffic(rng, n, b, key_range):
    return [(rng.choice(3, b, p=[0.6, 0.25, 0.15]).astype(np.int32),
             rng.integers(0, key_range, b).astype(np.int32))
            for _ in range(n)]


@pytest.mark.parametrize("router", ("v1", "v2"))
@pytest.mark.parametrize("backend", ("probe", "scan", "bucket"))
def test_sharded_map_on_the_card_matches_the_cpu(cuda, backend, router):
    """A sharded map of 8 shards on the card and on the CPU under the same
    batches, crash and per-shard adversary: the same results, drop masks,
    per-shard histograms and every stacked leaf, bit for bit.  Each shard
    runs its backend's lookup kernel as often as the flat map on the card
    runs it for the same batch, and every recovery runs recovery_scan
    once per shard."""
    rng = np.random.default_rng(11)
    spec = SetSpec(capacity=1 << 14, backend=backend)
    maps = [ShardedDurableMap(spec, n_shards=8, router=router, device=dev)
            for dev in (cuda, "cpu")]
    batches = _shard_traffic(rng, 6, 512, 12000)
    flat = DurableMap(spec, device=cuda)
    lookup = _LOOKUP.get(backend)
    if lookup is not None:
        lookup.launches = 0
        flat.apply(*batches[0], batches[0][1])
        per_batch_flat = lookup.launches
        lookup.launches = 0
    scan_cuda.launches = 0
    for step, (ops, keys) in enumerate(batches):
        res = [m.apply(ops, keys, keys * 3) for m in maps]
        assert isinstance(res[0], np.ndarray)
        np.testing.assert_array_equal(res[0], res[1])
        np.testing.assert_array_equal(maps[0].last_drop_mask,
                                      maps[1].last_drop_mask)
        if lookup is not None and step == 0:
            assert lookup.launches == 8 * per_batch_flat
        if step == 3:
            u = rng.random((8, spec.capacity // 8), dtype=np.float32)
            for m in maps:
                m.crash_and_recover(u)
            np.testing.assert_array_equal(maps[0].last_recovery_hist_shards,
                                          maps[1].last_recovery_hist_shards)
            assert scan_cuda.launches == 8
    q = np.arange(12000, dtype=np.int32)
    np.testing.assert_array_equal(*(m.get(q, default=-1) for m in maps))
    got, want = (state_to_numpy(m.state) for m in maps)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert maps[0].router_dropped == maps[1].router_dropped


def test_sharded_hybrid_recovery_on_the_card_equals_full(cuda, tmp_path):
    """8 bucket shards of 2^13 slots on the card: recovery through a
    Snapshotter equals the full rebuild of a copy of the same pre-crash
    state, every leaf and per-shard histogram; recovery_scan runs once per
    shard on each shard's delta."""
    rng = np.random.default_rng(12)
    spec = SetSpec(capacity=1 << 16, backend="bucket")
    m = ShardedDurableMap(spec, n_shards=8, device=cuda)
    keys = (rng.choice(1 << 18, 1 << 14, replace=False) + 1).astype(np.int32)
    for chunk in np.split(keys[: 1 << 13], 8):
        assert m.insert(chunk).all()
    sn = Snapshotter(m, str(tmp_path / "snap"))
    sn.snapshot()
    sn.wait()
    for ops, k in _shard_traffic(rng, 10, 1024, 1 << 18):
        m.apply(ops, k)
    ref = ShardedDurableMap(spec, n_shards=8, device=cuda)
    ref.state = _clone(m.state)
    u = rng.random((8, spec.capacity // 8), dtype=np.float32)
    ref.crash_and_recover(u)
    scan_cuda.launches = 0
    sn.recover(u)
    assert scan_cuda.launches == 8
    got, want = state_to_numpy(m.state), state_to_numpy(ref.state)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(m.last_recovery_hist_shards,
                                  ref.last_recovery_hist_shards)
    assert m.psyncs == 0
    sn.close()


def sharded_mesh_run(backend, snap_dir):
    """One map of 8 shards of 2^11 slots on the card under
    ``use_shard_map`` (on this rank's rows inside a process group, on all
    8 without one): a prefill, 10 mixed batches, a crash (through a
    snapshot on bucket), 5 batches.  Returns the results, counters,
    histogram, rows held, their leaves and this process's launches."""
    from repro_torch.kernels.recovery_scan.kernel import scan_cuda as scan
    lookup = probe_cuda if backend == "bucket" else table_probe_cuda
    scan.launches = lookup.launches = 0
    rng = np.random.default_rng(41)
    m = ShardedDurableMap(SetSpec(capacity=1 << 14, backend=backend),
                          n_shards=8, device="cuda", use_shard_map=True)
    res = [m.insert(k) for k in np.split(
        rng.choice(1 << 13, 1 << 12, replace=False).astype(np.int32), 4)]
    sn = None
    if backend == "bucket":
        sn = Snapshotter(m, snap_dir)
        sn.snapshot()
        sn.wait()
    batches = list(_shard_traffic(rng, 15, 256, 1 << 13))
    res += [m.apply(ops, k) for ops, k in batches[:10]]
    u = np.random.default_rng(42).random((8, 1 << 11)).astype(np.float32)
    if sn is not None:
        sn.recover(u)
        sn.close()
    else:
        m.crash_and_recover(u)
    res += [m.apply(ops, k) for ops, k in batches[10:]]
    return {"results": np.concatenate(res),
            "hist": m.last_recovery_hist_shards,
            "counters": (m.psyncs, m.ops, len(m)),
            "rows": (m.rows.start, m.rows.stop), "device": str(m.device),
            "leaves": state_to_numpy(m.state),
            "launches": (scan.launches, lookup.launches)}


def sharded_mesh_rank(rank, snap_dir):
    return {b: sharded_mesh_run(b, f"{snap_dir}/{b}_mesh")
            for b in ("bucket", "probe")}


def test_sharded_mesh_of_two_ranks_on_the_card_matches_one_process(
        cuda, tmp_path):
    """``use_shard_map`` over 2 gloo ranks sharing the card, each holding 4
    of the 8 shards: bucket (snapshot and hybrid recovery) and probe,
    every result, counter, histogram and each rank's rows of every leaf
    equal to the one-process map's on the card; each rank launched its
    path's kernels."""
    from repro_torch.launch.mesh import spawn
    one = {b: sharded_mesh_run(b, str(tmp_path / f"{b}_one"))
           for b in ("bucket", "probe")}
    ranks = spawn(sharded_mesh_rank, 2, str(tmp_path))
    for b in ("bucket", "probe"):
        assert one[b]["rows"] == (0, 8)
        for r, got in enumerate(r_[b] for r_ in ranks):
            lo, hi = got["rows"]
            assert (lo, hi) == (4 * r, 4 * r + 4)
            assert got["device"] == "cuda:0"
            for k in ("results", "hist"):
                np.testing.assert_array_equal(got[k], one[b][k],
                                              err_msg=f"{b} rank {r} {k}")
            assert got["counters"] == one[b]["counters"]
            for f, leaf in got["leaves"].items():
                np.testing.assert_array_equal(
                    leaf, one[b]["leaves"][f][lo:hi],
                    err_msg=f"{b} rank {r} leaf {f}")
            assert min(got["launches"]) > 0, (b, r, got["launches"])


def mesh_snapshot_run(snap_dir):
    """8 bucket shards of 2^11 slots on the card under ``use_shard_map``,
    prefilled and snapshotted once: this process's ``recovery_scan``
    launches for the snapshot's build, its rows and the step."""
    from repro_torch.kernels.recovery_scan.kernel import scan_cuda as scan
    rng = np.random.default_rng(45)
    m = ShardedDurableMap(SetSpec(capacity=1 << 14, backend="bucket"),
                          n_shards=8, device="cuda", use_shard_map=True)
    for k in np.split(rng.choice(1 << 13, 1 << 12,
                                 replace=False).astype(np.int32), 4):
        m.insert(k, k * 3)
    sn = Snapshotter(m, snap_dir)
    scan.launches = 0
    sn.snapshot()
    step = sn.wait()
    launches = scan.launches
    sn.close()
    return {"rows": (m.rows.start, m.rows.stop), "launches": launches,
            "step": step}


def mesh_snapshot_rank(rank, snap_dir):
    return mesh_snapshot_run(snap_dir)


def test_sharded_mesh_snapshot_is_built_by_each_rank_on_the_card(
        cuda, tmp_path):
    """A snapshot of the 8-shard map over 2 gloo ranks sharing the card:
    each rank builds its 4 rows (4 ``recovery_scan`` launches, one
    process 8), and the stored files equal one process's byte for
    byte."""
    from repro_torch.launch.mesh import spawn
    one = mesh_snapshot_run(str(tmp_path / "one"))
    ranks = spawn(mesh_snapshot_rank, 2, str(tmp_path / "mesh"))
    assert one["launches"] == 8 and one["step"] == 1
    assert [(r["rows"], r["launches"], r["step"]) for r in ranks] == \
        [((0, 4), 4, 1), ((4, 8), 4, 1)]
    step = "step_000000000001"
    files = sorted(os.listdir(tmp_path / "one" / step))
    assert files == sorted(os.listdir(tmp_path / "mesh" / step))
    for fn in files:
        assert (tmp_path / "one" / step / fn).read_bytes() == \
            (tmp_path / "mesh" / step / fn).read_bytes(), fn


def mesh_resize_run(backend):
    """An elastic map of 2^11-slot shards on the card under
    ``use_shard_map`` (its rows inside a process group, every row without
    one): 1 shard prefilled, split online to 2 and to 4 with one
    ``step()`` per mixed batch, then merged back to 2 and 1 under reads
    and removes.  Returns the results, the counters and this process's
    rows of every leaf after each migration, and the launches."""
    from repro_torch.core.resize import ElasticShardedMap
    from repro_torch.kernels.recovery_scan.kernel import scan_cuda as scan
    lookup = probe_cuda if backend == "bucket" else table_probe_cuda
    scan.launches = lookup.launches = 0
    rng = np.random.default_rng(44)
    m = ElasticShardedMap(SetSpec(capacity=1 << 11, backend=backend),
                          n_shards=1, migrate_chunk=512, device="cuda",
                          use_shard_map=True)
    res = [m.insert(k) for k in np.split(
        rng.choice(1 << 12, 1 << 9, replace=False).astype(np.int32), 4)]
    after = []
    for kind in ("split", "split", "merge", "merge"):
        getattr(m, f"begin_{kind}")()
        for ops, k in _shard_traffic(rng, 64, 256, 1 << 12):
            if kind == "merge":           # the merged shards must hold both
                ops = np.where(ops == TE.OP_INSERT, TE.OP_CONTAINS, ops)
            res.append(m.apply(ops, k))
            res.append(m.get(k, default=-1))
            if m.step():
                break
        after.append({"counters": (m.n_shards, m.psyncs, m.ops, len(m),
                                   m.migration_psyncs, m.migrated_nodes),
                      "rows": (m.map.rows.start, m.map.rows.stop),
                      "leaves": state_to_numpy(m.map.state)})
    return {"results": np.concatenate([np.asarray(r).reshape(-1)
                                       for r in res]),
            "after": after, "launches": (scan.launches, lookup.launches)}


def mesh_resize_rank(rank):
    return {b: mesh_resize_run(b) for b in ("bucket", "probe")}


def test_mesh_resize_of_two_ranks_on_the_card_matches_one_process(cuda):
    """``ElasticShardedMap(use_shard_map=True)`` over 2 gloo ranks sharing
    the card: split 1 -> 2 (rows move from the state both ranks hold to
    one row each) -> 4, merged back 4 -> 2 -> 1, on both backends; every
    result and counter and each rank's rows of every leaf after each
    migration equal to the one-process map's; each rank launched its
    path's kernels."""
    from repro_torch.launch.mesh import spawn
    one = {b: mesh_resize_run(b) for b in ("bucket", "probe")}
    ranks = spawn(mesh_resize_rank, 2)
    for b in ("bucket", "probe"):
        assert [a["counters"][0] for a in one[b]["after"]] == [2, 4, 2, 1]
        for r, got in enumerate(r_[b] for r_ in ranks):
            np.testing.assert_array_equal(got["results"], one[b]["results"],
                                          err_msg=f"{b} rank {r}")
            for g, w in zip(got["after"], one[b]["after"]):
                s = w["counters"][0]
                assert g["counters"] == w["counters"], (b, r)
                lo, hi = g["rows"]
                assert (lo, hi) == ((0, 1) if s == 1 else
                                    (r * s // 2, (r + 1) * s // 2))
                for f, leaf in g["leaves"].items():
                    np.testing.assert_array_equal(
                        leaf, w["leaves"][f][lo:hi],
                        err_msg=f"{b} rank {r} S={s} leaf {f}")
            assert min(got["launches"]) > 0, (b, r, got["launches"])


def test_sharded_state_rows_are_separate_on_the_card(cuda):
    st = TS.make_state(TS.ShardSpec(base=SetSpec(capacity=64,
                                                 backend="bucket"),
                                    n_shards=4), device=cuda)
    st.bids[1, 0, 0] = 5
    assert int(st.bids[0, 0, 0]) == EMPTY and int(st.bids[2, 0, 0]) == EMPTY


# ---------------------------------------------------------------------------
# The durable queue: recovery through the kernel against the plain path
# ---------------------------------------------------------------------------

QN = 1 << 16


def _queue_traffic(q, rng, rounds, b=1024):
    """``rounds`` of one enqueue batch and one smaller dequeue batch, so the
    ring fills, then wraps: tickets pass N."""
    nxt = 0
    for _ in range(rounds):
        q.enqueue(np.arange(nxt, nxt + b, dtype=np.int32))
        nxt += b
        q.dequeue(int(rng.integers(b // 2, b)))
    return nxt


@pytest.mark.parametrize("mode", ("soft", "linkfree", "logfree"))
def test_queue_recovery_on_the_card_matches_plain(cuda, mode):
    """A 2^16-slot queue on the card and on the CPU under the same traffic
    (the ring wrapped) and crash adversary: recovery through the CUDA
    recovery_scan (launched once) equals the plain path on the card and
    the CPU queue's recovery, leaf for leaf, histogram included."""
    rng = np.random.default_rng(31)
    spec = QueueSpec(capacity=QN, mode=mode)
    qs = [DurableQueue(spec, device=dev) for dev in (cuda, "cpu")]
    for q in qs:
        _queue_traffic(q, np.random.default_rng(5), 96)
    assert int(qs[0].state.tail) > QN
    for a, b in zip(qs[0].state, qs[1].state):
        assert torch.equal(a.cpu(), b)
    u = rng.random(QN, dtype=np.float32)
    plain, plain_hist = TQ.crash_and_recover(
        _clone(qs[0].state), torch.from_numpy(u).to(cuda),
        spec=QueueSpec(capacity=QN, mode=mode, use_kernels=False))
    scan_cuda.launches = 0
    for q in qs:
        q.crash_and_recover(u)
    assert scan_cuda.launches == 1
    assert qs[0].psyncs == 0 and not qs[0].overflowed
    for a, b, c in zip(qs[0].state, plain, qs[1].state):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    np.testing.assert_array_equal(qs[0].last_recovery_hist,
                                  plain_hist.cpu().numpy())
    np.testing.assert_array_equal(qs[0].last_recovery_hist,
                                  qs[1].last_recovery_hist)
    for a, b in zip(qs[0].dequeue(1024), qs[1].dequeue(1024)):
        np.testing.assert_array_equal(a, b)


def test_queue_hybrid_recovery_on_the_card_equals_full(cuda, tmp_path):
    """2^16 slots on the card: recovery through a Snapshotter equals the
    full recovery of a copy of the same pre-crash state, and runs
    recovery_scan once, on the delta."""
    rng = np.random.default_rng(32)
    q = DurableQueue(QueueSpec(capacity=QN), device=cuda)
    _queue_traffic(q, rng, 60)
    sn = Snapshotter(q, str(tmp_path / "snap"))
    sn.snapshot()
    sn.wait()
    _queue_traffic(q, rng, 20)
    ref = DurableQueue(q.spec, device=cuda)
    ref.state = _clone(q.state)
    u = rng.random(QN, dtype=np.float32)
    ref.crash_and_recover(u)
    scan_cuda.launches = 0
    sn.recover(u)
    assert scan_cuda.launches == 1
    for f in q.state._fields:
        if f not in ("n_psync", "n_ops"):
            assert torch.equal(getattr(q.state, f), getattr(ref.state, f)), f
    np.testing.assert_array_equal(q.last_recovery_hist,
                                  ref.last_recovery_hist)
    assert q.psyncs == 0
    sn.close()


@pytest.mark.parametrize("kw", [dict(), dict(shards=8, pipeline=2)],
                         ids=["one-wave", "waves"])
def test_serve_queue_spine_on_the_card(cuda, kw):
    """The spine at smoke size on the card: 4 psyncs per request, the late
    acks redelivered, zero recovery psyncs, and recovery_scan launched once
    per recovered structure (a queue each, the registry once per shard)."""
    cfg = get_config("qwen3-32b-smoke")
    scan_cuda.launches = 0
    res = serve.run(cfg, requests=4, prompt_len=8, gen=4, crash=True,
                    device=cuda, queue=True, **kw)
    assert res["spine_psyncs"] + res["psyncs"] == 16
    assert res["redelivered"] == 4 and res["req_queue_len"] == 0
    assert res["queue_recovery_psyncs"] == {"req_queue": 0,
                                            "resp_queue": 0}
    assert res["recovery_psyncs"] == 0
    assert scan_cuda.launches == 2 + kw.get("shards", 1)
    assert len(res["ack_overlapped"]) == (3 if kw else 0)


@pytest.mark.parametrize("backend", ("probe", "scan", "bucket"))
def test_elastic_split_and_merge_on_the_card_match_the_cpu(cuda, backend):
    """An online split of 4 shards under traffic, a crash inside it and a
    blocking merge back, on the card and on the CPU: the same results,
    frontier and counters at every step, every leaf of both maps bit for
    bit.  Each commit rebuilds its children through recovery_scan on the
    card (two per split unit, one per merge unit), a crash recovers every
    shard of both maps through it, and the traffic runs the backend's
    lookup kernel."""
    rng = np.random.default_rng(21)
    spec = SetSpec(capacity=1 << 12, backend=backend)
    maps = [ElasticShardedMap(spec, n_shards=4, migrate_chunk=256,
                              device=dev) for dev in (cuda, "cpu")]
    keys = rng.choice(1 << 14, 1024, replace=False).astype(np.int32)
    for m in maps:
        assert m.insert(keys, keys * 3).all()
    lookup = _LOOKUP.get(backend)
    if lookup is not None:
        lookup.launches = 0
    scan_cuda.launches = 0
    for m in maps:
        m.begin_split()
    step = 0
    while True:
        f0, n0 = maps[0].frontier.committed, scan_cuda.launches
        done = [m.step() for m in maps]
        assert done[0] == done[1]
        if done[0]:
            assert scan_cuda.launches == n0 + 2
            break
        if maps[0].frontier.committed > f0:
            assert scan_cuda.launches == n0 + 2
        step += 1
        ops, k = _shard_traffic(rng, 1, 256, 1 << 14)[0]
        res = [m.apply(ops, k, k * 3) for m in maps]
        np.testing.assert_array_equal(res[0], res[1])
        assert [m.psyncs for m in maps[1:]] == [maps[0].psyncs]
        if step == 7:                       # inside unit 1's copy
            n0 = scan_cuda.launches
            u = rng.random((4, 1024), dtype=np.float32)
            for m in maps:
                m.crash_and_recover(u, seed=3)
            assert scan_cuda.launches == n0 + 4 + 8
            np.testing.assert_array_equal(maps[0].last_recovery_hist,
                                          maps[1].last_recovery_hist)
    assert maps[0].n_shards == 8 and maps[0].migration_psyncs == \
        maps[1].migration_psyncs
    if lookup is not None:
        assert lookup.launches > 0
    n0 = scan_cuda.launches
    for m in maps:
        m.merge()
    assert scan_cuda.launches == n0 + 4
    for m in maps:
        assert m.n_shards == 4 and not m.migrating
    got, want = (state_to_numpy(m.map.state) for m in maps)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    q = np.arange(1 << 14, dtype=np.int32)
    np.testing.assert_array_equal(*(m.get(q, default=-1) for m in maps))
    assert maps[0].migrated_nodes == maps[1].migrated_nodes


@pytest.mark.parametrize("new_s", (2, 8))
def test_elastic_load_resharded_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                            new_s):
    """A snapshot of 4 bucket shards on the card, loaded at another shard
    count on the card and on the CPU: every leaf equal, recovery psyncs 0,
    recovery_scan once per new shard on the card."""
    rng = np.random.default_rng(22)
    m = ShardedDurableMap(SetSpec(capacity=1 << 12, backend="bucket"),
                          n_shards=4, device=cuda)
    keys = rng.choice(1 << 14, 1536, replace=False).astype(np.int32)
    assert m.insert(keys, keys * 5).all()
    m.remove(keys[:256])
    d = str(tmp_path / "snap")
    sn = Snapshotter(m, d)
    sn.snapshot()
    sn.close()
    tgt = SetSpec(capacity=1024 * new_s, backend="bucket")
    scan_cuda.launches = 0
    maps = [load_resharded(d, tgt, new_s, device=dev)
            for dev in (cuda, "cpu")]
    assert scan_cuda.launches == new_s
    got, want = (state_to_numpy(x.map.state) for x in maps)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert maps[0].psyncs == 0 and len(maps[0]) == 1280
    np.testing.assert_array_equal(
        maps[0].get(keys, default=-1),
        np.where(np.isin(keys, keys[:256]), -1, keys * 5))


@pytest.mark.parametrize("index", ("probe", "scan"))
def test_legacy_wrappers_on_the_card_match_the_cpu(cuda, index):
    """The string-index wrappers on the card: a probe lookup runs the
    table_probe kernel (never the plain path), and every result and leaf
    equals the CPU run's, through a crash and recovery."""
    rng = np.random.default_rng(23)
    states = [DS.make_state(256, device=dev) for dev in (cuda, "cpu")]
    table_probe_cuda.launches = 0

    def step(fn, keys, *extra):
        out = [getattr(DS, fn)(st, torch.from_numpy(keys).to(st.keys.device),
                               *(torch.from_numpy(x).to(st.keys.device)
                                 for x in extra), mode="soft", index=index)
               for st in states]
        states[:] = [o[0] for o in out]
        assert torch.equal(out[0][1].cpu(), out[1][1])

    for _ in range(3):
        keys = rng.integers(0, 200, 64).astype(np.int32)
        step("insert_batch", keys, keys * 2)
        step("contains_batch", rng.integers(0, 256, 64).astype(np.int32))
        step("remove_batch", rng.integers(0, 200, 64).astype(np.int32))
    assert (table_probe_cuda.launches > 0) == (index == "probe")
    u = torch.from_numpy(rng.random(256, dtype=np.float32))
    states[:] = [DS.crash_and_recover(st, u.to(st.keys.device))
                 for st in states]
    got, want = (state_to_numpy(st) for st in states)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


BENCH_SMALL = dict(capacity=1 << 10, batch=64, key_range=5000)


def test_bench_serve_open_loop_quick_on_the_card(cuda, tmp_path):
    """A 2 s open loop at the --quick shape (4 probe shards of 2^14 slots,
    256 lanes, 1024-slot queues) on the card: no ack rejected, no short
    commit, no drop or overflow, one psync per queue op, the probe-window
    kernel launched, and the payload's meta names the card."""
    out = tmp_path / "bench.json"
    table_probe_cuda.launches = 0
    assert bench_serve.main(["--quick", "--duration", "2",
                             "--out", str(out)]) == 0
    import json
    p = json.loads(out.read_text())
    c = p["counters"]
    assert (c["ack_rejected"], c["commit_short"], c["router_dropped"]) == \
        (0, 0, 0)
    assert not c["registry_overflowed"] and not c["queue_overflowed"]
    assert p["psync_per_op"]["req_queue"] == 1.0
    assert p["psync_per_op"]["resp_queue"] == 1.0
    assert 0 < p["psync_per_op"]["registry"] <= 0.5
    assert p["requests_completed"] > 0 and p["latency"]["p99_ms"] > 0
    assert table_probe_cuda.launches > 0
    assert p["meta"]["device_name"] == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("shards,qcap", [(1, 128), (2, 128), (2, 32)])
def test_bench_serve_spine_round_on_the_card_matches_the_cpu(cuda, shards,
                                                             qcap):
    """Padded spine rounds on the card and on the CPU: every leaf of the
    registry and of both queues, and the spine counters, equal."""
    runs = []
    for dev in (cuda, torch.device("cpu")):
        cfg = bench_serve.ServeConfig(**BENCH_SMALL, shards=shards,
                                      queue_capacity=qcap, device=str(dev))
        m = MetricsRegistry()
        spine = bench_serve._build_spine(cfg, m)
        gen = bench_serve._ArrivalGen(cfg, 1000.0)
        for n in (64, 40, 64, 17, 64, 33):
            _, k, o = gen.take(1e9, n)
            keys = np.zeros((64,), np.int32)
            ops = np.full((64,), TE.OP_NOP, np.int32)
            keys[:n], ops[:n] = k, o
            bench_serve._spine_round(m, *spine, spine[1].spec, keys, ops)
        runs.append((spine, m.snapshot()["counters"]))
    (card, card_c), (cpu, cpu_c) = runs
    assert card_c == cpu_c
    got, want = state_to_numpy(card[0].state), state_to_numpy(cpu[0].state)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for qa, qb in zip(card[1:], cpu[1:]):
        for f, a, b in zip(qa.state._fields, qa.state, qb.state):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(),
                                          err_msg=f)


def test_bench_serve_meta_names_the_card(cuda):
    meta = bench_meta()
    assert meta["device_name"] == torch.cuda.get_device_name(0)
    assert meta["power_limit"].endswith("W")
    assert meta["cuda_version"] == torch.version.cuda


# f32 logits of a model on the card against the same model on the CPU: the
# kernels and cuBLAS sum in other orders than the plain versions and
# CPU matmuls, which compounds over the layers (a kernel alone is within
# 3e-5 of its plain version in f32)
FAMILY_LOGITS_ATOL = 1e-3


@pytest.mark.parametrize("arch", ["mixtral-8x22b-smoke", "arctic-480b-smoke",
                                  "qwen1.5-110b-smoke", "minicpm3-4b-smoke",
                                  "xlstm-350m-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_model_family_on_the_card_matches_the_cpu(cuda, arch):
    """Each family at smoke size: prefill of 20 tokens (longer than the
    smoke windows of 16) and 3 greedy decode steps on the card against the
    same weights on the CPU: the same tokens, logits within
    FAMILY_LOGITS_ATOL, and the attention kernels launched once per
    attention layer in prefill and per GQA layer in each decode step."""
    from repro_torch.models import model as M
    from repro_torch.models.blocks import attention_layers
    from repro_torch.models.params import tree_map
    cfg = get_config(arch)
    params = M.init_params(cfg, seed=0, device="cpu")
    attn = attention_layers(cfg)
    gqa = 0 if cfg.mla else attn
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda a: a.to(dev), params)
        cache = M.init_cache(cfg, 2, 24, device=dev)
        flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
        cache, logits = M.prefill(p, {"tokens": tok.to(dev)}, cache, cfg)
        steps = [logits]
        for _ in range(3):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            cache, logits = M.decode_step(p, cache, nxt, cfg)
            steps.append(logits)
        out[dev.type] = torch.stack(steps).cpu()
        if dev.type == "cuda":
            assert flash_prefill_cuda.launches == attn
            assert gqa_decode_cuda.launches == 3 * gqa
    cpu, card = out["cpu"], out[cuda.type]
    assert bool(torch.isfinite(card).all())
    assert torch.equal(cpu.argmax(-1), card.argmax(-1))
    assert float((cpu - card).abs().max()) <= FAMILY_LOGITS_ATOL


# ---------------------------------------------------------------------------
# the vlm and audio front ends: flash_prefill by positions, the two
# families on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(PREFILL_ATOL))
def test_frontend_positions_at_arange_equal_the_index_path(cuda, dtype):
    """Positions arange(S) mask as the index path does: the same output
    within the tolerance, causal and windowed."""
    rng = np.random.default_rng(11)
    b, s, h, kv, d = 2, 190, 8, 2, 64
    q = _randn(rng, (b, s, h, d), dtype, cuda)
    k = _randn(rng, (b, s, kv, d), dtype, cuda)
    v = _randn(rng, (b, s, kv, d), dtype, cuda)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)[None].expand(b, s)
    for window in (0, 40):
        got = flash_prefill_cuda(q, k, v, window, q_pos=pos, k_pos=pos)
        idx = flash_prefill_cuda(q, k, v, window)
        torch.cuda.synchronize()
        assert float((got.float() - idx.float()).abs().max()) <= \
            PREFILL_ATOL[dtype]


def test_frontend_positions_refused_on_bad_shapes(cuda):
    q = torch.zeros((1, 8, 2, 8), device=cuda)
    k = torch.zeros((1, 5, 1, 8), device=cuda)
    pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="do not fit"):
        flash_prefill_cuda(q, k, k)              # Sq != Sk by index
    with pytest.raises(ValueError, match="k_pos has shape"):
        flash_prefill_cuda(q, k, k, q_pos=pos, k_pos=pos)
    with pytest.raises(ValueError, match="both"):
        flash_prefill_cuda(q, k, k, q_pos=pos)


@pytest.mark.parametrize("arch,given", [("qwen2-vl-2b-smoke", False),
                                        ("qwen2-vl-2b-smoke", True),
                                        ("whisper-base-smoke", False)])
def test_frontend_model_on_the_card_matches_the_cpu(cuda, arch, given):
    """Each front end at smoke size, f32: prefill (the vlm's token prompt
    at the default positions or its embedding rows at given M-RoPE
    positions; whisper's frames and a decoder prompt) and 3 greedy decode
    steps on the card against the same weights on the CPU: the same
    tokens, logits within FAMILY_LOGITS_ATOL, and flash_prefill and
    gqa_decode launched as ``attention_layers`` and
    ``decode_attention_layers`` say."""
    from repro_torch.models import model as M
    from repro_torch.models.blocks import (attention_layers,
                                           decode_attention_layers)
    from repro_torch.models.params import tree_map
    cfg = get_config(arch)
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 20
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "audio":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    elif given:
        row = np.concatenate([np.arange(6), np.full(9, 6), 9 + np.arange(5)])
        batch = {"embeds": torch.from_numpy((0.02 * rng.standard_normal(
                     (b, s, cfg.d_model))).astype(np.float32)),
                 "positions": torch.from_numpy(np.ascontiguousarray(
                     np.broadcast_to(row, (3, b, s)), np.int32))}
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree_map(lambda a: a.to(dev), params)
        cache = M.init_cache(cfg, b, s + 4, device=dev)
        flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
        cache, logits = M.prefill(p, {k: a.to(dev) for k, a in batch.items()},
                                  cache, cfg)
        steps = [logits]
        for _ in range(3):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            cache, logits = M.decode_step(p, cache, nxt, cfg)
            steps.append(logits)
        out[dev.type] = torch.stack(steps).cpu()
        if dev.type == "cuda":
            assert flash_prefill_cuda.launches == attention_layers(cfg)
            assert gqa_decode_cuda.launches == \
                3 * decode_attention_layers(cfg)
    cpu, card = out["cpu"], out[cuda.type]
    assert bool(torch.isfinite(card).all())
    assert torch.equal(cpu.argmax(-1), card.argmax(-1))
    assert float((cpu - card).abs().max()) <= FAMILY_LOGITS_ATOL


# ---------------------------------------------------------------------------
# training: the train step of every config on the card
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["qwen2-vl-2b", "qwen3-32b", "h2o-danube-3-4b", "minicpm3-4b",
               "qwen1.5-110b", "xlstm-350m", "arctic-480b", "mixtral-8x22b",
               "whisper-base", "recurrentgemma-2b"]
TRAIN_LR = 1e-3


def _train_batch(cfg, b=2, s=16):
    """A numpy-seeded batch of ``tests/test_arch_smoke.py``'s layout: the
    vlm's patch embeddings at M-RoPE positions, whisper's frames and
    decoder tokens, else tokens."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch = {"embeds": (0.02 * rng.standard_normal(
                     (b, s, cfg.d_model))).astype(np.float32),
                 "labels": tok[:, 1:],
                 "positions": np.broadcast_to(
                     np.arange(s, dtype=np.int32), (3, b, s))}
    if cfg.family == "audio":
        batch["embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("grad_accum", (1, 2))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, grad_accum):
    """One train step of each smoke config (f32) on the card against the
    same step on the CPU, from the same state and batch: the gradients
    within 1e-4 of each leaf's largest magnitude; the loss and the grad
    norm within 1e-5 relative; ``step`` equal; m and v within lr x 1e-3;
    the params within lr x 1e-3 of the CPU's AdamW update applied to the
    card's gradients (the first AdamW step divides each gradient by its
    magnitude + 1e-8, so at gradients of about 1e-8 the rounding of the
    two devices' gradients moves the update by up to a tenth of lr).
    With grad_accum 2 the card also holds the accumulated gradients and
    loss against one whole batch on the CPU, where the model has no MoE
    auxiliary loss (a mean over the batch, not over its halves)."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cfg = get_config(arch + "-smoke")
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup=1, total_steps=10,
                            state_dtype=cfg.opt_dtype)
    cpu = torch.device("cpu")
    state0 = TS.init_train_state(cfg, 0, opt, device=cpu)
    batch = _train_batch(cfg)

    def on(dev, tree):
        return tree_map(lambda a: a.to(dev).clone(), tree)

    def state_on(dev):
        return TS.TrainState(on(dev, state0.params), adamw.AdamWState(
            state0.opt.step.to(dev), on(dev, state0.opt.m),
            on(dev, state0.opt.v)))

    def grads(dev, ga):
        """The step's gradients (each microbatch's summed, then divided)
        and loss, on the CPU."""
        total, loss = None, 0.0
        for i in range(ga):
            li, _, g = TS.loss_and_grads(
                cfg, on(dev, state0.params),
                TS.microbatch(on(dev, batch), i, ga))
            total = g if total is None else _add(total, g)
            loss = loss + li
        return tree_map(lambda v: (v / ga).cpu(), total), float(loss / ga)

    def close_grads(got, want):
        for (key, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) <= \
                1e-4 * float(b.abs().max()), key

    g_card, loss_card = grads(cuda, grad_accum)
    g_cpu, loss_cpu = grads(cpu, grad_accum)
    close_grads(g_card, g_cpu)
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    if grad_accum == 2 and not cfg.n_experts:
        g_one, loss_one = grads(cpu, 1)
        close_grads(g_card, g_one)
        assert abs(loss_card - loss_one) <= 1e-5 * abs(loss_one)

    step = TS.make_train_step(cfg, opt, grad_accum)
    flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
    card, m_card = step(state_on(cuda), on(cuda, batch))
    assert flash_prefill_cuda.launches == gqa_decode_cuda.launches == 0
    host, m_cpu = step(state_on(cpu), batch)
    assert int(card.opt.step) == int(host.opt.step) == 1
    for key in ("loss", "grad_norm"):
        assert abs(float(m_card[key]) - float(m_cpu[key])) <= \
            1e-5 * abs(float(m_cpu[key])), key
    ref = state_on(cpu)
    want_params, _, _ = adamw.update(g_card, ref.opt, ref.params, opt)
    for got, want in ((card.params, want_params), (card.opt.m, host.opt.m),
                      (card.opt.v, host.opt.v)):
        for (key, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a.cpu() - b).abs().max()) <= TRAIN_LR * 1e-3, key


def _add(a, b):
    """Leafwise a + b of two nested dicts of tensors."""
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


MESH_DECODE_RUNS = (("qwen3-32b-smoke", 32, 13, 8),
                    ("h2o-danube-3-4b-smoke", 32, 21, 8))


def mesh_decode_run(arch, seq, prompt, steps, ctx=None):
    """A prefill and greedy decode steps of a smoke config (f32) on the
    card, B 4, with this rank's rows and cache block under an enabled
    ``ctx``: logits and tokens on the host, KV bytes, launches."""
    from repro_torch.launch.specs import local_rows
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import steps as TS
    cfg = get_config(arch)
    params = M.init_params(cfg, 0, "cuda")
    rows = local_rows(ctx, 4)
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (4, prompt)).astype(np.int32))[rows].cuda()
    pre, dec = TS.make_serve_steps(cfg, ctx)
    cache = M.init_cache(cfg, 4, seq, device="cuda", ctx=ctx)
    flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
    cache, logits = pre(params, {"tokens": tok}, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [(logits.cpu(), nxt.cpu())]
    for _ in range(steps):
        cache, nxt, logits = dec(params, cache, nxt)
        out.append((logits.cpu(), nxt.cpu()))
    # numpy, not tensors: a rank's result crosses processes after it exits
    return {"logits": torch.stack([o[0] for o in out]).numpy(),
            "tokens": torch.stack([o[1] for o in out]).numpy(),
            "rows": rows,
            "kv": sum(a.numel() * a.element_size()
                      for k, a in tree_leaves(cache)
                      if k.endswith(("/k", "/v"))),
            "launches": (flash_prefill_cuda.launches,
                         gqa_decode_cuda.launches)}


def mesh_decode_rank(rank):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.launch.meshctx import mesh_context
    from repro_torch.launch.specs import make_shard_ctx
    from repro_torch.optim.compress import compressed_psum
    out = {}
    for arch, seq, prompt, steps in MESH_DECODE_RUNS:
        mm = make_model_mesh((1, 2))
        ctx = make_shard_ctx(get_config(arch), ShapeConfig(
            "d", seq, 4, "decode"), mm)
        with mesh_context(mm):
            out[arch] = mesh_decode_run(arch, seq, prompt, steps, ctx)
    gen = torch.Generator().manual_seed(rank)
    grads = [torch.randn((4096,), generator=gen) for _ in range(4)]
    means = []
    for dev in ("cuda", "cpu"):
        r = torch.zeros(4096, device=dev)
        got = []
        for g in grads:
            m, r = compressed_psum(g.to(dev), r)
            got.append((m.cpu(), r.cpu()))
        means.append(got)
    out["compress"] = all(torch.equal(a[i], b[i])
                          for a, b in zip(*means) for i in (0, 1))
    return out


def test_mesh_decode_of_two_ranks_on_the_card_matches_one_process(cuda):
    """The sequence-sharded decode over 2 gloo ranks sharing the card, on a
    (1, 2) grid: each step's logits within 1e-4 of one process's (whose
    decode runs ``gqa_decode``; the ranks' combine is plain f32 PyTorch),
    greedy tokens equal, each rank's KV bytes half of one process's,
    ``flash_prefill`` once a layer in each rank's prefill and
    ``gqa_decode`` never; ``compressed_psum`` of card tensors equal to the
    CPU's bit for bit."""
    from repro_torch.launch.mesh import spawn
    one = {a[0]: mesh_decode_run(*a) for a in MESH_DECODE_RUNS}
    ranks = spawn(mesh_decode_rank, 2)
    for arch, seq, prompt, steps in MESH_DECODE_RUNS:
        layers = get_config(arch).n_layers
        assert one[arch]["launches"] == (layers, layers * steps)
        for r, got in enumerate(x[arch] for x in ranks):
            assert got["rows"] == slice(0, 4)
            assert got["kv"] * 2 == one[arch]["kv"]
            assert got["launches"] == (layers, 0), (arch, r)
            np.testing.assert_allclose(got["logits"], one[arch]["logits"],
                                       atol=1e-4, rtol=0)
            np.testing.assert_array_equal(got["tokens"],
                                          one[arch]["tokens"])
    assert all(x["compress"] for x in ranks)


MESH_TRAIN_GRID = (2, 2)
# the sharded train step on the card: qwen3-32b-smoke (attention), then
# the moe kind on the width route (mixtral), on the EP route with the dense
# residual (arctic with 16 experts, "+16") and MLA (minicpm3); each with
# the leaf whose four blocks must differ
MESH_TRAIN_ARCHS = {"qwen3-32b-smoke": "stack_0/b0_attn/attn/wq",
                    "mixtral-8x22b-smoke": "stack_0/b0_moe/moe/wi",
                    "arctic-480b-smoke+16": "stack_0/b0_moe/moe/wi",
                    "minicpm3-4b-smoke": "stack_0/b0_attn/attn/wo"}


def _mesh_train_cfg(name):
    arch, _, experts = name.partition("+")
    cfg = get_config(arch)
    return cfg.replace(n_experts=int(experts)) if experts else cfg


def mesh_train_rank(rank):
    """Each ``MESH_TRAIN_ARCHS`` config's (f32) sharded train step on this
    rank of a (2, 2) grid on the card, from the seed's state and batch:
    the metrics, the gathered gradients it applies, the gathered state
    before and after, this rank's block of the config's leaf and the
    attention kernels' launches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.launch.meshctx import mesh_context
    from repro_torch.launch.specs import (batch_pspecs, gather,
                                          make_shard_ctx, put)
    from repro_torch.models.params import param_pspecs, tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    mesh = make_model_mesh(MESH_TRAIN_GRID)
    shape = ShapeConfig("t", 16, 4, "train")
    out = {}
    for name, leaf in MESH_TRAIN_ARCHS.items():
        cfg = _mesh_train_cfg(name)
        opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup=1, total_steps=10,
                                state_dtype=cfg.opt_dtype)
        ctx = make_shard_ctx(cfg, shape, mesh)
        specs = param_pspecs(cfg, ctx, mesh=mesh)
        # the CPU's seeded state (a card generator draws other numbers),
        # its blocks moved to the card
        state = TS.shard_train_state(
            TS.init_train_state(cfg, 0, opt, device="cpu"), cfg, ctx, mesh)

        def card(tree):
            return tree_map(lambda a: a.cuda(), tree)

        state = TS.TrainState(card(state.params), adamw.AdamWState(
            state.opt.step.cuda(), card(state.opt.m), card(state.opt.v)))
        rows = put({k: v.cuda() for k, v in _train_batch(cfg, 4).items()},
                   batch_pspecs(cfg, shape, ctx), mesh)

        def host(tree):
            return tree_map(lambda a: a.cpu().numpy(), tree)

        with mesh_context(mesh):
            before = host(gather(state.params, specs, mesh))
            grads = host(gather(TS.loss_and_grads(cfg, state.params, rows,
                                                  ctx)[2], specs, mesh))
            flash_prefill_cuda.launches = gqa_decode_cuda.launches = 0
            state, m = TS.make_train_step(cfg, opt, 1, ctx)(state, rows)
            launches = (flash_prefill_cuda.launches,
                        gqa_decode_cuda.launches)
            after = {"params": host(gather(state.params, specs, mesh)),
                     "m": host(gather(state.opt.m, specs, mesh)),
                     "v": host(gather(state.opt.v, specs, mesh))}
        block = dict(tree_leaves(state.params))[leaf]
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "before": before, "grads": grads, "after": after,
                     "block": block.cpu().numpy().tobytes(),
                     "block_numel": block.numel(), "launches": launches}
    return out


@pytest.fixture(scope="module")
def mesh_train_ranks():
    """One spawn of 4 gloo ranks sharing the card for every config of
    ``MESH_TRAIN_ARCHS``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.launch.mesh import spawn
    return spawn(mesh_train_rank, 4)


def _check_mesh_train(name, ranks):
    """The ranks' run of ``name`` against one process on the CPU, from the
    same seed's state and batch: the loss and grad norm within 1e-5
    relative, the gradients within 1e-4 of each leaf's largest magnitude,
    m and v within lr x 1e-3 of the CPU's, the params within lr x 1e-3 of
    the CPU's AdamW update of the card's gradients (the rule of the train
    card test above), the leaf a different quarter on each rank, neither
    attention kernel launched."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cfg = _mesh_train_cfg(name)
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup=1, total_steps=10,
                            state_dtype=cfg.opt_dtype)
    cpu = torch.device("cpu")
    batch = _train_batch(cfg, 4)
    state = TS.init_train_state(cfg, 0, opt, device=cpu)
    _, _, g_cpu = TS.loss_and_grads(cfg, state.params, batch)
    host, m_cpu = TS.make_train_step(cfg, opt)(
        TS.init_train_state(cfg, 0, opt, device=cpu), batch)
    got = [r[name] for r in ranks]
    whole = dict(tree_leaves(state.params))[MESH_TRAIN_ARCHS[name]].numel()
    assert len({r["block"] for r in got}) == 4
    for r in got:
        assert r["block_numel"] * 4 == whole and r["launches"] == (0, 0)
        for key in ("loss", "grad_norm"):
            assert abs(r["metrics"][key] - float(m_cpu[key])) <= \
                1e-5 * abs(float(m_cpu[key])), key
        for (key, a), (_, b) in zip(tree_leaves(r["before"]),
                                    tree_leaves(state.params)):
            assert np.array_equal(a, b.numpy()), key
        for (key, a), (_, b) in zip(tree_leaves(r["grads"]),
                                    tree_leaves(g_cpu)):
            assert float(np.abs(a - b.numpy()).max()) <= \
                1e-4 * float(b.abs().max()), key
        want, _, _ = adamw.update(
            tree_map(torch.from_numpy, r["grads"]),
            TS.init_train_state(cfg, 0, opt, device=cpu).opt,
            TS.init_train_state(cfg, 0, opt, device=cpu).params, opt)
        for got_t, ref in ((r["after"]["params"], want),
                           (r["after"]["m"], host.opt.m),
                           (r["after"]["v"], host.opt.v)):
            for (key, a), (_, b) in zip(tree_leaves(got_t),
                                        tree_leaves(ref)):
                assert float(np.abs(a - b.numpy()).max()) <= \
                    TRAIN_LR * 1e-3, key


def test_mesh_train_of_four_ranks_on_the_card_matches_the_cpu(
        cuda, mesh_train_ranks):
    """The sharded train step over 4 gloo ranks sharing the card on a (2,
    2) grid against one process on the CPU (``_check_mesh_train``):
    qwen3-32b-smoke, ``wq`` a different quarter on each rank."""
    _check_mesh_train("qwen3-32b-smoke", mesh_train_ranks)


@pytest.mark.parametrize("name", [n for n in MESH_TRAIN_ARCHS
                                  if not n.startswith("qwen3")])
def test_mesh_train_of_moe_and_mla_on_the_card_matches_the_cpu(
        cuda, mesh_train_ranks, name):
    """The moe kind and MLA in the sharded train step on the card against
    the CPU (``_check_mesh_train``): mixtral's experts split on their
    width, arctic's 16 on E (the EP route: its all-gather of card
    tensors) beside its dense residual, minicpm3's MLA heads; each
    expert's ``wi`` (MLA's ``wo``) a different quarter on each rank."""
    _check_mesh_train(name, mesh_train_ranks)
