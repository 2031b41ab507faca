"""The port's checkpoint store and snapshot layout, on the CPU.

The cases of tests/test_checkpoint.py, tests/test_store_corruption.py and
the ``dirs``-layout and crash-mid-save cases of tests/test_snapshot.py, run
on ``repro_torch.store`` with the same hypothesis settings; then the files
both packages write: the same leaf names, the same bytes, and a ``dirs``
snapshot written by either package restores in the other to the same
recovered state."""
import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip(
    "hypothesis",
    reason="dev-only dependency; pip install -r requirements-dev.txt")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import engine as JE  # noqa: E402
from repro.store import checkpoint as JC  # noqa: E402
from repro.store.snapshot import Snapshotter as JSnapshotter  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402
from repro_torch.core.durable_set import SetState  # noqa: E402
from repro_torch.store import checkpoint as TC  # noqa: E402
from repro_torch.store.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.store.snapshot import Snapshotter  # noqa: E402
from repro_torch.store.tensorstore import DurableArea  # noqa: E402


def tree(step):
    return {"layer": {"w": np.full((4, 4), float(step)),
                      "b": np.arange(step + 1, dtype=np.int32)},
            "step_arr": np.array([step])}


def _copy_state(state):
    return SetState(*(t.clone() for t in state))


def _assert_states_equal(got, want, skip=("n_psync", "n_ops")):
    got = state_to_numpy(got)
    for f in SetState._fields:
        if f in skip:
            continue
        w = want[f] if isinstance(want, dict) else np.asarray(
            getattr(want, f))
        assert got[f].dtype == w.dtype, (f, got[f].dtype, w.dtype)
        np.testing.assert_array_equal(got[f], w, err_msg=f"field {f}")


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2, 3):
        m.save(s, tree(s))
    m.close()
    m2 = CheckpointManager(str(tmp_path))
    assert m2.latest_step() == 3
    r = m2.restore(like=tree(3))
    np.testing.assert_array_equal(r["layer"]["w"], tree(3)["layer"]["w"])
    r1 = m2.restore(step=2, like=tree(2))
    np.testing.assert_array_equal(r1["layer"]["w"], tree(2)["layer"]["w"])
    m2.close()


def test_restore_like_tensors_gives_tensors(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "n": [torch.tensor(7, dtype=torch.int32)]})
    like = {"w": torch.zeros((2, 3), dtype=torch.float64),
            "n": [torch.zeros((), dtype=torch.int32)]}
    r = m.restore(like=like)
    assert r["w"].dtype == torch.float64 and r["n"][0].dtype == torch.int32
    assert r["w"].tolist() == [[0, 1, 2], [3, 4, 5]] and int(r["n"][0]) == 7
    m.close()


def test_gc_patches_deleted(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(1, tree(1))
    m.save(2, tree(2))
    m.close()
    m2 = CheckpointManager(str(tmp_path))
    assert m2.committed == [2]          # step 1 destroyed, never rewritten
    m2.close()


def test_single_fsync_per_record_soft(tmp_path):
    m = CheckpointManager(str(tmp_path), mode="soft", keep=5)
    m.save(1, tree(1))
    # 3 leaves + 1 commit record == 4 fsyncs, the SOFT bound
    assert m.fsyncs == 4
    m.close()
    m2 = CheckpointManager(str(tmp_path) + "_lf", mode="linkfree", keep=5)
    m2.save(1, tree(1))
    assert m2.fsyncs == 8               # link-free pays the pointer persist
    m2.close()


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    fut = m.save(1, tree(1), async_=True)
    fut.result()
    m.save(2, tree(2), async_=True)
    m.wait()
    assert m.committed[-1] == 2
    m.close()


def test_async_save_snapshots_the_tree_at_the_call(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = {"w": torch.zeros(4), "v": np.zeros(3)}
    fut = m.save(1, t, async_=True)
    t["w"].add_(1)
    t["v"] += 1
    fut.result()
    r = m.restore(1)
    assert r["w"].tolist() == [0] * 4 and r["v"].tolist() == [0] * 3
    m.close()


@settings(max_examples=25, deadline=None)
@given(cut=st.integers(1, 400))
def test_kill9_truncation_never_corrupts(tmp_path_factory, cut):
    """Truncating the tail anywhere must leave all fully-committed earlier
    steps restorable (the paper's invalid-node rule on disk)."""
    d = tmp_path_factory.mktemp("ckpt")
    m = CheckpointManager(str(d), keep=5)
    m.save(1, tree(1))
    size1 = os.path.getsize(m.area.path)
    m.save(2, tree(2))
    m.close()
    path = os.path.join(str(d), "area_00000.pdn")
    size2 = os.path.getsize(path)
    keep_bytes = max(size1, size2 - cut)
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    m2 = CheckpointManager(str(d))
    assert 1 in m2.committed
    r = m2.restore(step=1, like=tree(1))
    np.testing.assert_array_equal(r["layer"]["w"], tree(1)["layer"]["w"])
    m2.close()


def test_flipped_byte_detected(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=5)
    m.save(1, tree(1))
    m.close()
    path = os.path.join(str(tmp_path), "area_00000.pdn")
    with open(path, "r+b") as f:       # corrupt a payload byte
        f.seek(64)
        b = f.read(1)
        f.seek(64)
        f.write(bytes([b[0] ^ 0xFF]))
    # the scan drops the flipped record (the first, at offset 0)
    assert all(rec.offset != 0 for rec, _ in DurableArea.scan(path))
    m2 = CheckpointManager(str(tmp_path))
    assert 1 not in m2.committed        # CRC catches the flip
    m2.close()


def test_elastic_restore_new_sharding_names_its_roadmap_item(tmp_path):
    """The JAX package re-shards onto a NamedSharding at restore; one GPU
    has no such layout, so ``shardings=`` raises naming its item."""
    m = CheckpointManager(str(tmp_path), keep=2)
    t = {"w": np.arange(16, dtype=np.float32).reshape(4, 4)}
    m.save(1, t)
    with pytest.raises(NotImplementedError, match="item 13"):
        m.restore(like=t, shardings={"w": object()})
    np.testing.assert_array_equal(m.restore(like=t)["w"], t["w"])
    m.close()


# ---------------------------------------------------------------------------
# tests/test_store_corruption.py
# ---------------------------------------------------------------------------


def _tree(step):
    return {"w": np.arange(64, dtype=np.float32) + step,
            "b": np.full((8,), step, np.int32)}


@settings(max_examples=40, deadline=None)
@given(offset_frac=st.floats(0.0, 0.999), flip=st.integers(1, 255))
def test_single_byte_flip_never_corrupts(tmp_path_factory, offset_frac, flip):
    d = tmp_path_factory.mktemp("ckpt")
    m = CheckpointManager(str(d), keep=5)
    m.save(1, _tree(1))
    m.save(2, _tree(2))
    m.close()
    path = os.path.join(str(d), "area_00000.pdn")
    size = os.path.getsize(path)
    pos = int(offset_frac * size)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ flip]))

    m2 = CheckpointManager(str(d))
    for step in m2.committed:          # every surviving step restores EXACTLY
        r = m2.restore(step=step)
        expect = _tree(step)
        for k in expect:
            np.testing.assert_array_equal(r[k], expect[k])
    m2.close()


# ---------------------------------------------------------------------------
# tests/test_snapshot.py: dirs layout and crash mid-save
# ---------------------------------------------------------------------------


def test_dirs_layout_commit_and_reopen(tmp_path):
    d = str(tmp_path / "cm")
    cm = CheckpointManager(d, layout="dirs", keep=2)
    cm.save(1, {"a": np.arange(5), "n": {"b": np.ones((2, 2))}},
            extra={"watermark": 7})
    cm.save(2, {"a": np.arange(6), "n": {"b": np.zeros((2, 2))}},
            extra={"watermark": 9})
    assert cm.latest_step() == 2
    assert cm.extra() == {"watermark": 9}
    cm.close()
    cm2 = CheckpointManager(d, layout="dirs")    # restart: rescan the dir
    assert cm2.latest_step() == 2
    r = cm2.restore(2)
    np.testing.assert_array_equal(r["a"], np.arange(6))
    assert r["n/b"].shape == (2, 2)
    assert cm2.extra(1) == {"watermark": 7}
    cm2.close()


def test_dirs_layout_partial_saves_never_selected(tmp_path):
    d = str(tmp_path / "cm")
    cm = CheckpointManager(d, layout="dirs")
    cm.save(2, {"a": np.arange(4)})
    cm.close()
    # crash mid-save: tmp dir full of planes but never renamed
    os.makedirs(d + "/.tmp-step_000000000003")
    np.save(d + "/.tmp-step_000000000003/a.npy", np.arange(3))
    # crash after rename that somehow lost a leaf: manifest re-verified
    shutil.copytree(d + "/step_000000000002", d + "/step_000000000004")
    os.remove(d + "/step_000000000004/a.npy")
    # unreadable manifest == not committed
    os.makedirs(d + "/step_000000000005")
    with open(d + "/step_000000000005/manifest.json", "w") as f:
        f.write("{truncated")
    cm2 = CheckpointManager(d, layout="dirs")
    assert cm2.latest_step() == 2, cm2.committed
    cm2.close()


def _rows_tree(rng, s=8):
    return {"keys": rng.integers(-5, 99, (s, 32)).astype(np.int32),
            "bkeys": rng.integers(0, 9, (s, 4, 8)).astype(np.int32),
            "overflow": rng.random(s) > 0.5,
            "size": rng.integers(0, 32, s).astype(np.int32)}


@pytest.mark.parametrize("order", ((0, 1, 2, 3), (3, 1, 0, 2)))
def test_dirs_rows_from_several_writers_equal_one_save(tmp_path, order):
    """A step created by one manager (``begin_rows``), whose rows four
    managers of the same directory write in any order (``write_rows``),
    and committed by the first (``commit_rows``): the files and the
    manifest equal one ``save`` of the whole arrays byte for byte, the
    bytes written add up to save's, and a mapped restore reads the rows."""
    rng = np.random.default_rng(31)
    tree, extra = _rows_tree(rng), {"kind": "sharded_map", "w": [1, 2]}
    one = CheckpointManager(str(tmp_path / "one"), layout="dirs")
    one.save(5, tree, extra=extra)
    d = str(tmp_path / "rows")
    lead = CheckpointManager(d, layout="dirs")
    lead.begin_rows(5, {k: (v.dtype, v.shape) for k, v in tree.items()})
    assert lead.latest_step() is None                # nothing committed
    writers = [lead] + [CheckpointManager(d, layout="dirs")
                        for _ in range(3)]
    for r in order:
        writers[r].write_rows(5, 2 * r, {k: v[2 * r:2 * r + 2]
                                         for k, v in tree.items()})
    assert CheckpointManager(d, layout="dirs").latest_step() is None
    lead.commit_rows(5, extra=extra)
    step = "step_000000000005"
    files = sorted(os.listdir(os.path.join(one.dir, step)))
    assert files == sorted(os.listdir(os.path.join(d, step)))
    for fn in files:
        with open(os.path.join(one.dir, step, fn), "rb") as a, \
                open(os.path.join(d, step, fn), "rb") as b:
            assert a.read() == b.read(), fn
    assert one.bytes_written == sum(w.bytes_written for w in writers)
    got = CheckpointManager(d, layout="dirs").restore(5, mmap=True)
    for k, v in tree.items():
        assert isinstance(got[k], np.memmap), k
        np.testing.assert_array_equal(got[k][2:4], v[2:4], err_msg=k)


def test_dirs_rows_refused_where_they_do_not_fit_or_the_step_is_unseen(
        tmp_path):
    """``write_rows`` raises ``FileNotFoundError`` in a directory that
    never saw the step, and ``ValueError`` for rows of another dtype or
    width or past the stored rows; an uncommitted step stays ignored
    ``.tmp-*`` residue."""
    rng = np.random.default_rng(32)
    tree = _rows_tree(rng)
    lead = CheckpointManager(str(tmp_path / "a"), layout="dirs")
    lead.begin_rows(1, {k: (v.dtype, v.shape) for k, v in tree.items()})
    other = CheckpointManager(str(tmp_path / "b"), layout="dirs")
    with pytest.raises(FileNotFoundError):
        other.write_rows(1, 0, {"keys": tree["keys"][:2]})
    for rows, at in ((tree["keys"][:2].astype(np.int64), 0),
                     (tree["keys"][:2, :16], 0), (tree["keys"][:2], 7)):
        with pytest.raises(ValueError):
            lead.write_rows(1, at, {"keys": rows})
    assert CheckpointManager(lead.dir, layout="dirs").latest_step() is None
    assert os.listdir(lead.dir) == [".tmp-step_000000000001"]


def test_dirs_layout_gc_keeps_newest(tmp_path):
    d = str(tmp_path / "cm")
    cm = CheckpointManager(d, layout="dirs", keep=2)
    for s in (1, 2, 3):
        cm.save(s, {"a": np.full((4,), s)})
    assert cm.committed == [2, 3]
    assert not os.path.exists(d + "/step_000000000001")
    assert cm.restore(3)["a"].tolist() == [3, 3, 3, 3]
    cm.close()


def _kill_after(monkeypatch, n_calls):
    """Kill the save after ``n_calls`` plane writes: np.save raises, the
    build thread dies mid-save, the tmp dir is left partially written --
    exactly what SIGKILL between plane writes leaves behind."""
    real_save, calls = np.save, [0]

    def killer(f, arr, *a, **kw):
        calls[0] += 1
        if calls[0] > n_calls:
            raise RuntimeError("simulated kill-9 between plane writes")
        return real_save(f, arr, *a, **kw)

    monkeypatch.setattr("repro_torch.store.checkpoint.np.save", killer)


def test_crash_kill_between_plane_writes(tmp_path, monkeypatch):
    from repro_torch.obs import MetricsRegistry
    rng = np.random.default_rng(8)
    m = TE.DurableMap(TE.SetSpec(capacity=512, backend="bucket"),
                      metrics=MetricsRegistry(), device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    m.insert(np.arange(1, 150, dtype=np.int32))
    sn.snapshot()
    sn.wait()                                # snapshot 1: committed
    m.insert(np.arange(200, 280, dtype=np.int32))
    _kill_after(monkeypatch, 2)              # snapshot 2 dies mid-save
    sn.snapshot()
    m.remove(np.arange(1, 40, dtype=np.int32))   # delta keeps growing
    ref = TE.DurableMap(m.spec, device="cpu")
    ref.state = _copy_state(m.state)
    u = rng.random(512).astype(np.float32)
    ref.crash_and_recover(u)
    sn.recover(u)                            # prior snapshot + larger delta
    _assert_states_equal(m.state, state_to_numpy(ref.state))
    assert sn.store.latest_step() == 1       # the dead build never commits
    g = m._m.snapshot()["gauges"]
    assert g["map.last_recovery_from_delta_slots"] > 0
    sn.close()


def test_crash_kill_before_rename(tmp_path, monkeypatch):
    """Kill at the worst point: every plane + manifest written, rename not
    reached.  The full tmp dir is ignored and a RESTARTED snapshotter
    (fresh directory scan) recovers through the prior snapshot."""
    rng = np.random.default_rng(9)
    m = TE.DurableMap(TE.SetSpec(capacity=256, backend="scan"), device="cpu")
    d = str(tmp_path / "snap")
    sn = Snapshotter(m, d)
    m.insert(np.arange(1, 80, dtype=np.int32))
    sn.snapshot()
    sn.wait()
    m.insert(np.arange(100, 140, dtype=np.int32))
    monkeypatch.setattr("repro_torch.store.checkpoint.os.rename",
                        lambda *a: (_ for _ in ()).throw(
                            RuntimeError("simulated kill-9 before rename")))
    f = sn.snapshot()
    with pytest.raises(RuntimeError):
        f.result()
    monkeypatch.undo()
    ref = TE.DurableMap(m.spec, device="cpu")
    ref.state = _copy_state(m.state)
    u = rng.random(256).astype(np.float32)
    ref.crash_and_recover(u)
    sn.close()
    sn2 = Snapshotter(m, d)                  # restart: rescan the store dir
    assert sn2.store.latest_step() == 1
    assert any(fn.startswith(".tmp-") for fn in os.listdir(d))
    sn2.recover(u)
    _assert_states_equal(m.state, state_to_numpy(ref.state))
    sn2.close()


# ---------------------------------------------------------------------------
# the same files in both packages
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    a: object
    b: object


NESTED = {"n": {"b": np.ones(2, np.float32),
                "a": [np.zeros(1, np.int32), (np.ones(3), None)]},
          "t": Pair(np.arange(2), {"z": np.int32(1), "y": np.bool_(True)}),
          "s": 5}


def test_leaf_names_are_jax_names():
    """A dict key ``n/b``, a list item ``l/0``, a NamedTuple field
    ``t/.a``, None an empty subtree, in JAX's order -- also for a whole
    SetState of each package."""
    got, want = TC._flatten(NESTED), JC._flatten(NESTED)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    tstate = TE.make_state(TE.SetSpec(capacity=16, backend="bucket"),
                           device="cpu")
    jstate = JE.make_state(JE.SetSpec(capacity=16, backend="bucket"))
    assert list(TC._flatten({"s": tstate})) == \
        list(JC._flatten({"s": jstate})) == \
        [f"s/.{f}" for f in SetState._fields]


@pytest.mark.parametrize("layout", ("area", "dirs"))
def test_both_packages_write_the_same_checkpoint(tmp_path, layout):
    """The same tree saved by each package: byte-identical area files, or
    the same ``dirs`` files with the same manifest; each restores the
    other's."""
    dirs = {}
    for name, mod in (("jax", JC), ("torch", TC)):
        d = str(tmp_path / name)
        cm = mod.CheckpointManager(d, layout=layout)
        cm.save(3, NESTED, extra={"watermark": 4} if layout == "dirs"
                else None)
        cm.close()
        dirs[name] = d
    if layout == "area":
        for fn in os.listdir(dirs["jax"]):
            with open(os.path.join(dirs["jax"], fn), "rb") as a, \
                    open(os.path.join(dirs["torch"], fn), "rb") as b:
                assert a.read() == b.read(), fn
    else:
        step = "step_000000000003"
        mans = []
        for d in dirs.values():
            with open(os.path.join(d, step, "manifest.json")) as f:
                mans.append(json.load(f))
        assert mans[0] == mans[1]
        assert list(mans[0]["leaves"]) == list(mans[1]["leaves"])
    for reader, writer in ((TC, "jax"), (JC, "torch")):
        cm = reader.CheckpointManager(dirs[writer], layout=layout)
        got = cm.restore(3)
        want = JC._flatten(NESTED)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        cm.close()


def _map_pair(backend, n):
    spec = dict(capacity=n, backend=backend)
    return (JE.DurableMap(JE.SetSpec(**spec)),
            TE.DurableMap(TE.SetSpec(**spec), device="cpu"))


def _both(maps, name, *args):
    for m in maps:
        getattr(m, name)(*args)


@pytest.mark.parametrize("backend", ("bucket", "scan"))
@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_dirs_snapshot_restores_across_packages(tmp_path, writer, backend):
    """A snapshot written by one package's Snapshotter recovers through the
    other's to the state the writer's own recovery reaches, leaf for leaf,
    with the same histogram."""
    rng = np.random.default_rng(21)
    n = 512
    jm, tm = maps = _map_pair(backend, n)
    keys = (rng.permutation(4 * n)[: n // 2] + 1).astype(np.int32)
    _both(maps, "insert", keys[:150], keys[:150] * 3)
    _both(maps, "remove", keys[:30])
    d = str(tmp_path / "snap")
    if writer == "jax":
        w = JSnapshotter(jm, d)
        w.snapshot()
        w.wait()
        tm.snapshot_capture()                # the same stamp generation
    else:
        w = Snapshotter(tm, d)
        w.snapshot()
        w.wait()
        jm.snapshot_capture()
    w.close()
    _both(maps, "insert", keys[150:220])
    _both(maps, "remove", keys[40:90])
    _both(maps, "insert", keys[:20])
    _assert_states_equal(tm.state, jm.state, skip=())
    u = rng.random(n).astype(np.float32)
    jsn, tsn = JSnapshotter(jm, d), Snapshotter(tm, d)
    jsn.recover(jnp.asarray(u))
    tsn.recover(u)
    _assert_states_equal(tm.state, jm.state, skip=())
    np.testing.assert_array_equal(tm.last_recovery_hist,
                                  jm.last_recovery_hist)
    jsn.close()
    tsn.close()


@pytest.mark.parametrize("backend", ("bucket", "scan"))
def test_both_packages_write_the_same_snapshot_files(tmp_path, backend):
    """One state, snapshotted by each package: the same files, leaf names,
    manifest and ``.npy`` dtypes, shapes and values."""
    rng = np.random.default_rng(22)
    maps = _map_pair(backend, 256)
    keys = (rng.permutation(1024)[:120] + 1).astype(np.int32)
    _both(maps, "insert", keys, keys * 7)
    _both(maps, "remove", keys[:25])
    dirs = {}
    for name, cls, m in (("jax", JSnapshotter, maps[0]),
                         ("torch", Snapshotter, maps[1])):
        dirs[name] = str(tmp_path / name)
        sn = cls(m, dirs[name])
        sn.snapshot()
        sn.wait()
        sn.close()
    step = "step_000000000001"
    files = [sorted(os.listdir(os.path.join(d, step)))
             for d in dirs.values()]
    assert files[0] == files[1]
    mans = []
    for d in dirs.values():
        with open(os.path.join(d, step, "manifest.json")) as f:
            mans.append(json.load(f))
    assert mans[0] == mans[1]
    assert list(mans[0]["leaves"]) == list(mans[1]["leaves"])
    for fn in files[0]:
        if fn.endswith(".npy"):
            a, b = (np.load(os.path.join(d, step, fn))
                    for d in dirs.values())
            assert a.dtype == b.dtype and a.shape == b.shape, fn
            np.testing.assert_array_equal(a, b, err_msg=fn)
