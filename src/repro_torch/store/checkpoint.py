"""Checkpoint manager over the SOFT durable tensor store.

Two on-disk layouts, selected by ``layout=``:

``area`` (default, the original)
    One durable-area file per (host, writer-shard) under ``directory``.  A
    checkpoint step is a set of leaf records plus one ``__commit__`` record
    whose payload lists the expected leaf names -- the commit record's
    single fsync is the checkpoint's durability point (its linearization
    point, in the paper's terms).  Restore scans all areas, keeps the
    newest step whose commit record is valid and whose leaves are all
    present, and materializes the pytree -- onto ANY mesh/sharding
    (elastic restore), since records hold full logical arrays keyed by
    tree path.

``dirs`` (snapshot layout, DESIGN.md §11)
    One directory per step.  A save writes every leaf as an ``.npy`` file
    plus a ``manifest.json`` into a hidden ``.tmp-step_*`` directory,
    fsyncs each file and the directory itself, then ``os.rename``s it to
    ``step_{step:012d}`` and fsyncs the parent -- the rename IS the commit
    point, atomic under POSIX.  Latest-step discovery lists only committed
    ``step_*`` directories and re-verifies the manifest against the files
    actually present, so a crash ANYWHERE mid-save (between plane writes,
    before the rename, even mid-rename) leaves at worst an ignored tmp
    directory: a partially-written snapshot can never be selected as
    "latest".  Large-plane saves stream straight to their own files, which
    is what the background snapshotter wants (no area-file compaction).

Kill-9 safety (area): a crash leaves either (a) a torn leaf/commit record
-> invalid by validity words/CRC -> step ignored, or (b) a completed commit
-> step fully restorable.  GC of superseded steps patches ``deleted`` words
(one fsync each), reproducing PNode::destroy.

PyTorch port of ``repro.store.checkpoint``: the same on-disk formats, and
leaf names that are JAX's byte for byte (a dict key ``n/b``, a list item
``l/0``, a NamedTuple field ``t/.a``), so a checkpoint or snapshot written
by either package restores in the other.  Trees are dicts, lists, tuples
and NamedTuples of numpy arrays, torch tensors or scalars; ``None`` is an
empty subtree, as in JAX.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor, Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.store.tensorstore import (BF16_BITS, DurableArea, Record,
                                           decode_array, encode_array,
                                           write_npy)

COMMIT = "__commit__"
_READ_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _map_with_path(fn, tree, path=()):
    """``fn(name, leaf)`` at every leaf of ``tree``, visited in JAX's
    flatten order (dict keys sorted, sequences and NamedTuple fields in
    order), with JAX's leaf name (path entries joined by ``/``: a dict
    key, a sequence index, ``.field`` for a NamedTuple).  Returns a tree
    of the same structure holding the results."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + ("." + f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor as its 16-bit pattern viewed
    as ``BF16_BITS``, which the store writes with the JAX store's header."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=copy)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_BITS)
        return host.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    out = {}

    def put(name, leaf):
        out[name] = _to_numpy(leaf)
    _map_with_path(put, tree)
    return out


def _like(arr: np.ndarray, leaf):
    """``arr`` as the kind of ``leaf``: a tensor on its device at its dtype,
    else a numpy array at its dtype.  A 2-byte void array (a bf16 leaf
    written by either package) restores into a bf16 tensor by its bit
    pattern."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype == BF16_BITS and leaf.dtype == torch.bfloat16:
            bits = torch.from_numpy(np.array(arr.view(np.int16)))
            return bits.view(torch.bfloat16).to(leaf.device)
        return torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)
    return np.asarray(arr, dtype=getattr(leaf, "dtype", None))


def _leaf_file(name: str) -> str:
    """The file of leaf ``name`` in a step directory."""
    return name.replace("/", "__") + ".npy"


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, mode: str = "soft",
                 host: int = 0, keep: int = 2, layout: str = "area"):
        if layout not in ("area", "dirs"):
            raise ValueError(f"layout must be 'area' or 'dirs', got "
                             f"{layout!r}")
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.mode = mode
        self.host = host
        self.keep = keep
        self.layout = layout
        self.bytes_written = 0                # payload bytes fsynced to disk
        self.area = None
        self._dir_fsyncs = 0
        if layout == "area":
            self.area = DurableArea(
                os.path.join(directory, f"area_{host:05d}.pdn"), mode=mode)
        self.index: Dict[int, Dict[str, Any]] = {}        # volatile only
        self.committed: List[int] = []
        self._extra: Dict[int, Any] = {}      # dirs-layout manifest extras
        self._open_rows: Dict[int, List[str]] = {}   # begun, not committed
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._recover_index()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, async_: bool = False, extra=None):
        """Persist ``tree`` as checkpoint ``step``.  ``extra`` (dirs layout
        only) is a JSON-able blob stored in the manifest -- snapshot
        watermarks and histograms ride here."""
        if extra is not None and self.layout != "dirs":
            raise ValueError("extra= requires layout='dirs'")
        if async_:
            self.wait()
            host_tree = _map_with_path(               # snapshot now
                lambda _, leaf: _to_numpy(leaf, copy=True), tree)
            self._pending = self._pool.submit(self._save_sync, step,
                                              host_tree, extra)
            return self._pending
        return self._save_sync(step, tree, extra)

    def _save_sync(self, step: int, tree, extra=None):
        if self.layout == "dirs":
            return self._save_sync_dirs(step, tree, extra)
        leaves = _flatten(tree)
        recs: Dict[str, Record] = {}
        for name, arr in leaves.items():
            payload = encode_array(arr)
            recs[name] = self.area.append(step, name, payload)
            self.bytes_written += len(payload)
        manifest = json.dumps(sorted(leaves)).encode()
        recs[COMMIT] = self.area.append(step, COMMIT, manifest)
        self.bytes_written += len(manifest)
        # volatile publish -- after the durability point, like SOFT's
        # state change to INSERTED after PNode::create's psync.
        self.index[step] = recs
        self.committed.append(step)
        self._gc()
        return step

    def _save_sync_dirs(self, step: int, tree, extra=None):
        leaves = _flatten(tree)
        tmp = self._fresh_tmp(step)
        for name, arr in leaves.items():
            p = os.path.join(tmp, _leaf_file(name))
            with open(p, "wb") as f:
                write_npy(f, arr)
                f.flush()
                os.fsync(f.fileno())
            self._dir_fsyncs += 1
            self.bytes_written += os.path.getsize(p)
        return self._commit_tmp(step, list(leaves), extra)

    def _tmp_path(self, step: int) -> str:
        return os.path.join(self.dir, f".tmp-step_{step:012d}")

    def _fresh_tmp(self, step: int) -> str:
        tmp = self._tmp_path(step)
        if os.path.exists(tmp):          # garbage from a crashed save
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def _commit_tmp(self, step: int, names, extra) -> int:
        """Write the manifest of ``step``'s tmp directory (its leaves
        ``names`` in flatten order, whose files are durable), fsync the
        directory and rename it: the commit point."""
        tmp = self._tmp_path(step)
        final = os.path.join(self.dir, f"step_{step:012d}")
        manifest = {"step": step,
                    "leaves": {n: _leaf_file(n) for n in names},
                    "extra": extra}
        mp = os.path.join(tmp, "manifest.json")
        with open(mp, "wb") as f:
            f.write(json.dumps(manifest).encode())
            f.flush()
            os.fsync(f.fileno())
        self._dir_fsyncs += 1
        self.bytes_written += os.path.getsize(mp)
        _fsync_dir(tmp)                  # entries durable before the rename
        self._dir_fsyncs += 1
        if os.path.exists(final):        # re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)            # THE commit point (atomic)
        _fsync_dir(self.dir)             # the rename itself is durable
        self._dir_fsyncs += 1
        self.index[step] = {n: os.path.join(final, fn)
                            for n, fn in manifest["leaves"].items()}
        self._extra[step] = extra
        if step in self.committed:
            self.committed.remove(step)
        self.committed.append(step)
        self._gc()
        return step

    # -- one step written by several processes (dirs layout) ------------------
    #
    # A map whose rows are partitioned over the ranks of a process group
    # writes each step from every rank: the committing process creates the
    # step's tmp directory with every leaf's file at its whole shape
    # (begin_rows), each process writes the byte range of its own rows
    # (write_rows), and the committing process writes the manifest and
    # renames (commit_rows).  The files are byte for byte the ones save()
    # writes for the whole arrays.

    def begin_rows(self, step: int, layout: Dict[str, tuple]):
        """Create ``step``'s tmp directory holding, for each leaf name of
        ``layout`` (name -> (numpy dtype, whole shape)), its ``.npy`` file
        at that shape: ``np.save``'s header, then zeros (a sparse file)
        until :meth:`write_rows` fills them.  Returns nothing; nothing is
        committed until :meth:`commit_rows`."""
        if self.layout != "dirs":
            raise ValueError("begin_rows requires layout='dirs'")
        tmp = self._fresh_tmp(step)
        for name in sorted(layout):
            dtype, shape = layout[name]
            dtype = np.dtype(dtype)
            p = os.path.join(tmp, _leaf_file(name))
            with open(p, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": np.lib.format.dtype_to_descr(dtype),
                        "fortran_order": False, "shape": tuple(shape)})
                self.bytes_written += f.tell()
                f.truncate(f.tell() + dtype.itemsize
                           * int(np.prod(shape, dtype=np.int64)))
        self._open_rows[step] = sorted(layout)  # a flat dict's flatten order

    def write_rows(self, step: int, start: int, planes: Dict[str, Any]):
        """Write rows ``start .. start + k - 1`` of each leaf of ``planes``
        (name -> its k rows) into the files :meth:`begin_rows` created for
        ``step``, then flush and fsync each.  Raises ``FileNotFoundError``
        where this process's view of the directory lacks the step, and
        ``ValueError`` where a file's shape or dtype does not take the
        rows."""
        tmp = self._tmp_path(step)
        for name in sorted(planes):
            rows = np.ascontiguousarray(planes[name])
            with open(os.path.join(tmp, _leaf_file(name)), "r+b") as f:
                shape, _, dtype = _READ_HEADER[np.lib.format.read_magic(f)](f)
                if (dtype != rows.dtype or shape[1:] != rows.shape[1:]
                        or start + rows.shape[0] > shape[0]):
                    raise ValueError(
                        f"{name}: rows {start}:{start + rows.shape[0]} "
                        f"{rows.dtype}{rows.shape[1:]} do not fit the "
                        f"stored {dtype}{shape}")
                row = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
                f.seek(f.tell() + start * row)
                f.write(rows.tobytes())
                f.flush()
                os.fsync(f.fileno())
            self._dir_fsyncs += 1
            self.bytes_written += rows.nbytes

    def commit_rows(self, step: int, extra=None) -> int:
        """Commit ``step`` once every process's :meth:`write_rows` has
        ended: the manifest, the directory's fsync and the rename, as
        :meth:`save` ends.  Only the process that called
        :meth:`begin_rows` commits."""
        return self._commit_tmp(step, self._open_rows.pop(step), extra)

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- restore --------------------------------------------------------------
    def _recover_index(self):
        if self.layout == "dirs":
            return self._recover_index_dirs()
        by_step: Dict[int, Dict[str, Record]] = {}
        for fn in sorted(os.listdir(self.dir)):
            if not fn.endswith(".pdn"):
                continue
            for rec, live in DurableArea.scan(os.path.join(self.dir, fn)):
                if live:
                    by_step.setdefault(rec.step, {})[rec.name] = rec
        self.index = {}
        self.committed = []
        for step, recs in sorted(by_step.items()):
            commit = recs.get(COMMIT)
            if commit is None:
                continue
            names = json.loads(self._payload(commit))
            if all(n in recs for n in names):
                self.index[step] = recs
                self.committed.append(step)

    def _recover_index_dirs(self):
        """Latest-step discovery: only a COMMITTED ``step_*`` directory
        whose manifest parses and whose every listed leaf file exists is
        eligible -- ``.tmp-*`` residue of a crashed save is skipped (and
        can never shadow an older complete snapshot)."""
        self.index, self.committed, self._extra = {}, [], {}
        for fn in sorted(os.listdir(self.dir)):
            p = os.path.join(self.dir, fn)
            if not (fn.startswith("step_") and os.path.isdir(p)):
                continue
            try:
                with open(os.path.join(p, "manifest.json"), "rb") as f:
                    man = json.loads(f.read())
                leaves = man["leaves"]
                if not all(os.path.exists(os.path.join(p, v))
                           for v in leaves.values()):
                    continue            # torn: leaf lost after the rename?
                step = int(man["step"])
            except (OSError, ValueError, KeyError):
                continue                # unreadable manifest == not committed
            self.index[step] = {n: os.path.join(p, v)
                                for n, v in leaves.items()}
            self._extra[step] = man.get("extra")
            self.committed.append(step)
        self.committed.sort()

    def _payload(self, rec: Record) -> bytes:
        if rec.area == self.area.path:
            return self.area.read_payload(rec)
        tmp = DurableArea(rec.area, mode=self.mode)
        try:
            return tmp.read_payload(rec)
        finally:
            tmp.close()

    def refresh(self):
        """Re-read which steps are committed, for a reader of a directory
        that another process writes."""
        self._recover_index()

    def latest_step(self) -> Optional[int]:
        return max(self.committed) if self.committed else None

    def extra(self, step: Optional[int] = None):
        """The manifest ``extra`` blob of a committed step (dirs layout)."""
        step = step if step is not None else self.latest_step()
        return self._extra.get(step)

    def _arrays(self, step: int, mmap: bool = False
                ) -> Dict[str, np.ndarray]:
        recs = self.index[step]
        if self.layout == "dirs":
            mode = "r" if mmap else None
            return {name: np.load(path, mmap_mode=mode)
                    for name, path in recs.items()}
        return {name: decode_array(self._payload(r))
                for name, r in recs.items() if name != COMMIT}

    def restore(self, step: Optional[int] = None, like=None,
                shardings=None, mmap: bool = False):
        """Restore a step.  ``like`` (a tree of tensors or arrays) fixes the
        tree structure, and each leaf's kind, dtype and device.  ``mmap``
        (dirs layout) maps each leaf's file read-only instead of reading
        it, so a reader that copies a few rows reads only those.  The JAX
        package's ``shardings`` (a tree of ``NamedSharding``) has no form on
        one GPU and raises."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) is not ported (ROADMAP queue A, "
                "item 13: NamedSharding has no one-GPU form)")
        step = step if step is not None else self.latest_step()
        if step is None or step not in self.index:
            return None
        arrays = self._arrays(step, mmap)
        if like is None:
            return arrays
        return _map_with_path(lambda name, leaf: _like(arrays[name], leaf),
                              like)

    # -- gc -------------------------------------------------------------------
    def _gc(self):
        while len(self.committed) > self.keep:
            old = self.committed.pop(0)
            recs = self.index.pop(old)
            self._extra.pop(old, None)
            if self.layout == "dirs":
                shutil.rmtree(os.path.join(self.dir, f"step_{old:012d}"),
                              ignore_errors=True)
                continue
            for rec in recs.values():
                if rec.area == self.area.path:
                    self.area.delete(rec)

    @property
    def fsyncs(self) -> int:
        if self.layout == "dirs":
            return self._dir_fsyncs
        return self.area.fsyncs

    def close(self):
        self.wait()
        self._pool.shutdown()
        if self.area is not None:
            self.area.close()
