"""SOFT durable tensor store: the paper's persistence discipline applied to
checkpointing (DESIGN.md §3).

A copy of ``repro.store.tensorstore`` (which imports no JAX), with the same
record format and byte layout, so that the port reads and writes the same
area files without importing the JAX package.

Every record is a self-validating PNode on disk:

    [MAGIC][validStart][key][payload_len] payload [crc32][validEnd][deleted]

* a record becomes durable with exactly ONE fsync (SOFT's single psync per
  update): write header+payload+footer -> fsync -> publish to the volatile
  in-memory index;
* no manifest / index file is EVER persisted ("no pointers"): recovery
  scans the append-only area files and rebuilds the index;
* deletion = patching the ``deleted`` word in place + one fsync
  (PNode::destroy) -- never a rewrite;
* torn writes (crash mid-record) leave validStart != validEnd or a CRC
  mismatch and are ignored by the recovery scan (the invalid-node rule);
* link-free mode is also provided for comparison: it additionally patches
  a per-record "linked" word after publish (modeling the second cache-line
  touch), costing a second fsync -- the benchmarks show the gap.
"""
from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0x50444E4F44453031            # "PDNODE01"
_HDR = struct.Struct("<QQQQQ")         # magic, validStart, key_hi, key_lo, len
_FTR = struct.Struct("<QQQ")           # crc, validEnd, deleted
VALIDITY = 0x5A5A5A5A5A5A5A5A          # pValidity generation value


def _key(step: int, name: str) -> Tuple[int, int]:
    return step, zlib.crc32(name.encode()) | (len(name) << 32)


@dataclass
class Record:
    step: int
    name: str
    offset: int           # file offset of the record header
    length: int           # payload length
    area: str             # area file path


class DurableArea:
    """One append-only area file (per host / per writer thread)."""

    def __init__(self, path: str, mode: str = "soft"):
        assert mode in ("soft", "linkfree")
        self.path = path
        self.mode = mode
        self.lock = threading.Lock()
        self.fsyncs = 0
        if not os.path.exists(path):
            with open(path, "wb"):
                pass
        self._f = open(path, "r+b")

    # -- write path ----------------------------------------------------------
    def append(self, step: int, name: str, payload: bytes) -> Record:
        hi, lo = _key(step, name)
        body = name.encode()
        blob = struct.pack("<I", len(body)) + body + payload
        crc = zlib.crc32(blob)
        with self.lock:
            self._f.seek(0, os.SEEK_END)
            off = self._f.tell()
            self._f.write(_HDR.pack(MAGIC, VALIDITY, hi, lo, len(blob)))
            self._f.write(blob)
            self._f.write(_FTR.pack(crc, VALIDITY, 0))
            self._f.flush()
            os.fsync(self._f.fileno())            # THE single psync (SOFT)
            self.fsyncs += 1
            if self.mode == "linkfree":
                # model the second cache-line touch (link persist)
                os.fsync(self._f.fileno())
                self.fsyncs += 1
        return Record(step, name, off, len(blob), self.path)

    def delete(self, rec: Record) -> None:
        """PNode::destroy -- patch the deleted word, one fsync."""
        with self.lock:
            ftr_off = rec.offset + _HDR.size + rec.length + 16
            self._f.seek(ftr_off)
            self._f.write(struct.pack("<Q", VALIDITY))
            self._f.flush()
            os.fsync(self._f.fileno())
            self.fsyncs += 1

    # -- recovery scan ---------------------------------------------------------
    @staticmethod
    def scan(path: str) -> List[Tuple[Record, bool]]:
        """Parse the area; returns (record, live) pairs.  Torn tails and
        invalid records are skipped -- never an exception."""
        out: List[Tuple[Record, bool]] = []
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            off = 0
            while off + _HDR.size + _FTR.size <= size:
                f.seek(off)
                hdr = f.read(_HDR.size)
                magic, vstart, hi, lo, ln = _HDR.unpack(hdr)
                if magic != MAGIC or ln > size - off:
                    break                          # torn tail / garbage
                blob = f.read(ln)
                ftr = f.read(_FTR.size)
                if len(ftr) < _FTR.size:
                    break
                crc, vend, deleted = _FTR.unpack(ftr)
                nlen = struct.unpack("<I", blob[:4])[0] if len(blob) >= 4 else -1
                valid = (vstart == VALIDITY and vend == VALIDITY
                         and zlib.crc32(blob) == crc and 0 <= nlen <= ln - 4)
                if valid:
                    name = blob[4:4 + nlen].decode()
                    rec = Record(hi, name, off, ln, path)
                    out.append((rec, deleted != VALIDITY))
                off += _HDR.size + ln + _FTR.size
        return out

    def read_payload(self, rec: Record) -> bytes:
        with self.lock:
            self._f.seek(rec.offset + _HDR.size)
            blob = self._f.read(rec.length)
        nlen = struct.unpack("<I", blob[:4])[0]
        return blob[4 + nlen:]

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# numpy (de)serialization envelope
# ---------------------------------------------------------------------------

# A bfloat16 leaf travels as its 16-bit pattern, a 2-byte void array.
# The JAX store writes ml_dtypes' bfloat16, whose npy descr is '<V2' (a
# plain void array's is '|V2'); the port writes that descr too, so both
# stores write the same bytes for the same values.
BF16_DESCR = "<V2"
BF16_BITS = np.dtype("V2")


def write_npy(f, arr: np.ndarray) -> None:
    """``arr`` in npy format to the file object ``f``: ``np.save``'s bytes,
    and for a bf16 bit pattern (``BF16_BITS``) the JAX store's header."""
    arr = np.asarray(arr)
    if arr.dtype != BF16_BITS:
        np.save(f, arr, allow_pickle=False)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
    f.write(arr.tobytes())                 # C order, as write_array


def encode_array(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    arr = np.asarray(arr)
    if arr.ndim and not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)   # (0-d arrays: ascontiguous -> 1-d!)
    write_npy(buf, arr)
    return buf.getvalue()


def decode_array(payload: bytes) -> np.ndarray:
    return np.lib.format.read_array(io.BytesIO(payload), allow_pickle=False)
