"""Native materializer of a columnar sync batch (csrc/wire_batch.cpp).

`WireReader.read` is the columnar path of `Hashgraph.read_wire_batch`
(babble_tpu_torch/INGEST.md). It resolves every parent that is not an
earlier row of the batch in Python, in row order and self-parent first,
so the store lookups, and the `StoreError` an unknown parent raises,
are those of the Python path. Then one call into the native library
writes every row's Go-JSON body and event encodings, both SHA-256
digests and the event's hex, with the interpreter lock released.
Python builds the `EventBody` and `Event` objects last, every marshal,
hash and hex memo seeded, so the signature check, the event's identity
and a later relay never encode or hash the event again.

The library is host C++, compiled on first use with the system's C++
compiler into build/host/ at the repository root and loaded with ctypes
(csrc.build_library, as the CUDA kernels are built). Where it cannot be
built, or a batch's columns do not add up, `read` returns None and the
caller takes the Python path (`event.materialize_wire_event`), which the
tests hold this one against byte for byte.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..csrc import build_library, load_library
from ..gojson import Timestamp
from .event import Event, EventBody, _creator_b64, _creator_hex

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "wire_batch.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_ENTRY = {
    "babble_wire_batch": (
        [_I32, _P, _P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _I64, _P, _I64,
         _P, _I32, _P, _P, _I64, _P, _P, _P], ctypes.c_int),
    "babble_sha256": ([_P, _I64, _P, _I32], None),
    "babble_rfc3339nano": ([_I64, _I64, _P], _I32),
}

# The most bytes csrc/wire_batch.cpp writes for a row, past its
# creator, parents and transactions: the body's literals, "null" (no
# shorter than "[]"), the longest timestamp (30) and index (11); then
# the event's literals around the body's copy, R and S (78 digits each),
# two newlines and the 66-byte hex. The creator, the parents and the
# transactions are in the body, so twice.
_BODY_LITERALS = ('{"Transactions":', ',"Parents":["', '","', '"],"Creator":"',
                  '","Timestamp":"', '","Index":', '}')
_BODY_BYTES = sum(map(len, _BODY_LITERALS)) + 4 + 30 + 11
_ROW_BYTES = 2 * _BODY_BYTES + len('{"Body":' ',"R":' ',"S":' '}') + 2 * 78 + 2 + 66
_HEX = 66

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _cxx() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler on PATH")
    return found


def library() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once a process; None (logged once)
    where it cannot be built or loaded."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = load_library(build_library(SOURCE, _cxx, CXX_FLAGS, BUILD_DIR)["path"],
                                    _ENTRY)
            except (OSError, RuntimeError) as exc:
                _build_error = str(exc)
                logging.getLogger("babble_tpu_torch").warning(
                    "columnar batches take the Python path: %s", exc)
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class WireReader:
    """The native columnar reader of one graph. Its participants'
    creator bytes, hex and base64 are laid out by creator id once, at
    the first batch."""

    def __init__(self, reverse_participants: Dict[int, str]):
        self._rp = reverse_participants
        self._table = None
        # The last batch the native call built: (rows, perf_counter_ns
        # before and after the call); None after any other read.
        self.last: Optional[Tuple[int, int, int]] = None

    def _creators(self):
        """({id: (creator bytes, creator hex)}, base64 offsets by id,
        base64 blob, longest base64), or None where an id is negative
        (the native table is indexed by id)."""
        if self._table is None:
            ids = list(self._rp)
            if not ids or min(ids) < 0:
                self._table = False
                return None
            creators, b64 = {}, [b""] * (max(ids) + 1)
            for i, pk in self._rp.items():
                cb = bytes.fromhex(pk[2:])
                creators[i] = (cb, _creator_hex(cb))
                b64[i] = _creator_b64(cb).encode("ascii")
            off = np.zeros(len(b64) + 1, np.int32)
            off[1:] = np.cumsum([len(b) for b in b64])
            self._table = (creators, off, b"".join(b64), max(map(len, b64)))
        return self._table or None

    def read(self, cols, resolve) -> Optional[List[Event]]:
        """The batch's events, or None where the native path cannot take
        it. `resolve(creator id, index)` is the graph's batch resolver
        (store windows, then the store). Sets `last` where the native
        call built the batch. Caller holds the core lock."""
        self.last = None
        n = len(cols.cid)
        if not n:
            return []
        lib = library()
        table = self._creators() if lib is not None else None
        if table is None:
            return None
        creators, cre_off, cre_blob, cre_max = table
        cid = np.ascontiguousarray(cols.cid, np.int32)
        idx_a = np.ascontiguousarray(cols.idx, np.int32)
        ts_a = np.ascontiguousarray(cols.ts_ns, np.int64)
        counts = np.ascontiguousarray(cols.tx_counts, np.int32)
        tx_lens = np.ascontiguousarray(cols.tx_lens, np.int32)
        blob, sigs = bytes(cols.tx_blob), bytes(cols.sigs)
        if not (len(idx_a) == len(ts_a) == len(counts) == len(cols.sp_idx)
                == len(cols.op_cid) == len(cols.op_idx) == n and len(sigs) >= 64 * n):
            return None

        # Parents: an earlier row of the batch (the latest with that
        # creator and index), else resolved now, in the Python path's order.
        cids, idx = cid.tolist(), idx_a.tolist()
        sp, opc, opi = cols.sp_idx.tolist(), cols.op_cid.tolist(), cols.op_idx.tolist()
        par = [-1] * (2 * n)
        named: List[Optional[str]] = [""] * (2 * n)
        ext: List[str] = []
        rows: Dict[tuple, int] = {}
        for k in range(n):
            c = cids[k]
            if c not in creators:
                raise KeyError(c)  # as the Python path's participant lookup
            if sp[k] >= 0:
                r = rows.get((c, sp[k]))
                if r is None:
                    named[2 * k] = h = resolve(c, sp[k])
                    ext.append(h)
                else:
                    par[2 * k], named[2 * k] = r, None
            else:
                ext.append("")
            if opi[k] >= 0:
                r = rows.get((opc[k], opi[k]))
                if r is None:
                    named[2 * k + 1] = h = resolve(opc[k], opi[k])
                    ext.append(h)
                else:
                    par[2 * k + 1], named[2 * k + 1] = r, None
            else:
                ext.append("")
            rows[(c, idx[k])] = k
        ext_lens = np.fromiter(map(len, ext), np.int32, len(ext))
        ext_blob = "".join(ext).encode()
        if len(ext_blob) != int(ext_lens.sum()):
            return None  # not ASCII: the Python path encodes it
        par_a = np.asarray(par, np.int32)

        # An upper bound of what the call writes: out of room is a fault.
        b64 = 4 * ((np.maximum(tx_lens, 0).astype(np.int64) + 2) // 3) + 3
        cap = (n * (_ROW_BYTES + 2 * cre_max) + 2 * _HEX * int((par_a >= 0).sum())
               + 2 * len(ext_blob) + 2 * int(b64.sum()))
        out = np.empty(cap, np.uint8)
        off = np.empty(n + 1, np.int64)
        lens = np.empty(2 * n, np.int32)
        dig = np.empty(64 * n, np.uint8)
        t0 = time.perf_counter_ns()
        rc = lib.babble_wire_batch(
            n, _ptr(cid), _ptr(idx_a), _ptr(ts_a), _ptr(counts), _ptr(tx_lens),
            len(tx_lens), blob, len(blob), sigs, _ptr(par_a), _ptr(ext_lens),
            len(ext_lens), ext_blob, len(ext_blob), _ptr(cre_off), len(cre_off) - 1,
            cre_blob, _ptr(out), cap, _ptr(off), _ptr(lens), _ptr(dig))
        t1 = time.perf_counter_ns()
        if rc == 2:
            raise RuntimeError(f"wire batch of {n} rows overran its {cap}-byte buffer")
        if rc != 0:
            return None  # the columns do not add up: the Python path decides
        self.last = (n, t0, t1)

        offs, lens_l = off.tolist(), lens.tolist()
        buf = out[:offs[n]].tobytes()
        text = buf.decode("ascii")
        digs = dig.tobytes()
        ts = ts_a.tolist()
        counts_l = counts.tolist()
        tx_off = list(itertools.accumulate(tx_lens.tolist(), initial=0))
        all_txs = [blob[a:b] for a, b in zip(tx_off, tx_off[1:])]
        trace = cols.trace_ids.tolist() if cols.trace_ids is not None else None
        created = cols.create_ns.tolist() if cols.create_ns is not None else None
        hexes: List[str] = []
        events: List[Event] = []
        t = 0
        for k in range(n):
            c = cids[k]
            cb, chex = creators[c]
            cnt = counts_l[k]
            if cnt < 0:
                txs = None
            else:
                txs = all_txs[t:t + cnt]
                t += cnt
            p0, p1 = named[2 * k], named[2 * k + 1]
            if p0 is None:
                p0 = hexes[par[2 * k]]
            if p1 is None:
                p1 = hexes[par[2 * k + 1]]
            body = EventBody(txs, [p0, p1], cb, Timestamp(ts[k]), idx[k])
            o, b, e = offs[k], lens_l[2 * k], lens_l[2 * k + 1]
            body._marshal_str = text[o:o + b]
            body._marshal = buf[o:o + b + 1]
            body._hash = digs[64 * k:64 * k + 32]
            body.self_parent_index = sp[k]
            body.other_parent_creator_id = opc[k]
            body.other_parent_index = opi[k]
            body.creator_id = c
            s = 64 * k
            ev = Event(body, r=int.from_bytes(sigs[s:s + 32], "big"),
                       s=int.from_bytes(sigs[s + 32:s + 64], "big"))
            o += b + 1
            ev._marshal_str = text[o:o + e]
            ev._marshal = buf[o:o + e + 1]
            ev._hash = digs[64 * k + 32:64 * k + 64]
            ev._hex = hx = text[o + e + 1:o + e + 67]
            ev._creator_hex = chex
            ev.trace_id = trace[k] if trace is not None else 0
            ev.create_ns = created[k] if created is not None else 0
            hexes.append(hx)
            events.append(ev)
        return events
