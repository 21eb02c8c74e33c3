"""Packed columnar wire form for gossip sync batches.

The legacy sync payload is one Go-JSON dict per event (base64 byte
slices, RFC3339Nano timestamps) — fine for interop with the reference,
but the live node pays a per-event Python-object tax three times per
hop: dict build on the sender, JSON bytes on the TCP wire, dict walk +
string parsing on the receiver, all before the batched ingest pipeline
(docs/ingest.md) sees anything.

`ColumnarEvents` carries a whole sync batch as one contiguous block
per field instead:

    cid / idx / sp_idx / op_cid / op_idx   int32[n]   wire coordinates
    ts_ns                                  int64[n]   claimed timestamps
    sigs                                   bytes      r||s, 32+32 BE per event
    tx_counts                              int32[n]   -1 = Go nil slice
    tx_lens / tx_blob                      int32[t] + bytes  concatenated txs
    trace_ids                              int64[n]   optional sidecar column
    create_ns                              int64[n]   optional sidecar column

Everything consensus-visible is in the columns; the signed-body blob
column the ingest path verifies over is DERIVED on the receiver from
these fields (hashgraph/event.py `materialize_wire_event` reconstructs
the exact Go-JSON encoding and seeds the marshal memos), not shipped.
Shipping sender-built body bytes would either require re-deriving them
anyway to keep "signature covers parent resolution" (the property that
makes the compact wire ints safe against a lying relay: wrong ints →
different reconstructed body → signature check fails), or trusting the
sender's bytes — so the wire stays pure columns and the blob column is
materialized at unpack time.

`encode()`/`decode()` give the length-prefixed binary frame the TCP
transport ships (little-endian, no JSON, no base64); the in-process
transport passes `ColumnarEvents` objects through by reference. Both
`SyncResponse.events` and `EagerSyncRequest.events` may hold either a
`List[WireEvent]` (legacy) or a `ColumnarEvents` — `Core.sync` and
`Hashgraph.read_wire_batch` accept both, which is what makes per-peer
wire negotiation (net/tcp_transport.py) transparent to the node.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ..hashgraph.event import Event, WireBody, WireEvent
from ..gojson import Timestamp

MAGIC = b"BBC1"
_FLAG_TRACE = 1
_FLAG_CREATE = 2

WIRE_LEGACY = "gojson"
WIRE_COLUMNAR = "columnar"
# The per-peer negotiation token (net/tcp_transport.py RPC_WIRE_HELLO).
WIRE_VERSION = "columnar.v1"


class WireFormatError(ValueError):
    pass


def wire_payload_nbytes(events) -> int:
    """Wire size of a sync payload in either form, for the gossip
    bytes-per-new-event accounting (docs/observability.md "Gossip
    efficiency"). Columnar batches report their exact frame size;
    legacy `List[WireEvent]` payloads report an ESTIMATE of the
    Go-JSON line (fixed per-event envelope + base64-expanded tx
    bytes) — close enough for an efficiency ratio without paying a
    real json.dumps per sync on the hot path. In-process transports
    never serialize at all, so an estimate is the only number there;
    the TCP transport's `babble_wire_bytes_total` stays the exact
    ground truth."""
    if not isinstance(events, list):
        return events.nbytes()
    # Go-JSON envelope per event: body skeleton + 2 sigs at ~77
    # decimal digits + field names ≈ 330 bytes, then 4/3 per tx byte.
    size = 0
    for w in events:
        size += 330
        for t in (w.body.transactions or ()):
            size += 4 * len(t) // 3 + 4
    return size


DIGEST_MAGIC = b"BBD1"
# (creator_id int32, index int32, sha256 hash 32B) per digest row.
_DIGEST_ROW = 4 + 4 + 32


class ColumnarDigests:
    """Packed IHAVE digest batch (docs/gossip.md): one int32 column per
    wire coordinate plus the raw 32-byte event hashes, so a lazy-peer
    announcement costs 40 bytes per event instead of a Go-JSON list
    entry. The in-process transports pass the object by reference; the
    TCP transport ships `encode()` as a binary frame."""

    __slots__ = ("cid", "idx", "hashes")

    def __init__(self, cid, idx, hashes: bytes):
        self.cid = cid
        self.idx = idx
        self.hashes = hashes  # 32 bytes per digest, concatenated

    def __len__(self) -> int:
        return len(self.cid)

    @classmethod
    def from_list(cls, digests) -> "ColumnarDigests":
        """From [(creator_id, index, event_hex), ...] — event_hex is the
        store key form ("0x" + 64 hex chars)."""
        cid = [c for c, _, _ in digests]
        idx = [i for _, i, _ in digests]
        hashes = b"".join(bytes.fromhex(h[2:]) for _, _, h in digests)
        return cls(np.asarray(cid, np.int32), np.asarray(idx, np.int32),
                   hashes)

    def to_list(self):
        cid = self.cid.tolist()
        idx = self.idx.tolist()
        return [(cid[k], idx[k],
                 "0x" + self.hashes[32 * k:32 * k + 32].hex().upper())
                for k in range(len(cid))]

    def nbytes(self) -> int:
        return 4 + 4 + _DIGEST_ROW * len(self)

    def encode(self) -> bytes:
        n = len(self)
        return b"".join((
            DIGEST_MAGIC, struct.pack("<I", n),
            np.ascontiguousarray(self.cid, "<i4").tobytes(),
            np.ascontiguousarray(self.idx, "<i4").tobytes(),
            self.hashes,
        ))

    @classmethod
    def decode(cls, buf: bytes) -> "ColumnarDigests":
        if len(buf) < 8 or buf[:4] != DIGEST_MAGIC:
            raise WireFormatError("bad columnar digest header")
        (n,) = struct.unpack_from("<I", buf, 4)
        if len(buf) != 8 + _DIGEST_ROW * n:
            raise WireFormatError(
                f"digest frame length {len(buf)} != expected "
                f"{8 + _DIGEST_ROW * n}")
        cid = np.frombuffer(buf, "<i4", n, 8)
        idx = np.frombuffer(buf, "<i4", n, 8 + 4 * n)
        hashes = buf[8 + 8 * n:]
        return cls(cid, idx, hashes)


class ColumnarEvents:
    """One sync batch, one contiguous array per field."""

    __slots__ = ("cid", "idx", "sp_idx", "op_cid", "op_idx", "ts_ns",
                 "sigs", "tx_counts", "tx_lens", "tx_blob", "trace_ids",
                 "create_ns")

    def __init__(self, cid, idx, sp_idx, op_cid, op_idx, ts_ns, sigs,
                 tx_counts, tx_lens, tx_blob,
                 trace_ids: Optional[np.ndarray] = None,
                 create_ns: Optional[np.ndarray] = None):
        self.cid = cid
        self.idx = idx
        self.sp_idx = sp_idx
        self.op_cid = op_cid
        self.op_idx = op_idx
        self.ts_ns = ts_ns
        self.sigs = sigs
        self.tx_counts = tx_counts
        self.tx_lens = tx_lens
        self.tx_blob = tx_blob
        self.trace_ids = trace_ids
        # Creation-stamp sidecar column (docs/observability.md "Gossip
        # efficiency"): int64[n] creator cluster-epoch ns, same
        # optional-column contract as trace_ids.
        self.create_ns = create_ns

    def __len__(self) -> int:
        return len(self.cid)

    # -- pack --------------------------------------------------------------

    @classmethod
    def from_wire_events(cls, wires: List[WireEvent]) -> "ColumnarEvents":
        # Columns build as plain lists and convert once: np.asarray on
        # a list is C-speed, while per-element numpy scalar stores cost
        # ~10x a list append — this path runs per gossip batch, and
        # steady-state batches are only a few events.
        n = len(wires)
        cid: List[int] = []
        idx: List[int] = []
        sp_idx: List[int] = []
        op_cid: List[int] = []
        op_idx: List[int] = []
        ts_ns: List[int] = []
        tx_counts: List[int] = []
        sig_parts = bytearray(64 * n)
        tx_lens: List[int] = []
        tx_parts: List[bytes] = []
        trace = None
        created = None
        for k, w in enumerate(wires):
            b = w.body
            cid.append(b.creator_id)
            idx.append(b.index)
            sp_idx.append(b.self_parent_index)
            op_cid.append(b.other_parent_creator_id)
            op_idx.append(b.other_parent_index)
            ts_ns.append(b.timestamp.ns)
            off = 64 * k
            sig_parts[off:off + 32] = int(w.r).to_bytes(32, "big")
            sig_parts[off + 32:off + 64] = int(w.s).to_bytes(32, "big")
            txs = b.transactions
            if txs is None:
                tx_counts.append(-1)
            else:
                tx_counts.append(len(txs))
                for t in txs:
                    tx_lens.append(len(t))
                    tx_parts.append(t)
            if w.trace_id:
                if trace is None:
                    trace = np.zeros(n, np.int64)
                trace[k] = w.trace_id
            if w.create_ns:
                if created is None:
                    created = np.zeros(n, np.int64)
                created[k] = w.create_ns
        return cls(np.asarray(cid, np.int32), np.asarray(idx, np.int32),
                   np.asarray(sp_idx, np.int32),
                   np.asarray(op_cid, np.int32),
                   np.asarray(op_idx, np.int32),
                   np.asarray(ts_ns, np.int64),
                   bytes(sig_parts), np.asarray(tx_counts, np.int32),
                   np.asarray(tx_lens, np.int32), b"".join(tx_parts),
                   trace, created)

    @classmethod
    def from_events(cls, events: List[Event]) -> "ColumnarEvents":
        # Event.to_wire is memoized, so in steady state this walks
        # cached WireEvents, not fresh allocations.
        return cls.from_wire_events([e.to_wire() for e in events])

    # -- unpack helpers ----------------------------------------------------

    def signature(self, k: int):
        off = 64 * k
        sig = self.sigs
        return (int.from_bytes(sig[off:off + 32], "big"),
                int.from_bytes(sig[off + 32:off + 64], "big"))

    def transactions_of(self, tx_starts, tx_off, k: int):
        """Transactions of event k given the prefix sums computed by
        `tx_layout` (None for a Go nil slice)."""
        c = int(self.tx_counts[k])
        if c < 0:
            return None
        if c == 0:
            return []
        s = int(tx_starts[k])
        return [self.tx_blob[int(tx_off[i]):int(tx_off[i + 1])]
                for i in range(s, s + c)]

    def tx_layout(self):
        """(tx_starts[n], tx_off[t+1]): per-event first-tx index and
        per-tx byte offsets into the blob. Small batches (the gossip
        steady state) take a plain-Python prefix sum — numpy
        concatenate/cumsum overhead beats the loop until ~100 rows."""
        if len(self.cid) < 96:
            tx_starts, acc = [], 0
            for c in self.tx_counts.tolist():
                tx_starts.append(acc)
                if c > 0:
                    acc += c
            tx_off, acc = [0], 0
            for ln in self.tx_lens.tolist():
                acc += ln
                tx_off.append(acc)
            return tx_starts, tx_off
        counts = np.maximum(self.tx_counts, 0)
        tx_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        tx_off = np.concatenate(([0], np.cumsum(self.tx_lens)))
        return tx_starts, tx_off

    def to_wire_events(self) -> List[WireEvent]:
        """Legacy materialization (compat path: relaying to a peer that
        only speaks Go-JSON, tests, debugging)."""
        tx_starts, tx_off = self.tx_layout()
        cid = self.cid.tolist()
        idx = self.idx.tolist()
        sp = self.sp_idx.tolist()
        opc = self.op_cid.tolist()
        opi = self.op_idx.tolist()
        ts = self.ts_ns.tolist()
        trace = self.trace_ids.tolist() if self.trace_ids is not None \
            else None
        created = self.create_ns.tolist() if self.create_ns is not None \
            else None
        out: List[WireEvent] = []
        for k in range(len(cid)):
            r, s = self.signature(k)
            out.append(WireEvent(
                body=WireBody(
                    transactions=self.transactions_of(tx_starts, tx_off, k),
                    self_parent_index=sp[k],
                    other_parent_creator_id=opc[k],
                    other_parent_index=opi[k],
                    creator_id=cid[k],
                    timestamp=Timestamp(ts[k]),
                    index=idx[k],
                ),
                r=r, s=s,
                trace_id=trace[k] if trace is not None else 0,
                create_ns=created[k] if created is not None else 0,
            ))
        return out

    # -- binary frame ------------------------------------------------------

    def nbytes(self) -> int:
        """Exact `encode()` frame size, without building the frame —
        the cheap bytes-per-new-event accounting hook for in-process
        transports (docs/observability.md "Gossip efficiency")."""
        n = len(self)
        size = 4 + 17 + n * (5 * 4 + 8 + 64 + 4) \
            + len(self.tx_lens) * 4 + len(self.tx_blob)
        if self.trace_ids is not None:
            size += 8 * n
        if self.create_ns is not None:
            size += 8 * n
        return size

    def encode(self) -> bytes:
        n = len(self)
        flags = _FLAG_TRACE if self.trace_ids is not None else 0
        if self.create_ns is not None:
            flags |= _FLAG_CREATE
        t = len(self.tx_lens)
        head = MAGIC + struct.pack("<IBIQ", n, flags, t,
                                   len(self.tx_blob))
        parts = [head]
        for arr, dt in ((self.cid, "<i4"), (self.idx, "<i4"),
                        (self.sp_idx, "<i4"), (self.op_cid, "<i4"),
                        (self.op_idx, "<i4"), (self.ts_ns, "<i8")):
            parts.append(np.ascontiguousarray(arr, dt).tobytes())
        parts.append(self.sigs)
        parts.append(np.ascontiguousarray(self.tx_counts, "<i4").tobytes())
        parts.append(np.ascontiguousarray(self.tx_lens, "<i4").tobytes())
        parts.append(self.tx_blob)
        if self.trace_ids is not None:
            parts.append(
                np.ascontiguousarray(self.trace_ids, "<i8").tobytes())
        if self.create_ns is not None:
            parts.append(
                np.ascontiguousarray(self.create_ns, "<i8").tobytes())
        return b"".join(parts)

    @classmethod
    def decode(cls, buf: bytes, validate: bool = True) -> "ColumnarEvents":
        """Column views over a wire frame. `validate=False` skips the
        O(n) integrity sweeps (tx-blob sum, tx-count reconciliation) —
        ONLY for frames a procs-runtime worker already validated
        (docs/runtime.md "Decode plane"); the structural length check
        always runs, since the views below depend on it."""
        if len(buf) < 4 + 17 or buf[:4] != MAGIC:
            raise WireFormatError("bad columnar frame header")
        n, flags, t, blob_len = struct.unpack_from("<IBIQ", buf, 4)
        off = 4 + 17
        need = off + n * (5 * 4 + 8 + 64 + 4) + t * 4 + blob_len \
            + (n * 8 if flags & _FLAG_TRACE else 0) \
            + (n * 8 if flags & _FLAG_CREATE else 0)
        if len(buf) != need:
            raise WireFormatError(
                f"columnar frame length {len(buf)} != expected {need}")

        def arr(dt, count, width):
            nonlocal off
            a = np.frombuffer(buf, dt, count, off)
            off += count * width
            return a

        cid = arr("<i4", n, 4)
        idx = arr("<i4", n, 4)
        sp_idx = arr("<i4", n, 4)
        op_cid = arr("<i4", n, 4)
        op_idx = arr("<i4", n, 4)
        ts_ns = arr("<i8", n, 8)
        sigs = buf[off:off + 64 * n]
        off += 64 * n
        tx_counts = arr("<i4", n, 4)
        tx_lens = arr("<i4", t, 4)
        if validate:
            total = int(tx_lens.sum()) if t else 0
            if total != blob_len or (t and int(tx_lens.min()) < 0):
                raise WireFormatError("tx blob length mismatch")
            claimed = int(np.maximum(tx_counts, 0).sum()) if n else 0
            if claimed != t:
                raise WireFormatError("tx count / length column mismatch")
        tx_blob = buf[off:off + blob_len]
        off += blob_len
        trace = arr("<i8", n, 8) if flags & _FLAG_TRACE else None
        created = arr("<i8", n, 8) if flags & _FLAG_CREATE else None
        return cls(cid, idx, sp_idx, op_cid, op_idx, ts_ns, sigs,
                   tx_counts, tx_lens, tx_blob, trace, created)
