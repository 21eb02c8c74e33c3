"""Signed gossip events and their compact wire form.

Reference: hashgraph/event.go. An event body carries the payload
transactions, the two parent hashes (self-parent first), the creator's
public key, a claimed timestamp, and the creator-sequence index
(event.go:14-27). The body hash (SHA-256 of its Go-JSON encoding,
event.go:48-54) is what gets ECDSA-signed; the full event hash (Go-JSON
of {Body, R, S}, event.go:171-180) names the event everywhere
("0x"-prefixed uppercase hex, event.go:182-188).

Wire form (event.go:252-267) replaces the two 64-char parent hashes with
four small ints resolved against each side's per-participant event
indexes (reference hashgraph.go:532-614).
"""

from __future__ import annotations

import base64
import functools
from typing import List, Optional, Sequence

from .. import crypto
from ..gojson import BigInt, GoStruct, Timestamp, ZERO_TIME, decode_byte_slices, marshal

# Marshal/hash reuse contract (docs/ingest.md): Event and EventBody
# memoize their Go-JSON bytes and SHA-256 digests because the ingest
# path would otherwise pay the same marshal up to three times per event
# (body hash for signature verify, event hash for identity, re-marshal
# when persisting/relaying). The caches are sound only while the
# underlying fields are frozen, so every mutation MUST go through an
# invalidating mutator (`sign`, `set_wire_info`) or call
# `invalidate()` explicitly after touching fields by hand.


class MemoStats:
    """Process-wide hit/miss accounting for the marshal/hash memos
    (docs/observability.md "Capacity"): one slotted int increment per
    accessor call — GIL-atomic, no lock, read only at scrape time.
    Hits are calls served from the memo; misses are the ones that
    paid the marshal/sha256. Counts fold Event and EventBody together
    per kind (the ingest path exercises them as one unit)."""

    __slots__ = ("marshal_hits", "marshal_misses",
                 "hash_hits", "hash_misses")

    def __init__(self):
        self.marshal_hits = 0
        self.marshal_misses = 0
        self.hash_hits = 0
        self.hash_misses = 0

    def snapshot(self) -> dict:
        return {"marshal_hits": self.marshal_hits,
                "marshal_misses": self.marshal_misses,
                "hash_hits": self.hash_hits,
                "hash_misses": self.hash_misses}


MEMO_STATS = MemoStats()


class EventCoordinates:
    """(hash, index) pointer used in the per-participant coordinate
    vectors — reference event.go:56-59."""

    __slots__ = ("hash", "index")

    def __init__(self, hash: str = "", index: int = 0):
        self.hash = hash
        self.index = index

    def copy(self) -> "EventCoordinates":
        return EventCoordinates(self.hash, self.index)

    def __repr__(self) -> str:
        return f"Coord({self.index},{self.hash[:10]})"


class EventBody(GoStruct):
    go_fields = (
        ("Transactions", "transactions"),
        ("Parents", "parents"),
        ("Creator", "creator"),
        ("Timestamp", "timestamp"),
        ("Index", "index"),
    )

    def __init__(
        self,
        transactions: Optional[List[bytes]],
        parents: List[str],
        creator: bytes,
        timestamp: Timestamp,
        index: int,
    ):
        self.transactions = transactions  # None == Go nil slice (marshals null)
        self.parents = parents
        self.creator = creator
        self.timestamp = timestamp
        self.index = index
        # wire info — unexported in Go, not part of the JSON encoding
        self.self_parent_index = -1
        self.other_parent_creator_id = -1
        self.other_parent_index = -1
        self.creator_id = -1
        # memoized Go-JSON encoding + digest (see module docstring)
        self._marshal_str: Optional[str] = None
        self._marshal: Optional[bytes] = None
        self._hash: Optional[bytes] = None

    def invalidate(self) -> None:
        """Drop the memoized encoding/digest after a by-hand field
        mutation. The wire-info ints are NOT part of the encoding
        (unexported in Go), so set_wire_info does not need this."""
        self._marshal_str = None
        self._marshal = None
        self._hash = None

    def marshal_value(self) -> str:
        s = self._marshal_str
        if s is None:
            s = self._marshal_str = GoStruct.marshal_value(self)
        return s

    def marshal(self) -> bytes:
        b = self._marshal
        if b is None:
            MEMO_STATS.marshal_misses += 1
            b = self._marshal = (self.marshal_value() + "\n").encode("utf-8")
        else:
            MEMO_STATS.marshal_hits += 1
        return b

    def hash(self) -> bytes:
        h = self._hash
        if h is None:
            MEMO_STATS.hash_misses += 1
            h = self._hash = crypto.sha256(self.marshal())
        else:
            MEMO_STATS.hash_hits += 1
        return h


class Event(GoStruct):
    go_fields = (
        ("Body", "body"),
        ("R", "r"),
        ("S", "s"),
    )

    def __init__(self, body: EventBody, r: int = 0, s: int = 0):
        self.body = body
        self.r = BigInt(r)
        self.s = BigInt(s)

        self.topological_index = 0
        self.round_received: Optional[int] = None
        self.consensus_timestamp: Timestamp = ZERO_TIME

        self.last_ancestors: List[EventCoordinates] = []
        self.first_descendants: List[EventCoordinates] = []

        self._creator_hex: str = ""
        self._marshal_str: Optional[str] = None
        self._marshal: Optional[bytes] = None
        self._hash: bytes = b""
        self._hex: str = ""
        # memoized signature-check result and wire form (see
        # docs/ingest.md): sound while body/R/S are frozen.
        self._sig_ok: Optional[bool] = None
        self._wire: Optional["WireEvent"] = None
        # Distributed-tracing annotation (docs/observability.md): the
        # trace id of a sampled transaction this event carries. NOT
        # part of the signed body or the Go-JSON encoding — it rides
        # the wire form as sidecar metadata and never influences
        # hashes, signatures, or consensus.
        self.trace_id: int = 0
        # Propagation-tracing annotation (docs/observability.md
        # "Gossip efficiency"): the creator's cluster-epoch stamp (ns)
        # taken when the event was signed. Same sidecar contract as
        # trace_id: never in the signed body, rides the wire forms
        # only when set, 0 = unstamped (legacy form byte-identical).
        self.create_ns: int = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def new(
        cls,
        transactions: Optional[Sequence[bytes]],
        parents: Sequence[str],
        creator: bytes,
        index: int,
        timestamp: Optional[Timestamp] = None,
    ) -> "Event":
        body = EventBody(
            transactions=list(transactions) if transactions is not None else None,
            parents=list(parents),
            creator=creator,
            timestamp=timestamp if timestamp is not None else Timestamp.now(),
            index=index,
        )
        return cls(body)

    # -- accessors ---------------------------------------------------------

    def creator(self) -> str:
        if not self._creator_hex:
            self._creator_hex = "0x" + self.body.creator.hex().upper()
        return self._creator_hex

    def self_parent(self) -> str:
        return self.body.parents[0]

    def other_parent(self) -> str:
        return self.body.parents[1]

    def transactions(self) -> Optional[List[bytes]]:
        return self.body.transactions

    def index(self) -> int:
        return self.body.index

    def is_loaded(self) -> bool:
        """Payload-carrying, or the creator's initial event — event.go:119-126."""
        if self.body.index == 0:
            return True
        return bool(self.body.transactions)

    # -- cache invalidation ------------------------------------------------

    def invalidate(self, body: bool = True) -> None:
        """Centralized cache invalidation: drop every memo derived from
        the (body, R, S) triple. `body=True` also drops the body's own
        encoding caches — required after any by-hand body-field
        mutation; `sign` passes body=False because it changes only
        R/S."""
        if body:
            self.body.invalidate()
            self._creator_hex = ""
        self._marshal_str = None
        self._marshal = None
        self._hash = b""
        self._hex = ""
        self._sig_ok = None
        self._wire = None

    # -- crypto ------------------------------------------------------------

    def sign(self, key) -> None:
        r, s = crypto.sign(key, self.body.hash())
        self.r, self.s = BigInt(r), BigInt(s)
        self.invalidate(body=False)
        # A signature we just produced with the creator's own key is
        # valid by ECDSA correctness — memoize the verdict so the
        # insert pipeline's verify() does not re-derive it (a full
        # scalar multiplication per self-event). A mismatched key
        # (tests, adversarial fixtures) leaves the memo unset and
        # verify() computes the honest answer.
        if crypto.pub_key_bytes(key) == self.body.creator:
            self._sig_ok = True

    def verify(self) -> bool:
        ok = self._sig_ok
        if ok is None:
            pub = crypto.pub_key_from_bytes_cached(self.body.creator)
            ok = self._sig_ok = crypto.verify(
                pub, self.body.hash(), self.r, self.s)
        return ok

    # -- identity ----------------------------------------------------------

    def marshal_value(self) -> str:
        s = self._marshal_str
        if s is None:
            s = self._marshal_str = GoStruct.marshal_value(self)
        return s

    def marshal(self) -> bytes:
        b = self._marshal
        if b is None:
            MEMO_STATS.marshal_misses += 1
            b = self._marshal = (self.marshal_value() + "\n").encode("utf-8")
        else:
            MEMO_STATS.marshal_hits += 1
        return b

    def hash(self) -> bytes:
        if not self._hash:
            MEMO_STATS.hash_misses += 1
            self._hash = crypto.sha256(self.marshal())
        else:
            MEMO_STATS.hash_hits += 1
        return self._hash

    def hex(self) -> str:
        if not self._hex:
            self._hex = "0x" + self.hash().hex().upper()
        return self._hex

    # -- consensus bookkeeping --------------------------------------------

    def set_round_received(self, rr: int) -> None:
        self.round_received = rr

    def set_wire_info(
        self,
        self_parent_index: int,
        other_parent_creator_id: int,
        other_parent_index: int,
        creator_id: int,
    ) -> None:
        self.body.self_parent_index = self_parent_index
        self.body.other_parent_creator_id = other_parent_creator_id
        self.body.other_parent_index = other_parent_index
        self.body.creator_id = creator_id
        # The wire ints are not part of the Go-JSON encoding, so the
        # marshal/hash/signature memos stay valid — only the cached
        # wire form must be rebuilt.
        self._wire = None

    def to_wire(self) -> "WireEvent":
        w = self._wire
        if w is None:
            w = self._wire = WireEvent(
                body=WireBody(
                    transactions=self.body.transactions,
                    self_parent_index=self.body.self_parent_index,
                    other_parent_creator_id=self.body.other_parent_creator_id,
                    other_parent_index=self.body.other_parent_index,
                    creator_id=self.body.creator_id,
                    timestamp=self.body.timestamp,
                    index=self.body.index,
                ),
                r=self.r,
                s=self.s,
                trace_id=self.trace_id,
                create_ns=self.create_ns,
            )
        return w

    def __repr__(self) -> str:
        return f"Event({self.creator()[:10]}#{self.index()})"


def event_from_json_obj(obj: dict) -> "Event":
    """Reconstruct a full signed Event from its Go-JSON encoding (the
    exact bytes `marshal()` produces), for persistent-store replay.
    Round-trips exactly: re-marshaling the parsed event reproduces the
    original bytes, so hashes and signatures survive storage."""
    body_obj = obj["Body"]
    txs = body_obj.get("Transactions")
    if txs is not None:
        txs = [t if isinstance(t, bytes) else base64.b64decode(t) for t in txs]
    creator = body_obj["Creator"]
    if not isinstance(creator, bytes):
        creator = base64.b64decode(creator)
    body = EventBody(
        transactions=txs,
        parents=list(body_obj["Parents"]),
        creator=creator,
        timestamp=Timestamp.parse(body_obj["Timestamp"]),
        index=body_obj["Index"],
    )
    return Event(body, r=obj["R"], s=obj["S"])


class WireBody(GoStruct):
    go_fields = (
        ("Transactions", "transactions"),
        ("SelfParentIndex", "self_parent_index"),
        ("OtherParentCreatorID", "other_parent_creator_id"),
        ("OtherParentIndex", "other_parent_index"),
        ("CreatorID", "creator_id"),
        ("Timestamp", "timestamp"),
        ("Index", "index"),
    )

    def __init__(
        self,
        transactions: Optional[List[bytes]],
        self_parent_index: int,
        other_parent_creator_id: int,
        other_parent_index: int,
        creator_id: int,
        timestamp: Timestamp,
        index: int,
    ):
        self.transactions = transactions
        self.self_parent_index = self_parent_index
        self.other_parent_creator_id = other_parent_creator_id
        self.other_parent_index = other_parent_index
        self.creator_id = creator_id
        self.timestamp = timestamp
        self.index = index


class WireEvent(GoStruct):
    go_fields = (
        ("Body", "body"),
        ("R", "r"),
        ("S", "s"),
    )

    def __init__(self, body: WireBody, r: int, s: int, trace_id: int = 0,
                 create_ns: int = 0):
        self.body = body
        self.r = BigInt(r)
        self.s = BigInt(s)
        # Sidecar tracing metadata (docs/observability.md): rides the
        # JSON relay as "_TraceID" ONLY when set, so an untraced wire
        # event serializes byte-identically to the pre-tracing form
        # (legacy interop pinned by tests/test_tracing.py) and the
        # Go-JSON marshal (go_fields above) never sees it.
        self.trace_id = trace_id
        # Creation-stamp sidecar ("_CreateNs"): same only-when-set
        # contract, feeding the propagation-latency histogram
        # (docs/observability.md "Gossip efficiency").
        self.create_ns = create_ns
        self._dict: Optional[dict] = None

    def to_dict(self) -> dict:
        # Memoized: the same wire form is JSON-relayed once per peer
        # (TCP transport), and WireEvents are themselves memoized per
        # Event — callers treat the dict as read-only.
        d = self._dict
        if d is not None:
            return d
        d = self._dict = {
            "Body": {
                "Transactions": (
                    None
                    if self.body.transactions is None
                    else [t for t in self.body.transactions]
                ),
                "SelfParentIndex": self.body.self_parent_index,
                "OtherParentCreatorID": self.body.other_parent_creator_id,
                "OtherParentIndex": self.body.other_parent_index,
                "CreatorID": self.body.creator_id,
                "Timestamp": self.body.timestamp.rfc3339nano(),
                "Index": self.body.index,
            },
            "R": int(self.r),
            "S": int(self.s),
        }
        if self.trace_id:
            d["_TraceID"] = self.trace_id
        if self.create_ns:
            d["_CreateNs"] = self.create_ns
        return d

    @classmethod
    def from_json_obj(cls, obj: dict) -> "WireEvent":
        body = obj["Body"]
        txs = body.get("Transactions")
        if txs is not None:
            txs = [t if isinstance(t, bytes) else base64.b64decode(t) for t in txs]
        return cls(
            body=WireBody(
                transactions=txs,
                self_parent_index=body["SelfParentIndex"],
                other_parent_creator_id=body["OtherParentCreatorID"],
                other_parent_index=body["OtherParentIndex"],
                creator_id=body["CreatorID"],
                timestamp=Timestamp.parse(body["Timestamp"]),
                index=body["Index"],
            ),
            r=obj["R"],
            s=obj["S"],
            trace_id=obj.get("_TraceID", 0),
            create_ns=obj.get("_CreateNs", 0),
        )


@functools.lru_cache(maxsize=4096)
def _creator_b64(creator: bytes) -> str:
    """Base64 of a creator's public-key bytes — one per participant,
    reused on every event of the columnar read path."""
    return base64.b64encode(creator).decode("ascii")


@functools.lru_cache(maxsize=4096)
def _creator_hex(creator: bytes) -> str:
    return "0x" + creator.hex().upper()


def materialize_wire_event(
    creator_bytes: bytes,
    self_parent: str,
    other_parent: str,
    index: int,
    ts_ns: int,
    txs: Optional[List[bytes]],
    r: int,
    s: int,
    sp_idx: int,
    op_cid: int,
    op_idx: int,
    cid: int,
    trace_id: int = 0,
    create_ns: int = 0,
) -> Event:
    """Zero-rebuild materialization of a columnar wire row into a full
    Event: the Go-JSON body and event encodings are built directly with
    one f-string each and SEEDED into the marshal memos, so the ingest
    pipeline's body hash (signature verify), event hash (identity), and
    any later relay marshal are all cache hits — no GoStruct field walk
    and no JSON dict ever exists for the event.

    Soundness: every string interpolated below comes from a domain that
    Go-JSON writes through unescaped (hex hashes, base64, RFC3339Nano,
    decimal ints), and the field order matches EventBody.go_fields /
    Event.go_fields exactly — pinned byte-for-byte against the GoStruct
    encoder by tests/test_wire.py. Because the encoding is DERIVED from
    the resolved columns, a relay that lies about the wire coordinates
    still produces a body whose signature check fails, exactly like the
    legacy read path."""
    if txs is None:
        txpart = "null"
    elif txs:
        txpart = '["' + '","'.join(
            base64.b64encode(t).decode("ascii") for t in txs) + '"]'
    else:
        txpart = "[]"
    ts = Timestamp(ts_ns)
    body_str = (
        '{"Transactions":' + txpart
        + ',"Parents":["' + self_parent + '","' + other_parent
        + '"],"Creator":"' + _creator_b64(creator_bytes)
        + '","Timestamp":"' + ts.rfc3339nano()
        + '","Index":' + str(index) + "}"
    )
    body = EventBody(
        transactions=txs,
        parents=[self_parent, other_parent],
        creator=creator_bytes,
        timestamp=ts,
        index=index,
    )
    body._marshal_str = body_str
    body.self_parent_index = sp_idx
    body.other_parent_creator_id = op_cid
    body.other_parent_index = op_idx
    body.creator_id = cid
    ev = Event(body, r=r, s=s)
    ev._marshal_str = (
        '{"Body":' + body_str + ',"R":' + str(r) + ',"S":' + str(s) + "}")
    ev._creator_hex = _creator_hex(creator_bytes)
    ev.trace_id = trace_id
    ev.create_ns = create_ns
    return ev


def by_topological_order(events: List[Event]) -> List[Event]:
    """Sort key mirror of reference event.go:241-247."""
    return sorted(events, key=lambda e: e.topological_index)


def by_timestamp(events: List[Event]) -> List[Event]:
    """Sort mirror of reference event.go:227-237. Go uses unstable
    sort.Sort; keys here are total enough for our uses (median only
    reads the timestamp value, which ties share)."""
    return sorted(events, key=lambda e: e.body.timestamp.ns)
