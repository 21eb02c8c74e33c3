"""Transport contract + RPC message types.

Reference net/transport.go:6-57 and net/commands.go:5-27. Go's
(out-param, error) convention becomes return-or-raise; Go channels
become queue.Queue. The consumer queue carries inbound RPC objects the
node answers via RPC.respond."""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

from ..hashgraph.event import WireEvent


class TransportError(Exception):
    pass


@dataclass
class SyncRequest:
    from_id: int
    known: Dict[int, int]
    # Shared-epoch clock handshake (telemetry/clock.py): the
    # requester's epoch-domain send stamp (ns). 0 = no handshake (a
    # legacy peer); the field rides the RPC dict only when set, so the
    # pre-handshake wire form is unchanged and Go-style decoders
    # ignore the extra key either way.
    t_send: int = 0
    # Requested response payload format (net/columnar.py): "" = the
    # legacy Go-JSON event list; the columnar version token asks the
    # responder for a packed `ColumnarEvents` payload if it speaks it.
    # Same sidecar contract as ClockSend: only present when set, so
    # the legacy wire bytes are unchanged and legacy decoders ignore
    # the extra key.
    wire: str = ""
    # Consensus health sidecar (docs/observability.md "Consensus
    # health"): the requester's committed-block chain claim + last
    # consensus round (node/health.py). Same contract as the clock
    # stamps: rides the dict only when set, never enters any signed
    # event body, and a legacy peer ignores the extra key.
    health: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"FromID": self.from_id,
             "Known": {str(k): v for k, v in self.known.items()}}
        if self.t_send:
            d["ClockSend"] = self.t_send
        if self.wire:
            d["Wire"] = self.wire
        if self.health is not None:
            d["Health"] = self.health
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SyncRequest":
        return cls(
            from_id=d["FromID"],
            known={int(k): v for k, v in (d.get("Known") or {}).items()},
            t_send=d.get("ClockSend", 0),
            wire=d.get("Wire", ""),
            health=d.get("Health"),
        )


@dataclass
class SyncResponse:
    from_id: int
    sync_limit: bool = False
    # Legacy List[WireEvent] or a packed ColumnarEvents batch
    # (net/columnar.py) — Core.sync accepts both; to_dict downconverts
    # so a columnar payload can still ride the legacy JSON framing.
    events: object = field(default_factory=list)
    known: Dict[int, int] = field(default_factory=dict)
    # Clock handshake echo: the request's ClockSend (t0), the
    # responder's receive stamp (t1, taken when the RPC object was
    # constructed — before queue wait) and reply stamp (t2), all
    # epoch-domain ns on the responder's clock except t_origin. Zero =
    # the responder does not speak the handshake.
    t_origin: int = 0
    t_recv: int = 0
    t_reply: int = 0
    # Responder's consensus health sidecar — see SyncRequest.health.
    health: Optional[dict] = None

    def to_dict(self) -> dict:
        events = self.events
        if not isinstance(events, list):
            events = events.to_wire_events()
        d = {
            "FromID": self.from_id,
            "SyncLimit": self.sync_limit,
            "Events": [e.to_dict() for e in events],
            "Known": {str(k): v for k, v in self.known.items()},
        }
        if self.t_recv:
            d["ClockOrigin"] = self.t_origin
            d["ClockRecv"] = self.t_recv
            d["ClockReply"] = self.t_reply
        if self.health is not None:
            d["Health"] = self.health
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SyncResponse":
        return cls(
            from_id=d["FromID"],
            sync_limit=d.get("SyncLimit", False),
            events=[WireEvent.from_json_obj(e) for e in (d.get("Events") or [])],
            known={int(k): v for k, v in (d.get("Known") or {}).items()},
            t_origin=d.get("ClockOrigin", 0),
            t_recv=d.get("ClockRecv", 0),
            t_reply=d.get("ClockReply", 0),
            health=d.get("Health"),
        )


@dataclass
class EagerSyncRequest:
    from_id: int
    # Legacy List[WireEvent] or a packed ColumnarEvents batch.
    events: object = field(default_factory=list)
    # Plumtree eager-push marker (docs/gossip.md): True when this push
    # is an epidemic-broadcast tree edge rather than the reference's
    # round-trailing push — the receiver uses it to pick the `eager`
    # accounting leg and to answer redundant edges with PRUNE. Same
    # sidecar contract as the clock stamps: rides the dict only when
    # set, so the legacy wire form is byte-identical and legacy
    # decoders ignore the extra key.
    plum: bool = False

    def to_dict(self) -> dict:
        events = self.events
        if not isinstance(events, list):
            events = events.to_wire_events()
        d = {
            "FromID": self.from_id,
            "Events": [e.to_dict() for e in events],
        }
        if self.plum:
            d["Plum"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "EagerSyncRequest":
        return cls(
            from_id=d["FromID"],
            events=[WireEvent.from_json_obj(e) for e in (d.get("Events") or [])],
            plum=bool(d.get("Plum", False)),
        )


@dataclass
class EagerSyncResponse:
    from_id: int
    success: bool = False

    def to_dict(self) -> dict:
        return {"FromID": self.from_id, "Success": self.success}

    @classmethod
    def from_dict(cls, d: dict) -> "EagerSyncResponse":
        return cls(from_id=d["FromID"], success=d.get("Success", False))


# -- epidemic broadcast tree RPCs (docs/gossip.md) -----------------------
#
# Plumtree lazy-repair plane: IHAVE announces fresh events to lazy
# peers as compact digests (event hash + creator/index coordinates),
# GRAFT pulls a gap from a peer and promotes the edge to eager, PRUNE
# demotes a redundant eager edge back to lazy. None of these exist in
# the reference (its gossip is pull-only); all three follow the sidecar
# discipline of the other extensions — plain Go-style JSON dicts, no
# signed bodies, and a request-matching response type even on errors
# (the PR 2 not-ready rule).


@dataclass
class IHaveRequest:
    """Digest announcement to a lazy peer. Digests are
    (creator_id, index, event_hex) triples — enough for the receiver to
    check its store, dedupe announcers, and name the exact gap in a
    GRAFT. `digests` may also arrive as a packed `ColumnarDigests`
    (net/columnar.py) on the binary TCP framing."""

    from_id: int
    digests: object = field(default_factory=list)

    def to_dict(self) -> dict:
        digests = self.digests
        if not isinstance(digests, list):
            digests = digests.to_list()
        return {
            "FromID": self.from_id,
            "Digests": [[c, i, h] for (c, i, h) in digests],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IHaveRequest":
        return cls(
            from_id=d["FromID"],
            digests=[(int(c), int(i), str(h))
                     for c, i, h in (d.get("Digests") or [])],
        )


@dataclass
class IHaveResponse:
    from_id: int
    success: bool = True

    def to_dict(self) -> dict:
        return {"FromID": self.from_id, "Success": self.success}

    @classmethod
    def from_dict(cls, d: dict) -> "IHaveResponse":
        return cls(from_id=d["FromID"], success=d.get("Success", True))


@dataclass
class GraftRequest:
    """Lazy pull + eager promotion: 'send me what I'm missing and keep
    me on your eager set'. Carries the requester's known map so the
    responder serves an exact diff (the missing event AND its
    not-yet-seen ancestors, which a hash-only pull could not name)."""

    from_id: int
    known: Dict[int, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"FromID": self.from_id,
                "Known": {str(k): v for k, v in self.known.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "GraftRequest":
        return cls(
            from_id=d["FromID"],
            known={int(k): v for k, v in (d.get("Known") or {}).items()},
        )


@dataclass
class GraftResponse:
    from_id: int
    # Legacy List[WireEvent] or a packed ColumnarEvents batch, exactly
    # like SyncResponse.events.
    events: object = field(default_factory=list)
    # True when the requester is too far behind for a bounded diff
    # (same semantics as SyncResponse.sync_limit): fast-sync instead.
    sync_limit: bool = False

    def to_dict(self) -> dict:
        events = self.events
        if not isinstance(events, list):
            events = events.to_wire_events()
        return {
            "FromID": self.from_id,
            "SyncLimit": self.sync_limit,
            "Events": [e.to_dict() for e in events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GraftResponse":
        return cls(
            from_id=d["FromID"],
            sync_limit=d.get("SyncLimit", False),
            events=[WireEvent.from_json_obj(e)
                    for e in (d.get("Events") or [])],
        )


@dataclass
class PruneRequest:
    """'Stop eager-pushing at me — I already had that': demote the
    sender->receiver tree edge to lazy (IHAVE digests keep flowing, so
    the edge still repairs losses)."""

    from_id: int

    def to_dict(self) -> dict:
        return {"FromID": self.from_id}

    @classmethod
    def from_dict(cls, d: dict) -> "PruneRequest":
        return cls(from_id=d["FromID"])


@dataclass
class PruneResponse:
    from_id: int
    success: bool = True

    def to_dict(self) -> dict:
        return {"FromID": self.from_id, "Success": self.success}

    @classmethod
    def from_dict(cls, d: dict) -> "PruneResponse":
        return cls(from_id=d["FromID"], success=d.get("Success", True))


@dataclass
class FastForwardRequest:
    """Fast-sync: ask a peer for its current Frame (roots + events).
    The reference stops at a stub here (node/node.go:432-441); this
    completes the intended flow using GetFrame/Reset
    (hashgraph.go:879-1002)."""

    from_id: int

    def to_dict(self) -> dict:
        return {"FromID": self.from_id}

    @classmethod
    def from_dict(cls, d: dict) -> "FastForwardRequest":
        return cls(from_id=d["FromID"])


@dataclass
class FastForwardResponse:
    """Frame payload: roots as Root.to_dict() maps, events as full
    Go-JSON event objects (signatures included — the receiver
    re-verifies on insert)."""

    from_id: int
    roots: Dict[str, dict] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "FromID": self.from_id,
            "Roots": self.roots,
            "Events": self.events,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FastForwardResponse":
        return cls(
            from_id=d["FromID"],
            roots=d.get("Roots") or {},
            events=d.get("Events") or [],
        )


@dataclass
class RPCResponse:
    response: object
    error: Optional[Exception] = None


class RPC:
    """An inbound request plus its response channel. `recv_pc_ns` is
    the raw perf_counter receive stamp, taken at construction — i.e.
    before any consumer-queue wait — so the clock handshake's t1 is
    the closest thing to wire arrival every transport can offer
    without protocol changes (the node rebases it onto its epoch)."""

    __slots__ = ("command", "resp_chan", "recv_pc_ns", "wire")

    def __init__(self, command, resp_chan: Optional[queue.Queue] = None,
                 wire: str = ""):
        self.command = command
        self.resp_chan = resp_chan if resp_chan is not None else queue.Queue(1)
        self.recv_pc_ns = time.perf_counter_ns()
        # Wire format the response must be framed in ("" = legacy
        # Go-JSON): set by the TCP transport from the inbound frame
        # type so the columnar negotiation stays transport-local.
        self.wire = wire

    def respond(self, resp, err: Optional[Exception] = None) -> None:
        self.resp_chan.put(RPCResponse(resp, err))


class Transport(Protocol):
    def consumer(self) -> "queue.Queue[RPC]": ...

    def local_addr(self) -> str: ...

    def sync(self, target: str, args: SyncRequest) -> SyncResponse: ...

    def eager_sync(self, target: str, args: EagerSyncRequest) -> EagerSyncResponse: ...

    def ihave(self, target: str, args: IHaveRequest) -> IHaveResponse: ...

    def graft(self, target: str, args: GraftRequest) -> GraftResponse: ...

    def prune(self, target: str, args: PruneRequest) -> PruneResponse: ...

    def fast_forward(
        self, target: str, args: FastForwardRequest
    ) -> FastForwardResponse: ...

    def close(self) -> None: ...
