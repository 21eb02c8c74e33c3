"""TCP transport: reference wire protocol + negotiated columnar frames.

Reference net/net_transport.go:33-46,147-390 + tcp_transport.go:48-91:
- request: 1 framing byte (0x00 Sync, 0x01 EagerSync, 0x02 FastForward)
  + JSON body
- response: JSON error string ("" = ok) + JSON payload
- pooled outbound connections per target, capped at max_pool
- a listener thread accepts connections; each connection gets a handler
  thread that dispatches inbound RPCs to the consumer queue and writes
  the response back.

Bodies are encoded exactly as Go's encoding/json would (field names,
base64 []byte, RFC3339Nano timestamps), one JSON value per line — Go's
json.Encoder also terminates values with '\n', so the framing is
byte-compatible in both directions.

Columnar extension (docs/ingest.md "Wire layout"): two extra frame
types move sync payloads as length-prefixed binary columns
(net/columnar.py) instead of base64-inside-JSON-inside-readline —

    0x03 SyncColumnar:      JSON request line; response = JSON error
                            line + [u32 len][JSON header][columns]
    0x04 EagerSyncColumnar: request = [u32 len][JSON header][columns];
                            response = JSON error line + JSON payload
    0x7E WireHello:         JSON {"Wire": [versions]} -> JSON
                            {"Wire": chosen}; negotiates per peer

Negotiation is per-target and transparent: the first columnar-eligible
RPC to a peer sends WireHello on the pooled connection. A legacy peer
answers it with its normal "unknown rpc type" error — the hello body
is a plain JSON line, so the legacy handler stays framed and the
connection survives — and the sender falls back to the Go-JSON forms
(downconverting any ColumnarEvents payload), preserving mixed-cluster
interop. Every frame (JSON or binary) is capped at `max_msg_bytes`; an
oversized message raises TransportError instead of growing an
unbounded readline buffer.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
from typing import Dict, List, Optional

from ..telemetry import InstrumentedQueue, QueueInstrument, get_registry
from .columnar import ColumnarDigests, ColumnarEvents, WIRE_VERSION
from .transport import (
    FastForwardRequest,
    FastForwardResponse,
    GraftRequest,
    GraftResponse,
    IHaveRequest,
    IHaveResponse,
    PruneRequest,
    PruneResponse,
    RPC,
    EagerSyncRequest,
    EagerSyncResponse,
    SyncRequest,
    SyncResponse,
    Transport,
    TransportError,
)

RPC_SYNC = 0x00
RPC_EAGER_SYNC = 0x01
RPC_FAST_FORWARD = 0x02
RPC_SYNC_COL = 0x03
RPC_EAGER_SYNC_COL = 0x04
# Plumtree lazy-repair plane (docs/gossip.md): IHAVE digests, GRAFT
# pulls, PRUNE demotions. The *_COL variants move the payload as a
# length-prefixed binary frame when the peer negotiated columnar.
RPC_IHAVE = 0x05
RPC_IHAVE_COL = 0x06
RPC_GRAFT = 0x07
RPC_GRAFT_COL = 0x08
RPC_PRUNE = 0x09
RPC_WIRE_HELLO = 0x7E

DEFAULT_MAX_MSG_BYTES = 32 << 20


def _b64_bytes(obj):
    import base64

    if isinstance(obj, (bytes, bytearray)):
        return base64.b64encode(bytes(obj)).decode()
    raise TypeError(f"not JSON serializable: {type(obj)}")


class _Conn:
    """One pooled connection: socket + buffered reader. `count` is the
    transport's wire-byte accounting hook (format, direction, n)."""

    def __init__(self, sock: socket.socket, max_msg_bytes: int, count):
        self.sock = sock
        self.reader = sock.makefile("rb")
        self.max_msg = max_msg_bytes
        self.count = count

    def send_json(self, obj) -> None:
        data = json.dumps(obj, default=_b64_bytes).encode() + b"\n"
        self.count("gojson", "tx", len(data))
        self.sock.sendall(data)

    def recv_json(self):
        # readline with a hard cap: a misbehaving peer streaming an
        # endless unterminated line must hit a clear error, not an
        # unbounded buffer.
        line = self.reader.readline(self.max_msg + 1)
        if not line:
            raise TransportError("connection closed")
        if len(line) > self.max_msg:
            raise TransportError(
                f"message exceeds max_msg_bytes ({self.max_msg})")
        self.count("gojson", "rx", len(line))
        return json.loads(line)

    def send_frame(self, payload: bytes) -> None:
        self.count("columnar", "tx", len(payload) + 4)
        self.sock.sendall(struct.pack(">I", len(payload)))
        self.sock.sendall(payload)

    def recv_frame(self) -> bytes:
        head = self._read_exact(4)
        (n,) = struct.unpack(">I", head)
        if n > self.max_msg:
            raise TransportError(
                f"frame of {n} bytes exceeds max_msg_bytes "
                f"({self.max_msg})")
        payload = self._read_exact(n)
        self.count("columnar", "rx", n + 4)
        return payload

    def _read_exact(self, n: int) -> bytes:
        buf = self.reader.read(n)
        if buf is None or len(buf) < n:
            raise TransportError("connection closed mid-frame")
        return buf

    def close(self) -> None:
        try:
            self.reader.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _pack_sync_response(resp: SyncResponse) -> bytes:
    """[u32 header len][header JSON][columns] — the header is the
    normal SyncResponse dict minus Events (clock stamps included)."""
    events = resp.events
    if isinstance(events, list):
        events = ColumnarEvents.from_wire_events(events)
    header = {
        "FromID": resp.from_id,
        "SyncLimit": resp.sync_limit,
        "Known": {str(k): v for k, v in resp.known.items()},
    }
    if resp.t_recv:
        header["ClockOrigin"] = resp.t_origin
        header["ClockRecv"] = resp.t_recv
        header["ClockReply"] = resp.t_reply
    if resp.health is not None:
        header["Health"] = resp.health
    hb = json.dumps(header).encode()
    return struct.pack(">I", len(hb)) + hb + events.encode()


def _decode_events(buf) -> ColumnarEvents:
    """Inbound event-frame decode. When any node in this process has
    opted into the procs runtime, large frames route through its
    decode plane — the integrity validation runs on a worker process,
    off the GIL the gossip threads need (docs/runtime.md "Decode
    plane"); otherwise (and for small frames, and on any worker
    failure) this is exactly `ColumnarEvents.decode`. Lazy import:
    net/ must not import node/ at module load."""
    from ..node.runtime import decode_columnar
    return decode_columnar(buf)


def _unpack_sync_response(buf: bytes) -> SyncResponse:
    if len(buf) < 4:
        raise TransportError("short columnar sync response")
    (hlen,) = struct.unpack_from(">I", buf)
    header = json.loads(buf[4:4 + hlen])
    resp = SyncResponse(
        from_id=header["FromID"],
        sync_limit=header.get("SyncLimit", False),
        known={int(k): v for k, v in (header.get("Known") or {}).items()},
        t_origin=header.get("ClockOrigin", 0),
        t_recv=header.get("ClockRecv", 0),
        t_reply=header.get("ClockReply", 0),
        health=header.get("Health"),
    )
    resp.events = _decode_events(buf[4 + hlen:])
    return resp


def _pack_eager_request(req: EagerSyncRequest) -> bytes:
    events = req.events
    if isinstance(events, list):
        events = ColumnarEvents.from_wire_events(events)
    header = {"FromID": req.from_id}
    if req.plum:
        header["Plum"] = True
    hb = json.dumps(header).encode()
    return struct.pack(">I", len(hb)) + hb + events.encode()


def _unpack_eager_request(buf: bytes) -> EagerSyncRequest:
    if len(buf) < 4:
        raise TransportError("short columnar eager request")
    (hlen,) = struct.unpack_from(">I", buf)
    header = json.loads(buf[4:4 + hlen])
    return EagerSyncRequest(
        from_id=header["FromID"],
        events=_decode_events(buf[4 + hlen:]),
        plum=bool(header.get("Plum", False)),
    )


def _pack_ihave_request(req: IHaveRequest) -> bytes:
    digests = req.digests
    if isinstance(digests, list):
        digests = ColumnarDigests.from_list(digests)
    hb = json.dumps({"FromID": req.from_id}).encode()
    return struct.pack(">I", len(hb)) + hb + digests.encode()


def _unpack_ihave_request(buf: bytes) -> IHaveRequest:
    if len(buf) < 4:
        raise TransportError("short columnar ihave request")
    (hlen,) = struct.unpack_from(">I", buf)
    header = json.loads(buf[4:4 + hlen])
    return IHaveRequest(
        from_id=header["FromID"],
        digests=ColumnarDigests.decode(buf[4 + hlen:]),
    )


def _pack_graft_response(resp: GraftResponse) -> bytes:
    events = resp.events
    if isinstance(events, list):
        events = ColumnarEvents.from_wire_events(events)
    hb = json.dumps({"FromID": resp.from_id,
                     "SyncLimit": resp.sync_limit}).encode()
    return struct.pack(">I", len(hb)) + hb + events.encode()


def _unpack_graft_response(buf: bytes) -> GraftResponse:
    if len(buf) < 4:
        raise TransportError("short columnar graft response")
    (hlen,) = struct.unpack_from(">I", buf)
    header = json.loads(buf[4:4 + hlen])
    resp = GraftResponse(
        from_id=header["FromID"],
        sync_limit=header.get("SyncLimit", False),
    )
    resp.events = _decode_events(buf[4 + hlen:])
    return resp


class TCPTransport:
    def __init__(
        self,
        bind_addr: str,
        advertise: Optional[str] = None,
        max_pool: int = 3,
        timeout: float = 1.0,
        response_timeout: Optional[float] = None,
        consumer_buffer: int = 16,
        wire_format: str = "columnar",
        max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES,
    ):
        """`timeout` bounds outbound socket operations; a connection
        handler waits `response_timeout` (default 10x timeout) for the
        node to answer an inbound RPC before reporting a handler
        timeout to the caller. `consumer_buffer` caps queued inbound
        RPCs — when it is full the handler answers with a
        TransportError immediately instead of stalling its connection
        (overload is signalled, not absorbed). `wire_format`
        ("columnar" | "gojson") picks the preferred sync payload
        encoding; columnar is negotiated per peer with transparent
        legacy fallback. `max_msg_bytes` bounds any single JSON line or
        binary frame in either direction."""
        host, port_s = bind_addr.rsplit(":", 1)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port_s)))
        self._listener.listen(64)
        bound_port = self._listener.getsockname()[1]
        self._addr = advertise or f"{host}:{bound_port}"
        if self._addr.startswith(":"):
            raise TransportError("local bind address is not advertisable")

        # Inbound RPC queue, instrumented (docs/observability.md
        # "Saturation"): depth/capacity/wait/drops under
        # babble_queue_*{queue="tcp_consumer"}. Process-global registry
        # (the transport predates its node), labelled by bind address.
        self._consumer: "queue.Queue[RPC]" = InstrumentedQueue(
            max(1, consumer_buffer),
            QueueInstrument(
                get_registry(), "tcp_consumer", max(1, consumer_buffer),
                addr=self._addr))
        self._pool: Dict[str, List[_Conn]] = {}
        self._pool_lock = threading.Lock()
        self._max_pool = max_pool
        self._timeout = timeout
        self._response_timeout = (
            response_timeout if response_timeout is not None
            else timeout * 10)
        self._wire_format = wire_format
        self._max_msg_bytes = max_msg_bytes
        # Per-target negotiated wire: True = peer speaks columnar,
        # False = legacy. Absent = not yet negotiated.
        self._peer_columnar: Dict[str, bool] = {}
        self._wire_lock = threading.Lock()
        reg = get_registry()
        self._byte_counters = {
            (fmt, d): reg.counter(
                "babble_wire_bytes_total",
                "Bytes moved on the gossip wire by payload format and "
                "direction", format=fmt, dir=d)
            for fmt in ("gojson", "columnar") for d in ("tx", "rx")
        }
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []

        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _count(self, fmt: str, direction: str, n: int) -> None:
        self._byte_counters[(fmt, direction)].inc(n)

    # -- Transport interface ----------------------------------------------

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._addr

    def sync(self, target: str, args: SyncRequest) -> SyncResponse:
        if self._use_columnar(target):
            args.wire = WIRE_VERSION
            out = self._columnar_sync_rpc(target, args.to_dict())
            return out
        args.wire = ""
        out = self._generic_rpc(target, RPC_SYNC, args.to_dict())
        return SyncResponse.from_dict(out)

    def eager_sync(self, target: str, args: EagerSyncRequest) -> EagerSyncResponse:
        if self._use_columnar(target):
            out = self._columnar_eager_rpc(target, args)
            return EagerSyncResponse.from_dict(out)
        # Legacy peer: downconvert a columnar payload transparently.
        out = self._generic_rpc(target, RPC_EAGER_SYNC, args.to_dict())
        return EagerSyncResponse.from_dict(out)

    def ihave(self, target: str, args: IHaveRequest) -> IHaveResponse:
        if self._use_columnar(target):
            out = self._frame_request_rpc(
                target, RPC_IHAVE_COL, _pack_ihave_request(args))
            return IHaveResponse.from_dict(out)
        out = self._generic_rpc(target, RPC_IHAVE, args.to_dict())
        return IHaveResponse.from_dict(out)

    def graft(self, target: str, args: GraftRequest) -> GraftResponse:
        if self._use_columnar(target):
            frame = self._frame_response_rpc(
                target, RPC_GRAFT_COL, args.to_dict())
            try:
                return _unpack_graft_response(frame)
            except (ValueError, KeyError) as exc:
                raise TransportError(
                    f"malformed columnar graft response from {target}: "
                    f"{exc}") from exc
        out = self._generic_rpc(target, RPC_GRAFT, args.to_dict())
        return GraftResponse.from_dict(out)

    def prune(self, target: str, args: PruneRequest) -> PruneResponse:
        out = self._generic_rpc(target, RPC_PRUNE, args.to_dict())
        return PruneResponse.from_dict(out)

    def fast_forward(self, target: str,
                     args: FastForwardRequest) -> FastForwardResponse:
        out = self._generic_rpc(target, RPC_FAST_FORWARD, args.to_dict())
        return FastForwardResponse.from_dict(out)

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._pool_lock:
            for conns in self._pool.values():
                for c in conns:
                    c.close()
            self._pool = {}

    # -- outbound ----------------------------------------------------------

    def _get_conn(self, target: str) -> _Conn:
        with self._pool_lock:
            conns = self._pool.get(target)
            if conns:
                return conns.pop()
        host, port_s = target.rsplit(":", 1)
        sock = socket.create_connection((host, int(port_s)), timeout=self._timeout)
        sock.settimeout(self._timeout)
        return _Conn(sock, self._max_msg_bytes, self._count)

    def _return_conn(self, target: str, conn: _Conn) -> None:
        with self._pool_lock:
            conns = self._pool.setdefault(target, [])
            if len(conns) < self._max_pool and not self._shutdown.is_set():
                conns.append(conn)
                return
        conn.close()

    def _use_columnar(self, target: str) -> bool:
        """Negotiated wire for `target`, running the WireHello handshake
        on first contact. Failures mark the peer legacy for this
        process lifetime — the RPC that follows still goes through on
        the Go-JSON forms."""
        if self._wire_format != "columnar":
            return False
        with self._wire_lock:
            got = self._peer_columnar.get(target)
        if got is not None:
            return got
        ok = False
        try:
            conn = self._get_conn(target)
            try:
                conn.sock.sendall(bytes([RPC_WIRE_HELLO]))
                conn.send_json({"Wire": [WIRE_VERSION]})
                rpc_error = conn.recv_json()
                payload = conn.recv_json()
                ok = (not rpc_error
                      and payload.get("Wire") == WIRE_VERSION)
            except (OSError, ValueError, TransportError):
                conn.close()
                raise
            self._return_conn(target, conn)
        except TransportError:
            raise
        except (OSError, ValueError) as exc:
            raise TransportError(
                f"wire hello to {target} failed: {exc}") from exc
        with self._wire_lock:
            self._peer_columnar[target] = ok
        return ok

    def _generic_rpc(self, target: str, rpc_type: int, body: dict) -> dict:
        conn = self._get_conn(target)
        try:
            conn.sock.sendall(bytes([rpc_type]))
            conn.send_json(body)
            rpc_error = conn.recv_json()
            resp = conn.recv_json()
        except (OSError, ValueError, TransportError) as exc:
            conn.close()
            raise TransportError(f"rpc to {target} failed: {exc}") from exc
        if rpc_error:
            conn.close()
            raise TransportError(f"rpc error: {rpc_error}")
        self._return_conn(target, conn)
        return resp

    def _columnar_sync_rpc(self, target: str, body: dict) -> SyncResponse:
        conn = self._get_conn(target)
        try:
            conn.sock.sendall(bytes([RPC_SYNC_COL]))
            conn.send_json(body)
            rpc_error = conn.recv_json()
            frame = conn.recv_frame() if not rpc_error else b""
        except (OSError, ValueError, TransportError) as exc:
            conn.close()
            raise TransportError(f"rpc to {target} failed: {exc}") from exc
        if rpc_error:
            conn.close()
            raise TransportError(f"rpc error: {rpc_error}")
        self._return_conn(target, conn)
        try:
            return _unpack_sync_response(frame)
        except (ValueError, KeyError) as exc:
            raise TransportError(
                f"malformed columnar response from {target}: {exc}"
            ) from exc

    def _columnar_eager_rpc(self, target: str,
                            args: EagerSyncRequest) -> dict:
        return self._frame_request_rpc(
            target, RPC_EAGER_SYNC_COL, _pack_eager_request(args))

    def _frame_request_rpc(self, target: str, rpc_type: int,
                           frame: bytes) -> dict:
        """Binary request frame -> JSON error line + JSON response (the
        EagerSyncColumnar / IHaveColumnar shape)."""
        if len(frame) > self._max_msg_bytes:
            raise TransportError(
                f"frame of {len(frame)} bytes exceeds max_msg_bytes "
                f"({self._max_msg_bytes})")
        conn = self._get_conn(target)
        try:
            conn.sock.sendall(bytes([rpc_type]))
            conn.send_frame(frame)
            rpc_error = conn.recv_json()
            resp = conn.recv_json()
        except (OSError, ValueError, TransportError) as exc:
            conn.close()
            raise TransportError(f"rpc to {target} failed: {exc}") from exc
        if rpc_error:
            conn.close()
            raise TransportError(f"rpc error: {rpc_error}")
        self._return_conn(target, conn)
        return resp

    def _frame_response_rpc(self, target: str, rpc_type: int,
                            body: dict) -> bytes:
        """JSON request line -> JSON error line + binary response frame
        (the SyncColumnar / GraftColumnar shape)."""
        conn = self._get_conn(target)
        try:
            conn.sock.sendall(bytes([rpc_type]))
            conn.send_json(body)
            rpc_error = conn.recv_json()
            frame = conn.recv_frame() if not rpc_error else b""
        except (OSError, ValueError, TransportError) as exc:
            conn.close()
            raise TransportError(f"rpc to {target} failed: {exc}") from exc
        if rpc_error:
            conn.close()
            raise TransportError(f"rpc error: {rpc_error}")
        self._return_conn(target, conn)
        return frame

    # -- inbound -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.settimeout(None)
            t = threading.Thread(target=self._handle_conn, args=(sock,), daemon=True)
            t.start()

    def _handle_conn(self, sock: socket.socket) -> None:
        conn = _Conn(sock, self._max_msg_bytes, self._count)
        try:
            while not self._shutdown.is_set():
                t = conn.reader.read(1)
                if not t:
                    return
                wire = ""
                if t[0] == RPC_WIRE_HELLO:
                    offers = conn.recv_json().get("Wire") or []
                    speak = (WIRE_VERSION
                             if (self._wire_format == "columnar"
                                 and WIRE_VERSION in offers)
                             else "gojson")
                    conn.send_json("")
                    conn.send_json({"Wire": speak})
                    continue
                if t[0] == RPC_SYNC:
                    cmd = SyncRequest.from_dict(conn.recv_json())
                elif t[0] == RPC_SYNC_COL:
                    cmd = SyncRequest.from_dict(conn.recv_json())
                    cmd.wire = WIRE_VERSION
                    wire = "columnar"
                elif t[0] == RPC_EAGER_SYNC:
                    cmd = EagerSyncRequest.from_dict(conn.recv_json())
                elif t[0] == RPC_EAGER_SYNC_COL:
                    cmd = _unpack_eager_request(conn.recv_frame())
                elif t[0] == RPC_IHAVE:
                    cmd = IHaveRequest.from_dict(conn.recv_json())
                elif t[0] == RPC_IHAVE_COL:
                    cmd = _unpack_ihave_request(conn.recv_frame())
                elif t[0] == RPC_GRAFT:
                    cmd = GraftRequest.from_dict(conn.recv_json())
                elif t[0] == RPC_GRAFT_COL:
                    cmd = GraftRequest.from_dict(conn.recv_json())
                    wire = "columnar_graft"
                elif t[0] == RPC_PRUNE:
                    cmd = PruneRequest.from_dict(conn.recv_json())
                elif t[0] == RPC_FAST_FORWARD:
                    cmd = FastForwardRequest.from_dict(conn.recv_json())
                else:
                    conn.send_json(f"unknown rpc type {t[0]}")
                    conn.send_json({})
                    continue

                rpc = RPC(cmd, wire=wire)
                if not self._consumer.put_drop(rpc):
                    # Overloaded node: fail the RPC immediately instead
                    # of blocking this handler thread (which would also
                    # stall every later RPC on this connection).
                    self._respond_error(conn, wire, "consumer queue full")
                    continue
                try:
                    rpc_resp = rpc.resp_chan.get(
                        timeout=self._response_timeout)
                except queue.Empty:
                    self._respond_error(conn, wire, "rpc handler timed out")
                    continue
                err = str(rpc_resp.error) if rpc_resp.error else ""
                payload = rpc_resp.response
                if wire == "columnar":
                    conn.send_json(err)
                    if err:
                        continue
                    conn.send_frame(_pack_sync_response(payload))
                elif wire == "columnar_graft":
                    conn.send_json(err)
                    if err:
                        continue
                    conn.send_frame(_pack_graft_response(payload))
                else:
                    conn.send_json(err)
                    conn.send_json(
                        payload.to_dict() if payload is not None else {})
        except (OSError, ValueError, TransportError):
            pass
        finally:
            conn.close()

    def _respond_error(self, conn: _Conn, wire: str, msg: str) -> None:
        conn.send_json(msg)
        if not wire.startswith("columnar"):
            conn.send_json({})
