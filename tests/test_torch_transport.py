"""The port's transports (babble_tpu_torch/net): tests/test_transport.py's
cases on the port's InmemTransport and TCPTransport, its TCP-only cases,
and wire parity with the reference's TCPTransport. Tolerance: exact
equality.

Wire parity: a relay in front of the server records the bytes of each
direction. Sync, eager-sync and fast-forward requests go from a client
of one package to a server of either package, in both wire formats
(columnar, negotiated per peer, and gojson). The recorded bytes, the
request the server decoded and the response the client decoded equal
those of the reference client against the reference server."""

from __future__ import annotations

import json
import queue
import socket
import threading
import time

import pytest

import babble_tpu.gojson as ref_gojson
import babble_tpu.hashgraph.event as ref_event
import babble_tpu.net as ref_net
import babble_tpu.net.transport as ref_transport
import babble_tpu_torch.gojson as port_gojson
import babble_tpu_torch.hashgraph.event as port_event
import babble_tpu_torch.net as port_net
import babble_tpu_torch.net.transport as port_transport
from babble_tpu_torch.net import InmemTransport, TCPTransport
from babble_tpu_torch.net.inmem_transport import connect_all
from babble_tpu_torch.net.transport import (
    EagerSyncRequest,
    EagerSyncResponse,
    FastForwardRequest,
    FastForwardResponse,
    SyncRequest,
    SyncResponse,
    TransportError,
)

KINDS = ["inmem", "tcp"]


def make_pair(kind, **kw):
    if kind == "inmem":
        t1 = InmemTransport("addrA", timeout=1.0)
        t2 = InmemTransport("addrB", timeout=1.0)
        connect_all([t1, t2])
    else:
        t1 = TCPTransport("127.0.0.1:0", timeout=1.0, **kw)
        t2 = TCPTransport("127.0.0.1:0", timeout=1.0, **kw)
    return t1, t2


def wire_event(ev_mod=port_event, gojson=port_gojson):
    return ev_mod.WireEvent(
        ev_mod.WireBody(transactions=None, self_parent_index=1, other_parent_creator_id=10,
                        other_parent_index=0, creator_id=9,
                        timestamp=gojson.Timestamp(1_700_000_000_000_000_123), index=1),
        r=12345, s=67890)


def serve(trans, expect_type, resp, n=1, fail=None, got=None):
    """Answer n inbound RPCs with `resp`; the commands go to `got`."""

    def loop():
        for _ in range(n):
            try:
                rpc = trans.consumer().get(timeout=5.0)
            except queue.Empty:
                return
            assert isinstance(rpc.command, expect_type)
            if got is not None:
                got.append(rpc.command)
            rpc.respond(resp, fail)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


# -- tests/test_transport.py's cases on the port -----------------------


@pytest.mark.parametrize("kind", KINDS)
def test_start_stop(kind):
    t1, t2 = make_pair(kind)
    t1.close()
    t2.close()


@pytest.mark.parametrize("kind", KINDS)
def test_sync_round_trip(kind):
    t1, t2 = make_pair(kind)
    try:
        got = []
        resp = SyncResponse(from_id=1, events=[wire_event()], known={0: 4, 1: 5, 2: 6})
        serve(t1, SyncRequest, resp, got=got)
        out = t2.sync(t1.local_addr(), SyncRequest(from_id=0, known={0: 1, 1: 2, 2: 3}))
        assert got[0].known == {0: 1, 1: 2, 2: 3} and got[0].from_id == 0
        assert out.from_id == 1 and out.sync_limit is False
        assert out.known == {0: 4, 1: 5, 2: 6}
        assert len(out.events) == 1
        events = out.events if isinstance(out.events, list) else out.events.to_wire_events()
        we = events[0]
        assert we.body.self_parent_index == 1 and we.body.other_parent_creator_id == 10
        assert we.body.creator_id == 9
        assert int(we.r) == 12345 and int(we.s) == 67890
    finally:
        t1.close()
        t2.close()


@pytest.mark.parametrize("kind", KINDS)
def test_eager_sync_round_trip(kind):
    t1, t2 = make_pair(kind)
    try:
        serve(t1, EagerSyncRequest, EagerSyncResponse(1, True))
        out = t2.eager_sync(t1.local_addr(), EagerSyncRequest(0, [wire_event()]))
        assert out.from_id == 1 and out.success is True
    finally:
        t1.close()
        t2.close()


@pytest.mark.parametrize("kind", KINDS)
def test_fast_forward_round_trip(kind):
    t1, t2 = make_pair(kind)
    try:
        resp = FastForwardResponse(
            1, roots={"0xAB": {"X": "h1", "Y": "h2", "Index": 3, "Round": 2, "Others": {}}},
            events=[{"Body": {"Index": 0}}])
        serve(t1, FastForwardRequest, resp)
        out = t2.fast_forward(t1.local_addr(), FastForwardRequest(0))
        assert out.from_id == 1 and out.roots["0xAB"]["Index"] == 3
        assert out.events == [{"Body": {"Index": 0}}]
    finally:
        t1.close()
        t2.close()


@pytest.mark.parametrize("kind", KINDS)
def test_error_response_propagates(kind):
    t1, t2 = make_pair(kind)
    try:
        serve(t1, SyncRequest, SyncResponse(1), fail=TransportError("busy"))
        with pytest.raises(TransportError):
            t2.sync(t1.local_addr(), SyncRequest(0, {}))
    finally:
        t1.close()
        t2.close()


def test_inmem_unknown_peer():
    t1 = InmemTransport("addrA", timeout=0.3)
    with pytest.raises(TransportError):
        t1.sync("nowhere", SyncRequest(0, {}))
    t1.close()


def test_inmem_timeout_on_nonconsuming_peer():
    t1, t2 = make_pair("inmem")
    try:
        t0 = time.monotonic()
        with pytest.raises(TransportError):
            t2.sync(t1.local_addr(), SyncRequest(0, {}))
        assert time.monotonic() - t0 < 5.0
    finally:
        t1.close()
        t2.close()


def test_tcp_pooled_conn_reuse():
    t1, t2 = make_pair("tcp", max_pool=2)
    try:
        serve(t1, SyncRequest, SyncResponse(1, events=[wire_event()]), n=40)
        errs = []

        def worker():
            try:
                for _ in range(5):
                    assert t2.sync(t1.local_addr(), SyncRequest(0, {0: 1})).from_id == 1
            except Exception as exc:  # noqa: BLE001 - reported below
                errs.append(exc)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20.0)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        with t2._pool_lock:
            pooled = sum(len(v) for v in t2._pool.values())
        assert 1 <= pooled <= 2, f"pool size {pooled} vs max_pool 2"
    finally:
        t1.close()
        t2.close()


def test_tcp_garbage_frame_does_not_kill_listener():
    t1, t2 = make_pair("tcp")
    try:
        host, port = t1.local_addr().rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=1.0)
        s.sendall(b"\xff this is not a frame\n")
        time.sleep(0.2)
        s.close()
        serve(t1, SyncRequest, SyncResponse(1))
        assert t2.sync(t1.local_addr(), SyncRequest(0, {})).from_id == 1
    finally:
        t1.close()
        t2.close()


def test_tcp_sync_after_peer_restart():
    t1, t2 = make_pair("tcp")
    addr = t1.local_addr()
    try:
        serve(t1, SyncRequest, SyncResponse(1))
        assert t2.sync(addr, SyncRequest(0, {})).from_id == 1
        t1.close()
        time.sleep(0.1)
        with pytest.raises(TransportError):
            t2.sync(addr, SyncRequest(0, {}))
    finally:
        t1.close()
        t2.close()


def test_tcp_response_timeout_and_consumer_buffer_params():
    t1 = TCPTransport("127.0.0.1:0", timeout=1.0)
    t2 = TCPTransport("127.0.0.1:0", timeout=2.0, response_timeout=0.4, consumer_buffer=1)
    assert t2._response_timeout == 0.4 and t2._consumer.maxsize == 1
    assert t1._response_timeout == 10.0
    results = {}

    def call(tag):
        t0 = time.monotonic()
        try:
            t1.sync(t2.local_addr(), SyncRequest(0, {}))
            results[tag] = ("ok", time.monotonic() - t0)
        except TransportError as exc:
            results[tag] = (str(exc), time.monotonic() - t0)

    try:
        first = threading.Thread(target=call, args=("first",))
        first.start()
        time.sleep(0.15)  # the first RPC fills the one-slot queue
        second = threading.Thread(target=call, args=("second",))
        second.start()
        first.join(timeout=5.0)
        second.join(timeout=5.0)
        assert not first.is_alive() and not second.is_alive()
        msg, dt = results["second"]
        assert "consumer queue full" in msg, results
        assert dt < 0.3, f"full-queue rejection took {dt:.2f}s"
        assert "rpc handler timed out" in results["first"][0], results
    finally:
        t1.close()
        t2.close()


# -- wire parity with the reference ------------------------------------


class Tap:
    """A TCP relay to `target` that records the bytes of each direction."""

    def __init__(self, target):
        host, port = target.rsplit(":", 1)
        self.target = (host, int(port))
        self.up, self.down = bytearray(), bytearray()
        self.lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.threads = [threading.Thread(target=self._accept, daemon=True)]
        self.threads[0].start()

    def _accept(self):
        while True:
            try:
                client, _ = self.sock.accept()
            except OSError:
                return
            server = socket.create_connection(self.target, timeout=5.0)
            for src, dst, buf in ((client, server, self.up), (server, client, self.down)):
                t = threading.Thread(target=self._pump, args=(src, dst, buf), daemon=True)
                t.start()
                self.threads.append(t)

    def _pump(self, src, dst, buf):
        try:
            while data := src.recv(65536):
                with self.lock:
                    buf.extend(data)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self.sock.close()


PKGS = {
    "ref": (ref_net, ref_transport, ref_event, ref_gojson),
    "port": (port_net, port_transport, port_event, port_gojson),
}
RPCS = ["sync", "eager_sync", "fast_forward"]


def canonical(obj):
    """A decoded request or response as plain JSON text."""
    d = obj.to_dict() if hasattr(obj, "to_dict") else dict(vars(obj))
    for k, v in list(d.items()):
        if hasattr(v, "to_wire_events"):
            v = v.to_wire_events()
        if isinstance(v, list):
            d[k] = [x.to_json_obj() if hasattr(x, "to_json_obj") else x for x in v]
    return json.dumps(d, sort_keys=True, default=str)


def exchange(client_pkg, server_pkg, wire_format, rpc):
    """One RPC from a client of `client_pkg` through a Tap to a server of
    `server_pkg`: (request bytes, response bytes, request as the server
    decoded it, response as the client decoded it)."""
    c_net, c_tr, c_ev, c_go = PKGS[client_pkg]
    s_net, s_tr, s_ev, s_go = PKGS[server_pkg]
    server = s_net.TCPTransport("127.0.0.1:0", timeout=2.0, wire_format=wire_format)
    client = c_net.TCPTransport("127.0.0.1:0", timeout=2.0, wire_format=wire_format)
    tap = Tap(server.local_addr())
    got = []
    try:
        if rpc == "sync":
            resp = s_tr.SyncResponse(from_id=1, events=[wire_event(s_ev, s_go)],
                                     known={0: 4, 1: 5, 2: 6})
            expect, call = s_tr.SyncRequest, lambda: client.sync(
                tap.addr, c_tr.SyncRequest(from_id=0, known={0: 1, 1: 2, 2: 3}))
        elif rpc == "eager_sync":
            resp = s_tr.EagerSyncResponse(1, True)
            expect, call = s_tr.EagerSyncRequest, lambda: client.eager_sync(
                tap.addr, c_tr.EagerSyncRequest(0, [wire_event(c_ev, c_go)]))
        else:
            resp = s_tr.FastForwardResponse(
                1, roots={"0xAB": {"X": "h1", "Y": "h2", "Index": 3, "Round": 2, "Others": {}}},
                events=[{"Body": {"Index": 0}}])
            expect, call = s_tr.FastForwardRequest, lambda: client.fast_forward(
                tap.addr, c_tr.FastForwardRequest(0))
        worker = serve(server, expect, resp, got=got)
        out = call()
        worker.join(timeout=5.0)
        assert not worker.is_alive() and len(got) == 1
    finally:
        client.close()
        server.close()
        tap.close()
    deadline = time.monotonic() + 5.0
    while any(t.is_alive() for t in tap.threads[1:]) and time.monotonic() < deadline:
        time.sleep(0.01)
    with tap.lock:
        return bytes(tap.up), bytes(tap.down), canonical(got[0]), canonical(out)


@pytest.mark.parametrize("rpc", RPCS)
@pytest.mark.parametrize("wire_format", ["columnar", "gojson"])
def test_tcp_wire_parity_with_reference(wire_format, rpc):
    base = exchange("ref", "ref", wire_format, rpc)
    assert base[0] and base[1]
    for client, server in (("port", "ref"), ("ref", "port"), ("port", "port")):
        assert exchange(client, server, wire_format, rpc) == base, (client, server)
