"""In-process loopback transport: the no-network multi-node fabric.

Reference net/inmem_transport.go:34-150 — a map of addr -> peer
transport; an RPC is enqueued straight onto the target's consumer
queue and the caller blocks on the response queue with a timeout."""

from __future__ import annotations

import queue
import threading
import uuid

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


def new_inmem_addr() -> str:
    return str(uuid.uuid4())


class InmemTransport:
    def __init__(self, addr: str = "", timeout: float = 0.5):
        self._addr = addr or new_inmem_addr()
        self._consumer: "queue.Queue[RPC]" = queue.Queue(16)
        self._peers: dict[str, "InmemTransport"] = {}
        self._lock = threading.RLock()
        self._timeout = timeout

    def consumer(self) -> "queue.Queue[RPC]":
        return self._consumer

    def local_addr(self) -> str:
        return self._addr

    def sync(self, target: str, args: SyncRequest) -> SyncResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, SyncResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def eager_sync(self, target: str, args: EagerSyncRequest) -> EagerSyncResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, EagerSyncResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def ihave(self, target: str, args: IHaveRequest) -> IHaveResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, IHaveResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def graft(self, target: str, args: GraftRequest) -> GraftResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, GraftResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def prune(self, target: str, args: PruneRequest) -> PruneResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, PruneResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def fast_forward(self, target: str,
                     args: FastForwardRequest) -> FastForwardResponse:
        resp = self._make_rpc(target, args)
        if not isinstance(resp, FastForwardResponse):
            raise TransportError(f"unexpected response type {type(resp)}")
        return resp

    def _make_rpc(self, target: str, args):
        with self._lock:
            peer = self._peers.get(target)
        if peer is None:
            raise TransportError(f"failed to connect to peer: {target}")
        rpc = RPC(args)
        try:
            # Bounded put: a non-consuming peer (down or wedged) must
            # surface as a timeout, not block the caller forever.
            peer._consumer.put(rpc, timeout=self._timeout)
        except queue.Full:
            raise TransportError(f"peer {target} not consuming") from None
        try:
            rpc_resp = rpc.resp_chan.get(timeout=self._timeout)
        except queue.Empty:
            raise TransportError("command timed out") from None
        if rpc_resp.error is not None:
            raise TransportError(str(rpc_resp.error))
        return rpc_resp.response

    # -- peer management (reference WithPeers) ----------------------------

    def connect(self, peer: str, trans: "InmemTransport") -> None:
        with self._lock:
            self._peers[peer] = trans

    def disconnect(self, peer: str) -> None:
        with self._lock:
            self._peers.pop(peer, None)

    def disconnect_all(self) -> None:
        with self._lock:
            self._peers = {}

    def close(self) -> None:
        self.disconnect_all()


def connect_all(transports) -> None:
    """Fully mesh a set of InmemTransports (test/demo helper)."""
    for a in transports:
        for b in transports:
            if a is not b:
                a.connect(b.local_addr(), b)
