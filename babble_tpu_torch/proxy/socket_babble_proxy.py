"""App-side socket proxy: serves State.CommitBlock from babble, calls
Babble.SubmitTx on the node's app proxy.

Reference proxy/babble/socket_babble_proxy{,_server,_client}.go."""

from __future__ import annotations

import base64
import queue

from ..hashgraph.block import Block
from .jsonrpc import JSONRPCClient, JSONRPCError, JSONRPCServer


class SocketBabbleProxy:
    def __init__(self, node_addr: str, bind_addr: str, timeout: float = 1.0):
        self._client = JSONRPCClient(node_addr, timeout)
        self._commit: "queue.Queue[Block]" = queue.Queue()
        self._server = JSONRPCServer(bind_addr)
        self._server.register("State.CommitBlock", self._handle_commit_block)
        self._server.start()
        self.bind_addr = self._server.addr

    def _handle_commit_block(self, payload) -> bool:
        self._commit.put(Block.from_json_obj(payload))
        return True

    # -- BabbleProxy interface ---------------------------------------------

    def commit_ch(self) -> "queue.Queue[Block]":
        return self._commit

    def submit_tx(self, tx: bytes) -> None:
        ack = self._client.call("Babble.SubmitTx", base64.b64encode(tx).decode())
        if not ack:
            raise JSONRPCError("Failed to deliver transaction to Babble")

    def close(self) -> None:
        self._server.close()
