"""Babble-side socket proxy: serves Babble.SubmitTx from the app,
calls State.CommitBlock on the app.

Reference proxy/app/socket_app_proxy{,_server,_client}.go."""

from __future__ import annotations

import base64
import queue

from ..hashgraph.block import Block
from .jsonrpc import JSONRPCClient, JSONRPCError, JSONRPCServer


class SocketAppProxy:
    def __init__(self, client_addr: str, bind_addr: str, timeout: float = 1.0):
        self._timeout = timeout
        self._client = JSONRPCClient(client_addr, timeout)
        self._submit: "queue.Queue[bytes]" = queue.Queue()
        self._server = JSONRPCServer(bind_addr)
        self._server.register("Babble.SubmitTx", self._handle_submit_tx)
        self._server.start()
        self.bind_addr = self._server.addr

    def set_client_addr(self, client_addr: str) -> None:
        """Re-point at the app client (used when the app binds an
        ephemeral port after this proxy starts)."""
        self._client = JSONRPCClient(client_addr, self._timeout)

    def _handle_submit_tx(self, tx_b64) -> bool:
        self._submit.put(base64.b64decode(tx_b64))
        return True

    # -- AppProxy interface ------------------------------------------------

    def submit_ch(self) -> "queue.Queue[bytes]":
        return self._submit

    def commit_block(self, block: Block) -> None:
        ack = self._client.call("State.CommitBlock", block.to_json_obj())
        if not ack:
            raise JSONRPCError("App returned false to CommitBlock")

    def close(self) -> None:
        self._server.close()
