"""Minimal Go-net/rpc/jsonrpc-compatible client and server.

Wire format (one JSON value per line, as Go's codec emits):
  request:  {"method": "Service.Method", "params": [arg], "id": N}
  response: {"id": N, "result": <value>, "error": null | "msg"}
[]byte params/results are base64 strings, matching encoding/json."""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable, Dict, Optional


class JSONRPCError(Exception):
    pass


class JSONRPCClient:
    """One call per connection, like the reference's dial-per-call
    clients (proxy/app/socket_app_proxy_client.go:28-47)."""

    def __init__(self, addr: str, timeout: float = 1.0):
        host, port_s = addr.rsplit(":", 1)
        self._addr = (host, int(port_s))
        self._timeout = timeout
        self._seq = 0

    def call(self, method: str, param) -> object:
        self._seq += 1
        req = {"method": method, "params": [param], "id": self._seq}
        with socket.create_connection(self._addr, timeout=self._timeout) as sock:
            sock.settimeout(self._timeout)
            sock.sendall(json.dumps(req).encode() + b"\n")
            reader = sock.makefile("rb")
            line = reader.readline()
        if not line:
            raise JSONRPCError("connection closed")
        resp = json.loads(line)
        if resp.get("error"):
            raise JSONRPCError(str(resp["error"]))
        return resp.get("result")


class JSONRPCServer:
    """Threaded line-JSON RPC server; handlers take the decoded param
    and return the result value."""

    def __init__(self, bind_addr: str):
        host, port_s = bind_addr.rsplit(":", 1)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port_s)))
        self._listener.listen(16)
        self.addr = f"{host}:{self._listener.getsockname()[1]}"
        self._handlers: Dict[str, Callable[[object], object]] = {}
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, method: str, handler: Callable[[object], object]) -> None:
        self._handlers[method] = handler

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            reader = conn.makefile("rb")
            while not self._shutdown.is_set():
                line = reader.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                except ValueError:
                    return
                rid = req.get("id")
                method = req.get("method", "")
                handler = self._handlers.get(method)
                if handler is None:
                    resp = {"id": rid, "result": None,
                            "error": f"rpc: can't find method {method}"}
                else:
                    try:
                        params = req.get("params") or [None]
                        result = handler(params[0])
                        resp = {"id": rid, "result": result, "error": None}
                    except Exception as exc:  # noqa: BLE001 - surfaced to caller
                        resp = {"id": rid, "result": None, "error": str(exc)}
                conn.sendall(json.dumps(resp).encode() + b"\n")
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
