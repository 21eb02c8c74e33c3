"""App integration layer.

Two mirror-image contracts (reference proxy/proxy.go:5-13):
- AppProxy (babble side): submit_ch() feeds transactions into the node;
  commit_block(block) delivers consensus blocks to the application.
- BabbleProxy (app side): commit_ch() receives blocks; submit_tx(tx)
  sends transactions to babble.

Implementations: InmemAppProxy (in-process, test/--no_client stand-in),
FileAppProxy (fsynced JSONL delivery journal with restart dedupe — the
observable app of the kill -9 crash harness), and the JSON-RPC/TCP
socket pair (SocketAppProxy on the babble side, SocketBabbleProxy in
the app process).
"""

from .proxy import AppProxy, BabbleProxy
from .file_app_proxy import FileAppProxy
from .inmem_app_proxy import InmemAppProxy
from .socket_app_proxy import SocketAppProxy
from .socket_babble_proxy import SocketBabbleProxy

__all__ = [
    "AppProxy",
    "BabbleProxy",
    "FileAppProxy",
    "InmemAppProxy",
    "SocketAppProxy",
    "SocketBabbleProxy",
]
