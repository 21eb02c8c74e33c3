"""App integration layer.

Two mirror-image contracts (reference proxy/proxy.go:5-13):
- AppProxy (babble side): submit_ch() feeds transactions into the node;
  commit_block(block) delivers consensus blocks to the application.
- BabbleProxy (app side): commit_ch() receives blocks; submit_tx(tx)
  sends transactions to babble.

Implementation in the port: InmemAppProxy (in-process, test/--no_client
stand-in). FileAppProxy and the JSON-RPC/TCP socket pair are not ported
yet (ROADMAP A7b).
"""

from .proxy import AppProxy, BabbleProxy
from .inmem_app_proxy import InmemAppProxy

__all__ = [
    "AppProxy",
    "BabbleProxy",
    "InmemAppProxy",
]
