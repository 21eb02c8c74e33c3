"""Demo chat application over the BabbleProxy.

Reference proxy/dummy.go:14-110 + cmd/dummy_client/main.go:36-77: the
app state is an append-only messages file; committed block transactions
become chat lines; stdin lines are submitted as transactions.

Usage: python -m babble_tpu_torch.dummy --name client1 \
           --client_addr 127.0.0.1:1339 --node_addr 127.0.0.1:1338
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import List, Optional

from .hashgraph.block import Block
from .proxy.socket_babble_proxy import SocketBabbleProxy


class State:
    """Append-only chat log — reference proxy/dummy.go:14-46."""

    def __init__(self, log_path: Optional[str] = None):
        self.messages: List[str] = []
        self.log_path = log_path

    def commit_block(self, block: Block) -> None:
        for tx in block.transactions or []:
            msg = tx.decode(errors="replace")
            self.messages.append(msg)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(msg + "\n")

    def get_committed_transactions(self) -> List[str]:
        return list(self.messages)


class DummyClient:
    """Wires a State to a SocketBabbleProxy — reference
    proxy/dummy.go:74-110."""

    def __init__(self, node_addr: str, bind_addr: str,
                 log_path: Optional[str] = None, timeout: float = 1.0):
        self.state = State(log_path)
        self.proxy = SocketBabbleProxy(node_addr, bind_addr, timeout)
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._commit_loop, daemon=True)
        self._thread.start()

    def _commit_loop(self) -> None:
        import queue

        ch = self.proxy.commit_ch()
        while not self._shutdown.is_set():
            try:
                block = ch.get(timeout=0.1)
            except queue.Empty:
                continue
            self.state.commit_block(block)

    def submit_tx(self, tx: bytes) -> None:
        self.proxy.submit_tx(tx)

    def close(self) -> None:
        self._shutdown.set()
        self.proxy.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dummy", description=__doc__)
    p.add_argument("--name", default="dummy", help="chat handle")
    p.add_argument("--client_addr", default="127.0.0.1:1339",
                   help="IP:Port to bind this client's proxy server")
    p.add_argument("--node_addr", default="127.0.0.1:1338",
                   help="IP:Port of the babble node's app proxy")
    p.add_argument("--log", default="", help="messages file (default: stdout only)")
    args = p.parse_args(argv)

    client = DummyClient(args.node_addr, args.client_addr,
                         log_path=args.log or None)
    print(f"listening on {client.proxy.bind_addr}; type messages, ^D to quit")

    def print_committed():
        seen = 0
        import time

        while True:
            msgs = client.state.get_committed_transactions()
            for m in msgs[seen:]:
                print(f"<< {m}", flush=True)
            seen = len(msgs)
            time.sleep(0.2)

    threading.Thread(target=print_committed, daemon=True).start()

    try:
        for line in sys.stdin:
            line = line.strip()
            if line:
                client.submit_tx(f"{args.name}: {line}".encode())
    except KeyboardInterrupt:
        pass
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
