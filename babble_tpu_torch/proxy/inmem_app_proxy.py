"""In-process app stand-in used by tests and `run --no_client`.

Reference proxy/app/inmem_app_proxy.go:8-48."""

from __future__ import annotations

import queue
import threading
from typing import List

from ..hashgraph.block import Block


class InmemAppProxy:
    def __init__(self):
        self._submit: "queue.Queue[bytes]" = queue.Queue()
        self._committed: List[bytes] = []
        self._lock = threading.Lock()

    def submit_ch(self) -> "queue.Queue[bytes]":
        return self._submit

    def commit_block(self, block: Block) -> None:
        with self._lock:
            self._committed.extend(block.transactions or [])

    def submit_tx(self, tx: bytes) -> None:
        self._submit.put(tx)

    def committed_transactions(self) -> List[bytes]:
        with self._lock:
            return list(self._committed)
