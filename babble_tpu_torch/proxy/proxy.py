"""Proxy contracts — reference proxy/proxy.go:5-13."""

from __future__ import annotations

import queue
from typing import Protocol

from ..hashgraph.block import Block


class AppProxy(Protocol):
    """Babble-side view of the application."""

    def submit_ch(self) -> "queue.Queue[bytes]": ...

    def commit_block(self, block: Block) -> None: ...


class BabbleProxy(Protocol):
    """Application-side view of babble."""

    def commit_ch(self) -> "queue.Queue[Block]": ...

    def submit_tx(self, tx: bytes) -> None: ...
