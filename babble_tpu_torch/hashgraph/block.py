"""Commit unit: the transactions of one received round.

Reference: hashgraph/block.go:11-61 — {RoundReceived, Transactions} with
a SHA-256 hash over the Go-JSON encoding.
"""

from __future__ import annotations

import base64
from typing import List, Optional

from .. import crypto
from ..gojson import GoStruct, marshal


class Block(GoStruct):
    go_fields = (
        ("RoundReceived", "round_received"),
        ("Transactions", "transactions"),
    )

    def __init__(self, round_received: int, transactions: Optional[List[bytes]]):
        self.round_received = round_received
        self.transactions = transactions
        self._hash = b""
        self._hex = ""

    def marshal(self) -> bytes:
        return marshal(self)

    def hash(self) -> bytes:
        if not self._hash:
            self._hash = crypto.sha256(self.marshal())
        return self._hash

    def hex(self) -> str:
        if not self._hex:
            self._hex = "0x" + self.hash().hex().upper()
        return self._hex

    def to_json_obj(self) -> dict:
        """The one wire/storage shape for blocks (Go-JSON compatible:
        []byte -> base64, nil slice -> null). Used by the socket
        proxies and the persistent store — keep them byte-identical."""
        return {
            "RoundReceived": self.round_received,
            "Transactions": (
                None
                if self.transactions is None
                else [base64.b64encode(t).decode() for t in self.transactions]
            ),
        }

    @classmethod
    def from_json_obj(cls, obj: dict) -> "Block":
        txs = obj.get("Transactions")
        return cls(
            obj.get("RoundReceived", 0),
            None if txs is None else [base64.b64decode(t) for t in txs],
        )

    def __repr__(self) -> str:
        ntx = len(self.transactions) if self.transactions else 0
        return f"Block(rr={self.round_received}, txs={ntx})"
