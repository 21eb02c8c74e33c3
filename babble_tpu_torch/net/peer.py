"""Peer addressing + the peers.json store.

Reference net/peer.go:16-141. The sorted-pubkey order of peers.json is
the canonical participant-id assignment (reference
cmd/babble/main.go:215-225)."""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class Peer:
    net_addr: str
    pub_key_hex: str

    def pub_key_bytes(self) -> bytes:
        return bytes.fromhex(self.pub_key_hex[2:])

    def to_dict(self) -> dict:
        return {"NetAddr": self.net_addr, "PubKeyHex": self.pub_key_hex}

    @classmethod
    def from_dict(cls, d: dict) -> "Peer":
        return cls(net_addr=d["NetAddr"], pub_key_hex=d["PubKeyHex"])


JSON_PEER_PATH = "peers.json"


class StaticPeers:
    def __init__(self, peers: List[Peer] | None = None):
        self._peers = list(peers or [])
        self._lock = threading.Lock()

    def peers(self) -> List[Peer]:
        with self._lock:
            return list(self._peers)

    def set_peers(self, peers: List[Peer]) -> None:
        with self._lock:
            self._peers = list(peers)


class JSONPeers:
    """peers.json-backed store, file format compatible with the
    reference (a JSON array of {NetAddr, PubKeyHex})."""

    def __init__(self, base: str):
        self.path = os.path.join(base, JSON_PEER_PATH)
        self._lock = threading.Lock()

    def peers(self) -> List[Peer]:
        with self._lock:
            with open(self.path, "rb") as f:
                buf = f.read()
            if not buf:
                return []
            return [Peer.from_dict(d) for d in json.loads(buf)]

    def set_peers(self, peers: List[Peer]) -> None:
        with self._lock:
            data = json.dumps([p.to_dict() for p in peers]).encode() + b"\n"
            with open(self.path, "wb") as f:
                f.write(data)


def exclude_peer(peers: List[Peer], addr: str) -> Tuple[int, List[Peer]]:
    """Returns (index of excluded peer or -1, remaining peers)."""
    index = -1
    others: List[Peer] = []
    for i, p in enumerate(peers):
        if p.net_addr != addr:
            others.append(p)
        else:
            index = i
    return index, others


def sort_peers_by_pub_key(peers: List[Peer]) -> List[Peer]:
    return sorted(peers, key=lambda p: p.pub_key_hex)
