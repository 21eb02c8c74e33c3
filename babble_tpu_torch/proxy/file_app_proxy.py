"""Journal-backed app stand-in: the durable sibling of InmemAppProxy.

Every committed block is appended to a JSONL journal (written+flushed
before commit_block returns; fsynced per block under sync="always" or
once per drained commit burst under sync="batch" — see __init__), so
an external observer (the kill -9 harness, tests/crash_harness.py) can
audit exactly what the application received across arbitrary process
deaths.

Exactly-once contract (docs/robustness.md "Crash recovery"): the node
advances the store's durable delivered marker only AFTER commit_block
returns, so a crash between the two re-emits the block on restart. The
journal itself closes that window: on construction the proxy reads its
own tail and silently drops redelivered blocks at or below the last
journaled round. Journal line + marker thus act as a two-phase
delivery — every tx-bearing block lands in the journal exactly once no
matter where the process dies."""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import List

from ..hashgraph.block import Block


class FileAppProxy:
    def __init__(self, path: str, sync: str = "batch"):
        # sync="always" fsyncs every committed block (power-loss safe
        # per block); "batch" (default) writes + flushes per block —
        # still torn-tail-safe under kill -9, the bytes are in the OS
        # page cache — and defers the fsync to flush(), which the node
        # calls once per drained commit burst (one fsync per intake
        # batch, the same policy family as store_sync=batch).
        self.path = path
        self.sync = sync
        self.fsync_count = 0
        self._dirty = False
        self._submit: "queue.Queue[bytes]" = queue.Queue()
        self._lock = threading.Lock()
        self._last_round = self._recover_last_round()
        self._fh = open(path, "a", encoding="utf-8")

    def _recover_last_round(self) -> int:
        """Highest round already journaled (-1 for a fresh journal).
        A torn final line — the process died inside a write — is
        truncated away: its block was not durably delivered and will
        be re-emitted by bootstrap, landing on a clean line."""
        if not os.path.exists(self.path):
            return -1
        last = -1
        keep = 0
        with open(self.path, "r+b") as fh:
            data = fh.read()
            for line in data.splitlines(keepends=True):
                if not line.endswith(b"\n"):
                    break
                try:
                    last = max(last, json.loads(line)["round"])
                except (ValueError, KeyError):
                    pass
                keep += len(line)
            if keep < len(data):
                fh.truncate(keep)
        return last

    def submit_ch(self) -> "queue.Queue[bytes]":
        return self._submit

    def submit_tx(self, tx: bytes) -> None:
        self._submit.put(tx)

    def commit_block(self, block: Block) -> None:
        with self._lock:
            if block.round_received <= self._last_round:
                # Redelivery of a block journaled before a crash that
                # beat the store's delivered marker — exactly-once
                # means dropping it here.
                return
            rec = {
                "round": block.round_received,
                "txs": [tx.hex() for tx in (block.transactions or [])],
            }
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            if self.sync == "always":
                os.fsync(self._fh.fileno())
                self.fsync_count += 1
            else:
                self._dirty = True
            self._last_round = block.round_received

    def flush(self) -> None:
        """Coalesced fsync point for sync="batch": the node calls this
        once per drained commit burst and at shutdown."""
        with self._lock:
            if not self._dirty:
                return
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self.fsync_count += 1
                self._dirty = False
            except (OSError, ValueError):
                pass

    def journal_bytes(self) -> int:
        """Journal file size for the capacity plane
        (babble_store_bytes{file="journal"})."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def last_round(self) -> int:
        with self._lock:
            return self._last_round

    def committed_transactions(self) -> List[bytes]:
        """All journaled transactions in delivery order (reads the
        file, so it reflects pre-restart history too)."""
        out: List[bytes] = []
        with self._lock:
            self._fh.flush()
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                out.extend(bytes.fromhex(t) for t in rec.get("txs", []))
        return out

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except (OSError, ValueError):
                pass
            self._fh.close()
