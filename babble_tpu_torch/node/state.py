"""Node state machine plumbing — reference node/state.go:9-76.

Go's atomics become a lock; the goroutine waitgroup becomes a tracked
thread list."""

from __future__ import annotations

import enum
import threading
from typing import Callable, List


class NodeState(enum.IntEnum):
    BABBLING = 0
    CATCHING_UP = 1
    SHUTDOWN = 2

    def __str__(self) -> str:
        return ("Babbling", "CatchingUp", "Shutdown")[int(self)]


class StateMachine:
    def __init__(self):
        self._state = NodeState.BABBLING
        self._starting = False
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []

    def get_state(self) -> NodeState:
        with self._lock:
            return self._state

    def set_state(self, s: NodeState) -> None:
        with self._lock:
            self._state = s

    def is_starting(self) -> bool:
        with self._lock:
            return self._starting

    def set_starting(self, starting: bool) -> None:
        with self._lock:
            self._starting = starting

    def go_func(self, f: Callable[[], None], name: str = None) -> None:
        # Named threads feed the per-thread CPU attribution and the
        # flame profiler (telemetry/threadcpu.py, telemetry/profiler.py).
        t = threading.Thread(target=f, daemon=True, name=name)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def wait_routines(self, timeout: float = 5.0) -> None:
        """Join outstanding routines within a TOTAL timeout budget (a
        long-gossiping node can have many threads in flight; joining
        each with its own timeout would multiply)."""
        import time

        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            t.join(remaining)
