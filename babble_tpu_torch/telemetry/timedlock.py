"""A lock that times the waits it imposes (babble_tpu_torch/TRACING.md
"The core lock's wait")."""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable


class TimedLock:
    """A `threading.Lock` that reports each contended acquisition: when
    the lock is taken after a wait, `on_wait(t0_ns, t1_ns, site)` runs
    with the lock held, `site` naming the function that asked for it.
    An uncontended acquisition costs one non-blocking try more than a
    plain lock and reports nothing."""

    def __init__(self, on_wait: Callable[[int, int, str], None]):
        self._lock = threading.Lock()
        self._on_wait = on_wait

    def acquire(self, blocking: bool = True, timeout: float = -1,
                _depth: int = 1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter_ns()
        if not self._lock.acquire(True, timeout):
            return False
        try:
            self._on_wait(t0, time.perf_counter_ns(),
                          sys._getframe(_depth).f_code.co_name)
        except BaseException:
            # the caller sees the error and never owned the lock
            self._lock.release()
            raise
        return True

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire(_depth=2)

    def __exit__(self, *exc) -> None:
        self._lock.release()
