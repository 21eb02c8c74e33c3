"""Resettable randomized heartbeat — reference node/control_timer.go.

Fires at base + U(0, base) after each reset; the tick is delivered on a
queue the babble loop consumes. `set` mirrors the reference flag: True
while a timer is armed."""

from __future__ import annotations

import queue
import random
import threading


class ControlTimer:
    def __init__(self, base: float):
        self._base = base
        self.tick_ch: "queue.Queue[None]" = queue.Queue(1)
        self.set = False
        self._cond = threading.Condition()
        self._deadline: float | None = None
        self._shutdown = False
        self._thread: threading.Thread | None = None

    def _next_timeout(self) -> float:
        return self._base + random.random() * self._base

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.reset()

    def _loop(self) -> None:
        import time

        with self._cond:
            while not self._shutdown:
                if self._deadline is None:
                    self._cond.wait()
                    continue
                delay = self._deadline - time.monotonic()
                if delay > 0:
                    self._cond.wait(delay)
                    continue
                # fire
                self._deadline = None
                self.set = False
                try:
                    self.tick_ch.put_nowait(None)
                except queue.Full:
                    pass

    def reset(self) -> None:
        import time

        with self._cond:
            self._deadline = time.monotonic() + self._next_timeout()
            self.set = True
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._deadline = None
            self.set = False
            self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()
