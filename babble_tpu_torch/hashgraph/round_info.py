"""Per-round witness/fame bookkeeping.

Reference: hashgraph/roundInfo.go. Fame is a trilean
(Undefined/True/False); the round pseudo-random number is the XOR of the
famous witnesses' hex hashes interpreted as big ints
(roundInfo.go:100-110).
"""

from __future__ import annotations

import enum
from typing import Dict, List


class Trilean(enum.IntEnum):
    UNDEFINED = 0
    TRUE = 1
    FALSE = 2

    def __str__(self) -> str:
        return ("Undefined", "True", "False")[int(self)]


class RoundEvent:
    __slots__ = ("witness", "famous")

    def __init__(self, witness: bool = False, famous: Trilean = Trilean.UNDEFINED):
        self.witness = witness
        self.famous = famous


class RoundInfo:
    def __init__(self):
        self.events: Dict[str, RoundEvent] = {}
        self.queued = False  # not persisted — reference hashgraph.go:629-637

    def add_event(self, x: str, witness: bool) -> None:
        if x not in self.events:
            self.events[x] = RoundEvent(witness=witness)

    def set_fame(self, x: str, famous: bool) -> None:
        e = self.events.get(x)
        if e is None:
            e = RoundEvent(witness=True)
            self.events[x] = e
        e.famous = Trilean.TRUE if famous else Trilean.FALSE

    def witnesses_decided(self) -> bool:
        return all(
            not e.witness or e.famous != Trilean.UNDEFINED for e in self.events.values()
        )

    def witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness]

    def famous_witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness and e.famous == Trilean.TRUE]

    def is_decided(self, witness: str) -> bool:
        e = self.events.get(witness)
        return e is not None and e.witness and e.famous != Trilean.UNDEFINED

    def pseudo_random_number(self) -> int:
        res = 0
        for x, e in self.events.items():
            if e.witness and e.famous == Trilean.TRUE:
                res ^= int(x, 16)  # "0x..." parses directly
        return res
