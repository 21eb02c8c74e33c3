"""Frame = logical checkpoint {Roots, Events} at the last consensus round.

Reference: hashgraph/frame.go:3-6, produced by GetFrame
(hashgraph.go:900-1002) and consumed by Reset (hashgraph.go:879-898).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .event import Event
from .root import Root


@dataclass
class Frame:
    roots: Dict[str, Root] = field(default_factory=dict)
    events: List[Event] = field(default_factory=list)
