"""Per-participant DAG base.

Reference: hashgraph/root.go:63-76. A Root lets a hashgraph start "from
the middle": each participant's first event must have self-parent X and
other-parent Y matching its Root; `Others` maps event hex -> other-parent
hash for events whose other-parents fall outside a Frame (root.go ex 2).
Base roots are X=Y="", Index=-1, Round=-1.
"""

from __future__ import annotations

from typing import Dict


class Root:
    __slots__ = ("x", "y", "index", "round", "others")

    def __init__(
        self,
        x: str = "",
        y: str = "",
        index: int = -1,
        round: int = -1,
        others: Dict[str, str] | None = None,
    ):
        self.x = x
        self.y = y
        self.index = index
        self.round = round
        self.others = others if others is not None else {}

    def to_dict(self) -> dict:
        return {
            "X": self.x,
            "Y": self.y,
            "Index": self.index,
            "Round": self.round,
            "Others": self.others,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Root":
        return cls(
            x=d["X"],
            y=d["Y"],
            index=d["Index"],
            round=d["Round"],
            others=d.get("Others") or {},
        )

    def __repr__(self) -> str:
        return f"Root(x={self.x[:10]}, y={self.y[:10]}, idx={self.index}, rnd={self.round})"


def new_base_root() -> Root:
    return Root(x="", y="", index=-1, round=-1)
