"""Structure-of-arrays event DAG (counterpart of babble_tpu/ops/dag.py).

The DAG is host-side numpy: events become ids in insertion order,
creators participant ids, timestamps dense int32 ranks (rank -1 is
reserved for Go's zero time, reference hashgraph.go:860-868). The
pipeline copies the arrays to its device when it runs.

This system has no weights: the DAG is the state. `build_dag` makes
it from signed `Event`s in insertion order; `dag_from_arrays` carries a
DAG across from the reference package by its numpy fields;
`synthetic_dag` makes the benchmark's random-gossip DAGs from a seed
(bit-identical to the reference's for the same seed).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..hashgraph.graph import middle_bit


@dataclass
class DagTensors:
    """Structure-of-arrays DAG. Per-event arrays are padded with one
    trailing sentinel row (id E) so scatter/gather padding lanes have a
    harmless target."""

    n: int  # participants
    e: int  # true event count
    # [E+1] int32; parents are event ids, -1 = root / none
    self_parent: np.ndarray
    other_parent: np.ndarray
    creator: np.ndarray  # [E+1] int32 participant ids
    index: np.ndarray  # [E+1] int32 creator-sequence index
    coin: np.ndarray  # [E+1] int8 middleBit of the event hash
    ts_rank: np.ndarray  # [E+1] int32 dense timestamp rank
    ts_values: np.ndarray  # [U] int64 sorted unique timestamp ns
    levels: np.ndarray  # [L, W] int32 event ids per DAG depth level, -1 pad
    depth: int  # true DAG depth (pre-chunking level count)
    chain: np.ndarray  # [n, K] int32 event id of creator c's k-th event, -1 pad
    chain_len: np.ndarray  # [n] int32
    chain_rank: np.ndarray  # [n, K] int32 timestamp rank along each chain
    root_round: np.ndarray  # [n] int32 per-participant Root round (-1 base)
    hexes: List[str] = field(default_factory=list)  # id -> event hex
    hex_to_id: Dict[str, int] = field(default_factory=dict)
    events: list = field(default_factory=list)  # id -> Event

    @property
    def super_majority(self) -> int:
        return 2 * self.n // 3 + 1

    @property
    def max_rounds(self) -> int:
        """Static bound on round numbers: rounds start from the largest
        Root round (-1 for base roots) and grow by at most 1 per true
        DAG depth level (round(x) <= max(parent rounds) + 1). Uses the
        pre-chunking depth — chunked level rows subdivide levels
        without adding round headroom."""
        base = int(self.root_round.max()) + 1 if self.n else 0
        return max(base, 0) + self.depth + 2


def _assemble(
    n: int,
    e: int,
    self_parent: np.ndarray,
    other_parent: np.ndarray,
    creator: np.ndarray,
    index: np.ndarray,
    coin: np.ndarray,
    ts_rank: np.ndarray,
    ts_values: np.ndarray,
    root_round: np.ndarray,
    hexes: List[str],
    hex_to_id: Optional[Dict[str, int]] = None,
    events: Optional[list] = None,
    max_level_width: Optional[int] = None,
) -> DagTensors:
    """Shared tail of DAG assembly: wavefront levels + creator chains.

    `max_level_width` splits wide levels into consecutive rows (events
    within a level are mutually independent, so any split is valid) to
    bound the [W, n, n] working set of the round kernel at large n."""
    # DAG depth levels (wavefront schedule).
    level = np.zeros(e, dtype=np.int32)
    for i in range(e):
        lv = -1
        sp, op = self_parent[i], other_parent[i]
        if sp >= 0:
            lv = max(lv, level[sp])
        if op >= 0:
            lv = max(lv, level[op])
        level[i] = lv + 1
    n_levels = int(level.max()) + 1 if e else 1
    depth = n_levels
    buckets: List[List[int]] = [[] for _ in range(n_levels)]
    for i in range(e):
        buckets[level[i]].append(i)
    if max_level_width is not None and max_level_width > 0:
        chunked: List[List[int]] = []
        for b in buckets:
            for off in range(0, max(len(b), 1), max_level_width):
                chunked.append(b[off : off + max_level_width])
        buckets = chunked
    width = max((len(b) for b in buckets), default=1)
    levels = np.full((len(buckets), width), -1, dtype=np.int32)
    for l, b in enumerate(buckets):
        levels[l, : len(b)] = b

    # Per-creator chains: chain[c, k] = id of c's event with index k.
    k_max = int(index[:e].max()) + 1 if e else 1
    chain = np.full((n, k_max), -1, dtype=np.int32)
    chain_len = np.zeros(n, dtype=np.int32)
    for i in range(e):
        c, k = int(creator[i]), int(index[i])
        if chain[c, k] != -1:
            raise ValueError(f"fork: two events by creator {c} at index {k}")
        chain[c, k] = i
    for c in range(n):
        length = 0
        while length < k_max and chain[c, length] != -1:
            length += 1
        if np.any(chain[c, length:] != -1):
            raise ValueError(f"non-contiguous chain for creator {c}")
        chain_len[c] = length

    chain_rank = np.full((n, k_max), -1, dtype=np.int32)
    valid = chain >= 0
    chain_rank[valid] = ts_rank[chain[valid]]

    return DagTensors(
        n=n,
        e=e,
        self_parent=self_parent,
        other_parent=other_parent,
        creator=creator,
        index=index,
        coin=coin,
        ts_rank=ts_rank,
        ts_values=ts_values,
        levels=levels,
        depth=depth,
        chain=chain,
        chain_len=chain_len,
        chain_rank=chain_rank,
        root_round=root_round,
        hexes=hexes,
        hex_to_id=hex_to_id if hex_to_id is not None else {},
        events=events if events is not None else [],
    )


def build_dag(
    events: Sequence,
    participants: Dict[str, int],
    roots: Optional[Dict] = None,
    max_level_width: Optional[int] = None,
) -> DagTensors:
    """The DAG of signed `Event`s (hashgraph/event.py), which must be in
    insertion (topological) order — the order the incremental engine
    would receive them. Parents are resolved by hex and must be in the
    batch; coins are the middle bit of each hash; `roots` (participant
    key -> Root) set each creator's root round."""
    n = len(participants)
    e = len(events)

    hex_to_id: Dict[str, int] = {}
    hexes: List[str] = []
    for i, ev in enumerate(events):
        h = ev.hex()
        hex_to_id[h] = i
        hexes.append(h)

    self_parent = np.full(e + 1, -1, dtype=np.int32)
    other_parent = np.full(e + 1, -1, dtype=np.int32)
    creator = np.zeros(e + 1, dtype=np.int32)
    index = np.zeros(e + 1, dtype=np.int32)
    coin = np.zeros(e + 1, dtype=np.int8)
    ts_ns = np.zeros(e, dtype=np.int64)

    for i, ev in enumerate(events):
        sp, op = ev.self_parent(), ev.other_parent()
        if sp:
            if sp not in hex_to_id:
                raise ValueError(f"event {i} self-parent not in batch: {sp[:16]}")
            self_parent[i] = hex_to_id[sp]
        if op:
            if op not in hex_to_id:
                raise ValueError(f"event {i} other-parent not in batch: {op[:16]}")
            other_parent[i] = hex_to_id[op]
        creator[i] = participants[ev.creator()]
        index[i] = ev.index()
        coin[i] = 1 if middle_bit(hexes[i]) else 0
        ts_ns[i] = ev.body.timestamp.ns

    # Dense timestamp ranks: median selection and the final sort only
    # need ordering, so int32 ranks replace int64 nanoseconds on device.
    ts_values, ts_rank_e = np.unique(ts_ns, return_inverse=True)
    ts_rank = np.zeros(e + 1, dtype=np.int32)
    ts_rank[:e] = ts_rank_e.astype(np.int32)

    root_round = np.full(n, -1, dtype=np.int32)
    if roots:
        for pk, root in roots.items():
            root_round[participants[pk]] = root.round

    return _assemble(
        n, e, self_parent, other_parent, creator, index, coin, ts_rank,
        ts_values, root_round, hexes, hex_to_id, list(events),
        max_level_width=max_level_width,
    )


def dag_from_arrays(
    *,
    n: int,
    e: int,
    self_parent,
    other_parent,
    creator,
    index,
    coin,
    ts_rank,
    ts_values,
    levels,
    depth: int,
    chain,
    chain_len,
    chain_rank,
    root_round,
    hexes: Optional[Sequence[str]] = None,
) -> DagTensors:
    """The port's DagTensors from the numpy fields of a DAG built
    elsewhere (the reference package's `build_dag`, a file). Copies
    every array at the layout's dtypes and checks the shapes, so the
    result shares no memory with its source."""
    def arr(a, dtype, shape):
        out = np.array(a, dtype=dtype, copy=True)
        if out.shape != shape:
            raise ValueError(f"expected shape {shape}, got {out.shape}")
        return out

    n, e, depth = int(n), int(e), int(depth)
    levels = np.array(levels, dtype=np.int32, copy=True)
    chain = np.array(chain, dtype=np.int32, copy=True)
    if levels.ndim != 2 or chain.ndim != 2 or chain.shape[0] != n:
        raise ValueError("levels must be [L, W] and chain [n, K]")
    k = chain.shape[1]
    return DagTensors(
        n=n,
        e=e,
        self_parent=arr(self_parent, np.int32, (e + 1,)),
        other_parent=arr(other_parent, np.int32, (e + 1,)),
        creator=arr(creator, np.int32, (e + 1,)),
        index=arr(index, np.int32, (e + 1,)),
        coin=arr(coin, np.int8, (e + 1,)),
        ts_rank=arr(ts_rank, np.int32, (e + 1,)),
        ts_values=np.array(ts_values, dtype=np.int64, copy=True),
        levels=levels,
        depth=depth,
        chain=chain,
        chain_len=arr(chain_len, np.int32, (n,)),
        chain_rank=arr(chain_rank, np.int32, (n, k)),
        root_round=arr(root_round, np.int32, (n,)),
        hexes=list(hexes) if hexes is not None else [],
    )


def synthetic_dag(
    n: int,
    e: int,
    seed: int = 0,
    max_level_width: Optional[int] = None,
):
    """Generate a random-gossip DAG directly as tensors (no crypto, no
    Event objects) for benchmarking the device pipeline: each step a
    random creator records a sync from a random other peer, exactly the
    event pattern the gossip runtime produces (reference
    node/node.go:315-487).

    Returns (DagTensors, s_rank[E] int64) where s_rank stands in for
    the raw big-int signature-S tiebreak of the final sort."""
    if e < n or n < 2:
        raise ValueError("need n >= 2 and at least one event per participant")
    rng = np.random.default_rng(seed)
    self_parent = np.full(e + 1, -1, dtype=np.int32)
    other_parent = np.full(e + 1, -1, dtype=np.int32)
    creator = np.zeros(e + 1, dtype=np.int32)
    index = np.zeros(e + 1, dtype=np.int32)

    heads = np.full(n, -1, dtype=np.int64)
    seqs = np.full(n, -1, dtype=np.int64)
    creators = np.concatenate(
        [np.arange(n, dtype=np.int64), rng.integers(0, n, size=e - n)]
    )
    others = rng.integers(1, n, size=e)  # offset, so other != creator
    for i in range(e):
        c = int(creators[i])
        if i >= n:
            j = (c + int(others[i])) % n
            other_parent[i] = heads[j]
        self_parent[i] = heads[c]
        seqs[c] += 1
        creator[i] = c
        index[i] = seqs[c]
        heads[c] = i

    coin = np.zeros(e + 1, dtype=np.int8)
    coin[:e] = rng.integers(0, 2, size=e, dtype=np.int8)
    ts_rank = np.zeros(e + 1, dtype=np.int32)
    ts_rank[:e] = np.arange(e, dtype=np.int32)  # monotone clock
    ts_values = np.arange(e, dtype=np.int64)
    root_round = np.full(n, -1, dtype=np.int32)
    s_rank = rng.integers(0, 2**62, size=e, dtype=np.int64)

    dag = _assemble(
        n,
        e,
        self_parent,
        other_parent,
        creator,
        index,
        coin,
        ts_rank,
        ts_values,
        root_round,
        hexes=[],
        max_level_width=max_level_width,
    )
    return dag, s_rank
