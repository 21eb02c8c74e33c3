"""Batch consensus driver: the one-shot pipeline and its host finish
(counterpart of babble_tpu/ops/engine.py).

`run_consensus_batch` runs the full pipeline (coordinates -> rounds ->
fame -> round received) on the device, then finishes on the host
exactly as the reference does: the final total order sorts by
(roundReceived, consensusTimestamp, raw big-int S) — the
ConsensusSorter with its never-populated PRN quirk (reference
consensus_sorter.go:21-52) — and blocks group consecutive consensus
events by roundReceived with Go's nil-vs-empty transaction slice
semantics (hashgraph.go:826-854).

Timestamps arrive as dense ranks, and S as an int64 key that orders
like the big-int S: the dense rank of each event's S for signed events
(`s_rank_of`), `s_rank` for synthetic DAGs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..gojson import Timestamp, ZERO_TIME
from ..hashgraph.block import Block
from ..hashgraph.round_info import Trilean
from .dag import DagTensors, build_dag
from .kernels import FAME_UNDEFINED, ZERO_TS_RANK
from .pipeline import run_pipeline


def consensus_order(rr, cts_rank, s_key) -> np.ndarray:
    """Event ids of the decided events (rr >= 0) in consensus order:
    by round received, then consensus-timestamp rank, then S key. Ties
    in all three keep id order, as the reference's stable sort does.
    Accepts tensors on any device or numpy arrays."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    rr, cts_rank, s_key = host(rr), host(cts_rank), host(s_key)
    ids = np.nonzero(rr >= 0)[0]
    order = np.lexsort((s_key[ids], cts_rank[ids], rr[ids]))
    return ids[order]


def s_rank_of(events: Sequence) -> np.ndarray:
    """[E] int64 dense rank of each event's signature S. S is a big int
    up to 2^256, so it is ranked by a Python sort, never cast; equal S
    get equal ranks, and the order's stable sort keeps them in id
    order."""
    s_vals = [int(ev.s) for ev in events]
    rank = {s: i for i, s in enumerate(sorted(set(s_vals)))}
    return np.array([rank[s] for s in s_vals], dtype=np.int64)


@dataclass
class BatchConsensusResult:
    dag: DagTensors
    rounds: np.ndarray  # [E] int32
    witness: np.ndarray  # [E] bool
    witness_table: np.ndarray  # [R, n] event ids, -1 empty
    famous: np.ndarray  # [R, n] trilean
    round_received: np.ndarray  # [E] int32, -1 undecided
    cts_rank: np.ndarray  # [E] int32
    consensus_order: List[str]  # event hexes in consensus order
    blocks: List[Block]
    last_consensus_round: Optional[int]
    undecided_rounds: List[int]

    def round_of(self, ehex: str) -> int:
        return int(self.rounds[self.dag.hex_to_id[ehex]])

    def witnesses_of_round(self, r: int) -> List[str]:
        return [
            self.dag.hexes[int(i)] for i in self.witness_table[r] if int(i) >= 0
        ]

    def fame_of(self, ehex: str) -> Trilean:
        eid = self.dag.hex_to_id[ehex]
        r = int(self.rounds[eid])
        c = int(self.dag.creator[eid])
        if int(self.witness_table[r, c]) != eid:
            return Trilean.UNDEFINED
        return Trilean(int(self.famous[r, c]))

    def consensus_timestamp(self, eid: int) -> Timestamp:
        rank = int(self.cts_rank[eid])
        if rank == ZERO_TS_RANK:
            return ZERO_TIME
        return Timestamp(int(self.dag.ts_values[rank]))


def run_consensus_batch(
    events: Sequence,
    participants: Dict[str, int],
    roots: Optional[Dict] = None,
    *,
    device=None,
) -> BatchConsensusResult:
    """Consensus over signed `Event`s in insertion order (participant
    key -> id, optional frame roots), on `device` (CUDA unless the
    caller names another; raises when CUDA is absent)."""
    dag = build_dag(events, participants, roots)
    outs = run_pipeline(dag, device=device)
    rounds, wit, wt_np, famous_np, rr, cts_rank = (
        t.cpu().numpy() for t in outs)

    # Host finish: total order + block assembly (hashgraph.go:801-858).
    ids = consensus_order(rr, cts_rank, s_rank_of(dag.events))
    consensus_order_hex = [dag.hexes[int(i)] for i in ids]

    blocks: List[Block] = []
    block_by_rr: Dict[int, Block] = {}
    for i in ids:
        e = dag.events[int(i)]
        etxs = e.transactions()
        b = block_by_rr.get(int(rr[i]))
        if b is None:
            b = Block(int(rr[i]), None if etxs is None else list(etxs))
            block_by_rr[int(rr[i])] = b
            blocks.append(b)
        elif etxs:
            if b.transactions is None:
                b.transactions = list(etxs)
            else:
                b.transactions.extend(etxs)

    # Round bookkeeping mirrors of DecideFame's LastConsensusRound /
    # UndecidedRounds updates (hashgraph.go:713-729).
    undecided: List[int] = []
    last_consensus: Optional[int] = None
    for ri in sorted(set(int(x) for x in rounds)):
        slots = wt_np[ri]
        if any(int(s) >= 0 and int(famous_np[ri, c]) == FAME_UNDEFINED
               for c, s in enumerate(slots)):
            undecided.append(ri)
        elif last_consensus is None or ri > last_consensus:
            last_consensus = ri

    return BatchConsensusResult(
        dag=dag,
        rounds=rounds,
        witness=wit,
        witness_table=wt_np,
        famous=famous_np,
        round_received=rr,
        cts_rank=cts_rank,
        consensus_order=consensus_order_hex,
        blocks=blocks,
        last_consensus_round=last_consensus,
        undecided_rounds=undecided,
    )
