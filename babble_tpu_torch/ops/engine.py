"""Host finish of the batch consensus run (counterpart of the order
step of babble_tpu/ops/engine.py).

The final total order sorts the decided events by (roundReceived,
consensusTimestamp, raw big-int S) — the reference's ConsensusSorter
(consensus_sorter.go:21-52). Timestamps arrive as dense ranks and S as
an int64 key that orders like the big-int S: a dense rank of each
event's S for signed events, `s_rank` for synthetic DAGs. Block
assembly from signed events waits for the port of the hashgraph
models.
"""

from __future__ import annotations

import numpy as np
import torch


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
