"""The comparison that decides `correct`: what the node under test made
of the stream, against the plain reference's consensus of the stream.

A capture is what the node produced: its consensus order (event
hashes), which stream events it holds, each one's round and round
received as it reports them (-1 for none), each ordered event's
consensus timestamp, and the bytes of every block it committed.
Every number is a count of disagreements, with the limit 0.

The node under test is a silent participant: none of the stream's
events descends from its own events, so it cannot change a round, a
fame or an order, but its witnesses vote, and they can decide a round
earlier than the stream alone does. So the node is held to a reference
over a longer stream than it took: it must order exactly the
reference's events received in the rounds it has decided, in the
reference's order (a prefix of the reference's order); and it must
order at least as many events as the reference decides on the very
prefix the node took (`min_ordered`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NUMBERS = ("order_mismatch", "ordered_shortfall", "round_mismatch",
           "round_received_mismatch", "timestamp_mismatch", "block_mismatch")


def capture(core, hexes: List[str], blocks: List[bytes]) -> dict:
    """A torch Core's outputs for the stream events `hexes`: its order,
    which it holds, their rounds and rounds received, each ordered
    event's consensus timestamp (from the engine that made it), and the
    bytes of the blocks it delivered. The caller keeps the Core still."""
    from babble_tpu_torch.ops.incremental import CTS_SENTINEL, ZERO_TIME_NS

    hg = core.hg
    order = core.get_consensus_events()
    cts = {}
    for h in order:
        v = int(hg.engine.cts_ns[hg._eid_of[h]])
        cts[h] = ZERO_TIME_NS if v == CTS_SENTINEL else v
    return {"order": order, "first": core.get_consensus_events_count() - len(order),
            "held": np.array([h in hg._eid_of for h in hexes]),
            "rounds": np.array([hg.round(h) for h in hexes], np.int64),
            "rr": np.array([hg.round_received(h) for h in hexes], np.int64),
            "cts": cts, "blocks": blocks}


def empty() -> Dict[str, int]:
    return {k: 0 for k in NUMBERS}


def compare(cap: dict, ref, hexes: List[str], index: Dict[str, int],
            fed: int, min_ordered: int, blocks_prefix: bool = False) -> Dict[str, int]:
    """Disagreements of `cap` (a node that took the first `fed` events)
    with the reference result `ref` of the stream whose event hashes are
    `hexes` (`index`: hash -> id), at least `fed` events long. With
    `blocks_prefix` the blocks delivered need only be the first of those
    the order implies (a node's app delivery trails its order)."""
    order = cap["order"]
    ref_order = [hexes[i] for i in ref.order]
    last_rr = max((int(ref.rr[index[h]]) if h in index else -1 for h in order),
                  default=-1)
    want = [h for h in ref_order if int(ref.rr[index[h]]) <= last_rr]
    out = empty()
    out["order_mismatch"] = sum(a != b for a, b in zip(order, want)) + max(
        len(order) - len(want), 0)
    out["ordered_shortfall"] = max(len(want) - len(order), 0) + max(
        min_ordered - len(order), 0)
    rounds, rr, held = cap["rounds"], cap["rr"], cap["held"]
    done = rounds >= 0  # held and passed
    out["round_mismatch"] = int(np.sum(rounds[done] != ref.rounds[:len(rounds)][done])
                                + np.sum(held != (np.arange(len(held)) < fed))
                                + np.sum(done & ~held))
    decided = rr >= 0
    out["round_received_mismatch"] = int(np.sum(rr[decided] != ref.rr[:len(rr)][decided]))
    out["timestamp_mismatch"] = sum(
        h not in index or ts != ref.cts_ns[index[h]] for h, ts in cap["cts"].items())
    blocks = cap["blocks"]
    n_want = sum(1 for r in ref.block_rr if r <= last_rr)
    extra = len(blocks) - n_want
    out["block_mismatch"] = sum(a != b for a, b in zip(blocks, ref.blocks)) + (
        max(extra, 0) if blocks_prefix else abs(extra))
    return out


def worst(results: List[Dict[str, int]]) -> Dict[str, int]:
    out = empty()
    for r in results:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out
