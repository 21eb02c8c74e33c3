"""Batched gossip simulation: every simulated peer's view through one
view-axis pipeline (counterpart of babble_tpu/ops/sim.py).

The reference runs N OS processes exchanging syncs (reference
node/node.go:315-487); the batched simulator replays that protocol as
tensors: a peer-selection schedule generates the DAG, knowledge masks
track which events each peer has seen (gossip transfers the full
ancestry closure, so every view is ancestry-closed), and consensus for
ALL views runs at once — the checkGossip oracle (node/node_test.go:
548-599) computed on the device.

Ancestry-closure is what makes this sound: coordinates (last_anc /
first_desc) computed once on the full DAG are exact for every closed
subgraph (see kernels.compute_rounds), so views differ only in their
witness tables. The JAX package vmaps the masked pipeline over the mask
axis; here the three witness-dependent stages (rounds, fame, round
received) carry an explicit leading view axis, so each DAG level is one
strongly-see launch for all views (their working witness tables
stacked) and each chunk of voting rounds one launch, whatever V is.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import crypto
from ..devices import resolve_device
from ..gojson import Timestamp
from ..hashgraph.event import Event
from .dag import DagTensors, _assemble, build_dag
from .pipeline import consensus_pipeline, run_pipeline_wavefront


class GossipSim:
    """Host-side gossip simulator over real signed events, tracking
    per-peer knowledge (used for view-parity tests; the all-array
    `simulate_views` is the at-scale path)."""

    def __init__(self, n: int, seed: int = 0, seed_base: int = 9000):
        self.n = n
        self.rng = random.Random(seed)
        self.keys = [crypto.key_from_seed(seed_base + i) for i in range(n)]
        self.pubs = [crypto.pub_key_bytes(k) for k in self.keys]
        order = sorted(range(n), key=lambda i: self.pubs[i].hex())
        self.ids = {orig: rank for rank, orig in enumerate(order)}
        self.participants = {
            "0x" + self.pubs[i].hex().upper(): self.ids[i] for i in range(n)
        }
        self.events: List[Event] = []
        self.heads: List[str] = [""] * n
        self.seqs: List[int] = [-1] * n
        self.knows: List[set] = [set() for _ in range(n)]
        self._clock = 1_800_000_000_000_000_000

    def _make_event(self, i: int, other_parent: str, payload) -> Event:
        self._clock += 1_000_000
        self.seqs[i] += 1
        ev = Event.new(
            payload, [self.heads[i], other_parent], self.pubs[i], self.seqs[i],
            timestamp=Timestamp(self._clock),
        )
        ev.sign(self.keys[i])
        eid = len(self.events)
        self.events.append(ev)
        self.heads[i] = ev.hex()
        self.knows[i].add(eid)
        return ev

    def run(self, steps: int, tx_rate: float = 0.3) -> None:
        if not self.events:
            for i in range(self.n):
                self._make_event(i, "", [f"init{i}".encode()])
        for t in range(steps):
            i = self.rng.randrange(self.n)
            j = self.rng.choice([x for x in range(self.n) if x != i])
            # pull: i learns everything j knows, then records the sync
            self.knows[i] |= self.knows[j]
            payload = [f"tx{t}".encode()] if self.rng.random() < tx_rate else []
            self._make_event(i, self.heads[j], payload)

    def view_masks(self) -> np.ndarray:
        """[n, E] bool: which events each peer's view contains."""
        e = len(self.events)
        masks = np.zeros((self.n, e), dtype=bool)
        for i in range(self.n):
            masks[self.ids[i], list(self.knows[i])] = True
        return masks

    def dag(self) -> DagTensors:
        return build_dag(self.events, self.participants)


def gossip_schedule(
    n: int,
    steps: int,
    *,
    selector: str = "uniform",
    alpha: float = 1.5,
    silent: Optional[np.ndarray] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Peer-selection schedule tensors (creators[steps], targets[steps]).

    selector="uniform" reproduces the reference RandomPeerSelector:
    uniform over peers excluding self and the last-synced peer
    (node/peer_selector.go:38-46). selector="powerlaw" weights target
    choice by rank**-alpha — the skewed-topology axis of the batched
    simulation. `silent` [n] bool marks peers that never initiate or
    answer a sync (the missing/silent-byzantine node of
    node_test.go:409-420): they are excluded from both sides of the
    schedule, so their initial events stay unknown to the rest of the
    network. The draws are the JAX package's, so the same seed gives the
    same schedule."""
    rng = np.random.default_rng(seed)
    silent = np.zeros(n, bool) if silent is None else np.asarray(silent, bool)
    active = np.nonzero(~silent)[0]
    if len(active) < 2:
        raise ValueError("need at least two non-silent peers")
    if selector == "powerlaw":
        w = (1.0 + np.arange(n, dtype=np.float64)) ** -alpha
    elif selector == "uniform":
        w = np.ones(n, dtype=np.float64)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    w[silent] = 0.0

    creators = rng.choice(active, size=steps)
    targets = np.zeros(steps, dtype=np.int64)
    last = np.full(n, -1, dtype=np.int64)
    for t in range(steps):
        c = int(creators[t])
        wt = w.copy()
        wt[c] = 0.0
        if last[c] >= 0 and wt.sum() - wt[last[c]] > 0:
            wt[last[c]] = 0.0  # exclude the previously-synced peer
        wt /= wt.sum()
        j = int(rng.choice(n, p=wt))
        targets[t] = j
        last[c] = j
    return creators.astype(np.int32), targets.astype(np.int32)


def simulate_views(
    n: int,
    steps: int,
    *,
    selector: str = "uniform",
    alpha: float = 1.5,
    silent: Optional[np.ndarray] = None,
    seed: int = 0,
    snapshots: Optional[Sequence[int]] = None,
) -> Tuple[DagTensors, np.ndarray, np.ndarray]:
    """Array-native batched gossip: run a schedule, producing the global
    DAG tensors, per-peer ancestry-closed view masks, and the synthetic
    signature ranks for the final sort. No crypto, no Event objects —
    the at-scale counterpart of GossipSim.

    `snapshots` (step counts, ascending; default [steps]) captures every
    peer's view at each checkpoint, returning [len(snapshots)*n, E]
    masks — temporal views are ancestry-closed too, so the consistency
    oracle also checks that a peer's earlier order is a prefix of its
    later one (the monotonicity the reference gets from append-only
    ConsensusEvents, hashgraph.go:826-838)."""
    silent = np.zeros(n, bool) if silent is None else np.asarray(silent, bool)
    creators_s, targets_s = gossip_schedule(
        n, steps, selector=selector, alpha=alpha, silent=silent, seed=seed)
    rng = np.random.default_rng(seed + 1)

    e = n + steps
    self_parent = np.full(e + 1, -1, np.int32)
    other_parent = np.full(e + 1, -1, np.int32)
    creator = np.zeros(e + 1, np.int32)
    index = np.zeros(e + 1, np.int32)
    heads = np.full(n, -1, np.int64)
    seqs = np.full(n, -1, np.int64)
    know = np.zeros((n, e), dtype=bool)

    for i in range(n):  # initial events (reference core.Init)
        creator[i] = i
        seqs[i] = 0
        heads[i] = i
        know[i, i] = True

    if snapshots is None:
        snapshots = [steps]
    snap_masks: List[np.ndarray] = []
    snap_iter = iter(sorted(snapshots))
    next_snap = next(snap_iter)
    for t in range(steps):
        while next_snap == t:
            snap_masks.append(know.copy())
            next_snap = next(snap_iter, None)
        eid = n + t
        c, j = int(creators_s[t]), int(targets_s[t])
        know[c] |= know[j]  # pull: full ancestry closure transfers
        self_parent[eid] = heads[c]
        other_parent[eid] = heads[j]
        creator[eid] = c
        seqs[c] += 1
        index[eid] = seqs[c]
        heads[c] = eid
        know[c, eid] = True
    while next_snap is not None:
        snap_masks.append(know.copy())
        next_snap = next(snap_iter, None)
    masks = np.concatenate(snap_masks, axis=0)

    coin = np.zeros(e + 1, np.int8)
    coin[:e] = rng.integers(0, 2, size=e, dtype=np.int8)
    ts_rank = np.zeros(e + 1, np.int32)
    ts_rank[:e] = np.arange(e, dtype=np.int32)
    ts_values = np.arange(e, dtype=np.int64)
    root_round = np.full(n, -1, np.int32)
    s_rank = rng.integers(0, 2**62, size=e, dtype=np.int64)

    dag = _assemble(
        n, e, self_parent, other_parent, creator, index, coin, ts_rank,
        ts_values, root_round, hexes=[], hex_to_id={}, events=[])
    return dag, masks, s_rank


def _host(a) -> np.ndarray:
    """An array or a tensor on any device, as host numpy."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _padded_masks(dag: DagTensors, masks, dev) -> torch.Tensor:
    """[V, E] view masks as a [V, E+1] bool tensor on dev (the sentinel
    column False)."""
    masks = _host(masks).astype(bool)
    if masks.shape[1] != dag.e:
        raise ValueError(f"masks cover {masks.shape[1]} events, the DAG has {dag.e}")
    return torch.from_numpy(np.pad(masks, ((0, 0), (0, 1)))).to(dev)


def consensus_views_factored(dag: DagTensors, masks, device=None):
    """Per-view consensus with shared coordinates: last-ancestors and
    first-descendants are exact for every ancestry-closed view (see
    kernels.compute_rounds), so they are computed ONCE on the full DAG
    and only the witness-table-dependent stages (rounds, fame, round
    received) run with the view axis: the wavefront pipeline with a
    [V, E+1] mask (pipeline.run_pipeline_wavefront). Fame and round
    received run at the tight round bucket of all views' rounds
    (out-of-view events included, as the JAX package takes it), and
    fame is padded back to the static bound.

    masks: [V, E] bool. Returns per-view (rounds, witness, wt, famous,
    rr, cts) with a leading V axis, on `device` (CUDA unless the caller
    names another; raises when CUDA is absent)."""
    dev = resolve_device(device)
    return run_pipeline_wavefront(dag, dev, _padded_masks(dag, masks, dev))


def consensus_views(dag: DagTensors, masks, device=None):
    """The masked consensus pipeline (pipeline.consensus_pipeline) for V
    views at the static round bound dag.max_rounds: the oracle of the
    factored form. The coordinates do not depend on the mask and are
    computed once; the three witness stages run with the view axis.

    masks: [V, E] bool. Returns per-view (rounds, witness, wt, famous,
    rr, cts) with a leading V axis, on `device` (CUDA unless the caller
    names another; raises when CUDA is absent)."""
    dev = resolve_device(device)
    padded = _padded_masks(dag, masks, dev)
    return consensus_pipeline(
        dag.self_parent, dag.other_parent, dag.creator, dag.index, dag.coin,
        dag.levels, dag.root_round, dag.chain, dag.chain_len, dag.chain_rank,
        padded, n=dag.n, sm=dag.super_majority, r=dag.max_rounds, device=dev)


def view_order(dag: DagTensors, rr, cts,
               s_ints: Optional[Sequence[int]] = None) -> List[int]:
    """Consensus total order of one view as event ids: (roundReceived,
    consensusTimestamp, raw S) — the ConsensusSorter (reference
    consensus_sorter.go:21-52). `s_ints` stands in for the raw big-int
    signature S; defaults to the real signatures when the DAG carries
    Event objects (synthetic DAGs pass their s_rank array). rr and cts
    may be tensors on any device."""
    if s_ints is None:
        s_ints = [int(ev.s) for ev in dag.events]
    elif isinstance(s_ints, np.ndarray):
        s_ints = s_ints.tolist()
    rr, cts = _host(rr).tolist(), _host(cts).tolist()
    ids = [i for i in range(dag.e) if rr[i] >= 0]
    ids.sort(key=lambda i: (rr[i], cts[i], s_ints[i]))
    return ids


def check_view_consistency(
    dag: DagTensors, rr_v, cts_v, s_ints: Optional[Sequence[int]] = None,
) -> List[List[int]]:
    """The checkGossip oracle over all views: every pair of views'
    consensus orders must be prefix-compatible. Prefix-compatibility
    with the longest order implies it pairwise, so each view is checked
    against the longest only. Returns the per-view orders; raises
    AssertionError on divergence. rr_v and cts_v [V, E] may be tensors
    on any device."""
    if s_ints is None and dag.events:
        s_ints = [int(ev.s) for ev in dag.events]
    elif isinstance(s_ints, np.ndarray):
        s_ints = s_ints.tolist()
    rr_v, cts_v = _host(rr_v), _host(cts_v)
    orders = [
        view_order(dag, rr_v[v], cts_v[v], s_ints) for v in range(rr_v.shape[0])
    ]
    longest = max(orders, key=len)
    for v, order in enumerate(orders):
        if order != longest[: len(order)]:
            raise AssertionError(
                f"view {v} diverges from the longest view within its prefix"
            )
    return orders
