"""End-to-end consensus pipeline (counterpart of
babble_tpu/ops/pipeline.py): from DAG tensors to (rounds, witness
flags, witness table, fame, round received, consensus timestamps) —
the reference pipeline DivideRounds -> DecideFame -> FindOrder
(reference node/core.go:277-296, hashgraph.go:616-858).

PyTorch runs each kernel eagerly, so where the reference fuses stages
under one `jit` the port enqueues them on the device's stream; the
host reads the device only where the reference does (the tight round
bucket, and once per frontier chunk in the closure engine).
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device
from . import closure, frontier, kernels

I32 = torch.int32

_DEVICE_FIELDS = ("self_parent", "other_parent", "creator", "index", "coin",
                  "levels", "chain", "chain_len", "chain_rank", "root_round")


def _to_device(dag, dev):
    """The DAG's per-event and per-chain arrays as tensors on `dev`."""
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(dag, k))).to(dev)
            for k in _DEVICE_FIELDS}


def _coordinates_and_rounds(t, valid_mask=None, *, n, sm, r):
    """Coordinates and the rounds stage; `valid_mask` [E+1] or [V, E+1]
    (kernels.compute_rounds) restricts the witness tables to views."""
    la = kernels.compute_last_ancestors(
        t["self_parent"], t["other_parent"], t["creator"], t["index"],
        t["levels"], n=n)
    fd = kernels.compute_first_descendants(
        la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
    rounds, wit, wt = kernels.compute_rounds(
        t["self_parent"], t["other_parent"], t["creator"], t["index"], la, fd,
        t["levels"], t["root_round"], valid_mask, n=n, sm=sm, r=r)
    return la, fd, rounds, wit, wt


def _fame_and_order(wt, la, fd, rounds, t, valid_mask=None, *, n, sm, r):
    famous = kernels.decide_fame(wt, la, fd, t["index"], t["coin"],
                                 n=n, sm=sm, r=r)
    rr, cts = kernels.decide_round_received(
        rounds, wt, famous, la, fd, t["creator"], t["index"], t["chain_rank"],
        valid_mask, n=n, r=r)
    return famous, rr, cts


def consensus_pipeline(self_parent, other_parent, creator, index, coin, levels,
                       root_round, chain, chain_len, chain_rank, valid_mask=None,
                       *, n, sm, r, device=None):
    """The wavefront stages at the static round bound `r`, from per-event
    and per-chain arrays (numpy or tensors) to the six outputs (rounds,
    witness, wt, famous, rr, cts) on `device` (CUDA unless the caller
    names another). `valid_mask` [E+1] bool restricts consensus to an
    ancestry-closed view; a [V, E+1] mask runs V views at once over one
    set of coordinates, every output with a leading V axis."""
    dev = resolve_device(device)
    arrays = dict(self_parent=self_parent, other_parent=other_parent, creator=creator,
                  index=index, coin=coin, levels=levels, root_round=root_round,
                  chain=chain, chain_len=chain_len, chain_rank=chain_rank)
    t = {k: torch.as_tensor(v).to(dev) for k, v in arrays.items()}
    if valid_mask is not None:
        valid_mask = torch.as_tensor(valid_mask, dtype=torch.bool).to(dev)
    la, fd, rounds, wit, wt = _coordinates_and_rounds(t, valid_mask, n=n, sm=sm, r=r)
    famous, rr, cts = _fame_and_order(wt, la, fd, rounds, t, valid_mask, n=n, sm=sm, r=r)
    return rounds, wit, wt, famous, rr, cts


def _round_bucket(max_round: int, bound: int) -> int:
    """Round capacity for stage 2: next power of two above the observed
    max round (+2 headroom), capped at the static bound."""
    need = max_round + 3
    r = 8
    while r < need:
        r *= 2
    return min(r, bound)


def tight_round_bucket(rounds, bound: int) -> int:
    """The fame/round-received round capacity from observed rounds (one
    host read): votes are O(r^2), so the observed max round — not the
    depth-derived static bound — sets the real cost."""
    max_round = int(rounds.max()) if rounds.numel() else 0
    return _round_bucket(max_round, bound)


def pad_famous(famous_small, bound: int, n: int):
    """Restore the [bound, n] famous-table contract ([V, bound, n] with a
    view axis): rounds beyond the tight bucket have no witnesses and
    stay UNDEFINED (== 0)."""
    lead = famous_small.shape[:-2]
    famous = torch.zeros((*lead, bound, n), dtype=I32, device=famous_small.device)
    famous[..., : famous_small.shape[-2], :] = famous_small
    return famous


def run_pipeline_wavefront(dag, device=None, valid_mask=None):
    """The depth-sequential engine (one step per DAG level). A bool
    `valid_mask` on the device, [E+1] or [V, E+1], restricts consensus
    to ancestry-closed views (kernels.compute_rounds; ops/sim.py's
    factored per-view pipeline), the round bucket taken over all views."""
    dev = resolve_device(device)
    t = _to_device(dag, dev)
    n, sm, r_bound = dag.n, dag.super_majority, dag.max_rounds
    la, fd, rounds, wit, wt = _coordinates_and_rounds(
        t, valid_mask, n=n, sm=sm, r=r_bound)
    r_small = tight_round_bucket(rounds, r_bound)
    famous_small, rr, cts = _fame_and_order(
        wt[..., :r_small, :].contiguous(), la, fd, rounds, t, valid_mask,
        n=n, sm=sm, r=r_small)
    return rounds, wit, wt, pad_famous(famous_small, r_bound, n), rr, cts


def _default_engine(n: int, device: torch.device) -> str:
    """The reference's hardware-adaptive default (pipeline.py:124-138):
    the block-closure/round-frontier path trades FLOPs (dense 0/1
    matmuls) for sequential trip count, the right trade on an
    accelerator and the wrong one on a host CPU. Large n keeps the
    wavefront, as in the reference."""
    if device.type == "cpu" or n > 256:
        return "wavefront"
    return "closure"


def run_pipeline(dag, block: int = 512, engine: str = "auto", device=None):
    """The consensus pipeline over a DagTensors, on `device` (CUDA
    unless the caller names another; raises when CUDA is absent).

    engine="closure": trip counts scale with E/block + number of rounds,
    not DAG depth — coordinates from the block closure (ops/closure.py),
    rounds from the witness-frontier sweep (ops/frontier.py), then fame
    and round-received at a tight round bound read from the frontier.
    engine="wavefront": the depth-sequential sweeps. engine="auto"
    picks by device and n (_default_engine). Both engines return the
    same six int32/bool tensors on the device, bit-identical to each
    other and to the reference."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = _default_engine(dag.n, dev)
    if engine == "wavefront":
        return run_pipeline_wavefront(dag, dev)
    if engine != "closure":
        raise ValueError(f"unknown engine {engine!r}")

    n, sm, e = dag.n, dag.super_majority, dag.e
    t = _to_device(dag, dev)
    block = min(block, max(64, 1 << (e - 1).bit_length())) if e else 64
    la, rbase = closure.coordinates(dag, block=block, device=dev)
    fd = kernels.compute_first_descendants(
        la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
    wt_abs, fr_rel, rho_min = frontier.compute_frontier(
        la, rbase, fd, t["chain"], t["chain_len"], dag.root_round, n=n, sm=sm)
    rounds, wit = frontier.rounds_from_frontier(
        fr_rel, t["creator"][:e], t["index"][:e], t["self_parent"][:e],
        rho_min, n=n)
    max_round = wt_abs.shape[0] - 1
    r_bound = max(dag.max_rounds, max_round + 1)
    r_small = _round_bucket(max_round, r_bound)
    wt_small = torch.full((r_small, n), -1, dtype=I32, device=dev)
    wt_small[: min(r_small, wt_abs.shape[0])] = wt_abs[:r_small]
    famous_small, rr, cts = _fame_and_order(
        wt_small, la, fd, rounds, t, n=n, sm=sm, r=r_small)
    wt = torch.full((r_bound, n), -1, dtype=I32, device=dev)
    wt[: wt_abs.shape[0]] = wt_abs
    return rounds, wit, wt, pad_famous(famous_small, r_bound, n), rr, cts
