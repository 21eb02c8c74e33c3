"""The single-controller mesh of the incremental engine (counterpart of
the NamedSharding placement in babble_tpu/ops/incremental.py).

The JAX engine places its O(E·n) carries on a jax.sharding.Mesh and
lets GSPMD partition the same jitted kernels. PyTorch has no compiler
that partitions the engine's kernel launches and scatters, so here the
engine stays one object in one process and holds each such table as
the list of its d >= 1 parts, part p on the p-th device of the mesh
(Layout; the devices may repeat). Its stages loop over the parts, and
its exchanges are concatenations gathered on the controller (part 0's
device):

- the coordinate table la [cap+1, n] by participant column: part p
  holds columns [p·w, (p+1)·w), w = n/d, and a read gathers
  whole-width rows (ColumnShards), so the strongly-see kernel never
  sees a partial count;
- the chain tables ([n, K], [n, K, n] and the rank cube [n, n, K]) by
  chain, axis 0: part p holds chains [p·w, (p+1)·w).

The reads below hand one part (d = 1, the unsharded engine) to the
shared code (frontier.py, kernels.py) as the bare table, uncopied.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import torch

from ..devices import resolve_device

I32 = torch.int32


def mesh_devices(mesh) -> List[torch.device]:
    """The mesh as a flat list of devices, one per shard: a sequence of
    devices, or a 2 x d/2 ("dcn", "ici") grid (a sequence of sequences)
    flattened a-major, the order of parallel.mesh_axis's composite
    axis. Repeats are allowed. A CUDA device without an index is the
    current one's, so that equal devices compare equal."""
    flat: List[torch.device] = []

    def walk(m):
        if isinstance(m, (str, torch.device)):
            dev = resolve_device(m)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            flat.append(dev)
        else:
            for x in m:
                walk(x)

    walk(mesh)
    if not flat:
        raise ValueError("an empty mesh")
    return flat


def engine_mesh_devices(engine_mesh: int, n: int, device=None):
    """The devices of a node's engine mesh (Config.engine_mesh): d
    shrinks to the largest divisor of the validator count n, with a
    warning, as the JAX package's Core does; shard p goes on cuda:(p
    mod the card count), or on `device` itself when that is not CUDA.
    None for a single device."""
    if not engine_mesh or engine_mesh <= 1:
        return None
    d = engine_mesh
    while d > 1 and n % d:
        d -= 1
    if d != engine_mesh:
        logging.getLogger("babble_tpu_torch").warning(
            "engine_mesh=%d does not divide %d validators; using %d device(s)",
            engine_mesh, n, d)
    if d <= 1:
        return None
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * d
    count = torch.cuda.device_count()
    return [torch.device("cuda", p % count) for p in range(d)]


class Layout:
    """Where an engine's O(E·n) tables live: d >= 1 parts over the n
    chains (participant columns for the coordinate table), part p on
    devices[p] holding [p·w, (p+1)·w), w = n/d. `mesh` is as
    mesh_devices takes it; None is one part on `device`. With a mesh,
    `device`, when given, must be its first device, the controller."""

    def __init__(self, n: int, mesh=None, device=None):
        if mesh is None:
            self.devices = [resolve_device(device)]
        else:
            self.devices = mesh_devices(mesh)
            if device is not None and mesh_devices([device])[0] != self.devices[0]:
                raise ValueError(
                    f"device {device} is not the mesh's first device {self.devices[0]}")
        d = len(self.devices)
        if n % d:
            raise ValueError(f"participants {n} must divide over {d} devices")
        self.w = n // d
        self.cards = len(set(self.devices))  # distinct devices

    def columns(self, rows: int, fill: int) -> List[torch.Tensor]:
        """A [rows, n] int32 table by column: [rows, w] on each device."""
        return [torch.full((rows, self.w), fill, dtype=I32, device=dev)
                for dev in self.devices]

    def chains(self, tail: Tuple[int, ...], fill: int) -> List[torch.Tensor]:
        """An [n, *tail] int32 table by chain: [w, *tail] on each device."""
        return [torch.full((self.w,) + tail, fill, dtype=I32, device=dev)
                for dev in self.devices]

    def upload(self, a, put) -> List[torch.Tensor]:
        """A host array [n, ...] by chain: put(rows, device) a part."""
        w = self.w
        return [put(a[p * w:(p + 1) * w], dev) for p, dev in enumerate(self.devices)]

    def stats(self) -> dict:
        """The mesh's keys of the engine's memory stats, none for one part."""
        if len(self.devices) == 1:
            return {}
        return {"mesh_shards": len(self.devices), "mesh_devices": self.cards}


class ColumnShards:
    """A [rows, n] int32 table held as d column shards, part p [rows, w]
    = columns [p·w, (p+1)·w) on its own device, read on `device` (the
    controller):

    - view[ids] -> [*ids.shape, n], whole-width rows: each shard's slice
      of the rows, concatenated in column order;
    - view[rows, cols] -> the elements, rows and cols broadcast: each
      shard answers the columns it holds.

    The engine reads its coordinate table only through these gathers
    (the fd fold's batch rows, the skip correction's candidates, fame's
    window, round received), so a B1 launch gets whole-width rows."""

    def __init__(self, parts: Sequence[torch.Tensor], device: torch.device):
        self.parts = list(parts)
        self.device = device
        self.w = self.parts[0].shape[1]
        self.shape = (self.parts[0].shape[0], self.w * len(self.parts))

    def __getitem__(self, key):
        if isinstance(key, tuple):
            rows, cols = torch.broadcast_tensors(*key)
            shard = cols // self.w
            out = None
            for p, part in enumerate(self.parts):
                c = torch.clamp(cols - p * self.w, 0, self.w - 1)
                v = part[rows.to(part.device), c.to(part.device)].to(self.device)
                out = v if out is None else torch.where(shard == p, v, out)
            return out
        return torch.cat([part[key.to(part.device)].to(self.device)
                          for part in self.parts], -1)


def column_view(parts: Sequence[torch.Tensor], device):
    """A column-sharded table as a pass reads it: the bare table of one
    part, else a ColumnShards gathered on `device`, the controller."""
    return parts[0] if len(parts) == 1 else ColumnShards(parts, device)


def chain_view(parts: Sequence[torch.Tensor]):
    """A chain-sharded table as frontier.py reads it: the bare table of
    one part, else the list of parts."""
    return parts[0] if len(parts) == 1 else list(parts)


def split_chains(t: torch.Tensor, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """t [n, ...] on the controller cut like a chain-sharded table's
    parts, each on its part's device: [t] itself for one part."""
    if len(parts) == 1:
        return [t]
    w = parts[0].shape[0]
    return [t[p * w:(p + 1) * w].to(part.device) for p, part in enumerate(parts)]


def gather_chains(parts: Sequence[torch.Tensor], fn, *idx: torch.Tensor) -> torch.Tensor:
    """fn(part, *idx), whose last axis is the part's chains, for each
    part of a chain-sharded table, the indices sent to each part's
    device, concatenated on idx[0]'s: fn(table, *idx) for one part."""
    if len(parts) == 1:
        return fn(parts[0], *idx)
    return torch.cat([fn(part, *(i.to(part.device) for i in idx)).to(idx[0].device)
                      for part in parts], -1)


def take_tables(tables, pos: torch.Tensor) -> List[torch.Tensor]:
    """take_chains of each table in `tables` (lists of parts cut alike)
    at pos [rows, n]: one chain index a part serves every table, and
    one part reads its bare tables."""
    d = len(tables[0])
    out = [[] for _ in tables]
    for p, part in enumerate(tables[0]):
        w = part.shape[0]
        chains = torch.arange(w, device=part.device)[None, :]
        pos_p = pos if d == 1 else pos[..., p * w:(p + 1) * w].to(part.device)
        for got, parts in zip(out, tables):
            got.append(parts[p][chains, pos_p])
    if d == 1:
        return [got[0] for got in out]
    return [torch.cat([t.to(pos.device) for t in got], -1) for got in out]


def take_chains(parts: Sequence[torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
    """tab[c, pos[..., c]] for every chain c of a chain-sharded [n, K]
    table (parts [w, K], shard p = chains [p·w, (p+1)·w)), on pos's
    device: each shard answers its own chains' columns of pos."""
    w = parts[0].shape[0]
    out = []
    for p, part in enumerate(parts):
        rows = torch.arange(w, device=part.device)
        out.append(part[rows, pos[..., p * w:(p + 1) * w].to(part.device)].to(pos.device))
    return torch.cat(out, -1)


def count_below(parts: Sequence[torch.Tensor], bound: int, device) -> torch.Tensor:
    """#{k : tab[c, k] < bound} per chain c of a chain-sharded [n, K]
    table, int32 [n] on `device`."""
    return torch.cat([(part < bound).sum(1, dtype=I32).to(device) for part in parts])


def nbytes(x) -> int:
    """Bytes of a tensor or of a table's list of parts (0 for anything
    else)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)) and x and all(isinstance(t, torch.Tensor) for t in x):
        return sum(t.numel() * t.element_size() for t in x)
    return 0
