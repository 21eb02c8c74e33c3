"""The single-controller mesh of the incremental engine (counterpart of
the NamedSharding placement in babble_tpu/ops/incremental.py).

The JAX engine places its O(E·n) carries on a jax.sharding.Mesh and
lets GSPMD partition the same jitted kernels. PyTorch has no compiler
that partitions the engine's kernel launches and scatters, so here the
engine stays one object in one process and holds each sharded table as
d tensors, one per shard, shard p on the p-th device of the mesh (the
devices may repeat: d shards on one card). Its stages loop over the
shards, and its exchanges are concatenations of tensors that the one
process holds, gathered on the controller device (shard 0's):

- the coordinate table la [cap+1, n] by participant column
  (ColumnShards): shard p holds columns [p·w, (p+1)·w), w = n/d, and a
  read gathers whole-width rows, so the strongly-see kernel never sees
  a partial count;
- the chain tables ([n, K], [n, K, n] and the rank cube [n, n, K]) by
  chain, axis 0: shard p holds chains [p·w, (p+1)·w) (take_chains,
  count_below read them per shard).
"""

from __future__ import annotations

import logging
from typing import List, Sequence

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
    """Bytes of a tensor, of a list of shards, or of a ColumnShards."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, ColumnShards):
        x = x.parts
    if isinstance(x, (list, tuple)) and x and all(isinstance(t, torch.Tensor) for t in x):
        return sum(t.numel() * t.element_size() for t in x)
    return 0
