"""SPMD rank processes on torch.distributed: the port's counterpart of
JAX's `shard_map` over a mesh axis (babble_tpu/ops/sharded.py) and of
`babble_tpu/devices.py::ensure_virtual_devices`.

JAX writes one program for every device of a mesh axis and XLA runs
it on each. Here the same program runs as `world` rank processes on
one process group:

- gloo on the CPU (the tests: rank processes stand in for devices);
- gloo for several ranks sharing one GPU (NCCL refuses two ranks on
  one device);
- NCCL with one rank per GPU.

`spawn_ranks(world, fn, *args, backend=..., device=..., timeout_s=...)`
runs `fn(rank, axis, *args)` in every rank and returns the ranks'
results in rank order. `axis` is the 1-D axis over all ranks; a rank
builds the composite axis of a mesh, such as ("dcn", "ici") on 2 x 4,
with `mesh_axis`, which checks the mesh's layout and is that same
axis. `ShardAxis` holds the axis's process group, its size and
this rank's shard index, and the four collectives that sharded.py's
stages use (`pmax`, `psum`, `all_gather`, `all_to_all`), each on one
contiguous int32 tensor.

gloo takes CUDA tensors in all four collectives (torch 2.11 on the
H100 host) and copies each operand and result through pinned host
memory itself; `ShardAxis.host_bytes` counts those bytes, from the
operands' sizes. NCCL moves them device to device. `ShardAxis.calls`
counts the collectives and `wait_s` the host seconds spent in them: a
gloo call returns when the collective is done, an NCCL call when it is
enqueued.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from .devices import resolve_device

BACKENDS = ("gloo", "nccl")
# A rank that exited 0 has put its result before it exited; allow the
# queue this long to hand it over.
_EXITED_GRACE_S = 10.0


class ShardAxis:
    """One mesh axis of the rank processes, possibly composite: its
    process group, its size, this rank's shard index along it (a-major
    over the named dims of a composite axis, as sharded.py's
    `_make_axis_index`), the backend, and the collectives.

    Each collective takes one contiguous int32 tensor (JAX's operands
    in sharded.py are int32, or bool cast to it). `pmax` and `psum`
    reduce in place and return their operand, which callers build fresh
    for the call."""

    def __init__(self, group, size: int, index: int, backend: str):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.backend = backend
        self.host_bytes = 0  # bytes gloo copied through host memory for CUDA operands
        self.calls = 0  # collectives made
        self.wait_s = 0.0  # host seconds inside them (gloo returns when done)

    def _check(self, name: str, t: torch.Tensor) -> None:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: operand must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand must be contiguous")

    def _count(self, t0: float, *tensors: torch.Tensor) -> None:
        self.calls += 1
        self.wait_s += time.perf_counter() - t0
        if self.backend == "gloo" and tensors[0].is_cuda:
            self.host_bytes += sum(t.numel() * t.element_size() for t in tensors)

    def _all_reduce(self, name: str, t: torch.Tensor, op) -> torch.Tensor:
        self._check(name, t)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        self._count(t0, t, t)
        return t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """lax.pmax: the elementwise max over the axis, in place."""
        return self._all_reduce("pmax", t, dist.ReduceOp.MAX)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """lax.psum: the elementwise sum over the axis, in place."""
        return self._all_reduce("psum", t, dist.ReduceOp.SUM)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """lax.all_gather(..., axis=0, tiled=True): the shards'
        operands [a, ...] concatenated on axis 0 in shard order,
        [size * a, ...]."""
        self._check("all_gather", t)
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(out, t, group=self.group)
        self._count(t0, t, out)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """lax.all_to_all(t, split_axis=0, concat_axis=1, tiled=True)
        on a 2-D [size * a, b] operand: row block i goes to shard i, and
        the blocks received are laid side by side, column block i from
        shard i, [a, size * b]. all_to_all_single stacks the received
        blocks on axis 0 instead, so they are moved beside each other."""
        self._check("all_to_all", t)
        if t.dim() != 2 or t.shape[0] % self.size:
            raise ValueError(
                f"all_to_all: need a 2-D operand whose rows divide over {self.size} "
                f"shards, got {tuple(t.shape)}")
        a, b = t.shape[0] // self.size, t.shape[1]
        out = torch.empty_like(t)
        t0 = time.perf_counter()
        dist.all_to_all_single(out, t, group=self.group)
        self._count(t0, t, out)
        return out.view(self.size, a, b).permute(1, 0, 2).reshape(a, self.size * b)


def mesh_axis(shape: Sequence[int], names: Sequence[str], backend: str,
              device) -> ShardAxis:
    """The composite axis over every dim of a mesh of this process
    group's ranks laid out row-major as `shape` with dims `names`
    (torch.distributed.device_mesh.init_device_mesh), e.g. ("dcn",
    "ici") on (2, 4): its index is sharded.py's, a-major over the dims,
    and its collectives run over the mesh's ranks flattened in that
    order. That is the whole group in rank order, so the axis returned
    is the 1-D axis over all ranks; what a mesh adds is the layout
    check, that the a-major index is the rank (raises otherwise).
    Collective over the ranks: every rank calls it with the same
    arguments."""
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(names)
    mesh = init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=names)
    index = 0
    for dim, name in enumerate(names):
        index = index * mesh.size(dim) + mesh.get_local_rank(name)
    if mesh.mesh.reshape(-1).tolist() != list(range(dist.get_world_size())) or \
            index != dist.get_rank():
        raise RuntimeError(f"rank {dist.get_rank()}: mesh {mesh.mesh.tolist()} does not "
                           f"lay the group out a-major (index {index})")
    return ShardAxis(dist.group.WORLD, mesh.size(), index, backend)


def collectives_check(rank, axis, rows: int, cols: int, device, fail_rank=None):
    """A rank function that runs each collective once on this rank's
    operand x = rank * 1000 + arange(rows * cols) as int32 [rows, cols]
    (rows a multiple of the axis size) and returns x and the results as
    numpy: pmax(x), psum(x), all_gather(x), all_to_all(x). Rank
    `fail_rank` raises instead, leaving the others waiting in their
    first collective."""
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails on request")
    x = (rank * 1000 + torch.arange(rows * cols, dtype=torch.int32,
                                    device=device)).view(rows, cols)
    out = {"x": x, "pmax": axis.pmax(x.clone()), "psum": axis.psum(x.clone()),
           "all_gather": axis.all_gather(x), "all_to_all": axis.all_to_all(x)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def _rank_main(rank, world, backend, device, store_path, payload_path, timeout_s, results):
    """One rank: join the process group on a FileStore, load (fn, args)
    from the payload file, run fn(rank, axis, *args), put (rank, True,
    result) on `results`; on an error put (rank, False, traceback) and
    exit 1, leaving the group to the parent, which kills every rank."""
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        with open(payload_path, "rb") as f:
            fn, args = pickle.load(f)  # written by spawn_ranks for these ranks
        results.put((rank, True, fn(rank, ShardAxis(dist.group.WORLD, world, rank, backend),
                                    *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()


def _collect(procs, results, deadline: float, timeout_s: float) -> list:
    """Every rank's result, in rank order. Raises on a rank's error, on
    a rank that exited without a result, and at the deadline."""
    got, exited_at = {}, {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(got))
            raise TimeoutError(f"ranks {missing} did not finish within {timeout_s} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            now = time.monotonic()
            for rank, p in enumerate(procs):
                if rank in got or p.exitcode is None:
                    continue
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {rank} died with exit code {p.exitcode}")
                if now - exited_at.setdefault(rank, now) > _EXITED_GRACE_S:
                    raise RuntimeError(f"rank {rank} exited without a result")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        got[rank] = payload
    return [got[r] for r in range(len(procs))]


def spawn_ranks(world: int, fn: Callable, *args, backend: str = "gloo", device=None,
                timeout_s: float = 600.0) -> list:
    """Run fn(rank, axis, *args) in `world` new processes (the spawn
    start method), one rank each, on one process group of `backend`
    whose rendezvous is a FileStore in a fresh temporary directory (no
    port to race for). `axis` is the ShardAxis over all ranks. Returns
    the ranks' results in rank order.

    `fn` and `args` are pickled: `fn` must be a module-level function of
    this package, so that a rank imports nothing else. The ranks run on
    CUDA unless `device` names the CPU (devices.resolve_device). On the
    CPU each rank runs one intra-op thread; on CUDA rank r takes device
    r modulo the device count (gloo: every rank on the one GPU of a
    1-GPU host; NCCL needs a GPU for each rank). Collectives time out after
    `timeout_s`, and the whole run must end by then: on any rank's
    error, death or the deadline every rank is killed and the error is
    raised here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world < 1:
        raise ValueError(f"need at least one rank, got {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one GPU a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} GPUs (use gloo to share one)")
    elif dev.type != "cpu" or backend != "gloo":
        raise ValueError(f"no {backend} ranks on {dev}: gloo runs CPU ranks, "
                         "gloo or NCCL CUDA ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="babble-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        # fn and args go by file: a start() whose pickle outgrows the
        # pipe waits for the child to read it, and the child reads on
        # only after importing fn's module, so starts would run in turn.
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, backend, str(dev), store, payload, timeout_s,
                                   results))
                 for rank in range(world)]
        try:
            for p in procs:
                p.start()
            out = _collect(procs, results, deadline, timeout_s)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(5.0)
            results.close()
            results.join_thread()
