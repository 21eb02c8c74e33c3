"""Block-parallel ancestor coordinates via boolean closure matmuls
(counterpart of babble_tpu/ops/closure.py).

Replaces the depth-sequential wavefront of kernels.compute_last_ancestors
(one step per DAG level — 2,709 levels at n=64/e=50k) with a schedule
whose trip count scales with E/block: events are processed in
topological blocks of B; intra-block reachability is closed by log2(B)
0/1 float32 matrix squarings (exact with TF32 off, devices.py), and each
event's coordinates are the masked max of the closure-selected base
rows, chunked over rows to bound the [rows, B, n] select-max.

Semantics mirror reference hashgraph.go:448-499 (InitEventCoordinates:
lastAncestors = elementwise max over parents' rows, own slot = own
index). Additionally propagates `rbase` — the max over ancestors of the
per-event root-round contribution (root_round[creator]+1 where a parent
is missing, reference hashgraph.go:211-262 Root fallback) — which the
round-frontier sweep (ops/frontier.py) consumes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve_device

I32 = torch.int32

# Working-set bound for the closure-apply reduction: rows are processed
# in chunks so each [rows, B, n] select+max stays under ~64M elements.
_APPLY_ELEMS = 1 << 26


def _apply_chunks(block: int, n: int) -> int:
    rows = max(_APPLY_ELEMS // (block * n), 1)
    chunks = (block + rows - 1) // rows
    # equal chunks: round rows down to a divisor of block
    while block % chunks:
        chunks += 1
    return chunks


def make_block_body(self_parent, other_parent, creator, index, root_base,
                    *, n, block):
    """The per-block closure step over [E_pad+1]-shaped inputs. Returns
    body(b, la, rb), which writes block b's rows of `la` and `rb` in
    place (each block reads only rows of earlier blocks) and returns
    them.

    The step has two halves, also reachable as body.prep(b, rb) and
    body.apply(blk, la, col0): prep builds the block's reachability
    closure (per block, not per column) and writes its rb rows; apply
    writes its la rows for the columns la holds, [col0, col0 +
    la.shape[1]). Each column of la is a max over the reached rows of
    that same column, so a column-sharded table (ops/mesh.py) runs apply
    on each shard with one prep, and no exchange."""
    dev = self_parent.device
    e_pad = self_parent.shape[0] - 1
    log2b = max(int(np.ceil(np.log2(block))), 1)
    eye = torch.eye(block, dtype=torch.float32, device=dev)
    rows = torch.arange(block, device=dev)

    def prep(b, rb):
        s = b * block
        sp = self_parent[s:s + block]
        op = other_parent[s:s + block]
        cr = creator[s:s + block]
        idx = index[s:s + block]
        rb0 = root_base[s:s + block]

        # Intra-block reachability closure: R[i, j] = 1 iff block event
        # i reaches block event j (topological order makes parents
        # strictly earlier, so log2(block) squarings close all paths).
        # Each row is written once per parent, so the scatter-max of the
        # reference is a gather-max-set over unique (row, col) pairs.
        sp_int = sp >= s
        op_int = op >= s
        adj = torch.zeros((block, block), dtype=torch.float32, device=dev)
        col = torch.where(sp_int, sp - s, 0)
        adj[rows, col] = torch.maximum(adj[rows, col], sp_int.to(torch.float32))
        col = torch.where(op_int, op - s, 0)
        adj[rows, col] = torch.maximum(adj[rows, col], op_int.to(torch.float32))
        reach = torch.clamp(adj + eye, max=1.0)
        for _ in range(log2b):
            reach = torch.clamp(reach @ reach, max=1.0)
        reach = reach > 0.5

        # Base rows come from the external parents; rb's own.
        ext_sp = torch.where(sp_int | (sp < 0), e_pad, sp)
        ext_op = torch.where(op_int | (op < 0), e_pad, op)
        base_rb = torch.maximum(torch.maximum(rb[ext_sp], rb[ext_op]), rb0)
        rb[s:s + block] = torch.where(reach, base_rb[None, :], -1).amax(1)
        return s, cr, idx, reach, ext_sp, ext_op, rows

    def apply(blk, la, col0=0):
        if la.device != blk[3].device:
            blk = blk[:1] + tuple(t.to(la.device) for t in blk[1:])
        s, cr, idx, reach, ext_sp, ext_op, rws = blk
        w = la.shape[1]
        # Base rows: external-parent coordinates + own slot (written
        # only where the creator's column is one of la's).
        base = torch.maximum(la[ext_sp], la[ext_op])
        if w == n:
            base[rws, cr] = torch.maximum(base[rws, cr], idx)
        else:
            own = (cr >= col0) & (cr < col0 + w)
            col = torch.clamp(cr - col0, 0, w - 1)
            cur = base[rws, col]
            base[rws, col] = torch.where(own, torch.maximum(cur, idx), cur)

        # Apply the closure: out[i] = max over reached j of base[j].
        chunks = _apply_chunks(block, w)
        rows_per_chunk = block // chunks
        for c in range(chunks):
            r0 = c * rows_per_chunk
            sel = reach[r0:r0 + rows_per_chunk]
            la[s + r0:s + r0 + rows_per_chunk] = torch.where(
                sel[:, :, None], base[None, :, :], -1).amax(1)
        return la

    def body(b, la, rb):
        apply(prep(b, rb), la)
        return la, rb

    body.prep = prep
    body.apply = apply
    return body


def compute_coordinates(self_parent, other_parent, creator, index, root_base,
                        *, n, block):
    """la[x, i] = index of x's latest ancestor created by i (-1 none);
    rbase[x] = max over ancestors-incl-self of root_base (-1 none).

    Inputs are [E_pad + 1] int32 with E_pad a multiple of `block` and a
    sentinel row at id E_pad; pad events carry sp=op=-1, index=-1,
    root_base=-1 and produce inert rows. Returns (la[E_pad, n],
    rbase[E_pad])."""
    dev = self_parent.device
    e_pad = self_parent.shape[0] - 1
    la = torch.full((e_pad + 1, n), -1, dtype=I32, device=dev)
    rb = torch.full((e_pad + 1,), -1, dtype=I32, device=dev)
    body = make_block_body(self_parent, other_parent, creator, index,
                           root_base, n=n, block=block)
    for b in range(e_pad // block):
        la, rb = body(b, la, rb)
    return la[:e_pad], rb[:e_pad]


def pad_for_blocks(dag, block: int):
    """Pad a DagTensors' per-event arrays to a block multiple (+sentinel)
    and build the root_base vector. Returns a dict of numpy kernel
    inputs."""
    e = dag.e
    e_pad = ((e + block - 1) // block) * block if e else block

    def pad(a, fill):
        out = np.full(e_pad + 1, fill, dtype=np.int32)
        out[:e] = a[:e]
        return out

    sp = pad(dag.self_parent, -1)
    op = pad(dag.other_parent, -1)
    cr = pad(dag.creator, 0)
    idx = pad(dag.index, -1)
    root_base = np.full(e_pad + 1, -1, dtype=np.int32)
    missing = (dag.self_parent[:e] < 0) | (dag.other_parent[:e] < 0)
    root_base[:e] = np.where(
        missing, dag.root_round[dag.creator[:e]] + 1, -1)
    return {
        "self_parent": sp, "other_parent": op, "creator": cr,
        "index": idx, "root_base": root_base, "e_pad": e_pad,
    }


def coordinates(dag, block: int = 512, device=None):
    """(la[E, n], rbase[E]) for a DagTensors, on `device` (CUDA unless
    the caller names another)."""
    dev = resolve_device(device)
    p = pad_for_blocks(dag, block)
    t = {k: torch.from_numpy(p[k]).to(dev) for k in
         ("self_parent", "other_parent", "creator", "index", "root_base")}
    la, rb = compute_coordinates(
        t["self_parent"], t["other_parent"], t["creator"], t["index"],
        t["root_base"], n=dag.n, block=block)
    return la[:dag.e], rb[:dag.e]
