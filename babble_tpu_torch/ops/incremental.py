"""Incremental device-backed consensus: append events, re-run only the
undecided tip (counterpart of babble_tpu/ops/incremental.py).

The reference inserts one event at a time and re-runs
DivideRounds/DecideFame/FindOrder over its undetermined queue
(reference hashgraph/hashgraph.go:356-401, 616-858). This module keeps
an append-only DAG resident on the device and amortizes each sync:

  coordinates   the frozen prefix stays resident; only new closure
                blocks run (ops/closure.py block body, in place on the
                carry), so per-sync cost scales with the new events.
  rounds        the witness frontier (ops/frontier.py) restarts at the
                first round that can still gain members. Rows below are
                provably frozen: chain positions only append, and
                strongly-see of an existing event is stable under new
                descendants.
  fame          kernels.decide_fame over a round window starting at the
                first undecided round. Window-relative round numbers
                preserve the vote/coin semantics exactly (diff = j - rx
                is shift-invariant).
  round recv    a windowed sweep over candidate rounds, gated by a
                host-maintained eligibility mask that mirrors the
                reference's undecided-rounds bookkeeping, straggler
                quirk included (hashgraph.go:629-637, 762-764).

Frame reset (reference hashgraph.go:879-898): the engine is
position-based internally, so offset chain bases reduce to a
per-creator `index_base` subtracted at append time, and offset round
bases ride the per-participant `root_round` vector the closure
propagates as rbase.

Where the JAX package donates a carry (coordinates, event columns,
chain tables, rank cube), the port updates it in place. The rounds and
round-received carries are written out of place and committed only by a
successful collect(), so an abandoned or failed pass leaves them as
they were. The JAX package's scatters with mode="drop" become
`_set_where` (lanes masked, never a write to a live row), its clamped
slices explicit clamps.

On a CUDA device every device op of an engine runs on the engine's own
stream, on the staging worker and on the caller's thread alike; inputs
go up from pinned memory without blocking, and the one packed result
of a pass comes back by one non-blocking copy into pinned memory that
collect() waits on through an event. The frontier sweep reads one flag
per round on the host (frontier.frontier_sweep_impl); that read happens
on the staging worker, never on the caller's thread unless a redo runs
there.

The mesh (`mesh=[device, ...]`, d shards): the JAX package places its
O(E·n) carries with NamedSharding and lets GSPMD partition the same
jitted kernels. Here the engine stays one object under one controller
(ops/mesh.py): the coordinate table is held as d column shards, the
chain tables and the rank cube as d chain shards, and each stage loops
over the shards. Closure runs on each column shard with the block's
reachability computed once; the fd fold gathers the batch's la rows
whole-width (the pass's one exchange outside the epilogue) and each
chain shard folds its own chains; the epilogue reads la and fd through
row views that concatenate the shards' slices, and the frontier probe
runs once per chain shard. The 1-D event columns and the result
carries stay whole on the controller (shard 0's device). A single
device, or no mesh, is the unsharded engine.

Left out: the compiled cost report of the JAX package (XLA cost
analysis; device telemetry).
"""

from __future__ import annotations

import bisect
import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..devices import resolve_device
from . import closure, frontier, hopper_kernels, kernels
from .kernels import FAME_TRUE, FAME_UNDEFINED, INT32_MAX
from .mesh import ColumnShards, mesh_devices, nbytes, take_chains

I32 = torch.int32

# Go's zero time (0001-01-01T00:00:00Z) in ns — the value MedianTimestamp
# substitutes for unreached witnesses (reference hashgraph.go:860-868).
# It overflows int64, so host arrays store CTS_SENTINEL (which still
# sorts below every real timestamp) and the Python-level RunDelta
# carries the true value.
ZERO_TIME_NS = -62135596800 * 1_000_000_000
CTS_SENTINEL = np.iinfo(np.int64).min

# Device timestamps ride as a lexicographic (hi, lo) int32 pair:
# hi = ns >> 32 (arithmetic), lo = (ns & 0xFFFFFFFF) - 2^31, so signed
# (hi, lo) order == int64 ns order for every int64. ZERO_TIME is the
# pair (INT32_MIN, 0): it sorts below any real wall-clock timestamp.
ZERO_TS_HI = -(2**31)


def _ts_split(ts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split int64 ns into order-preserving (hi, lo) int32 planes."""
    ts = np.asarray(ts, np.int64)
    hi = (ts >> 32).astype(np.int32)
    lo = ((ts & 0xFFFFFFFF) - 2**31).astype(np.int32)
    return hi, lo


def _ts_join(hi: int, lo: int) -> int:
    """Inverse of _ts_split for one pair (host-side, Python ints)."""
    return (int(hi) << 32) | ((int(lo) + 2**31) & 0xFFFFFFFF)


def _pow2(x: int, floor: int = 8) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


def _pow4(x: int, floor: int) -> int:
    """Coarse x4 bucket. The port compiles nothing per shape; it keeps
    the JAX package's buckets so that both engines size their windows,
    and so redo, identically."""
    p = floor
    while p < x:
        p *= 4
    return p


def _set_where(dst, idx, values, ok):
    """dst[idx] = values on the lanes where `ok`, in place: JAX's
    scatter with mode="drop", with no host read. idx is a tuple of
    index tensors of ok's shape addressing dst's leading dims; values
    has ok's shape plus dst's trailing dims. Lanes that are not ok may
    hold any index; they are sent to the first ok lane's slot with its
    value (duplicate indices that agree), or, when no lane is ok, to a
    clamped slot with that slot's own value. So no lane that is not ok
    ever changes dst.

    Lane f is a one-element index tensor, never a 0-d one: torch reads
    a 0-d index on the host, a synchronisation per index."""
    lanes = ok.numel()
    tail = dst.shape[len(idx):]
    flat_ok = ok.reshape(-1)
    f = torch.argmax(flat_ok.to(torch.uint8)).reshape(1)  # first ok lane
    idx_f = tuple(torch.clamp(i.reshape(-1)[f], 0, size - 1)
                  for i, size in zip(idx, dst.shape))
    ok_f = flat_ok[f].reshape((1,) * (1 + len(tail)))
    val_f = torch.where(ok_f, values.reshape((lanes,) + tail)[f], dst[idx_f])
    idx2 = tuple(torch.where(ok, i, i_f) for i, i_f in zip(idx, idx_f))
    ok_v = ok.reshape(ok.shape + (1,) * len(tail))
    dst[idx2] = torch.where(ok_v, values, val_f)
    return dst


def _closure_update(la, rb, self_parent, other_parent, creator, index,
                    root_base, b0, b1, *, n, block):
    """Run the closure block body over blocks [b0, b1) in place on the
    coordinate carries la [cap+1, n] / rb [cap+1]. A list la is the
    table's column shards, in column order: each block's reachability
    is computed once and applied to every shard."""
    body = closure.make_block_body(
        self_parent, other_parent, creator, index, root_base,
        n=n, block=block)
    if isinstance(la, list):
        w = la[0].shape[1]
        for b in range(b0, b1):
            blk = body.prep(b, rb)
            for p, part in enumerate(la):
                body.apply(blk, part, p * w)
        return la, rb
    for b in range(b0, b1):
        la, rb = body(b, la, rb)
    return la, rb


def _pad_rows(a, *, rows, fill):
    """Grow a device carry by `rows` fill-rows along axis 0."""
    pad = torch.full((rows,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], 0)


def _pad_cols(a, *, cols, fill, axis=-1):
    """Grow a device carry by `cols` fill-slices along `axis`."""
    axis = axis % a.dim()
    shape = list(a.shape)
    shape[axis] = cols
    pad = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], axis)


def _each(x, fn, **kw):
    """fn(x, **kw), or [fn(t, **kw) for each shard] for a sharded carry."""
    return [fn(t, **kw) for t in x] if isinstance(x, list) else fn(x, **kw)


def _pad_ranks(ranks, len_counted, *, cols):
    """Grow the fd rank cube [n, n, K] -> [n, n, K+cols] (or a chain
    shard of it, [chains, n, K], with its chains' len_counted). Every
    counted la value is a chain position < K <= t for the new
    thresholds t, so the new columns are exactly the per-chain counted
    length."""
    c, n = ranks.shape[:2]
    pad = len_counted.to(ranks.dtype)[:, None, None].expand(c, n, cols)
    return torch.cat([ranks, pad], 2)


def _ingest(sp_d, op_d, cr_d, idx_d, coin_d, rb0_d,
            sp_b, op_b, cr_b, idx_b, coin_b, rb0_b, e0, *, bp):
    """Write one appended batch (host slices padded to bp) into the
    resident event columns at offset e0, in place. The caller keeps
    e0 + bp within the columns (the JAX package's dynamic_update_slice
    would clamp the start instead)."""
    out = []
    for arr, b in ((sp_d, sp_b), (op_d, op_b), (cr_d, cr_b),
                   (idx_d, idx_b), (coin_d, coin_b), (rb0_d, rb0_b)):
        if e0 + bp > arr.shape[0]:
            raise ValueError(f"batch [{e0}, {e0 + bp}) past {arr.shape[0]} rows")
        arr[e0:e0 + bp] = b.to(arr.dtype)
        out.append(arr)
    return tuple(out)


def _chain_ingest(chain_d, chain_th, chain_tl, newtab, newpos,
                  newhi, newlo, *, n, m):
    """Scatter the batch's per-creator new events ([n, m] id table, -1
    pad; newpos the matching chain positions) into the resident chain
    table and timestamp planes, in place. Pad lanes and positions past
    the table are dropped."""
    k = chain_d.shape[1]
    ok = (newtab >= 0) & (newpos < k)
    crows = torch.arange(n, device=newtab.device)[:, None].expand(n, m)
    idx = (crows, newpos.long())
    _set_where(chain_d, idx, newtab, ok)
    _set_where(chain_th, idx, newhi, ok)
    _set_where(chain_tl, idx, newlo, ok)
    return chain_d, chain_th, chain_tl


def _tables_chain_write(chain_la, chain_rb, la, rb, newtab, newpos,
                        *, n, m, k):
    """Shared prologue of the fd fold: write the batch rows into the
    resident chain_la/chain_rb tables in place and return the effective
    la rows (INT32_MAX in pad lanes)."""
    cap1 = la.shape[0]
    valid = newtab >= 0
    ids = torch.where(valid, newtab, cap1 - 1)  # sentinel row, masked below
    la_new = la[ids]  # [n, m, n]
    rb_new = rb[ids]  # [n, m]
    la_eff = torch.where(valid[:, :, None], la_new, INT32_MAX)
    _write_chain_rows(chain_la, chain_rb, la_eff, torch.where(valid, rb_new, INT32_MAX),
                      valid, newpos, k=k)
    return chain_la, chain_rb, la_eff


def _write_chain_rows(chain_la, chain_rb, la_eff, rb_eff, valid, newpos, *, k):
    """chain_la[c, newpos[c, j]] = la_eff[c, j] (chain_rb likewise) in
    place, for the valid lanes at positions inside the table; the
    chains are the rows of `valid` [chains, m]."""
    c, m = valid.shape
    ok = valid & (newpos < k)
    crows = torch.arange(c, device=valid.device)[:, None].expand(c, m)
    idx = (crows, newpos.long())
    _set_where(chain_la, idx, la_eff, ok)
    _set_where(chain_rb, idx, rb_eff, ok)


def _tables_update_hist(ranks, chain_la, chain_rb, la, rb, newtab,
                        newpos, *, n, m):
    """Fold one appended batch into the resident rank cube, in place:
    ranks[c, i, t] += #{new events on chain c : la[., i] < t}, as a
    histogram over la values (scatter-add) and an int32 cumulative sum
    along the threshold axis — the form the JAX package runs on every
    backend but the TPU.

    Bucketing: la = -1 counts for every t >= 0 (bucket 0), la = v >= 0
    for t > v (bucket v+1); pad lanes (INT32_MAX) clip to bucket K and
    never land inside the cumsum's [0, K) window."""
    k = ranks.shape[2]
    chain_la, chain_rb, la_eff = _tables_chain_write(
        chain_la, chain_rb, la, rb, newtab, newpos, n=n, m=m, k=k)
    _fold_ranks(ranks, la_eff)
    return ranks, chain_la, chain_rb


def _fold_ranks(ranks, la_eff):
    """ranks[c, i, t] += #{j : la_eff[c, j, i] < t}, in place, for the
    chains c of ranks [chains, n, K] and la_eff [chains, m, n]."""
    k = ranks.shape[2]
    # Clip BEFORE the +1: INT32_MAX + 1 would wrap into bucket 0.
    b = torch.clamp(la_eff, -1, k - 1) + 1  # [c, m, n(i)] buckets
    bt = b.permute(0, 2, 1)  # [c, n(i), m]
    h = torch.zeros(bt.shape[:2] + (k + 1,), dtype=I32, device=ranks.device)
    h.scatter_add_(2, bt.long(), torch.ones(bt.shape, dtype=I32, device=ranks.device))
    ranks += torch.cumsum(h, 2, dtype=I32)[:, :, :k]


class _FdRows:
    """Lazy row view of the first-descendant matrix: fd[ids] -> the
    same [*ids.shape, n] rows _fd_from_ranks would give, gathered
    straight from the resident rank cube. Every consumer of fd in the
    engine (frontier sweep, fame, consensus timestamps) reads row
    gathers only, so the dense [cap, n] table (512 MB per pass at the
    n=1024 north star) is never built. A list `ranks` is the cube's
    chain shards, in chain order: each gives its chains' columns of the
    rows, concatenated on the creator vector's device."""

    def __init__(self, ranks, chain_len, creator, index):
        self.ranks = ranks
        self.chain_len = chain_len
        self.creator = creator
        self.index = index
        self.k = (ranks[0] if isinstance(ranks, list) else ranks).shape[2]

    def __getitem__(self, ids):
        ca = self.creator[ids]
        ix = self.index[ids]
        ia = torch.clamp(ix, 0, self.k - 1)
        if isinstance(self.ranks, list):
            raw = torch.cat([torch.movedim(r[:, ca.to(r.device), ia.to(r.device)], 0, -1)
                             .to(ca.device) for r in self.ranks], -1)
        else:
            raw = torch.movedim(self.ranks[:, ca, ia], 0, -1)  # [*S, n]
        fd = torch.where(raw < self.chain_len, raw, INT32_MAX)
        return torch.where((ix >= 0)[..., None], fd, INT32_MAX)


def _fd_from_ranks(ranks, chain_len, creator, index, *, n):
    """fd[a, c] from the resident rank cube: event a = chain[creator_a,
    index_a], so fd[a, c] = ranks[c, creator_a, index_a], INT32_MAX when
    the position is past chain c's end (the contract of
    kernels.fd_from_cube with the chain_len clamp fused in)."""
    k = ranks.shape[2]
    e1 = creator.shape[0] - 1
    ca = creator[:e1]
    ia = torch.clamp(index[:e1], 0, k - 1)
    raw = ranks[:, ca, ia].T  # [cap, n]
    fd = torch.where(raw < chain_len[None, :], raw, INT32_MAX)
    return torch.where((index[:e1] >= 0)[:, None], fd, INT32_MAX)


def _median_pairs(hi_m, lo_m, pick):
    """Row-wise element `pick` of the (hi, lo) pairs in lexicographic
    order — the JAX package's two-key sort — as one int64 sort: the key
    hi * 2^32 + (lo + 2^31) is order-preserving and invertible on every
    int32 pair (for a real timestamp it is its ns), so ZERO_TS
    (INT32_MIN, 0) still sorts first and the (INT32_MAX, INT32_MAX)
    pads last. Returns (hi, lo) int32 [rows]."""
    key = hi_m.to(torch.int64) * (1 << 32) + (lo_m.to(torch.int64) + (1 << 31))
    med = torch.gather(torch.sort(key, dim=1).values, 1, pick)[:, 0]
    return (med >> 32).to(I32), ((med & 0xFFFFFFFF) - (1 << 31)).to(I32)


def _consensus_fused(chain_la, chain_rb_tab, chain_len, la, ranks, rb_vec,
                     chain, wt_tab, fr_tab, wt_prev, fr_prev, t0, rho_min,
                     self_parent, creator, index, coin, e0, e1,
                     rounds_prev, rr_prev, fam_rel, in_list_rel,
                     chain_th, chain_tl, rx0, first_undec_prev, und_ids,
                     n_und, t_start,
                     *, n, sm, rcap, bp, rw, iw, cb, tw, mark=None,
                     k_bound=None, reads=None):
    """The whole per-sync consensus tail — frontier sweep, new-event
    rounds, fame merge, round received and median timestamps — ending
    in ONE packed int32 tensor, so the host pays one device->host copy
    per sync (plus the frontier's one flag read per round). The JAX
    package's jitted counterpart; every host scalar (t0, rho_min, e0,
    e1, rx0, first_undec_prev, n_und, t_start) is a Python int here.

    Window geometry: the witness/frontier tables are rho_min-relative
    [rcap, n] and are written in place; fame runs over [rx0, rho_min +
    rcap) and round received over [i0, rho_min + rcap), where i0 =
    min(first_undec_prev, min_new_round + 1) is derived on the device.
    `fam_rel`/`in_list_rel` are rho_min-relative host tables from the
    previous run.

    Packed layout (word for word the JAX package's):
    [t_end, newly_count, wt_win(tw*n), fr_win(tw*n), new_rounds(bp),
    new_wit(bp), famous_merged(rw*n), sel_l(cb), rr_sel(cb),
    cts_hi(cb), cts_lo(cb)]: wt/fr_win are the swept rows [t_start,
    t_start+tw); entries j < newly_count of the cb tail are the
    newly-received undecided-window lanes, with their round received and
    split-int64 consensus timestamp (_ts_split).

    Also returns the updated rounds and rr carries, new tensors (the
    inputs are left as they were): the host commits them after a
    successful pull. `mark(name)`, when given, is called after the
    frontier, the batch rounds and fame + round received. `k_bound` is
    a host bound on the chain lengths for the frontier's search; fame's
    host reads are appended to `reads` when a list is given.

    Every torch call here is a release and re-take of the interpreter
    lock, which costs a node whose gossip threads share the process
    far more than the call (ROADMAP C1), so the loops run over the
    window's live rows only and the round-received sweep over row
    chunks."""
    dev = la.device
    k = (chain_th[0] if isinstance(chain_th, list) else chain_th).shape[1]
    fd = _FdRows(ranks, chain_len, creator, index)

    def _mark(name):
        if mark is not None:
            mark(name)

    # 1. Witness frontier (host loop, one flag read per round).
    wt_tab, fr_tab, t_end = frontier.frontier_sweep_impl(
        chain_la, chain_rb_tab, chain_len, la, fd, rb_vec, chain,
        wt_tab, fr_tab, wt_prev, fr_prev, t0, rho_min,
        n=n, sm=sm, rcap=rcap, k_bound=k_bound)
    _mark("frontier")

    # 2. Rounds + witness flags for the batch [e0, e1): round = rho_min
    # - 1 + #{frontier rows at or below the event's chain position}.
    # The caller keeps e0 + bp <= len(rounds_prev).
    ids_b = e0 + torch.arange(bp, device=dev)
    valid_b = ids_b < e1
    cr_b = creator[e0:e0 + bp]
    pos_b = index[e0:e0 + bp]
    sp_b = self_parent[e0:e0 + bp]
    cnt = (fr_tab[:, cr_b] <= pos_b[None, :]).sum(0, dtype=I32)
    rnd_b = torch.where(valid_b, rho_min - 1 + cnt, -1).to(I32)
    rounds_all = rounds_prev.clone()
    rounds_all[e0:e0 + bp] = rnd_b
    sp_safe = torch.where(sp_b >= 0, sp_b, 0)
    wit_b = valid_b & ((sp_b < 0) | (rnd_b > rounds_all[sp_safe]))
    big = INT32_MAX // 2
    min_new = torch.where(valid_b, rnd_b, big).min()
    i0 = torch.clamp(min_new + 1, max=first_undec_prev)  # 0-d, on device
    _mark("rounds")

    # 3. Fame over the window [rx0, rho_min + rcap): rows gathered from
    # the swept table, merged under the undecided-rounds gating.
    t_w = rx0 - rho_min + torch.arange(rw, device=dev)
    row_ok = (t_w >= 0) & (t_w < rcap)
    t_wc = torch.clamp(t_w, 0, rcap - 1)
    wt_win = torch.where(row_ok[:, None], wt_tab[t_wc], -1)
    famous_prev_win = torch.where(row_ok[:, None], fam_rel[t_wc], 0)
    in_list_win = row_ok & in_list_rel[t_wc]

    # The table is fresh past t0 and the sweep wrote rows [t0, t_end),
    # so no window row at or past rho_min + t_end holds a witness. A
    # round with no witness votes on nothing and decides nothing, so
    # fame over the r_live rows before it is fame over the window.
    r_live = max(0, min(rw, rho_min + t_end - rx0))
    famous_comp = torch.zeros((rw, n), dtype=I32, device=dev)
    if r_live >= 2:
        famous_comp[:r_live] = kernels.decide_fame(
            wt_win[:r_live].contiguous(), la, fd, index, coin, n=n, sm=sm, r=r_live,
            reads=reads)
    wt_valid_f = wt_win >= 0
    mergeable = (in_list_win[:, None] & wt_valid_f
                 & (famous_prev_win == FAME_UNDEFINED))
    famous_merged = torch.where(mergeable, famous_comp, famous_prev_win)
    undec_row = (wt_valid_f & (famous_merged == FAME_UNDEFINED)).any(1)
    still_listed = in_list_win & undec_row
    rows_w = torch.arange(rw, device=dev)
    t_first = torch.where(still_listed, rows_w, big).min()
    first_undec = rx0 + t_first  # huge when the list empties

    # 4. Round received over [i0, rho_min + rcap): fame/eligibility from
    # the host tables below rx0, from this run's merge at and above it.
    i_vec = i0 + torch.arange(iw, device=dev)
    rel = i_vec - rho_min
    rel_ok = (rel >= 0) & (rel < rcap)
    rel_c = torch.clamp(rel, 0, rcap - 1)
    wt_rr = torch.where(rel_ok[:, None], wt_tab[rel_c], -1)
    t2 = torch.clamp(i_vec - rx0, 0, rw - 1)
    in_fame_win = i_vec >= rx0
    fam_low = torch.where(rel_ok[:, None], fam_rel[rel_c], 0)
    fam_rr = torch.where(in_fame_win[:, None], famous_merged[t2], fam_low)
    # Decidedness below the fame window comes from the POST-sweep
    # witness table: a straggler witness landing this run in an
    # already-removed round has UNDEFINED fame forever and poisons the
    # round (reference hashgraph.go:629-637, 762-764).
    elig_low = rel_ok & ~((wt_rr >= 0) & (fam_low == FAME_UNDEFINED)).any(1)
    decided_vec = torch.where(in_fame_win, ~undec_row[t2], elig_low)
    elig = decided_vec & (first_undec > i_vec)

    wt_valid = wt_rr >= 0
    wt_safe = torch.where(wt_valid, wt_rr, 0)
    fmask = (fam_rr == FAME_TRUE) & wt_valid
    fcnt = fmask.sum(1, dtype=I32)
    idx_w = torch.where(wt_valid, index[wt_safe], -1)

    # The sweep runs over the undecided lanes only (host-gathered ids
    # with rr < 0): decided events never change.
    au = und_ids.shape[0]
    lane_ok = torch.arange(au, device=dev) < n_und
    uid = torch.where(lane_ok, und_ids, 0)
    cr_u = creator[uid]
    ix_u = index[uid]
    rnd_u = rounds_all[uid]
    rr_u0 = torch.where(lane_ok, rr_prev[uid], 0)  # pad lanes: never assigned
    # A lane is received at the first round i0 + t that qualifies it;
    # rows go in chunks of _RR_ELEMS see-mask elements.
    rr_u = rr_u0
    i_rows = i_vec.to(I32)
    rows_per = kernels.chunk_width(iw, n * au, budget=_RR_ELEMS)
    for t_lo in range(0, iw, rows_per):
        rows = slice(t_lo, min(t_lo + rows_per, iw))
        la_w = la[wt_safe[rows]]  # [T, n(w), n]
        see_wx = la_w[:, :, cr_u] >= ix_u  # [T, n(w), au]
        s_cnt = (see_wx & fmask[rows, :, None]).sum(1, dtype=I32)  # [T, au]
        ok = (elig[rows, None] & (s_cnt > (fcnt[rows] // 2)[:, None])
              & (i_rows[rows, None] > rnd_u) & ((rr_u < 0) & lane_ok))
        first = torch.argmax(ok.to(I32), 0)  # the first qualifying row
        rr_u = torch.where(ok.any(0), i_rows[rows][first], rr_u)
    newly_l = (rr_u >= 0) & (rr_u0 < 0) & lane_ok
    newly_count = newly_l.sum(dtype=I32)

    # Consensus timestamps only for the lanes just assigned, compacted
    # to a [cb] bucket. The stable sort puts the newly-received lanes
    # first, in lane order; newly_count > cb tells the host to redo.
    order = torch.argsort((~newly_l).to(I32), stable=True)
    sel_l = order[:cb]
    sel_ids = uid[sel_l]
    t_sel = torch.clamp(rr_u[sel_l] - i0, 0, iw - 1)
    w_sel = wt_safe[t_sel]  # [cb, n]
    fm_sel = fmask[t_sel]
    idxw_sel = idx_w[t_sel]
    cr_sel = creator[sel_ids]
    ix_sel = index[sel_ids]
    fd_sel = fd[sel_ids]  # [cb, n]
    see_sel = la[w_sel, cr_sel[:, None]] >= ix_sel[:, None]
    s_mask = see_sel & fm_sel
    s_cnt = s_mask.sum(1, dtype=I32)
    valid_t = fd_sel <= idxw_sel  # first descendant reaches the witness
    fd_pos = torch.clamp(fd_sel, 0, k - 1)
    if isinstance(chain_th, list):
        ts_hi = take_chains(chain_th, fd_pos)
        ts_lo = take_chains(chain_tl, fd_pos)
    else:
        rows_n = torch.arange(n, device=dev)[None, :]
        ts_hi = chain_th[rows_n, fd_pos]
        ts_lo = chain_tl[rows_n, fd_pos]
    # ZERO_TIME for unreached witnesses (sorts first); INT32_MAX pads
    # the non-famous lanes to the end.
    hi_v = torch.where(valid_t, ts_hi, ZERO_TS_HI)
    lo_v = torch.where(valid_t, ts_lo, 0)
    hi_m = torch.where(s_mask, hi_v, INT32_MAX)
    lo_m = torch.where(s_mask, lo_v, INT32_MAX)
    med_hi, med_lo = _median_pairs(hi_m, lo_m, (s_cnt // 2).long()[:, None])
    rr_sel = rr_u[sel_l]

    # Post-pass rr carry: pad lanes never write (not even row e, which
    # may be a live pad row a later append will occupy).
    rr_all = _set_where(rr_prev.clone(), (uid.long(),), rr_u, lane_ok)

    # Only rows [t_start, t_start + tw) of the frontier tables can have
    # changed this sync (clamped as lax.dynamic_slice clamps).
    ts0 = max(min(t_start, rcap - tw), 0)
    wt_ret = wt_tab[ts0:ts0 + tw]
    fr_ret = fr_tab[ts0:ts0 + tw]

    packed = torch.cat([
        torch.full((1,), t_end, dtype=I32, device=dev), newly_count[None],
        wt_ret.reshape(-1), fr_ret.reshape(-1),
        rnd_b, wit_b.to(I32), famous_merged.to(I32).reshape(-1),
        sel_l.to(I32), rr_sel.to(I32), med_hi, med_lo,
    ])
    _mark("fame_rr")
    return packed, rounds_all, rr_all


# Elements of one round-received chunk's [rows, n, lanes] see mask.
_RR_ELEMS = 1 << 24


def _analyze_cost(args, kw, outputs) -> dict:
    """The cost of one _consensus_fused call, counted from its shapes
    (there is no compiler cost model to ask, as XLA's cost_analysis is
    in the JAX package). With n participants, the pass's windows (rw
    fame rounds, iw round-received rounds, tw swept frontier rows, bp
    batch events, rcap relative rounds, cb timestamp lanes) and au
    undecided lanes:

    - flops: integer operations of the contractions that dominate the
      pass, 2 n^3 (rw + tw) (a compare and an add per witness pair and
      participant in fame and the frontier sweep) + 2 iw n au (the
      round-received see counts) + rcap bp (the batch's round compares)
      + cb n (3 + ceil(log2 n)) (the timestamp lanes' gathers and
      median sort);
    - bytes_accessed: every tensor input read once (a sharded table:
      each shard) and every output written once;
    - output_bytes: the exact bytes of the outputs (the packed buffer,
      rounds_out and rr_out);
    - temp_bytes: the largest intermediates the pass builds, 4 rw n^2
      (fame's per-round strongly-see matrices) + T n au (one
      round-received chunk's see mask, T rows of iw) + 16 cb n (the
      median's int64 keys, sorted).

    Never raises: it runs on the staging worker."""
    try:
        n, rw, iw, tw, bp, rcap, cb = (
            kw[k] for k in ("n", "rw", "iw", "tw", "bp", "rcap", "cb"))
        au = int(args[27].shape[0])  # und_ids
        log_n = max(1, (n - 1).bit_length())
        out_bytes = sum(t.numel() * t.element_size() for t in outputs)
        in_bytes = sum(nbytes(t) for t in args)
        t_rows = kernels.chunk_width(iw, n * au, budget=_RR_ELEMS)
        return {"consensus_fused": {
                    "flops": float(2 * n ** 3 * (rw + tw) + 2 * iw * n * au
                                   + rcap * bp + cb * n * (3 + log_n)),
                    "bytes_accessed": float(in_bytes + out_bytes),
                    "output_bytes": float(out_bytes),
                    "temp_bytes": float(4 * rw * n * n + t_rows * n * au + 16 * cb * n)},
                "shapes": {k: int(v) for k, v in kw.items()}}
    except Exception as exc:  # noqa: BLE001 - report, don't wedge
        return {"error": str(exc)}


@dataclass
class RunDelta:
    """What one run() call newly decided — the exact shape of the
    reference's per-RunConsensus side effects (node/core.go:277-296)."""

    new_rounds: List[Tuple[int, int, bool]] = field(default_factory=list)
    # (round, eid, famous) in host decide_fame order
    fame_updates: List[Tuple[int, int, bool]] = field(default_factory=list)
    # (eid, round_received, consensus_ts_ns), unsorted
    new_received: List[Tuple[int, int, int]] = field(default_factory=list)
    newly_decided_rounds: List[int] = field(default_factory=list)
    last_consensus_round: Optional[int] = None
    last_commited_round_events: int = 0


class PendingPass:
    """One dispatched-but-uncollected consensus pass.

    Created by dispatch(), consumed exactly once by collect() (or
    abandon()). Carries the pass SNAPSHOT (batch ids, sizes, chain
    lengths), the staged device inputs the redo loop re-dispatches
    against, and the in-flight results: the packed buffer's pinned host
    copy and the events that say when the device has computed it and
    when the copy has landed. Appends landing while the pass is in
    flight go to the engine's fresh staging list, never this one.
    """

    __slots__ = (
        "new_ids", "e", "cap0", "k0", "chain_len0",
        "chain_len_d", "la", "rb", "cr_d", "idx_d", "coin_d",
        "t0", "wt_prev", "fr_prev", "rel_rows",
        "e0_b", "bp", "rounds_up", "rr_up",
        "und", "und_up", "n_und", "au",
        "undecided_set", "rx0",
        "w_floor", "tw_floor", "rw", "iw", "cb", "tw", "rcap",
        "tw_i", "t_start", "fame_reads",
        "packed_dev", "packed_host", "computed", "pulled",
        "rounds_out", "rr_out",
        "dispatched_ns",
        "ready", "error",
    )


class IncrementalEngine:
    """Growable device-resident DAG + amortized consensus pipeline.

    append()/append_batch() stage events on the host (numpy mirrors with
    capacity doubling). dispatch() snapshots the staged batch and hands
    every device step of the pass (growth pads, ingest, closure, fd
    fold, the fused consensus epilogue) to a staging worker thread,
    returning a PendingPass at once; collect() waits only for the packed
    commit-delta copy, applies the host mirrors, and returns a RunDelta.
    run() = dispatch + collect. While a pass is in flight appends keep
    landing in a fresh staging list (double buffering). Queries serve
    from the host mirrors of the last collected pass.

    `device` is CUDA unless the caller names another (the tests pass
    "cpu", where the strongly-see kernel takes its plain version).

    `mesh` (a sequence of d devices, repeats allowed, or a 2 x d/2 grid
    given a-major; see ops/mesh.py) splits the O(E·n) carries into d
    shards, shard p on the p-th device: the coordinate table by
    participant column, the chain tables and the rank cube by chain.
    The controller, which holds everything else, is the mesh's first
    device; `device`, when given too, must be it. `n` must divide over
    the d shards. `shards(name)` lists a carry's shards.
    """

    def __init__(self, n: int, root_round=None, *, capacity: int = 256,
                 block: int = 256, k_capacity: int = 64,
                 index_base=None, from_reset: bool = False,
                 mesh=None, device=None):
        if n < 1:
            raise ValueError("need at least one participant")
        devs = None if mesh is None else mesh_devices(mesh)
        if devs is not None and device is not None and mesh_devices([device])[0] != devs[0]:
            raise ValueError(f"device {device} is not the mesh's first device {devs[0]}")
        self.device = resolve_device(device) if devs is None else devs[0]
        # Mesh placement: None is the unsharded engine (one device).
        self._mesh: Optional[List[torch.device]] = None
        if devs is not None and len(devs) > 1:
            if n % len(devs):
                raise ValueError(
                    f"participants {n} must divide over {len(devs)} devices")
            self._mesh = devs
        self.n = n
        self.sm = 2 * n // 3 + 1
        self.block = block
        self.root_round = (
            np.full(n, -1, np.int32) if root_round is None
            else np.asarray(root_round, np.int32).copy()
        )
        # Chain-position offset per creator: a frame root with
        # Root.index = k means the creator's next event has Go index
        # k+1 but chain position 0 (reference hashgraph.go:879-898).
        self.index_base = (
            np.zeros(n, np.int32) if index_base is None
            else np.asarray(index_base, np.int32).copy()
        )
        self.rho_min = int(self.root_round.min()) + 1
        self.cap = max(_pow2(capacity, block), block)
        self.kcap = _pow2(k_capacity, 8)

        self.e = 0
        c1 = self.cap + 1
        self.self_parent = np.full(c1, -1, np.int32)
        self.other_parent = np.full(c1, -1, np.int32)
        self.creator = np.zeros(c1, np.int32)
        self.index = np.full(c1, -1, np.int32)
        self.coin = np.zeros(c1, np.int8)
        self.root_base = np.full(c1, -1, np.int32)
        self.ts_ns = np.zeros(self.cap, np.int64)
        self.chain = np.full((n, self.kcap), -1, np.int32)
        self.chain_len = np.zeros(n, np.int32)

        # Results (host mirrors, -1 = undetermined).
        self.rounds = np.zeros(self.cap, np.int32)
        self.witness = np.zeros(self.cap, np.bool_)
        self.rr = np.zeros(self.cap, np.int32)  # pad rows 0: never assigned
        self.cts_ns = np.zeros(self.cap, np.int64)

        # One stream for every device op of this engine, on whichever
        # thread issues it (torch's current stream is per thread); a
        # mesh has one on each of its cards, so a pass's work on every
        # shard is ordered as on one card.
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._streams = [] if self._stream is None else [self._stream] + [
            torch.cuda.Stream(d) for d in dict.fromkeys(self._mesh or ())
            if d != self.device]

        # Device carries: coordinates plus everything the per-sync
        # pipeline would otherwise re-upload or recompute from scratch.
        # Under a mesh, the column- and chain-sharded ones are lists of
        # their d shards (ops/mesh.py).
        def full(shape, fill, dtype=I32):
            return torch.full(shape, fill, dtype=dtype, device=self.device)

        def by_col(rows, fill):
            if self._mesh is None:
                return full((rows, n), fill)
            w = n // len(self._mesh)
            return [torch.full((rows, w), fill, dtype=I32, device=d) for d in self._mesh]

        def by_chain(tail, fill):
            if self._mesh is None:
                return full((n,) + tail, fill)
            w = n // len(self._mesh)
            return [torch.full((w,) + tail, fill, dtype=I32, device=d) for d in self._mesh]

        with self._on_stream():
            self._la = by_col(c1, -1)
            self._rb = full((c1,), -1)
            self._sp_d = full((c1,), -1)
            self._op_d = full((c1,), -1)
            self._cr_d = full((c1,), 0)
            self._idx_d = full((c1,), -1)
            self._coin_d = full((c1,), 0, torch.int8)
            self._rb0_d = full((c1,), -1)
            self._chain_d = by_chain((self.kcap,), -1)
            # Resident split-int64 timestamp planes (see _ts_split).
            self._chain_th = by_chain((self.kcap,), 0)
            self._chain_tl = by_chain((self.kcap,), 0)
            # Resident consensus-result carries (committed post-pull).
            self._rounds_d = full((self.cap,), -1)
            self._rr_d = full((self.cap,), -1)
            self._ranks = by_chain((n, self.kcap), 0)
            # chain_la/chain_rb stay resident: the frontier reads them
            # every round, and only the new chain suffix rows are written.
            self._chain_la = by_chain((self.kcap, n), INT32_MAX)
            self._chain_rb = by_chain((self.kcap,), INT32_MAX)
        self._frozen_blocks = 0
        self._e_counted = 0
        self._len_counted = np.zeros(n, np.int32)

        # Frontier checkpoint: relative rows rho_min + t.
        self._fr_table = np.zeros((0, n), np.int32)
        self._wt_table = np.full((0, n), -1, np.int32)
        self._chain_len_prev = np.zeros(n, np.int32)

        # Fame / round-received bookkeeping (reference
        # hashgraph.go:629-637: queued-once, removed-once). A fresh
        # graph starts with round 0 queued; a frame-reset graph starts
        # empty and re-queues rounds as replayed events land.
        self.famous = np.zeros((0, n), np.int32)  # [r_total, n] trilean
        if from_reset:
            self.undecided_rounds: List[int] = []
            self._queued_rounds: set = set()
        else:
            self.undecided_rounds = [0]
            self._queued_rounds = {0}
        self._prev_first_undec = self.rho_min
        self._last_growth = 8  # rounds added by the previous run
        self._last_newly = 64  # round-received burst size of the last run
        self.last_consensus_round: Optional[int] = None

        self._new_since_run: List[int] = []
        self._empty_delta_ok = False  # True when state is at a fixpoint
        # The at-most-one in-flight pass: dispatch sets it,
        # collect/abandon clear it.
        self._inflight: Optional[PendingPass] = None
        # Staging worker (see dispatch()).
        self._stage_q: Optional[queue.Queue] = None
        self._stage_thread: Optional[threading.Thread] = None
        self._stage_lock = threading.Lock()
        # Window-floor ceiling: the JAX package's off-TPU choice (the
        # fame and round-received loops cost per sequential step, so
        # tight windows keep the step count at the real round movement).
        self._w_floor_max = 16
        # Wall between dispatch return and collect entry of the last
        # collected pass (device work the host did not wait for).
        self.last_overlap_ns = 0
        # Per-phase wall time (ns) of the last pass: coords, fd_fold,
        # frontier, rounds, fame_rr (the fused epilogue's parts), stage,
        # c_dispatch, c_stage_wait, c_pull (= c_pull_wait + c_pull_xfer),
        # consensus, apply. Device work is asynchronous, so a phase
        # charges its enqueue time unless BABBLE_ENGINE_TIMERS=1 makes
        # each mark synchronise first; the frontier synchronises every
        # round either way.
        self.phase_ns: dict = {}
        # Bytes of the last commit-delta pull.
        self.c_pull_bytes = 0
        # Redo dispatches over the engine's lifetime.
        self.redo_count = 0
        # Host reads of device values by the last collected pass: one
        # per frontier round swept and one per packed pull.
        self.host_syncs = 0
        # Cost attribution (/debug/profile?cost=1, the
        # babble_engine_pass_flops/_bytes gauges): request_cost_report()
        # arms a one-shot capture; the next fused-epilogue dispatch counts
        # its operations and bytes from the pass's shapes into here.
        self.cost_report: Optional[dict] = None
        self._cost_requested = False

    # -- device helpers ---------------------------------------------------

    def _on_stream(self):
        """Context that makes the engine's streams current on this
        thread, one on each card of its mesh (a no-op off CUDA)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        for st in self._streams:
            stack.enter_context(torch.cuda.stream(st))
        return stack

    def _upload(self, a: np.ndarray, device=None) -> torch.Tensor:
        """A host array on the engine's device (or on `device`, a mesh
        shard's). On CUDA the copy goes from pinned memory without
        blocking the host, ordered on the current (engine) stream; the
        caching host allocator keeps the pinned block until the copy
        has run."""
        dev = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._stream is None:
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    def shards(self, name: str) -> List[torch.Tensor]:
        """The shards of a device carry ("_la", "_chain_la", "_ranks",
        ...), in column or chain order: d tensors under a mesh, the one
        tensor otherwise."""
        t = getattr(self, name)
        return list(t) if isinstance(t, list) else [t]

    def _shard_rows(self):
        """(device, lo, hi) of each shard: its devices and its chains
        (or columns) [lo, hi)."""
        w = self.n // len(self._mesh)
        return [(d, p * w, (p + 1) * w) for p, d in enumerate(self._mesh)]

    # -- append ------------------------------------------------------------

    def append(self, sp: int, op: int, creator: int, index: int,
               coin: bool, ts_ns: int) -> int:
        """Append one event; parents are engine ids (-1 = root). Returns
        the event id. `index` is the event's Go index; the engine works
        in chain positions (index - index_base[creator]). Index must
        extend the creator's chain contiguously and sp must be its head
        (reference hashgraph.go:404-445)."""
        index = index - int(self.index_base[creator])
        if index != int(self.chain_len[creator]):
            raise ValueError(
                f"non-contiguous position {index} for creator {creator} "
                f"(chain length {int(self.chain_len[creator])})"
            )
        expect_sp = self.chain[creator, index - 1] if index > 0 else -1
        if sp != int(expect_sp):
            raise ValueError("self-parent is not the creator's head")
        if self.e == self.cap:
            self._grow_capacity()
        if index == self.kcap:
            self._grow_chains()
        i = self.e
        self.self_parent[i] = sp
        self.other_parent[i] = op
        self.creator[i] = creator
        self.index[i] = index
        self.coin[i] = 1 if coin else 0
        self.root_base[i] = (
            self.root_round[creator] + 1 if (sp < 0 or op < 0) else -1
        )
        self.ts_ns[i] = ts_ns
        self.chain[creator, index] = i
        self.chain_len[creator] += 1
        self.rounds[i] = -1
        self.witness[i] = False
        self.rr[i] = -1
        self.cts_ns[i] = CTS_SENTINEL
        self.e += 1
        self._new_since_run.append(i)
        self._empty_delta_ok = False
        return i

    def append_batch(self, sp, op, creator, index, coin, ts_ns) -> int:
        """Vectorized append of a whole batch, with the serial loop's
        semantics: per-creator contiguity and self-parent-is-head are
        enforced for every row, including rows whose parent is earlier
        in the same batch. Returns the first assigned event id; raises
        ValueError with NOTHING appended on an invalid batch."""
        m = len(sp)
        if m == 0:
            return self.e
        if m == 1:
            return self.append(int(sp[0]), int(op[0]), int(creator[0]),
                               int(index[0]), bool(coin[0]), int(ts_ns[0]))
        sp = np.asarray(sp, np.int64)
        op = np.asarray(op, np.int64)
        cr = np.asarray(creator, np.int64)
        idx = np.asarray(index, np.int64)
        coin = np.asarray(coin)
        ts = np.asarray(ts_ns, np.int64)

        pos = idx - self.index_base[cr]
        # Occurrence rank of each row within its creator group (stable):
        # the j-th batch row of a creator lands at chain_len + j.
        order = np.argsort(cr, kind="stable")
        scr = cr[order]
        new_group = np.r_[True, scr[1:] != scr[:-1]]
        group_start = np.flatnonzero(new_group)
        group_sizes = np.diff(np.r_[group_start, m])
        occ_sorted = np.arange(m) - np.repeat(group_start, group_sizes)
        occ = np.empty(m, np.int64)
        occ[order] = occ_sorted
        expect_pos = self.chain_len[cr] + occ
        if not np.array_equal(pos, expect_pos):
            k = int(np.flatnonzero(pos != expect_pos)[0])
            raise ValueError(
                f"non-contiguous position {int(pos[k])} for creator "
                f"{int(cr[k])} (expected {int(expect_pos[k])})")

        # Grow BEFORE the head gather below. Capacity is not observable
        # state, so growing for a batch that then fails is harmless.
        while self.e + m > self.cap:
            self._grow_capacity()
        while int(pos.max()) >= self.kcap:
            self._grow_chains()

        e0 = self.e
        expect_sp = np.where(
            pos > 0, self.chain[cr, np.maximum(pos, 1) - 1], -1)
        prev_row = np.empty(m, np.int64)
        prev_row[order] = np.r_[-1, order[:-1]]
        in_batch = occ > 0
        expect_sp[in_batch] = e0 + prev_row[in_batch]
        if not np.array_equal(sp, expect_sp):
            raise ValueError("self-parent is not the creator's head")

        lo, hi = e0, e0 + m
        self.self_parent[lo:hi] = sp
        self.other_parent[lo:hi] = op
        self.creator[lo:hi] = cr
        self.index[lo:hi] = pos
        self.coin[lo:hi] = np.where(coin, 1, 0)
        self.root_base[lo:hi] = np.where(
            (sp < 0) | (op < 0), self.root_round[cr] + 1, -1)
        self.ts_ns[lo:hi] = ts
        self.chain[cr, pos] = np.arange(lo, hi, dtype=np.int32)
        np.add.at(self.chain_len, scr[new_group],
                  group_sizes.astype(np.int32))
        self.rounds[lo:hi] = -1
        self.witness[lo:hi] = False
        self.rr[lo:hi] = -1
        self.cts_ns[lo:hi] = CTS_SENTINEL
        self.e = hi
        self._new_since_run.extend(range(lo, hi))
        self._empty_delta_ok = False
        return e0

    def _grow_capacity(self) -> None:
        new_cap = self.cap * 2
        c1 = new_cap + 1

        def regrow(a, fill, dtype):
            out = np.full(c1, fill, dtype)
            out[: self.cap] = a[: self.cap]
            return out

        self.self_parent = regrow(self.self_parent, -1, np.int32)
        self.other_parent = regrow(self.other_parent, -1, np.int32)
        self.creator = regrow(self.creator, 0, np.int32)
        self.index = regrow(self.index, -1, np.int32)
        self.coin = regrow(self.coin, 0, np.int8)
        self.root_base = regrow(self.root_base, -1, np.int32)
        for name, fill, dtype in (
            ("ts_ns", 0, np.int64), ("rounds", 0, np.int32),
            ("witness", False, np.bool_), ("rr", 0, np.int32),
            ("cts_ns", 0, np.int64),
        ):
            out = np.full(new_cap, fill, dtype)
            out[: self.cap] = getattr(self, name)[: self.cap]
            setattr(self, name, out)
        # Device carries grow lazily at the next pass (_sync_device).
        self.cap = new_cap

    def _grow_chains(self) -> None:
        new_k = self.kcap * 2
        chain = np.full((self.n, new_k), -1, np.int32)
        chain[:, : self.kcap] = self.chain
        self.chain = chain
        self.kcap = new_k

    # -- the incremental pipeline -----------------------------------------

    @property
    def _cap_dev(self) -> int:
        """Device-side event capacity, derived from the carry shapes."""
        return self.shards("_la")[0].shape[0] - 1

    @property
    def _kcap_dev(self) -> int:
        return self.shards("_chain_d")[0].shape[1]

    def _sync_device(self, cap_t: Optional[int] = None,
                     kcap_t: Optional[int] = None) -> None:
        """Bring the device carries up to the host mirrors' capacity and
        chain-bucket sizes (appends grow host state only), by device-side
        concatenation. `cap_t`/`kcap_t` (default: the live fields) grow
        to a pass's SNAPSHOT sizes, so a concurrent append crossing a
        growth boundary cannot change a pass's shapes mid-flight."""
        if cap_t is None:
            cap_t = self.cap
        if kcap_t is None:
            kcap_t = self.kcap
        while self._cap_dev < cap_t:
            rows = self._cap_dev  # double
            self._la = _each(self._la, _pad_rows, rows=rows, fill=-1)
            self._rb = _pad_rows(self._rb, rows=rows, fill=-1)
            self._sp_d = _pad_rows(self._sp_d, rows=rows, fill=-1)
            self._op_d = _pad_rows(self._op_d, rows=rows, fill=-1)
            self._cr_d = _pad_rows(self._cr_d, rows=rows, fill=0)
            self._idx_d = _pad_rows(self._idx_d, rows=rows, fill=-1)
            self._coin_d = _pad_rows(self._coin_d, rows=rows, fill=0)
            self._rb0_d = _pad_rows(self._rb0_d, rows=rows, fill=-1)
        while self._rounds_d.shape[0] < cap_t:
            rows = self._rounds_d.shape[0]  # double
            self._rounds_d = _pad_rows(self._rounds_d, rows=rows, fill=-1)
            self._rr_d = _pad_rows(self._rr_d, rows=rows, fill=-1)
        while self._kcap_dev < kcap_t:
            cols = self._kcap_dev  # double
            if self._mesh is None:
                self._ranks = _pad_ranks(
                    self._ranks, self._upload(self._len_counted), cols=cols)
            else:  # each shard pads with its own chains' counted lengths
                self._ranks = [
                    _pad_ranks(r, self._upload(self._len_counted[lo:hi], d), cols=cols)
                    for r, (d, lo, hi) in zip(self._ranks, self._shard_rows())]
            self._chain_la = _each(self._chain_la, _pad_cols, cols=cols,
                                   fill=INT32_MAX, axis=1)
            self._chain_d = _each(self._chain_d, _pad_cols, cols=cols, fill=-1)
            self._chain_th = _each(self._chain_th, _pad_cols, cols=cols, fill=0)
            self._chain_tl = _each(self._chain_tl, _pad_cols, cols=cols, fill=0)
            self._chain_rb = _each(self._chain_rb, _pad_cols, cols=cols,
                                   fill=INT32_MAX)

    def _ingest_batch(self, e: int, chain_len0: np.ndarray):
        """Stage the events appended since the last fold into the device
        carries: event-column slices at [e0, e) and the per-creator
        new-event table into the chain and timestamp tables. `e` and
        `chain_len0` are the pass SNAPSHOT; appends landing meanwhile
        only touch rows beyond it."""
        n = self.n
        sp_h, op_h = self.self_parent, self.other_parent
        cr_h, idx_h = self.creator, self.index
        coin_h, rb0_h = self.coin, self.root_base
        chain_h, ts_h = self.chain, self.ts_ns
        e0 = self._e_counted
        if e0 == e:
            return
        b = e - e0
        bp = _pow4(b, 1024)
        while e0 + bp > self._cap_dev + 1 and bp > b:
            bp //= 2
        if bp < b:
            bp = b

        def slc(a, fill, dtype):
            out = np.full(bp, fill, dtype)
            out[:b] = a[e0:e]
            return self._upload(out)

        _ingest(self._sp_d, self._op_d, self._cr_d, self._idx_d,
                self._coin_d, self._rb0_d,
                slc(sp_h, -1, np.int32), slc(op_h, -1, np.int32),
                slc(cr_h, 0, np.int32), slc(idx_h, -1, np.int32),
                slc(coin_h, 0, np.int8), slc(rb0_h, -1, np.int32),
                e0, bp=bp)

        # Per-creator new-event table: each creator's new events are the
        # suffix of its chain added since the last fold.
        new_lens = chain_len0 - self._len_counted
        m = _pow4(int(new_lens.max()), 16)
        newtab = np.full((n, m), -1, np.int32)
        newpos = np.zeros((n, m), np.int32)
        newhi = np.zeros((n, m), np.int32)
        newlo = np.zeros((n, m), np.int32)
        for c in np.nonzero(new_lens)[0]:
            l0, l1 = int(self._len_counted[c]), int(chain_len0[c])
            ids = chain_h[c, l0:l1]
            newtab[c, : l1 - l0] = ids
            newpos[c, : l1 - l0] = np.arange(l0, l1)
            newhi[c, : l1 - l0], newlo[c, : l1 - l0] = _ts_split(ts_h[ids])
        self._newtab_d = self._upload(newtab)
        self._new_m = m
        if self._mesh is None:
            self._newpos_d = self._upload(newpos)
            _chain_ingest(self._chain_d, self._chain_th, self._chain_tl,
                          self._newtab_d, self._newpos_d, self._upload(newhi),
                          self._upload(newlo), n=n, m=m)
            return
        # Each chain shard scatters its own chains' rows only.
        self._newpos_d = []
        for p, (d, lo, hi) in enumerate(self._shard_rows()):
            pos_p = self._upload(newpos[lo:hi], d)
            self._newpos_d.append(pos_p)
            _chain_ingest(self._chain_d[p], self._chain_th[p], self._chain_tl[p],
                          self._upload(newtab[lo:hi], d), pos_p,
                          self._upload(newhi[lo:hi], d), self._upload(newlo[lo:hi], d),
                          n=hi - lo, m=m)

    def run(self, *, unlocked=None) -> RunDelta:
        """One synchronous incremental consensus pass: dispatch() +
        collect() back to back.

        `unlocked` (optional): a context manager factory the engine
        enters around the blocking wait of collect() — a live node
        passes a core-lock release so gossip keeps inserting while the
        card computes. Safe because the pass works on a SNAPSHOT taken
        at dispatch."""
        pp = self.dispatch(unlocked=unlocked)
        if pp is None:
            return RunDelta(last_consensus_round=self.last_consensus_round)
        return self.collect(pp, unlocked=unlocked)

    # -- the async pipeline: dispatch / collect -----------------------------

    def dispatch(self, *, unlocked=None) -> Optional[PendingPass]:
        """Snapshot the appended batch and hand one full consensus pass
        to the staging worker thread, returning a PendingPass at once
        (None when there is nothing to do). The worker does the device
        work, including the frontier's one flag read per round, so the
        caller never waits on it. At most one pass may be in flight: the
        epilogue reads the previous pass's COMMITTED result carries, and
        commit happens in collect(). `unlocked` is accepted for symmetry
        with collect() and unused."""
        del unlocked
        if self._inflight is not None:
            raise RuntimeError("a consensus pass is already in flight")
        if self.e == 0 or (self._empty_delta_ok and not self._new_since_run):
            self.phase_ns = {}
            return None
        new_ids = self._new_since_run
        self._new_since_run = []
        try:
            pp = PendingPass()
            pp.new_ids = new_ids
            pp.e = self.e
            pp.cap0, pp.k0 = self.cap, self.kcap
            pp.chain_len0 = self.chain_len.copy()
            pp.ready = threading.Event()
            pp.error = None
            self._submit_stage(pp)
        except BaseException:
            # Retry safety: restore the batch so the next pass redoes it.
            self._new_since_run = new_ids + self._new_since_run
            raise
        self._inflight = pp
        return pp

    def _submit_stage(self, pp: PendingPass) -> None:
        with self._stage_lock:
            if self._stage_thread is None or not self._stage_thread.is_alive():
                self._stage_q = queue.Queue()
                self._stage_thread = threading.Thread(
                    target=self._stage_worker, args=(self._stage_q,),
                    daemon=True, name="babble-engine-stager")
                self._stage_thread.start()
            self._stage_q.put(pp)

    def _stage_worker(self, q: "queue.Queue") -> None:
        while True:
            try:
                pp = q.get(timeout=60.0)
            except queue.Empty:
                # Idle exit; the submit path restarts a worker on
                # demand. The lock makes exit-vs-put atomic.
                with self._stage_lock:
                    if not q.empty():
                        continue
                    if self._stage_thread is threading.current_thread():
                        self._stage_thread = None
                    return
            if pp is None:
                return
            try:
                self._stage_pass(pp)
            except BaseException as exc:  # noqa: BLE001 - relayed to collect
                pp.error = exc
            finally:
                pp.ready.set()

    def close(self) -> None:
        """Stop the staging worker (idle workers also exit on their
        own). Safe to call repeatedly; a later dispatch restarts it."""
        with self._stage_lock:
            if self._stage_thread is not None and self._stage_q is not None:
                self._stage_q.put(None)
                self._stage_thread = None

    def collect(self, pp: Optional[PendingPass], *,
                unlocked=None) -> RunDelta:
        """Wait for the commit delta of an in-flight pass — the one
        blocking device->host wait of the pass — apply the host mirrors,
        commit the device result carries, and return the RunDelta.
        Window-overflow redos re-dispatch the fused epilogue from the
        snapshot the PendingPass holds."""
        if pp is None:
            return RunDelta(last_consensus_round=self.last_consensus_round)
        if pp is not self._inflight:
            raise RuntimeError("collect() of a pass that is not in flight")
        self._inflight = None
        try:
            return self._collect_pass(pp, unlocked)
        except BaseException:
            self._new_since_run = pp.new_ids + self._new_since_run
            raise

    def abandon(self, pp: Optional[PendingPass]) -> None:
        """Drop an in-flight pass without applying it: the batch goes
        back to the staging list and the next pass redoes it (result
        carries are only committed by a successful collect)."""
        if pp is None or pp is not self._inflight:
            return
        self._inflight = None
        self._new_since_run = pp.new_ids + self._new_since_run

    @property
    def inflight(self) -> bool:
        return self._inflight is not None

    def _sync(self) -> None:
        """Wait for the engine's device work (a no-op off CUDA)."""
        for st in self._streams:
            st.synchronize()

    def _stage_pass(self, pp: PendingPass) -> None:
        """The staging half of a pass, run on the worker thread: device
        sync-up, ingest, closure, fd fold, the window derivation and the
        fused-epilogue dispatch. Reads only the pass snapshot plus host
        state that collect alone mutates."""
        with self._on_stream():
            self._stage_pass_on_stream(pp)

    def _stage_pass_on_stream(self, pp: PendingPass) -> None:
        n = self.n
        new_ids = pp.new_ids
        e = pp.e
        cap0, k0 = pp.cap0, pp.k0
        chain_len0 = pp.chain_len0
        _t = time.perf_counter_ns
        _phase_start = _t()
        self.phase_ns = {}
        # Timers synchronise only when asked: a synchronised mark stalls
        # the staging pipeline.
        sync_timers = os.environ.get("BABBLE_ENGINE_TIMERS") == "1"

        def _mark(name):
            nonlocal _phase_start
            if sync_timers:
                self._sync()
            now = _t()
            self.phase_ns[name] = now - _phase_start
            _phase_start = now

        # 0. Device sync-up: lazy capacity growth, then the new batch
        # into the resident event columns and chain tables.
        self._sync_device(cap0, k0)
        self._ingest_batch(e, chain_len0)
        pp.chain_len_d = self._upload(chain_len0)
        pp.cr_d = self._cr_d
        pp.idx_d = self._idx_d
        pp.coin_d = self._coin_d

        # 1. Coordinates: only blocks the frozen prefix doesn't cover.
        nb = (e + self.block - 1) // self.block
        _closure_update(self._la, self._rb, self._sp_d, self._op_d, pp.cr_d,
                        pp.idx_d, self._rb0_d, self._frozen_blocks, nb,
                        n=n, block=self.block)
        self._frozen_blocks = e // self.block
        if self._mesh is None:
            pp.la = self._la[:cap0]
        else:
            pp.la = ColumnShards([t[:cap0] for t in self._la], self.device)
        pp.rb = self._rb[:cap0]
        _mark("coords")

        # 2. Fold the batch into the resident rank cube; fd is read as
        # row gathers from it inside the epilogue (_FdRows).
        if self._e_counted < e:
            if self._mesh is None:
                _tables_update_hist(
                    self._ranks, self._chain_la, self._chain_rb,
                    self._la, self._rb, self._newtab_d, self._newpos_d,
                    n=n, m=self._new_m)
            else:
                self._fold_shards()
            self._e_counted = e
            self._len_counted = chain_len0.copy()
        _mark("fd_fold")

        # 3-6. Frontier, new-event rounds, fame and round received in
        # one epilogue with one packed pull (_consensus_fused).
        rel_rows = len(self._fr_table)
        if rel_rows:
            # A row can only change when a chain it is still waiting on
            # GROWS (frozen-row stability), so the sweep restarts at the
            # first such row; without the `grew` mask one lagging peer
            # would keep every row past its head growable.
            grew = chain_len0 > self._chain_len_prev
            growable = (
                (self._fr_table >= self._chain_len_prev[None, :])
                & grew[None, :]
            ).any(axis=1)
            t0 = int(np.argmax(growable)) if growable.any() else rel_rows
        else:
            t0 = 0
        pp.rel_rows = rel_rows
        pp.t0 = t0
        if t0 > 0:
            pp.wt_prev = self._upload(self._wt_table[t0 - 1])
            pp.fr_prev = self._upload(self._fr_table[t0 - 1])
        else:
            pp.wt_prev = torch.full((n,), -1, dtype=I32, device=self.device)
            pp.fr_prev = torch.zeros((n,), dtype=I32, device=self.device)

        # Batch range for device-side round assignment (contiguous ids).
        e0_b = new_ids[0] if new_ids else e
        b_new = e - e0_b
        bp = _pow4(max(b_new, 1), 1024)
        # Bound by cap (not cap+1): the kernel's rounds/rr vectors are
        # cap long, and a clamped dynamic_update_slice would silently
        # shift every batch round one slot down.
        while e0_b + bp > cap0 and bp > b_new:
            bp //= 2
        if bp < max(b_new, 1):
            bp = max(b_new, 1)
        pp.e0_b = e0_b
        pp.bp = bp

        pp.undecided_set = set(self.undecided_rounds)
        pp.rounds_up = self._rounds_d
        pp.rr_up = self._rr_d

        # Undecided-event window for the round-received sweep.
        und = np.nonzero(self.rr[:e] < 0)[0].astype(np.int32)
        au = _pow4(len(und), 4096)
        und_p = np.zeros(au, np.int32)
        und_p[: len(und)] = und
        pp.und = und
        pp.au = au
        pp.und_up = self._upload(und_p)
        pp.n_und = len(und)

        # Fame/rr window widths, PREDICTED from the previous run's round
        # growth (doubled); the post-pull checks redo on a misprediction.
        growth = 2 * self._last_growth + 2
        rx0_known = (
            self.undecided_rounds[0]
            if self.undecided_rounds else self._prev_first_undec)
        i0_known = min(self._prev_first_undec, rx0_known)
        w_floor = max(16, min(self._w_floor_max, (1 << 13) // n))
        pp.w_floor = w_floor
        pp.rw = pp.iw = _pow2(
            max(self.rho_min + rel_rows - rx0_known,
                self.rho_min + rel_rows - i0_known,
                rel_rows - t0, 1) + growth, w_floor)
        pp.rx0 = rx0_known
        # Consensus-timestamp bucket (a burst costs one redo and then
        # sticks via _last_newly).
        pp.cb = min(_pow2(max(self._last_newly, 1024)), cap0, au)
        pp.tw_floor = tw_floor = max(16, min(w_floor, (1 << 14) // n))
        pp.tw = min(pp.rw, _pow2(
            max(rel_rows - t0, 1) + growth, tw_floor))
        pp.rcap = _pow2(rel_rows + 8,
                        max(64, min(2048, (1 << 16) // n)))
        cd0 = self.phase_ns.get("c_dispatch", 0)
        self._dispatch_fused(pp)
        self.phase_ns["stage"] = (
            self.phase_ns.get("stage", 0) + _t() - _phase_start
            - (self.phase_ns.get("c_dispatch", 0) - cd0))
        pp.dispatched_ns = _t()

    def _fold_shards(self) -> None:
        """The fd fold under a mesh: the batch's la rows gathered
        whole-width from the column shards ([n, m, n], batch-sized: the
        pass's one exchange outside the epilogue), then each chain
        shard writes its chains' chain_la/chain_rb rows and folds its
        slice of the rank cube, as _tables_update_hist does."""
        la = ColumnShards(self._la, self.device)
        newtab = self._newtab_d
        valid = newtab >= 0
        ids = torch.where(valid, newtab, la.shape[0] - 1)  # sentinel row, masked
        la_eff = torch.where(valid[:, :, None], la[ids], INT32_MAX)
        rb_eff = torch.where(valid, self._rb[ids], INT32_MAX)
        k = self._kcap_dev
        for p, (d, lo, hi) in enumerate(self._shard_rows()):
            la_p = la_eff[lo:hi].to(d)
            _write_chain_rows(self._chain_la[p], self._chain_rb[p], la_p,
                              rb_eff[lo:hi].to(d), valid[lo:hi].to(d),
                              self._newpos_d[p], k=k)
            _fold_ranks(self._ranks[p], la_p)

    def _dispatch_fused(self, pp: PendingPass) -> None:
        """Build the window tables from host bookkeeping and enqueue the
        fused consensus epilogue for the pass's CURRENT window sizes,
        then the packed buffer's copy into pinned host memory. Called by
        the staging worker and again by collect() on a window-overflow
        redo; reads only host state that collect alone mutates."""
        n, sm = self.n, self.sm
        rcap = pp.rcap
        wt_tab = np.full((rcap, n), -1, np.int32)
        fr_tab = np.full((rcap, n), pp.k0, np.int32)
        wt_tab[:pp.t0] = self._wt_table[:pp.t0]
        fr_tab[:pp.t0] = self._fr_table[:pp.t0]
        # rho_min-relative round bookkeeping from the PREVIOUS run.
        fam_rel = np.zeros((rcap, n), np.int32)
        in_list_rel = np.ones(rcap, np.bool_)
        span = min(pp.rel_rows, rcap)
        for t in range(span):
            rho = self.rho_min + t
            fam_rel[t] = self.famous[rho]
            in_list_rel[t] = rho in pp.undecided_set
        pp.tw_i = min(pp.tw, rcap)
        pp.t_start = min(pp.t0, rcap - pp.tw_i)
        sync_timers = os.environ.get("BABBLE_ENGINE_TIMERS") == "1"
        t_stage = last = time.perf_counter_ns()

        def mark(name):
            nonlocal last
            if sync_timers:
                self._sync()
            now = time.perf_counter_ns()
            self.phase_ns[name] = self.phase_ns.get(name, 0) + now - last
            last = now

        fused_kw = dict(n=n, sm=sm, rcap=rcap, bp=pp.bp, rw=pp.rw, iw=pp.iw,
                        cb=pp.cb, tw=pp.tw_i)
        with self._on_stream():
            fused_args = (
                self._chain_la, self._chain_rb, pp.chain_len_d, pp.la,
                self._ranks, pp.rb, self._chain_d, self._upload(wt_tab),
                self._upload(fr_tab), pp.wt_prev, pp.fr_prev, pp.t0,
                self.rho_min, self._sp_d, pp.cr_d, pp.idx_d, pp.coin_d,
                pp.e0_b, pp.e, pp.rounds_up, pp.rr_up,
                self._upload(fam_rel), self._upload(in_list_rel),
                self._chain_th, self._chain_tl, pp.rx0,
                self._prev_first_undec, pp.und_up, pp.n_und, pp.t_start)
            pp.fame_reads = []
            packed, pp.rounds_out, pp.rr_out = _consensus_fused(
                *fused_args, **fused_kw, mark=mark,
                k_bound=int(pp.chain_len0.max(initial=0)), reads=pp.fame_reads)
            pp.packed_dev = packed
            if self._stream is None:
                pp.packed_host, pp.computed, pp.pulled = packed, None, None
            else:
                pp.computed = torch.cuda.Event()
                pp.computed.record(self._stream)
                pp.packed_host = torch.empty(
                    packed.shape, dtype=I32, pin_memory=True)
                pp.packed_host.copy_(packed, non_blocking=True)
                pp.pulled = torch.cuda.Event()
                pp.pulled.record(self._stream)
        self.phase_ns["c_dispatch"] = (
            self.phase_ns.get("c_dispatch", 0)
            + time.perf_counter_ns() - t_stage)
        if self._cost_requested:
            # One-shot: an overflow redo of the same pass re-arms only
            # if the operator asks again.
            self._cost_requested = False
            self.cost_report = _analyze_cost(
                fused_args, fused_kw, (packed, pp.rounds_out, pp.rr_out))

    def request_cost_report(self) -> None:
        """Arm a one-shot cost capture: the next fused-epilogue dispatch
        records the operations and bytes of its exact shapes into
        `self.cost_report` (see _analyze_cost)."""
        self.cost_report = None
        self._cost_requested = True

    def device_memory_stats(self) -> dict:
        """Device-memory plane: bytes of the engine's resident tensors,
        the host-mirror numpy bytes, and on CUDA the card's total, the
        process's allocated and peak allocated memory and a
        projected-peers headroom estimate (the
        dominant resident terms are O(n^2 K)). Never raises — it runs
        inside a metrics scrape."""
        dev = host = 0
        try:
            for v in vars(self).values():
                if isinstance(v, np.ndarray):
                    host += int(v.nbytes)
                else:
                    dev += nbytes(v)
        except Exception:  # noqa: BLE001
            return {"device_bytes": 0, "host_mirror_bytes": 0}
        out = {
            "device_bytes": dev,
            "host_mirror_bytes": host,
            "events": self.e,
            "capacity": self.cap,
            "chain_capacity": self.kcap,
            "n": self.n,
        }
        # A mesh's shards may share a card: the budget multiplies by the
        # distinct devices, not the shards.
        devices = 1
        if self._mesh is not None:
            devices = len(set(self._mesh))
            out["mesh_shards"] = len(self._mesh)
            out["mesh_devices"] = devices
        if self.device.type != "cuda":
            return out
        try:
            budget = int(torch.cuda.get_device_properties(self.device).total_memory)
            out["hbm_budget_bytes"] = budget
            out["hbm_in_use_bytes"] = int(torch.cuda.memory_allocated(self.device))
            out["hbm_peak_bytes"] = int(torch.cuda.max_memory_allocated(self.device))
        except Exception:  # noqa: BLE001 - a scrape must not fail
            budget = 0
        if budget and dev > 0:
            out["projected_max_peers"] = int(self.n * ((budget * devices) / dev) ** 0.5)
        return out

    def _collect_pass(self, pp: PendingPass, unlocked) -> RunDelta:
        n = self.n
        _t = time.perf_counter_ns
        syncs = 0
        # The stage wait, the pull and the redo loop run with the
        # caller's lock RELEASED: everything below uses the pass
        # snapshot, so interleaved appends are safe.
        _uctx = unlocked() if unlocked is not None else None
        if _uctx is not None:
            _uctx.__enter__()
        try:
            # phase_ns keys must not be written before this point:
            # _stage_pass resets the dict on the worker.
            _t_wait = _t()
            pp.ready.wait()
            if pp.error is not None:
                raise pp.error
            t_enter = _t()
            self.phase_ns["c_stage_wait"] = (
                self.phase_ns.get("c_stage_wait", 0) + t_enter - _t_wait)
            self.last_overlap_ns = max(t_enter - pp.dispatched_ns, 0)
            cd0 = self.phase_ns.get("c_dispatch", 0)
            cp0 = self.phase_ns.get("c_pull", 0)
            while True:
                # c_pull = wait (device compute still finishing) + xfer
                # (the packed buffer's copy into pinned memory).
                _t_pull = _t()
                if pp.computed is not None:
                    pp.computed.synchronize()
                _t_ready = _t()
                if pp.pulled is not None:
                    pp.pulled.synchronize()
                packed = pp.packed_host.numpy()
                _t_done = _t()
                self.phase_ns["c_pull_wait"] = (
                    self.phase_ns.get("c_pull_wait", 0) + _t_ready - _t_pull)
                self.phase_ns["c_pull_xfer"] = (
                    self.phase_ns.get("c_pull_xfer", 0) + _t_done - _t_ready)
                self.phase_ns["c_pull"] = (
                    self.phase_ns.get("c_pull", 0) + _t_done - _t_pull)
                self.c_pull_bytes = int(packed.nbytes)
                t_end = int(packed[0])
                newly_count = int(packed[1])
                # One flag read per frontier round swept, fame's reads,
                # one pull.
                syncs += t_end - pp.t0 + len(pp.fame_reads) + 1
                if t_end == pp.rcap:
                    # Frontier overflow: fame/rr ran against a truncated
                    # table — a safe but incomplete subset. Redo bigger.
                    pp.rcap *= 2
                    self.redo_count += 1
                    self._dispatch_fused(pp)
                    continue
                # Window overflows: in-window results are a valid subset,
                # but rounds beyond the windows were never processed —
                # redo with the exact spans now known. All checks read
                # this pull, so several overflows cost ONE redo.
                redo = False
                if t_end > pp.t_start + pp.tw_i:
                    pp.tw = _pow2(max(t_end - pp.t_start, pp.tw_i + 1),
                                  pp.tw_floor)
                    pp.rw = pp.iw = max(pp.rw, _pow2(pp.tw, pp.w_floor))
                    redo = True
                rnd_b = packed[2 + 2 * pp.tw_i * n:
                               2 + 2 * pp.tw_i * n + pp.bp]
                valid_b = rnd_b >= 0
                min_new = int(rnd_b[valid_b].min()) if valid_b.any() else None
                r_hi = self.rho_min + t_end
                i0_true = self._prev_first_undec
                if min_new is not None:
                    i0_true = min(i0_true, min_new + 1)
                if (r_hi - pp.rx0 > pp.rw or r_hi - i0_true > pp.iw
                        or newly_count > pp.cb):
                    pp.rw = pp.iw = _pow2(
                        max(r_hi - pp.rx0, r_hi - i0_true, pp.rw),
                        pp.w_floor)
                    pp.cb = min(_pow2(max(newly_count, 1024)), pp.cap0,
                                pp.au)
                    redo = True
                if redo:
                    self.redo_count += 1
                    self._dispatch_fused(pp)
                    continue
                # Window-geometry diagnostics of the final dispatch.
                self._dbg_windows = dict(
                    rcap=pp.rcap, rw=pp.rw, iw=pp.iw, cb=pp.cb, au=pp.au,
                    bp=pp.bp, tw=pp.tw_i, t0=pp.t0, t_end=t_end,
                    rel_rows=pp.rel_rows, fame_reads=len(pp.fame_reads))
                break
        finally:
            if _uctx is not None:
                _uctx.__exit__(None, None, None)

        e = pp.e
        chain_len0 = pp.chain_len0
        new_ids = pp.new_ids
        tw_i, t_start, bp, rw, cb = pp.tw_i, pp.t_start, pp.bp, pp.rw, pp.cb
        rel_rows, rx0, und = pp.rel_rows, pp.rx0, pp.und
        off = 2
        tabs = packed[off:off + 2 * tw_i * n].reshape(2, tw_i, n)
        off += 2 * tw_i * n
        span_w = t_end - t_start
        wt_all = np.concatenate(
            [self._wt_table[:t_start], tabs[0][:span_w]], axis=0)
        fr_all = np.concatenate(
            [self._fr_table[:t_start], tabs[1][:span_w]], axis=0)
        rnd_b = packed[off:off + bp]
        off += bp
        wit_b = packed[off:off + bp]
        off += bp
        famous_merged = packed[off:off + rw * n].reshape(rw, n)
        off += rw * n
        sel_np = packed[off:off + cb]
        off += cb
        rr_sel_np = packed[off:off + cb]
        off += cb
        cts_hi_np = packed[off:off + cb]
        off += cb
        cts_lo_np = packed[off:]
        # Host-side share of the fused stage, excluding the dispatches
        # and pulls recorded above.
        _now = _t()
        self.phase_ns["consensus"] = (
            self.phase_ns.get("consensus", 0) + _now - t_enter
            - (self.phase_ns.get("c_dispatch", 0) - cd0)
            - (self.phase_ns.get("c_pull", 0) - cp0))

        active = (fr_all < chain_len0[None, :]).any(axis=1)
        n_rows = int(np.nonzero(active)[0][-1]) + 1 if active.any() else 0
        self._fr_table = fr_all[:n_rows]
        self._wt_table = wt_all[:n_rows]
        self._chain_len_prev = chain_len0.copy()
        self._last_growth = max(n_rows - rel_rows, 1)
        self._last_newly = max(newly_count, 64)
        r_total = self.rho_min + n_rows
        wt_abs = np.full((r_total, n), -1, np.int32)
        if n_rows:
            wt_abs[self.rho_min:] = self._wt_table
        if self.famous.shape[0] < r_total:
            grown = np.zeros((r_total, n), np.int32)
            grown[: self.famous.shape[0]] = self.famous
            self.famous = grown

        delta = RunDelta()

        # Host mirrors of the device-computed rounds (reference
        # DivideRounds bookkeeping, hashgraph.go:616-646).
        for j, i in enumerate(new_ids):
            rnd = int(rnd_b[j])
            wit = bool(wit_b[j])
            self.rounds[i] = rnd
            self.witness[i] = wit
            delta.new_rounds.append((i, rnd, wit))
            if rnd not in self._queued_rounds:
                self._queued_rounds.add(rnd)
                bisect.insort(self.undecided_rounds, rnd)

        # Host mirror of DecideFame's bookkeeping from the pulled fame
        # window (hashgraph.go:649-730).
        for rho in list(self.undecided_rounds):
            if rho >= r_total:
                continue
            t = rho - rx0
            row_decided = True
            for c in range(n):
                if wt_abs[rho, c] < 0:
                    continue
                if self.famous[rho, c] == FAME_UNDEFINED:
                    f = int(famous_merged[t, c])
                    if f != FAME_UNDEFINED:
                        self.famous[rho, c] = f
                        delta.fame_updates.append(
                            (rho, int(wt_abs[rho, c]), f == FAME_TRUE))
                if self.famous[rho, c] == FAME_UNDEFINED:
                    row_decided = False
            if row_decided:
                self.undecided_rounds.remove(rho)
                delta.newly_decided_rounds.append(rho)
                if (self.last_consensus_round is None
                        or rho > self.last_consensus_round):
                    self.last_consensus_round = rho
                    delta.last_commited_round_events = int(
                        (self.rounds[:e] == rho - 1).sum())

        # The cb-compacted tail: entries [0, newly_count) are the newly
        # received lanes in ascending lane (= event id) order.
        for j in range(newly_count):
            li = int(sel_np[j])
            i = int(und[li])
            rr_i = int(rr_sel_np[j])
            hi = int(cts_hi_np[j])
            self.rr[i] = rr_i
            if hi == ZERO_TS_HI:
                self.cts_ns[i] = CTS_SENTINEL
                ns = ZERO_TIME_NS
            else:
                ns = _ts_join(hi, int(cts_lo_np[j]))
                self.cts_ns[i] = ns
            delta.new_received.append((int(i), rr_i, ns))
        delta.last_consensus_round = self.last_consensus_round
        self._prev_first_undec = (
            self.undecided_rounds[0] if self.undecided_rounds else r_total)

        # Commit the device result carries only now that the host
        # mirrors are applied: a redo, a failure or an exception above
        # leaves the previous pass's carries intact.
        self._rounds_d = pp.rounds_out
        self._rr_d = pp.rr_out
        self.host_syncs = syncs

        self.phase_ns["apply"] = (
            self.phase_ns.get("apply", 0) + _t() - _now)
        # An append that slipped in during the unlocked wait means the
        # state is NOT at a fixpoint yet.
        self._empty_delta_ok = not self._new_since_run
        return delta

    # -- prewarm ------------------------------------------------------------

    def prewarm(self, *, budget_bytes: int = 1 << 28) -> bool:
        """Pay the cold-start costs before live traffic: on CUDA, build
        the kernel libraries (B1's, and P-256's for a node that verifies
        on the device), then run a scratch sibling engine with the same
        shapes through two passes of a small synthetic gossip DAG (the
        allocator's first allocations, the kernel's first launches). Returns False (skipped) when the
        scratch carries would exceed `budget_bytes`."""
        n = self.n
        est = 4 * ((self.cap + 1) * n            # la
                   + 2 * n * n * self.kcap       # ranks + chain_la
                   + 5 * n * self.kcap           # chain id/ts/rb tables
                   + 8 * self.cap)               # 1-D event vectors
        if est > budget_bytes:
            return False
        if self.device.type == "cuda":
            hopper_kernels.build()
        scratch = IncrementalEngine(
            n, capacity=self.cap, block=self.block, k_capacity=self.kcap,
            mesh=self._mesh, device=self.device)
        heads = [-1] * n
        idx = [0] * n
        ts = 1_700_000_000_000_000_000

        def gossip_round(step: int) -> None:
            nonlocal ts
            for c in range(n):
                op = heads[(c + step) % n] if heads[c] >= 0 else -1
                ts += 1_000_000
                eid = scratch.append(
                    heads[c], op, c, idx[c], (idx[c] + c) % 2 == 1, ts)
                heads[c] = eid
                idx[c] += 1

        for step in (1, 2):
            gossip_round(step)
        scratch.run()
        for step in (3, 1):
            gossip_round(step)
        scratch.run()
        scratch.close()
        return True

    # -- queries -----------------------------------------------------------

    def backlog(self) -> int:
        """Events appended but not yet folded by a pass (ingest flow
        control gates on this); it resets when a pass snapshots."""
        return len(self._new_since_run)

    def round_of(self, eid: int) -> int:
        return int(self.rounds[eid])

    def witness_table(self) -> np.ndarray:
        r_total = self.rho_min + len(self._wt_table)
        wt_abs = np.full((r_total, self.n), -1, np.int32)
        if len(self._wt_table):
            wt_abs[self.rho_min:] = self._wt_table
        return wt_abs
