"""Memory-sharded consensus on torch.distributed (counterpart of
babble_tpu/ops/sharded.py): d ranks hold a d-times DAG.

The pipeline shards the two O(E·n) tables, lastAncestor coordinates and
first descendants, over the ranks of a mesh axis (parallel.ShardAxis)
and keeps them sharded through every stage; nothing event-sized is
replicated except O(E) int32 vectors (parents, creators, rounds). JAX
runs each stage as one `shard_map` program; here every rank runs the
same function on its shard, and the collectives are the axis's.

  coordinates   chain-sharded: rank p owns the coordinate rows of its
                creators' chains, kept as [n/d · K + 1, n] rows (row
                c·K + k: chain c's position k; the last row takes the
                writes of lanes this rank does not own, JAX's dropped
                scatter lanes). Each level is computed replicated from
                parent rows fetched by masked gather + pmax (one [2W, n]
                collective a level) and written back to the owned rows.
  fd            chain-local compare-and-count ranks, then one all_to_all
                turns the [E, n/d] chain columns into the event-sharded
                [E/d, n] table.
  rounds        per level the candidate-witness strongly-see tally is
                sharded over candidate chains: one B1 TALLY launch
                (hopper_kernels.strongly_see_gathered) over the level's
                [W, n] coordinate rows against this rank's witness-fd
                rows, psum-reduced to the [W] count.
  fame          the voters are sharded; their strongly-see matrices for
                every voting round come from one B1 MATRIX launch before
                the vote loop (they do not depend on the votes); votes
                all-gathered per round, decisions psum-reduced.
  round recv    event-sharded, against the replicated witness-row
                tables; no collective until the outputs are gathered.

Every stage reproduces the single-device pipeline bit for bit
(tests/test_torch_sharded.py holds it to the JAX package's
run_pipeline and sharded_pipeline). On a CUDA tensor both strongly-see
sites launch the kernel or raise; on a CPU tensor they take its plain
version. Each function takes `axis` and `device=None` (CUDA unless the
caller names another, `devices.resolve_device`); tensor arguments are
on that device. Semantics anchors as in kernels.py: reference
hashgraph.go:211-339, 448-530, 616-858.

JAX's `lax.dynamic_slice` clamps its start; here every slice is a
shard's own block (n and the padded e divide by d), so none needs it.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from ..devices import resolve_device
from ..parallel import mesh_axis
from . import hopper_kernels
from .dag import dag_from_arrays
from .kernels import (FAME_FALSE, FAME_TRUE, FAME_UNDEFINED, INT32_MAX, ZERO_TS_RANK,
                      _bcast_budget, chunk_width)
from .pipeline import pad_famous, tight_round_bucket

I32 = torch.int32
# The DAG fields that go to a rank process (dag_arrays) and back
# through dag.dag_from_arrays.
DAG_FIELDS = ("self_parent", "other_parent", "creator", "index", "coin", "ts_rank",
              "ts_values", "levels", "chain", "chain_len", "chain_rank", "root_round")
# Elements of the levels' coordinate rows that the rounds sweep fetches
# in one collective.
_LEVEL_ROWS = 1 << 22


def _shard_width(n: int, axis) -> int:
    if n % axis.size:
        raise ValueError(f"participants {n} must divide over {axis.size} shards")
    return n // axis.size


def _strongly_see(sites, site, *args):
    """hopper_kernels.strongly_see_gathered at a sharded site; `sites`
    (a dict, or None) counts its calls and its kernel launches there."""
    gathered = hopper_kernels.strongly_see_gathered
    before = sum(gathered.launches.values())
    out = gathered(*args)
    if sites is not None:
        rec = sites.setdefault(site, {"calls": 0, "launches": 0})
        rec["calls"] += 1
        rec["launches"] += sum(gathered.launches.values()) - before
    return out


# -- remote row fetches ---------------------------------------------------
#
# The resident tables are sharded; a row read is a masked local gather
# (the owner contributes the row, everyone else -1) followed by a pmax
# over the axis. Every real value is >= -1 (coordinates) or >= 0 (fd
# ranks, INT32_MAX), so a max with a -1 fill is exact.


def _fetch_by_chain(la, cr, pos, off, n_loc, k, fill=-1):
    """Rows keyed by (creator, chain position) from this rank's chain
    rows `la` [n_loc·k + 1, n]; cr/pos [m], entries outside this rank's
    chains or < 0 fetch fill rows. The LOCAL contribution [m, n], fresh
    (the caller's pmax reduces it in place)."""
    owned = (cr >= off) & (cr < off + n_loc) & (pos >= 0) & (pos < k)
    rows = la[torch.where(owned, (cr - off) * k + pos, n_loc * k)]
    return rows.masked_fill_(~owned[:, None], fill)


def _fetch_by_event(tbl, ids, off, e_loc, fill=-1):
    """Rows keyed by event id from this rank's event block `tbl`
    [e_loc, n]; ids [m], ids outside the block (or < 0) fetch fill
    rows. The LOCAL contribution [m, n], fresh."""
    owned = (ids >= off) & (ids < off + e_loc)
    rows = tbl[torch.clamp(ids - off, 0, e_loc - 1)]
    return rows.masked_fill_(~owned[:, None], fill)


# -- stage 1: lastAncestors, chain-sharded storage ------------------------


def last_ancestors(self_parent, other_parent, creator, index, levels, axis, device=None,
                   *, n, k):
    """Counterpart of make_last_ancestors(mesh, n=n, k=k, axis=axis)
    (babble_tpu/ops/sharded.py:138-181). Per-event inputs [E_pad + 1]
    and levels [L, W], replicated. Returns this rank's chain rows
    la [n/d · k + 1, n]: row c·k + p is the coordinate row of chain
    off + c's position p (-1 where the chain has no such event); the
    last row is the discard row of lanes this rank does not own."""
    dev = resolve_device(device)
    n_loc = _shard_width(n, axis)
    off = axis.index * n_loc
    discard = n_loc * k
    la = torch.full((discard + 1, n), -1, dtype=I32, device=dev)
    w = levels.shape[1]
    lanes = torch.arange(w, device=dev)
    valid = levels >= 0
    sids = torch.where(valid, levels, 0)
    cr_e = torch.where(valid, creator[sids], -1)
    idx_e = index[sids]
    # Parent rows by (creator, position); the level's self and other
    # parents ride one [2W, n] collective.
    both = torch.cat([torch.where(valid, self_parent[sids], -1),
                      torch.where(valid, other_parent[sids], -1)], 1)  # [L, 2W]
    safe = torch.where(both >= 0, both, 0)
    cr_p = torch.where(both >= 0, creator[safe], -1)
    pos_p = torch.where(both >= 0, index[safe], -1)
    own_slot = torch.where(valid, idx_e, -1)
    cr_slot = torch.clamp(cr_e, 0, n - 1)
    owned = valid & (cr_e >= off) & (cr_e < off + n_loc)
    dst = torch.where(owned, (cr_e - off) * k + idx_e, discard)
    for l in range(levels.shape[0]):
        rows2 = axis.pmax(_fetch_by_chain(la, cr_p[l], pos_p[l], off, n_loc, k))
        rows = torch.maximum(rows2[:w], rows2[w:])
        rows[lanes, cr_slot[l]] = own_slot[l]
        la[dst[l]] = rows
    return la


# -- stage 2: first descendants, chain-local ranks + one all_to_all ------


def first_descendants(la, chain_len, creator, index, axis, device=None, *, n, k):
    """Counterpart of make_first_descendants(mesh, n=n, axis=axis)
    (sharded.py:184-232): from this rank's chain rows (last_ancestors)
    to its block of the event-sharded first-descendant table
    fd [E_pad / d, n]. creator/index [E_pad + 1], chain_len [n]."""
    dev = resolve_device(device)
    n_loc = _shard_width(n, axis)
    off = axis.index * n_loc
    la_cs = la[: n_loc * k].view(n_loc, k, n)
    chain_len_loc = chain_len[off: off + n_loc]
    # Ranks are a chain-local compare-and-count, chunked over targets.
    tc = min(max((1 << 27) // max(n_loc * n * k, 1), 1), k)
    nchunks = -(-k // tc)
    # Positions beyond a chain's end hold the storage fill (-1) and must
    # not count (kernels.first_descendant_cube puts INT32_MAX there).
    in_chain = (torch.arange(k, device=dev)[None, :] < chain_len_loc[:, None])[:, :, None, None]
    ranks = torch.zeros((n_loc, n, nchunks * tc), dtype=I32, device=dev)
    for g in range(nchunks):
        t0 = g * tc
        ts = torch.arange(t0, t0 + tc, dtype=I32, device=dev)
        ranks[:, :, t0: t0 + tc] = (
            (la_cs[:, :, :, None] < ts) & in_chain).sum(1, dtype=I32)
    ranks = ranks[:, :, :k]
    cube = torch.where(ranks < chain_len_loc[:, None, None], ranks, INT32_MAX)
    e_pad = creator.shape[0] - 1
    ia = torch.clamp(index[:e_pad], 0, k - 1)
    fd_part = cube[:, creator[:e_pad], ia].T  # [E_pad, n/d] this rank's chain columns
    fd_part = torch.where((index[:e_pad] >= 0)[:, None], fd_part, INT32_MAX).contiguous()
    # Chain-sharded columns to event-sharded rows.
    return axis.all_to_all(fd_part)


# -- stage 3: rounds + witness tables, candidate tally chain-sharded -----


def rounds(self_parent, other_parent, creator, index, levels, root_round, la, fd, axis,
           device=None, *, n, k, sm, r, sites=None):
    """Counterpart of make_rounds(mesh, n=n, sm=sm, r=r, axis=axis)
    (sharded.py:235-337): rounds [E_pad], witness flags [E_pad] and the
    witness table wt [r, n], replicated, from this rank's chain rows
    `la` and event block `fd`.

    A level's candidate tally is one B1 TALLY launch: the level's
    coordinate rows x_tab = la_x [W, n] (one pmax) against this rank's
    witness-fd table f_tab [r · n/d + 1, n] (slot j · n/d + c: the fd
    row of witness wt[j, off + c], found as witnesses are discovered;
    the last row takes the writes of lanes this rank does not own),
    through w_tab [r, n/d] (the slot, or -1 where the round has no
    witness of that chain), row i reading its parent round's row; the
    ranks' tallies psum to the [W] count. This replaces JAX's chunked
    [wc, n/d, n] gather (sharded.py:283-302). JAX fetches la_x a level
    at a time; here one pmax fetches a block of levels' rows, up to
    2^22 elements (one level at n = 4,096). Row r of wt is the
    scatter dump: every lane that does not write a witness writes -1
    there."""
    dev = resolve_device(device)
    n_loc = _shard_width(n, axis)
    off = axis.index * n_loc
    e_pad = self_parent.shape[0] - 1
    e_loc = fd.shape[0]
    off_e = axis.index * e_loc
    w = levels.shape[1]
    discard = r * n_loc
    rnds = torch.full((e_pad + 1,), -1, dtype=I32, device=dev)
    wit = torch.zeros((e_pad + 1,), dtype=torch.bool, device=dev)
    wt = torch.full((r + 1, n), -1, dtype=I32, device=dev)
    fd_wt = torch.full((discard + 1, n), INT32_MAX, dtype=I32, device=dev)
    w_slots = torch.full((discard + 1,), -1, dtype=I32, device=dev)
    w_tab = w_slots[:discard].view(r, n_loc)
    xs = torch.arange(w, dtype=I32, device=dev)
    valid_all = levels >= 0
    sids_all = torch.where(valid_all, levels, 0)
    sp_all = torch.where(valid_all, self_parent[sids_all], -1)
    op_all = torch.where(valid_all, other_parent[sids_all], -1)
    cr_all = torch.where(valid_all, creator[sids_all], 0)
    pos_all = index[sids_all]
    cr_fetch = torch.where(valid_all, cr_all, -1)
    root_sp = root_round[cr_all]
    dst_all = torch.where(valid_all, sids_all, e_pad)
    block = max(min(_LEVEL_ROWS // (w * n), levels.shape[0]), 1)
    for l in range(levels.shape[0]):
        valid, sids, sp, op, cr = (valid_all[l], sids_all[l], sp_all[l], op_all[l],
                                   cr_all[l])
        rnd_sp_raw = torch.where(sp >= 0, rnds[torch.where(sp >= 0, sp, 0)], -1)
        sp_round = torch.where(sp >= 0, rnd_sp_raw, root_sp[l])
        op_round = torch.where(op >= 0, rnds[torch.where(op >= 0, op, 0)], root_sp[l])
        use_op = sp_round < op_round
        pr = torch.where(use_op, op_round, sp_round)
        pr_root = torch.where(use_op, op < 0, sp < 0)
        # lastAncestor rows of the level's events: one collective for a
        # block of levels (the sweep never writes them).
        if l % block == 0:
            hi = min(l + block, levels.shape[0])
            la_blk = axis.pmax(_fetch_by_chain(
                la, cr_fetch[l:hi].reshape(-1), pos_all[l:hi].reshape(-1), off, n_loc,
                k)).view(hi - l, w, n)
        la_x = la_blk[l % block]
        pr_c = torch.clamp(pr, 0, r - 1).to(I32)
        cnt = axis.psum(_strongly_see(sites, "rounds", la_x, xs, fd_wt, w_tab, pr_c, sm,
                                      "tally"))
        inc = pr_root | (cnt >= sm)
        r_new = pr + inc.to(I32)
        w_new = ((sp < 0) & (op < 0)) | (r_new > rnd_sp_raw)
        rnds[dst_all[l]] = torch.where(valid, r_new, -1)
        wit[dst_all[l]] = valid & w_new
        upd = valid & w_new
        r_idx = torch.where(upd, torch.clamp(r_new, 0, r - 1), r)
        wt[r_idx, cr] = torch.where(upd, sids, -1)
        # fd rows of the new witnesses (one collective), into this
        # rank's slots of the witness-fd table. upd is the same on every
        # rank, so a level without a new witness skips the collective
        # everywhere (one host read; gloo has synchronised the stream).
        if not bool(upd.any()):
            continue
        fd_rows = axis.pmax(_fetch_by_event(fd, torch.where(upd, sids, -1), off_e, e_loc))
        owned = upd & (cr >= off) & (cr < off + n_loc)
        slot = torch.where(owned, r_idx * n_loc + cr - off, discard)
        fd_wt[slot] = fd_rows
        w_slots[slot] = torch.where(owned, slot, -1).to(I32)
    return rnds[:e_pad], wit[:e_pad], wt[:r]


# -- witness-row prefetch -------------------------------------------------


def wt_tables(wt_flat, creator, index, la, fd, axis, device=None, *, n, k):
    """Counterpart of make_wt_tables(mesh, n=n, axis=axis)
    (sharded.py:348-377): the coordinate and fd rows of every witness in
    wt_flat [m] (-1: none, fetching -1 rows), replicated [m, n] each:
    the only row tables fame and round received need, bounded by
    rounds · n², not E · n."""
    resolve_device(device)
    n_loc = _shard_width(n, axis)
    off = axis.index * n_loc
    e_loc = fd.shape[0]
    valid = wt_flat >= 0
    safe = torch.where(valid, wt_flat, 0)
    cr = torch.where(valid, creator[safe], -1)
    pos = torch.where(valid, index[safe], -1)
    la_rows = axis.pmax(_fetch_by_chain(la, cr, pos, off, n_loc, k))
    fd_rows = axis.pmax(_fetch_by_event(fd, wt_flat, axis.index * e_loc, e_loc))
    return la_rows, fd_rows


# -- stage 4: fame, voting witnesses sharded -----------------------------


def fame(wt, la_wt, fd_wt, index, coin, axis, device=None, *, n, sm, r, sites=None):
    """Counterpart of make_fame(mesh, n=n, sm=sm, r=r, axis=axis)
    (sharded.py:380-447): famous [r, n] trilean, replicated, with this
    rank's n/d voters of each round, from the replicated witness rows
    la_wt / fd_wt [r, n, n] (row (j, c): the rows of witness wt[j, c]).

    The strongly-see matrices ss[j-1] = (counts(la_y, fd_{j-1}) >= sm)
    & witness valid of every voting round j come first, from gathered
    MATRIX launches (one per chunk of voting rounds, past 2^26 bytes of
    output; one at every size the repo runs). A round without any
    witness casts no vote and decides nothing: its step is skipped, its
    votes all false, as JAX's step leaves them. The yays product is
    0/1 float32, exact with TF32 off (devices.py)."""
    dev = resolve_device(device)
    n_loc = _shard_width(n, axis)
    y_off = axis.index * n_loc
    famous = torch.zeros((r, n), dtype=I32, device=dev)
    if r < 2:
        return famous
    wt_valid = wt >= 0
    wt_safe = torch.where(wt_valid, wt, 0)
    idx_x = torch.where(wt_valid, index[wt_safe], -1)  # [r, n]
    rx = torch.arange(r, device=dev)[:, None].expand(r, n)
    voters = wt_valid.any(1).tolist()  # rounds with a witness (one host read)
    # ss_all[j-1][y, x]: round j's voter y_off + y strongly sees round
    # j-1's witness x.
    x_tab = la_wt.reshape(r * n, n)
    f_tab = fd_wt.reshape(r * n, n)
    w_tab = torch.where(wt_valid, torch.arange(r * n, dtype=I32, device=dev).view(r, n), -1)
    y_rows = y_off + torch.arange(n_loc, dtype=I32, device=dev)
    per_launch = chunk_width(r - 1, n_loc * n)
    blocks = []
    for j in range(1, r, per_launch):
        hi = min(j + per_launch, r)
        rounds_j = torch.arange(j, hi, dtype=I32, device=dev)
        xs = (rounds_j[:, None] * n + y_rows[None, :]).reshape(-1)
        wrow = (rounds_j - 1).repeat_interleave(n_loc)
        blocks.append(_strongly_see(sites, "fame", x_tab, xs, f_tab, w_tab, wrow, sm,
                                    "matrix").view(torch.bool).view(hi - j, n_loc, n))
    ss_all = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    vote = torch.zeros((n_loc, r, n), dtype=torch.bool, device=dev)
    for j in range(1, r):
        if not voters[j]:
            vote = torch.zeros_like(vote)
            continue
        y = wt[j, y_off: y_off + n_loc]
        y_valid = y >= 0
        ys = torch.where(y_valid, y, 0)
        la_y = la_wt[j, y_off: y_off + n_loc]  # [n/d, n]
        see_v = la_y[:, None, :] >= idx_x[None, :, :]  # [n/d, r, n]
        ss = ss_all[j - 1]
        # Round j-1's votes by ALL voters feed the tally.
        v_prev = axis.all_gather(vote.reshape(n_loc, r * n).to(I32))  # [n, r·n]
        yays = (ss.to(torch.float32) @ v_prev.to(torch.float32)).to(I32).view(n_loc, r, n)
        nays = ss.sum(-1, dtype=I32)[:, None, None] - yays
        v = yays >= nays
        t = torch.maximum(yays, nays)
        diff = j - rx
        is_first = (diff == 1)[None]
        normal = ((diff % n) != 0)[None]
        coin_vote = coin[ys].to(torch.bool)[:, None, None]
        vote = torch.where(is_first, see_v, torch.where(normal | (t >= sm), v, coin_vote))
        active = y_valid[:, None, None] & wt_valid[None] & (rx < j)[None]
        vote = vote & active
        decide_now = active & ~is_first & normal & (t >= sm)
        dec_any = axis.psum(decide_now.any(0).to(I32)) > 0
        dec_val = axis.psum((decide_now & v).any(0).to(I32)) > 0
        undecided = (famous == FAME_UNDEFINED) & wt_valid
        famous = torch.where(undecided & dec_any,
                             torch.where(dec_val, FAME_TRUE, FAME_FALSE).to(I32), famous)
    return famous


# -- stage 5: round received, pure event sharding ------------------------


def round_received(rounds_loc, fd_loc, creator_loc, index_loc, wt, famous, idx_w, la_wt,
                   chain_rank, valid_loc, device=None, *, n, r):
    """Counterpart of make_round_received(mesh, n=n, r=r, axis=axis)
    (sharded.py:450-500) on this rank's event block: round received
    [e_loc] (-1 undecided) and consensus timestamp ranks [e_loc] (-1 =
    zero time), against the replicated witness tables; no collective.
    Both phases go over the block in chunks, so their [n, chunk] and
    [chunk, n] tensors stay under the broadcast budget."""
    dev = resolve_device(device)
    e_loc = rounds_loc.shape[0]
    k = chain_rank.shape[1]
    wt_valid = wt >= 0
    has_undec = ((famous == FAME_UNDEFINED) & wt_valid).any(1)  # [r]
    rows = torch.arange(r, device=dev)
    min_undec = torch.where(has_undec, rows, r).min()
    fmask = (famous == FAME_TRUE) & wt_valid  # [r, n]
    need = fmask.sum(1, dtype=I32) // 2
    ec = chunk_width(e_loc, n, _bcast_budget(dev))
    chunks = [slice(x0, min(x0 + ec, e_loc)) for x0 in range(0, e_loc, ec)]

    # Phase 1: first qualifying round per event.
    rr = torch.full((e_loc,), -1, dtype=I32, device=dev)
    for i in range(r):
        eligible = ~has_undec[i] & (min_undec > i)
        for sl in chunks:
            see_wx = la_wt[i][:, creator_loc[sl]] >= index_loc[sl]  # [n(w), chunk]
            s_cnt = (see_wx & fmask[i][:, None]).sum(0, dtype=I32)
            ok = (eligible & (s_cnt > need[i]) & (i > rounds_loc[sl]) & (rr[sl] < 0)
                  & valid_loc[sl])
            rr[sl] = torch.where(ok, i, rr[sl])

    # Phase 2: medians against each event's own receiving round.
    cts = torch.empty((e_loc,), dtype=I32, device=dev)
    cols = torch.arange(n, device=dev)[None, :]
    for sl in chunks:
        rr_g = rr[sl]
        rr_safe = torch.clamp(rr_g, 0, r - 1).long()
        see_sel = la_wt[rr_safe[:, None], cols, creator_loc[sl][:, None]] >= index_loc[sl][:, None]
        s_mask = see_sel & fmask[rr_safe]  # [chunk, n]
        s_cnt = s_mask.sum(1, dtype=I32)
        fd_g = fd_loc[sl]
        valid_t = fd_g <= idx_w[rr_safe]  # the first descendant reaches the witness
        ts_fd = chain_rank[cols, torch.clamp(fd_g, 0, k - 1)]
        tsv = torch.where(valid_t, ts_fd, ZERO_TS_RANK)
        tvals = torch.where(s_mask, tsv, INT32_MAX)
        sorted_t = torch.sort(tvals, dim=1).values
        med = torch.gather(sorted_t, 1, (s_cnt // 2).long()[:, None])[:, 0]
        cts[sl] = torch.where(rr_g >= 0, med, ZERO_TS_RANK)
    return rr, cts


# -- the whole pipeline --------------------------------------------------


def sharded_pipeline(dag, axis, device=None, *, sites=None, tables=None):
    """The consensus pipeline sharded over `axis` (a parallel.ShardAxis:
    one rank of a spawn_ranks program), the counterpart of
    sharded_pipeline(dag, mesh, axis) (sharded.py:503-574). Every rank
    calls it with the same DAG. Returns, on every rank, the six outputs
    of pipeline.run_pipeline, equal to them bit for bit: rounds, witness
    and wt are replicated by the stages, fame by its psums, and round
    received and timestamps are gathered from the event blocks (JAX
    assembles the sharded arrays on the host). The O(E·n) state stays
    sharded end to end, so d ranks hold a d-times DAG.

    `sites`, a dict, gets the strongly-see calls and kernel launches by
    site ("rounds": one TALLY a DAG level; "fame": one MATRIX a chunk of
    voting rounds); `tables`, a dict, gets this rank's chain rows
    ("la_cs" [n/d, K, n]) and event block ("fd_es" [E_pad / d, n])."""
    dev = resolve_device(device)
    d = axis.size
    n, e, sm, r = dag.n, dag.e, dag.super_majority, dag.max_rounds
    n_loc = _shard_width(n, axis)
    k = dag.chain.shape[1]
    e_pad = -(-e // d) * d if e else d
    e_loc = e_pad // d

    def padded(a, fill):
        out = np.full(e_pad + 1, fill, np.int32)
        out[:e] = np.asarray(a)[:e]
        return torch.from_numpy(out).to(dev)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sp_p = padded(dag.self_parent, -1)
    op_p = padded(dag.other_parent, -1)
    cr_p = padded(dag.creator, 0)
    idx_p = padded(dag.index, -1)
    levels = tensor(dag.levels)

    la = last_ancestors(sp_p, op_p, cr_p, idx_p, levels, axis, dev, n=n, k=k)
    fd_es = first_descendants(la, tensor(dag.chain_len), cr_p, idx_p, axis, dev, n=n, k=k)
    if tables is not None:
        tables["la_cs"] = la[: n_loc * k].view(n_loc, k, n)
        tables["fd_es"] = fd_es
    rounds_p, wit_p, wt = rounds(sp_p, op_p, cr_p, idx_p, levels, tensor(dag.root_round),
                                 la, fd_es, axis, dev, n=n, k=k, sm=sm, r=r, sites=sites)
    rnds = rounds_p[:e]
    r_small = tight_round_bucket(rnds, r)
    wt_small = wt[:r_small].contiguous()

    # Witness-row tables: the only row state fame and round received
    # need, fetched once from the sharded tables.
    la_rows, fd_rows = wt_tables(wt_small.view(-1), cr_p, idx_p, la, fd_es, axis, dev,
                                 n=n, k=k)
    la_wt = la_rows.view(r_small, n, n)
    fd_wt = fd_rows.view(r_small, n, n)
    famous_small = fame(wt_small, la_wt, fd_wt, idx_p, tensor(dag.coin), axis, dev, n=n,
                        sm=sm, r=r_small, sites=sites)

    wt_valid = wt_small >= 0
    idx_w = torch.where(wt_valid, idx_p[torch.where(wt_valid, wt_small, 0)], -1)
    blk = slice(axis.index * e_loc, (axis.index + 1) * e_loc)
    rounds_pad = torch.zeros(e_pad, dtype=I32, device=dev)
    rounds_pad[:e] = rnds
    valid_e = torch.arange(e_pad, device=dev) < e
    rr_loc, cts_loc = round_received(
        rounds_pad[blk], fd_es, cr_p[blk], idx_p[blk], wt_small, famous_small, idx_w, la_wt,
        tensor(dag.chain_rank), valid_e[blk], dev, n=n, r=r_small)
    rr_cts = axis.all_gather(torch.stack([rr_loc, cts_loc], 1))[:e]  # [e, 2]
    return (rnds, wit_p[:e], wt, pad_famous(famous_small, r, n), rr_cts[:, 0].contiguous(),
            rr_cts[:, 1].contiguous())


# -- rank side -------------------------------------------------------------


def dag_arrays(dag) -> dict:
    """The numpy fields of a DagTensors that sharded_pipeline needs, for
    a rank process (dag.dag_from_arrays(**arrays) rebuilds it)."""
    return {"n": dag.n, "e": dag.e, "depth": dag.depth,
            **{f: np.asarray(getattr(dag, f)) for f in DAG_FIELDS}}


def run_sharded(rank, axis, runs, device):
    """The rank side of parallel.spawn_ranks(d, run_sharded, runs,
    device, ...): sharded_pipeline on each of `runs`, in turn. A run is
    a dict: "dag" (dag_arrays of a DAG); optionally "mesh", a mesh
    (shape, names) whose composite axis the run uses instead of `axis`
    (parallel.mesh_axis, the same axis after a layout check); and
    "tables": True for the digests (table_digest) of this rank's la_cs
    and fd_es.

    Returns a record per run: this rank's shard index and the axis size
    and backend, the synchronised seconds of the run, the strongly-see
    calls and launches by site (`sites`) and by mode (`launches`, the
    wrapper's counts, reset to 0 just before), the bytes gloo copied
    through host memory, the collectives made and the host seconds in
    them, the peak device memory (CUDA), and on rank 0 the six outputs
    as numpy (`outputs`)."""
    dev = resolve_device(device)
    counts = hopper_kernels.strongly_see_gathered.launches
    records, meshes = [], {}
    for run in runs:
        ax = axis
        if run.get("mesh") is not None:
            shape, names = run["mesh"]
            key = (tuple(shape), tuple(names))
            if key not in meshes:
                meshes[key] = mesh_axis(shape, names, axis.backend, dev)
            ax = meshes[key]
        dag = dag_from_arrays(**run["dag"])
        host0, calls0, wait0 = ax.host_bytes, ax.calls, ax.wait_s
        for mode in counts:
            counts[mode] = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        sites, tables = {}, {} if run.get("tables") else None
        t0 = time.perf_counter()
        out = sharded_pipeline(dag, ax, dev, sites=sites, tables=tables)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec = {"rank": rank, "index": ax.index, "size": ax.size, "backend": ax.backend,
               "seconds": time.perf_counter() - t0, "sites": sites,
               "launches": dict(counts), "host_bytes": ax.host_bytes - host0,
               "collectives": ax.calls - calls0, "collective_s": ax.wait_s - wait0,
               "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}
        if rank == 0:
            rec["outputs"] = [o.cpu().numpy() for o in out]
        if tables is not None:
            rec["tables"] = {name: table_digest(t) for name, t in tables.items()}
        records.append(rec)
    return records


def table_digest(t: torch.Tensor) -> str:
    """sha256 of an int32 table's shape and its values, row-major."""
    a = np.ascontiguousarray(t.cpu().numpy(), dtype=np.int32)
    h = hashlib.sha256(repr(a.shape).encode())
    h.update(a)
    return h.hexdigest()


def single_device_table_digests(la, fd, chain, d) -> list:
    """For each of d shards, the digests that run_sharded gives for its
    "tables" run, from the single-device coordinates la [E, n] and
    first descendants fd [E, n] (kernels.compute_last_ancestors,
    compute_first_descendants) and chain [n, K], on one device: shard p
    holds chains p·n/d .. of la, -1 rows where a chain has no event,
    and events p·E_pad/d .. of fd, INT32_MAX rows past E."""
    e, n = la.shape
    n_loc = n // d
    e_pad = -(-e // d) * d if e else d
    e_loc = e_pad // d
    pad = torch.full((e_pad - e, n), INT32_MAX, dtype=I32, device=fd.device)
    fd_pad = torch.cat([fd, pad])
    out = []
    for p in range(d):
        ch = chain[p * n_loc: (p + 1) * n_loc]
        la_cs = torch.where((ch >= 0)[:, :, None], la[torch.clamp(ch, 0).long()], -1)
        out.append({"la_cs": table_digest(la_cs),
                    "fd_es": table_digest(fd_pad[p * e_loc: (p + 1) * e_loc])})
    return out


def oracle_equal(got, want) -> Optional[str]:
    """The name of the first of the six outputs where `got` differs
    from `want` (numpy arrays each) in shape or value, else None."""
    for name, a, b in zip(("rounds", "witness", "wt", "famous", "rr", "cts"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not (a == b).all():
            return name
    return None
